// qtos_torch/csrc/tick.cu built for the CPU against the stand-in runtime in
// this directory, from the repository's root:
//   g++ -std=c++17 -O2 -ffp-contract=off -pthread -shared -fPIC -I qtos_torch/csrc/emu
//       -o libtick_emu.so qtos_torch/csrc/emu/tick_emu.cpp
// -ffp-contract=off keeps every product rounded on its own, as nvcc's
// --fmad=false does on the card.
#define EMU_TYPED_LAUNCH_ONLY
#include "cuda_runtime.h"

float* emu_smem_base = nullptr;  // the kernel takes no shared memory

#include "../tick.cu"
