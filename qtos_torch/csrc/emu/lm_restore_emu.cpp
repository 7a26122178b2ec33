// qtos_torch/csrc/lm_restore.cu built for the CPU against the stand-in runtime
// in this directory, from the repository's root:
//   g++ -std=c++17 -O2 -pthread -shared -fPIC -I qtos_torch/csrc/emu
//       -o liblm_restore_emu.so qtos_torch/csrc/emu/lm_restore_emu.cpp
#define EMU_TYPED_LAUNCH_ONLY
#include "cuda_runtime.h"

float* emu_smem_base = nullptr;  // the kernel takes no shared memory

#include "../lm_restore.cu"
