// qtos_torch/csrc/assemble.cu built for the CPU against the stand-in runtime in
// this directory, from the repository's root:
//   g++ -std=c++17 -O2 -ffp-contract=off -pthread -shared -fPIC -I qtos_torch/csrc/emu
//       -o libassemble_emu.so qtos_torch/csrc/emu/assemble_emu.cpp
// -ffp-contract=off keeps every product rounded on its own, as nvcc's
// --fmad=false does on the card.
#define EMU_TYPED_LAUNCH_ONLY
#include "cuda_runtime.h"

namespace {
float4 smem4[kEmuSmemBytes / sizeof(float4)];
}
float* emu_smem_base = reinterpret_cast<float*>(smem4);

#include "../assemble.cu"
