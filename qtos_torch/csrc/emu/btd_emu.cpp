// qtos_torch/csrc/btd.cu built for the CPU against the stand-in runtime in
// this directory, from the repository's root:
//   g++ -std=c++17 -O2 -pthread -shared -fPIC -I qtos_torch/csrc/emu
//       -o libbtd_emu.so qtos_torch/csrc/emu/btd_emu.cpp
using EmuKernelSig = void(const float*, const float*, const float*, float*, float*, const float*,
                          int, int, int, int);
#include "cuda_runtime.h"

namespace {
// Page-aligned, with a guard page: a read past a launch's shared memory
// faults where its end falls on a page boundary (cuda_runtime.h).
alignas(kEmuSmemGuardBytes) float4 smem4[(kEmuSmemBytes + kEmuSmemGuardBytes) / sizeof(float4)];
[[maybe_unused]] const bool guarded = (emu_smem_guard = true);
}
float* emu_smem_base = reinterpret_cast<float*>(smem4);

#include "../btd.cu"

#include <type_traits>
static_assert(std::is_same_v<decltype(btd_kernel), EmuKernelSig>,
              "EmuKernelSig must be btd_kernel's signature: the launch casts to it");
