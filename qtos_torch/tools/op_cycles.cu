// A latency probe for the tick kernel's design floor
// (`qtos_torch/tools/tick_floor.py`) and the small BTD kernel's
// (`qtos_torch/tools/btd_floor.py`), built with the tick kernel's nvcc flags
// (`qtos_torch.ops.tick.nvcc_command`: sm_90a, --fmad=false, no fast math).
//
// One warp runs `n` dependent repetitions of one operation of the tick's
// chain, and lane 0 writes the clock cycles they took to out[0] and the last
// value to out[1] (so that nothing is optimised away); out[2..33] is the
// ring that the loads chase, and its copy in shared memory the ring of the
// shared-memory loads.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

enum Op { kFadd, kFmul, kDiv, kSqrt, kSin, kCos, kAtan2, kAcos, kShfl, kLoad, kRsqrt, kLds, kBar, kOps };

template <int OP>
__global__ void __launch_bounds__(32) op_cycles_kernel(int n, float x, float* out) {
  const int lane = threadIdx.x;
  __shared__ int shared_ring[32];
  volatile int* ring = reinterpret_cast<int*>(out + 2);
  ring[lane] = (lane + 1) & 31;
  for (int i = 0; i < 32; ++i) shared_ring[i] = (i + 1) & 31;  // every lane the same values
  __syncwarp();
  const int* link = reinterpret_cast<const int*>(out + 2);
  int j = lane;
  const long long t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    if (OP == kFadd) x = x + 1e-3f;
    if (OP == kFmul) x = x * 0.999f;
    if (OP == kDiv) x = 1.5f / x;
    if (OP == kSqrt) x = sqrtf(x);
    if (OP == kSin) x = sinf(x);
    if (OP == kCos) x = cosf(x);
    if (OP == kAtan2) x = atan2f(x, 0.75f);
    if (OP == kAcos) x = acosf(x * 0.5f);  // with the product that follows acosf on the chain
    if (OP == kShfl) x = __shfl_sync(kFullMask, x, (lane + 1) & 31);
    if (OP == kLoad) j = link[j];
    if (OP == kRsqrt) x = rsqrtf(x + 1.0f);  // with the add that keeps it from settling
    if (OP == kLds) j = shared_ring[j];
    if (OP == kBar) {
      __syncthreads();
      x = x + 1e-3f;
    }
  }
  const long long t1 = clock64();
  if (lane == 0) {
    out[0] = (float)(t1 - t0);
    out[1] = x + (float)j;
  }
}

using OpKernel = void (*)(int, float, float*);
constexpr OpKernel kOpKernels[kOps] = {
    op_cycles_kernel<kFadd>, op_cycles_kernel<kFmul>, op_cycles_kernel<kDiv>,   op_cycles_kernel<kSqrt>,
    op_cycles_kernel<kSin>,  op_cycles_kernel<kCos>,  op_cycles_kernel<kAtan2>, op_cycles_kernel<kAcos>,
    op_cycles_kernel<kShfl>, op_cycles_kernel<kLoad>, op_cycles_kernel<kRsqrt>, op_cycles_kernel<kLds>,
    op_cycles_kernel<kBar>};

}  // namespace

// Launches the probe of operation `op` (0 fadd, 1 fmul, 2 division, 3
// sqrtf, 4 sinf, 5 cosf, 6 atan2f, 7 acosf, 8 __shfl_sync, 9 a load that
// hits L1, 10 rsqrtf with an add, 11 a shared-memory load, 12
// __syncthreads with an add) with `n` repetitions on `stream`; `out` holds
// 34 floats.
extern "C" int op_cycles(int op, int n, void* out, void* stream) {
  if (op < 0 || op >= kOps || n < 0 || !out) return (int)cudaErrorInvalidValue;
  float* out_f = static_cast<float*>(out);
  float x = 0.5f;
  void* args[] = {&n, &x, &out_f};
  cudaError_t err = cudaLaunchKernel(kOpKernels[op], dim3(1), dim3(32), args, 0, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
