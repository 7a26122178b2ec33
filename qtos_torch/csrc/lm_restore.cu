// The LM loop's restore of rejected windows, for Hopper: in place in the
// system that assembly has just written, every window whose step was
// rejected takes back the system of its best accepted point.
//
// Replaces no Pallas kernel.  `qtos_tpu`'s LM loop keeps the best point's
// system by `jnp.where` over whole arrays, which XLA fuses into the loop on
// the TPU; the port's first loop did the same with three `torch.where`
// calls, each reading the fresh and the kept system in full and writing a
// third copy (10.3 GB per LM iteration at B=8192, K=41).  Here the loop
// keeps the fresh system by reference and this kernel copies only the
// windows that need the old one back, so when every step is accepted (the
// offline sweep) it moves nothing.  Plain PyTorch version:
// `restore_rejected_plain` in qtos_torch/ops/lm_restore.py; wrapper:
// `restore_rejected` there; caller: `_solve_pass` in
// qtos_torch/solver/solve.py.
//
// Shapes (float32, contiguous, batch-major, 16-byte aligned, a multiple of 4
// floats per window): D (B, K, n, n), L (B, K-1, n, n), g (B, K, n) and,
// when given, their kept copies of the same shapes; accept (B,) bytes
// (torch.bool).  For each window w with accept[w] == 0, D[w] = Db[w],
// L[w] = Lb[w], g[w] = gb[w], or zeros where no kept system exists yet
// (before the first accepted point).  Windows with accept[w] != 0 are not
// touched.  A copy is exact, so the result is that of
// torch.where(accept, D, Db) bit for bit.
//
// What bounds it on an H100: the rejected windows' bytes, read once and
// written once (zero-filled: written once), and the B flags: 2 x 425.8 KB
// per rejected window at K=41, n=36 (2.08 ms for all 8192 windows: 6.98 GB
// read and written at 3.35 TB/s), and B bytes when every step is accepted,
// where the time is that of launching the grid.
//
// Mapping: one block of kThreads threads per window.  All threads read the
// window's flag (one broadcast byte) and the block returns at once if it is
// set.  Otherwise the block copies the window's three slices by 16-byte
// loads and stores, kUnroll in flight per thread.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;

// Copies (or, with src == nullptr, zero-fills) the n4 float4s at dst.
__device__ __forceinline__ void restore_slice(float4* __restrict__ dst, const float4* __restrict__ src,
                                              size_t n4) {
  size_t i = threadIdx.x;
  if (src != nullptr) {
    for (; i + (kUnroll - 1) * kThreads < n4; i += kUnroll * kThreads) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = src[i + u * kThreads];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) dst[i + u * kThreads] = v[u];
    }
    for (; i < n4; i += kThreads) dst[i] = src[i];
  } else {
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (; i < n4; i += kThreads) dst[i] = z;
  }
}

__global__ void __launch_bounds__(kThreads) lm_restore_kernel(
    const unsigned char* __restrict__ accept, float4* __restrict__ D, const float4* __restrict__ Db,
    float4* __restrict__ L, const float4* __restrict__ Lb, float4* __restrict__ g,
    const float4* __restrict__ gb, long long nD4, long long nL4, long long ng4, int kept) {
  const size_t w = blockIdx.x;
  if (accept[w]) return;
  restore_slice(D + w * nD4, kept ? Db + w * nD4 : nullptr, (size_t)nD4);
  restore_slice(L + w * nL4, kept ? Lb + w * nL4 : nullptr, (size_t)nL4);
  restore_slice(g + w * ng4, kept ? gb + w * ng4 : nullptr, (size_t)ng4);
}

}  // namespace

// Launches one restore on `stream`: D, L, g (B windows of nD, nL, ng floats
// each) take Db, Lb, gb's windows where `kept` is nonzero, else zeros,
// wherever accept is 0.  Every tensor must be 16-byte aligned and each
// window a multiple of 4 floats.  Returns the launch's CUDA error (0 when it
// was accepted).
extern "C" int lm_restore_f32(const void* accept, void* D, const void* Db, void* L, const void* Lb,
                              void* g, const void* gb, int kept, int B, long long nD, long long nL,
                              long long ng, void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(D) | reinterpret_cast<uintptr_t>(L) |
                         reinterpret_cast<uintptr_t>(g) |
                         (kept ? reinterpret_cast<uintptr_t>(Db) | reinterpret_cast<uintptr_t>(Lb) |
                                     reinterpret_cast<uintptr_t>(gb)
                               : 0);
  if (B <= 0 || nD < 0 || nL < 0 || ng < 0 || ((nD | nL | ng) & 3) != 0 || (addr & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const unsigned char* a = static_cast<const unsigned char*>(accept);
  float4* D4 = static_cast<float4*>(D);
  float4* L4 = static_cast<float4*>(L);
  float4* g4 = static_cast<float4*>(g);
  const float4* Db4 = static_cast<const float4*>(Db);
  const float4* Lb4 = static_cast<const float4*>(Lb);
  const float4* gb4 = static_cast<const float4*>(gb);
  long long nD4 = nD / 4, nL4 = nL / 4, ng4 = ng / 4;
  void* args[] = {&a, &D4, &Db4, &L4, &Lb4, &g4, &gb4, &nD4, &nL4, &ng4, &kept};
  cudaError_t err = cudaLaunchKernel(lm_restore_kernel, dim3((unsigned)B), dim3(kThreads), args, 0,
                                     static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
