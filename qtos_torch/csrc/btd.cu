// Batched SPD block-tridiagonal solve H x = b by block Thomas, for Hopper.
//
// Replaces the Pallas TPU kernel `_btd_kernel` in qtos_tpu/ops/pallas/btd.py
// (launched by `_pallas_btd_lanes_transposed`).  Plain PyTorch version:
// `block_tridiag_solve` in qtos_torch/ops/tridiag.py; wrapper:
// `btd_solve` in qtos_torch/ops/btd.py.
//
// H = blocktridiag(diag = D_k, lower = L_k at (k+1, k), upper = L_k^T).
// Shapes (float32, contiguous, batch-major): D (B, K, n, n), L (B, K-1, n, n),
// b (B, K, n), x (B, K, n); C (B, K, n, n) is scratch for the factors.
//
// Recursion (the TPU kernel's, without its transposes):
//   S_0 = D_0, C_0 = chol(S_0), y_0 = b_0
//   k >= 1:  M C_{k-1}^T = L_{k-1}   and   C_{k-1} z = y_{k-1}   (row solves)
//            y_k = b_k - M z          (= b_k - L_{k-1} S_{k-1}^-1 y_{k-1})
//            S_k = D_k - M M^T,  C_k = chol(S_k), pivots clamped at 1e-12
//   x_{K-1} = S_{K-1}^-1 y_{K-1},  x_k = S_k^-1 (y_k - L_k^T x_{k+1})
//
// Design: one thread block per scenario; the whole K-step forward recursion
// and the back substitution run inside one launch.  C_{k-1}, S_k and M (with
// z as an extra row) live in shared memory with a padded leading dimension
// n+1, so the per-row forward substitutions read distinct banks.  y_k is kept
// in x's slot k until the back pass overwrites it with x_k, and C_k is
// written to the scratch for the back pass (lower triangle only).  Any
// n <= 64 and any B are accepted; there is no padding of n or B.
//
// What bounds it on an H100: the work is ~(1/3 + 1 + 1) n^3 flops per block
// step (Cholesky, triangular solve with n right-hand sides, symmetric rank-n
// update) and the bytes are D, L and b read once and x written once.  At
// B=8192, K=41, n=36 that is ~37 GFLOP (0.55 ms at 67 TFLOP/s f32) against
// 3.5 GB (1.06 ms at 3.35 TB/s): the bytes bound it.  This first version adds
// the C_k spill and re-reads of C and L in the back pass (~8.7 GB) and runs
// the Cholesky column by column with two barriers per column, so it is
// latency-bound well above that bound; chip_smoke.py measures it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxN = 64;

// In place: the lower triangle of S (n x n, leading dim ld) becomes its
// Cholesky factor.  Right-looking, one column per step.
__device__ void chol_inplace(float* S, int n, int ld) {
  for (int j = 0; j < n; ++j) {
    const float d = rsqrtf(fmaxf(S[j * ld + j], 1e-12f));
    for (int i = j + 1 + threadIdx.x; i < n; i += blockDim.x) S[i * ld + j] *= d;
    __syncthreads();
    // Nobody reads S[j][j] in this phase: the trailing update below uses the
    // scaled column under the pivot only.
    if (threadIdx.x == 0) S[j * ld + j] *= d;
    const int m = n - j - 1;
    for (int t = threadIdx.x; t < m * m; t += blockDim.x) {
      const int i = j + 1 + t / m;
      const int l = j + 1 + t % m;
      if (l <= i) S[i * ld + l] -= S[i * ld + j] * S[l * ld + j];
    }
    __syncthreads();
  }
}

// Row-wise forward substitution against the lower factor C: each of the
// `rows` rows of M becomes row * C^-T, one thread per row.
__device__ void forward_rows(float* M, const float* C, int rows, int n, int ld) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float* row = M + r * ld;
    for (int j = 0; j < n; ++j) {
      float s = row[j];
      for (int c = 0; c < j; ++c) s -= row[c] * C[j * ld + c];
      row[j] = s / C[j * ld + j];
    }
  }
}

// In place v <- (C C^T)^-1 v, run by one warp.
__device__ void chol_solve_vec_warp(const float* C, float* v, int n, int ld) {
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < n; ++j) {
    const float vj = v[j] / C[j * ld + j];
    __syncwarp();
    for (int i = j + 1 + lane; i < n; i += 32) v[i] -= C[i * ld + j] * vj;
    if (lane == 0) v[j] = vj;
    __syncwarp();
  }
  for (int j = n - 1; j >= 0; --j) {
    const float xj = v[j] / C[j * ld + j];
    __syncwarp();
    for (int i = lane; i < j; i += 32) v[i] -= C[j * ld + i] * xj;
    if (lane == 0) v[j] = xj;
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
btd_kernel(const float* __restrict__ D, const float* __restrict__ L,
           const float* __restrict__ b, float* __restrict__ x,
           float* __restrict__ Cg, int K, int n) {
  extern __shared__ float smem[];
  const int ld = n + 1;
  float* C = smem;              // n x ld: factor of S_{k-1}
  float* S = C + n * ld;        // n x ld: D_k -> S_k -> chol(S_k)
  float* M = S + n * ld;        // (n+1) x ld: L_{k-1} -> M, y_{k-1} -> z
  float* v = M + (n + 1) * ld;  // n: y_k in the forward pass, x_{k+1} in the back pass

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int nn = n * n;
  const size_t sc = blockIdx.x;
  const float* Db = D + sc * K * nn;
  const float* Lb = L + sc * (K - 1) * nn;
  const float* bb = b + sc * K * n;
  float* xb = x + sc * K * n;
  float* Cb = Cg + sc * K * nn;

  // ---- forward elimination ---------------------------------------------
  for (int t = tid; t < nn; t += nt) S[(t / n) * ld + t % n] = Db[t];
  for (int i = tid; i < n; i += nt) {
    const float y = bb[i];
    xb[i] = y;
    v[i] = y;
  }
  __syncthreads();
  chol_inplace(S, n, ld);
  for (int t = tid; t < nn; t += nt) {
    const int i = t / n, j = t % n;
    if (j <= i) Cb[t] = S[i * ld + j];
  }
  { float* tmp = C; C = S; S = tmp; }
  __syncthreads();

  for (int k = 1; k < K; ++k) {
    const float* Dk = Db + (size_t)k * nn;
    const float* Lk = Lb + (size_t)(k - 1) * nn;
    for (int t = tid; t < nn; t += nt) {
      const int i = t / n, j = t % n;
      S[i * ld + j] = Dk[t];
      M[i * ld + j] = Lk[t];
    }
    for (int i = tid; i < n; i += nt) M[n * ld + i] = v[i];
    __syncthreads();

    forward_rows(M, C, n + 1, n, ld);  // M C^T = L_{k-1}; C z = y_{k-1}
    __syncthreads();

    const float* z = M + n * ld;
    for (int t = tid; t < nn; t += nt) {
      const int i = t / n, l = t % n;
      if (l <= i) {
        float s = S[i * ld + l];
        for (int c = 0; c < n; ++c) s -= M[i * ld + c] * M[l * ld + c];
        S[i * ld + l] = s;
      }
    }
    for (int i = tid; i < n; i += nt) {
      float s = bb[(size_t)k * n + i];
      for (int c = 0; c < n; ++c) s -= M[i * ld + c] * z[c];
      v[i] = s;
      xb[(size_t)k * n + i] = s;
    }
    __syncthreads();

    chol_inplace(S, n, ld);
    float* Ck = Cb + (size_t)k * nn;
    for (int t = tid; t < nn; t += nt) {
      const int i = t / n, j = t % n;
      if (j <= i) Ck[t] = S[i * ld + j];
    }
    { float* tmp = C; C = S; S = tmp; }
    __syncthreads();
  }

  // ---- back substitution -------------------------------------------------
  if (tid < 32) chol_solve_vec_warp(C, v, n, ld);
  __syncthreads();
  for (int i = tid; i < n; i += nt) xb[(size_t)(K - 1) * n + i] = v[i];
  __syncthreads();

  float* w = M;  // rhs scratch
  for (int k = K - 2; k >= 0; --k) {
    const float* Ck = Cb + (size_t)k * nn;
    const float* Lk = Lb + (size_t)k * nn;
    for (int t = tid; t < nn; t += nt) {
      const int i = t / n, j = t % n;
      if (j <= i) C[i * ld + j] = Ck[t];
    }
    for (int c = tid; c < n; c += nt) {
      float s = xb[(size_t)k * n + c];  // y_k
      for (int r = 0; r < n; ++r) s -= Lk[r * n + c] * v[r];
      w[c] = s;
    }
    __syncthreads();
    if (tid < 32) chol_solve_vec_warp(C, w, n, ld);
    __syncthreads();
    for (int i = tid; i < n; i += nt) {
      xb[(size_t)k * n + i] = w[i];
      v[i] = w[i];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" size_t btd_smem_bytes(int n) {
  return sizeof(float) * ((size_t)(3 * n + 1) * (n + 1) + n);
}

// Launches one solve on `stream`; returns cudaGetLastError() after the
// launch (0 when it was accepted).
extern "C" int btd_solve_f32(const void* D, const void* L, const void* b, void* x,
                             void* C, int B, int K, int n, void* stream) {
  if (B <= 0 || K <= 0 || n <= 0 || n > kMaxN) return (int)cudaErrorInvalidValue;
  const size_t smem = btd_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      btd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  btd_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)D, (const float*)L, (const float*)b, (float*)x, (float*)C, K, n);
  return (int)cudaGetLastError();
}
