// Batched SPD block-tridiagonal solve H x = b by block Thomas, for Hopper.
//
// Replaces the Pallas TPU kernel `_btd_kernel` in qtos_tpu/ops/pallas/btd.py
// (launched by `_pallas_btd_lanes_transposed`).  Plain PyTorch version:
// `block_tridiag_solve` in qtos_torch/ops/tridiag.py; wrapper:
// `btd_solve` in qtos_torch/ops/btd.py.
//
// H = blocktridiag(diag = D_k, lower = L_k at (k+1, k), upper = L_k^T).
// Shapes (float32, contiguous, batch-major): D (B, K, n, n), L (B, K-1, n, n),
// b (B, K, n), x (B, K, n).  C (B, K-1, btd_packed_floats(n)) is scratch:
// the factors C_0 .. C_{K-2}, each lower triangle packed row by row
// (n(n+1)/2 floats, padded to a multiple of 4), for the back pass.
//
// With lm (B,) given (not null), the system solved is the Levenberg-Marquardt
// damped one, D_k + diag(lm[s] diag(D_k) + 1e-8) in place of D_k: each
// diagonal entry d of D_k becomes damped(d, lm[s]) once D_k has landed in
// shared memory, before anything reads it (for k >= 1 by the lane or thread
// that subtracts M M^T there).  D itself is never written.
//
// Recursion (the TPU kernel's, without its transposes):
//   S_0 = D_0, C_0 = chol(S_0), y_0 = b_0
//   k >= 1:  M C_{k-1}^T = L_{k-1}   and   C_{k-1} z = y_{k-1}   (row solves)
//            y_k = b_k - M z          (= b_k - L_{k-1} S_{k-1}^-1 y_{k-1})
//            S_k = D_k - M M^T,  C_k = chol(S_k), pivots clamped at 1e-12
//   x_{K-1} = S_{K-1}^-1 y_{K-1},  x_k = S_k^-1 (y_k - L_k^T x_{k+1})
//
// Mapping: one warp per scenario.  A block holds kWarps warps; each warp
// walks the batch by grid stride and solves whole scenarios alone, with
// __syncwarp and shuffles only: no block-wide barrier.  The grid is at most
// the blocks that fit on the card at once.  Lane l owns rows l and l + 32
// (n <= 64).  Each warp's shared memory holds
//   CS  n x P, P = cs_pitch(n) (36 at n = 36):  C_{k-1}, then D_k -> S_k -> C_k;
//       in the back pass, L_k
//   M   (n+1) x (n+1):  L_{k-1} -> M, and y_{k-1} -> z in its last row;
//       in the back pass, two packed factors (C_k and the next one)
//   v   n:              y_k in the forward pass, x_{k+1} in the back pass
// Step k: the row solves against CS; D_k into CS; y_k = b_k - M z; the lower
// triangle of S_k = D_k - M M^T; Cholesky in place, which also writes C_k
// packed to the scratch from registers.  y_k waits in x's slot k until the
// back pass overwrites it with x_k.
//
// What bounds it on an H100 at B=8192, K=41, n=36: the work's own bytes (D,
// L, b read once, x written once) are 3.54 GB, 1.06 ms at 3.35 TB/s, and its
// ~40 GFLOP take 0.60 ms at 67 TFLOP/s f32.  This design moves D once
// (1.74 GB), L twice (3.40 GB), the packed factors out and back (1.75 GB)
// and b, y, x (0.19 GB): ~7.1 GB, 2.1 ms.  Going below that needs the
// factors kept on chip (~109 KB per scenario).
//
// What sets its time is the dependent chain of each scenario more than any
// one throughput: on an H100 a scenario alone on its SM takes half as long
// as each of 20 sharing one, and device memory carries about a third of
// its peak; issue slots and shared-memory wavefronts are not measured
// (PERF.md).  So the design shortens the chain: every copy from
// device memory is a cp.async issued ahead of its use (L_k during the
// Cholesky of step k, D_k during y_k = b_k - M z and the first tiles of the
// rank update, the back pass's L_k and C_k during the previous step's vector
// solves); the triangular solves multiply by reciprocals computed off the
// chain; the Cholesky and the row solves go four columns at a time, with
// float4 broadcasts of the pivot rows; the rank update runs on 4 x 4
// register tiles; and the occupancy is as high as shared memory allows.
//
// Occupancy at n = 36: (36*36 + 37*37 + 36) * 4 B = 10,816 B per warp,
// 43,264 B per 4-warp block; five blocks with their 1 KB reserve each take
// 221,440 of the SM's 233,472 bytes, so 20 scenarios are in flight per SM.
// __launch_bounds__(128, 5) holds registers to that occupancy (96 used,
// with a 28-byte spill).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kMinBlocks = 5;
constexpr int kMaxN = 64;
constexpr unsigned kFull = 0xffffffffu;

// Pitch of CS: the least multiple of 4 that is >= n and whose quarter is
// odd.  Its rows are then 16-byte aligned for float4 reads and cp.async,
// and the 8 rows that a quarter-warp reads as float4 at one column fall in
// 8 distinct groups of 4 banks.
__host__ __device__ constexpr int cs_pitch(int n) { return 4 * (((n + 3) >> 2) | 1); }

// Floats of one packed factor in the scratch and in shared memory:
// n(n+1)/2 rounded up to a multiple of 4, for 16-byte copies.
__host__ __device__ constexpr int packed_floats(int n) { return (n * (n + 1) / 2 + 3) & ~3; }

// Floats of M: the forward pass's (n+1) x (n+1), or the back pass's two
// packed factors, whichever is larger.
__host__ __device__ constexpr int m_floats(int n) {
  return (n + 1) * (n + 1) > 2 * packed_floats(n) ? (n + 1) * (n + 1) : 2 * packed_floats(n);
}

// Floats of shared memory one warp uses: CS, M and v, rounded up to a
// multiple of 4 so that every warp's CS and M are 16-byte aligned.
__host__ __device__ constexpr int warp_floats(int n) {
  return (n * cs_pitch(n) + m_floats(n) + n + 3) & ~3;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// A diagonal entry d of D_k damped by l: d + (l d + 1e-8), each operation
// rounded on its own (no contraction into an FMA), as the two elementwise
// PyTorch kernels and the add of `D + diag_embed(lm * diagonal(D) + 1e-8)`
// round them.
__device__ __forceinline__ float damped(float d, float l) {
  return __fadd_rn(d, __fadd_rn(__fmul_rn(l, d), 1e-8f));
}

// Damps the diagonal of the n x n block S (pitch ld) by l, entry i on
// thread i mod nthreads (tid the thread's number among them).
__device__ __forceinline__ void damp_diagonal(float* S, int n, int ld, float l, int tid, int nthreads) {
  for (int i = tid; i < n; i += nthreads) S[i * ld + i] = damped(S[i * ld + i], l);
}

// Starts the copy dst[i * ld + j] = src[i * n + j] of an n x n block from
// device memory (cp.async; complete after cp_wait).  16-byte copies when
// `vec4` (src 16-byte aligned) and n and ld are multiples of 4, else 4-byte
// ones.  Each lane tracks the row of its elements incrementally.
__device__ __forceinline__ void copy_block(float* dst, const float* __restrict__ src, int n,
                                           int ld, bool vec4, int lane) {
  const int nn = n * n, pad = ld - n;
  if (vec4 && (n & 3) == 0 && (ld & 3) == 0) {
    int off = 0, j = 4 * lane;
    while (j >= n) { j -= n; off += pad; }
    for (int e = 4 * lane; e < nn; e += 128) {
      __pipeline_memcpy_async(dst + e + off, src + e, 16);
      j += 128;
      while (j >= n) { j -= n; off += pad; }
    }
  } else {
    int off = 0, j = lane;
    while (j >= n) { j -= n; off += pad; }
    for (int e = lane; e < nn; e += 32) {
      __pipeline_memcpy_async(dst + e + off, src + e, 4);
      j += 32;
      while (j >= n) { j -= n; off += pad; }
    }
  }
  __pipeline_commit();
}

// Starts the copy of `count` floats (a multiple of 4, both ends 16-byte
// aligned) from device memory.
__device__ __forceinline__ void copy_flat(float* dst, const float* __restrict__ src, int count,
                                          int lane) {
  for (int e = 4 * lane; e < count; e += 128) __pipeline_memcpy_async(dst + e, src + e, 16);
  __pipeline_commit();
}

// Waits for the lane's copies; the __syncwarp that follows makes every
// lane's copies visible to the warp.
__device__ __forceinline__ void cp_wait() {
  __pipeline_wait_prior(0);
  __syncwarp();
}

// The lower triangle of S (pitch ld) to dst packed row by row:
// dst[i (i + 1) / 2 + j] = S[i][j], j <= i.
__device__ __forceinline__ void pack_lower(float* __restrict__ dst, const float* S, int n, int ld,
                                           int lane) {
  const int np = n * (n + 1) / 2;
  int i = 0, j = lane;
  while (j > i) { j -= i + 1; ++i; }
  for (int p = lane; p < np; p += 32) {
    dst[p] = S[i * ld + j];
    j += 32;
    while (j > i) { j -= i + 1; ++i; }
  }
}

// s[b] = Si[j0 + b] - sum_{c<j0} Si[c] R[b][c] for b < 4, subtracting in
// the order c = 0, 1, ...: row Si and the rows R[b] read as float4 (all
// 16-byte aligned, j0 a multiple of 4).
__device__ __forceinline__ void row_block4(const float* Si, const float* const R[4], int j0,
                                           float s[4]) {
  const float4 h = ld4(Si + j0);
  s[0] = h.x; s[1] = h.y; s[2] = h.z; s[3] = h.w;
  for (int c = 0; c < j0; c += 4) {
    const float4 a = ld4(Si + c);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float4 q = ld4(R[b] + c);
      s[b] -= a.x * q.x;
      s[b] -= a.y * q.y;
      s[b] -= a.z * q.z;
      s[b] -= a.w * q.w;
    }
  }
}

// In place: the lower triangle of S (pitch ld = cs_pitch(n)) becomes its
// Cholesky factor C; when `spill` is not null, C is also written there,
// packed row by row (row i at i (i + 1) / 2), straight from registers.
// Left-looking in blocks of four columns j0..j0+3: for rows i >= j0,
// subtract the finished columns c < j0 (row_block4, the four pivot rows as
// float4 broadcasts); then every lane gathers the block's 4 x 4 diagonal
// part by shuffle, factors it itself, and finishes its own rows:
//   C[i][j] = (S[i][j] - sum_{c<j} C[i][c] C[j][c]) * rsqrt(max(pivot, 1e-12)).
// The subtractions run in the order c = 0, 1, ..., the order in which the
// plain version's right-looking updates reach S[i][j].  Block j0 gives row
// i to lane (i - j0) mod 32, so while n - j0 <= 32 every lane has at most
// one row.  Entries above the diagonal in the block's rows of S are
// overwritten with values nobody reads.  after_block(j0) runs on every lane
// once block j0 is in S (the small kernel hands the columns on with it).
struct NoHook {
  __device__ void operator()(int) const {}
};
template <class AfterBlock = NoHook>
__device__ void chol_inplace(float* S, float* __restrict__ spill, int n, int ld, int lane,
                             AfterBlock after_block = {}) {
  for (int j0 = 0; j0 < n; j0 += 4) {
    const int nb = min(4, n - j0);
    const float* R[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) R[b] = S + min(j0 + b, n - 1) * ld;
    const int i0 = j0 + ((lane - j0) & 31);
    const int i1 = i0 + 32;
    float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
    if (i0 < n) row_block4(S + i0 * ld, R, j0, s0);
    if (i1 < n) row_block4(S + i1 * ld, R, j0, s1);
    // a[r][c] (c <= r): the diagonal block, from lane (j0 + r) mod 32, which owns row j0 + r.
    float a[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c <= r; ++c) a[r][c] = __shfl_sync(kFull, s0[c], (j0 + r) & 31);
    }
    float d[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      d[b] = rsqrtf(fmaxf(a[b][b], 1e-12f));
#pragma unroll
      for (int r = b + 1; r < 4; ++r) {
        a[r][b] *= d[b];
#pragma unroll
        for (int c = b + 1; c <= r; ++c) a[r][c] -= a[r][b] * a[c][b];
      }
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      s0[b] *= d[b];
      s1[b] *= d[b];
#pragma unroll
      for (int r = b + 1; r < 4; ++r) {
        s0[r] -= s0[b] * a[r][b];
        s1[r] -= s1[b] * a[r][b];
      }
    }
    if (i0 < n) {
      *reinterpret_cast<float4*>(S + i0 * ld + j0) = make_float4(s0[0], s0[1], s0[2], s0[3]);
      if (spill) {
        float* row = spill + i0 * (i0 + 1) / 2 + j0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (b < nb && j0 + b <= i0) row[b] = s0[b];
      }
    }
    if (i1 < n) {
      *reinterpret_cast<float4*>(S + i1 * ld + j0) = make_float4(s1[0], s1[1], s1[2], s1[3]);
      if (spill) {
        float* row = spill + i1 * (i1 + 1) / 2 + j0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (b < nb) row[b] = s1[b];
      }
    }
    __syncwarp();
    after_block(j0);
  }
}

// Forward substitution against the lower factor C (pitch ldc, a multiple of
// 4), row by row: row r of M (pitch ldm) becomes row r * C^-T,
// M[r][j] = (M[r][j] - sum_{c<j} M[r][c] C[j][c]) / C[j][j], in blocks of
// four columns: the columns c < j0 first, with the block's four rows of C
// read as float4 broadcasts, then the block's small triangle; the
// subtractions run in the order c = 0, 1, ..., j-1, and the division is a
// multiplication by 1 / C[j][j], computed before the chain needs it.  Lane
// l owns rows l and l + 32 (and row 64 = l + 64 at n = 64), which share the
// reads of C; a lane without a second row runs the second chain on its
// first row and drops it.
__device__ void forward_rows(float* M, const float* C, int rows, int n, int ldm, int ldc,
                             int lane) {
  for (int base = 0; base + lane < rows; base += 64) {
    float* R0 = M + (base + lane) * ldm;
    const bool two = base + lane + 32 < rows;
    float* R1 = two ? R0 + 32 * ldm : R0;
    for (int j0 = 0; j0 < n; j0 += 4) {
      const int nb = min(4, n - j0);
      const float* Cr[4];
      float s0[4], s1[4], rinv[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        Cr[b] = C + min(j0 + b, n - 1) * ldc;
        rinv[b] = __fdividef(1.0f, Cr[b][min(j0 + b, n - 1)]);
        s0[b] = b < nb ? R0[j0 + b] : 0.f;
        s1[b] = b < nb ? R1[j0 + b] : 0.f;
      }
      for (int c = 0; c < j0; c += 4) {
        const float a0[4] = {R0[c], R0[c + 1], R0[c + 2], R0[c + 3]};
        const float a1[4] = {R1[c], R1[c + 1], R1[c + 2], R1[c + 3]};
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float4 q = ld4(Cr[b] + c);
          s0[b] -= a0[0] * q.x; s1[b] -= a1[0] * q.x;
          s0[b] -= a0[1] * q.y; s1[b] -= a1[1] * q.y;
          s0[b] -= a0[2] * q.z; s1[b] -= a1[2] * q.z;
          s0[b] -= a0[3] * q.w; s1[b] -= a1[3] * q.w;
        }
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (b < nb) {
          s0[b] *= rinv[b];
          s1[b] *= rinv[b];
#pragma unroll
          for (int b2 = b + 1; b2 < 4; ++b2) {
            if (b2 < nb) {
              const float cf = Cr[b2][j0 + b];
              s0[b2] -= s0[b] * cf;
              s1[b2] -= s1[b] * cf;
            }
          }
          R0[j0 + b] = s0[b];
          if (two) R1[j0 + b] = s1[b];
        }
      }
    }
  }
}

// S[i][l] = D[i][l] - sum_c M[i][c] M[l][c] on the lower triangle (l <= i),
// with D in S (pitch lds, a multiple of 4) and M at pitch ldm: the sum is
// taken first and subtracted once, as the plain version's D - M M^T; with
// lm not null, the lane of each diagonal tile damps its diagonal entries by
// lm[s] just before it subtracts (D waited for by then).  The
// triangle is cut into 4 x 4 tiles (T (T + 1) / 2 of them, T = ceil(n / 4))
// and lane takes every 32nd tile: per column c it reads 4 + 4 values of M
// for 16 FMAs.  D may still be on its way into S: the first tiles' sums
// are taken before waiting for it.  Entries above the diagonal in diagonal
// tiles are overwritten with values nobody reads; rows and columns past n
// read row n - 1 and are dropped.
__device__ void rank_update(float* S, const float* M, int n, int lds, int ldm, int lane,
                            const float* __restrict__ lm, size_t s) {
  const int T = (n + 3) >> 2;
  const int nt = T * (T + 1) / 2;
  int ti = 0, tl = lane;
  while (tl > ti) { tl -= ti + 1; ++ti; }
  for (int t0 = 0; t0 < nt; t0 += 32) {
    const bool active = t0 + lane < nt;
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
    }
    if (active) {
      const float* A[4];
      const float* Bm[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        A[a] = M + min(4 * ti + a, n - 1) * ldm;
        Bm[a] = M + min(4 * tl + a, n - 1) * ldm;
      }
#pragma unroll 2
      for (int c = 0; c < n; ++c) {
        float x[4], y[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) { x[a] = A[a][c]; y[a] = Bm[a][c]; }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] += x[a] * y[b];
        }
      }
    }
    if (t0 == 0) cp_wait();  // D in S
    if (active) {
      const bool diag = lm != nullptr && ti == tl;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (4 * ti + a < n) {
          float* Sa = S + (4 * ti + a) * lds + 4 * tl;
          float4 d = ld4(Sa);
          if (diag) {
            const float l = lm[s];
            if (a == 0) d.x = damped(d.x, l);
            if (a == 1) d.y = damped(d.y, l);
            if (a == 2) d.z = damped(d.z, l);
            if (a == 3) d.w = damped(d.w, l);
          }
          *reinterpret_cast<float4*>(Sa) = make_float4(d.x - acc[a][0], d.y - acc[a][1],
                                                       d.z - acc[a][2], d.w - acc[a][3]);
        }
      }
    }
    tl += 32;
    while (tl > ti) { tl -= ti + 1; ++ti; }
  }
}

// In place (C C^T) u = r for the lane's entries r0 = r[lane] and
// r1 = r[lane + 32], C packed row by row in P (row i at i (i + 1) / 2):
// C w = r, then C^T u = w, each solved entry broadcast from its lane by
// shuffle.  The order of operations is the plain version's (_solve_lower,
// then _solve_upper_t), with the division by C[j][j] a multiplication by
// its reciprocal, computed off the chain.  Packed rows put column j of 32
// rows in 32 distinct banks (triangular numbers are distinct mod 32).
__device__ void chol_solve_vec(const float* P, float& r0, float& r1, int n, int lane) {
  const int e0 = lane, e1 = lane + 32;
  const float* P0 = P + e0 * (e0 + 1) / 2;
  const float* P1 = P + e1 * (e1 + 1) / 2;
  int pj = 0;  // j (j + 1) / 2
  for (int j = 0; j < n; ++j) {
    const float rinv = __fdividef(1.0f, P[pj + j]);
    const float mine = (j & 32) ? r1 : r0;
    const float wj = __shfl_sync(kFull, mine, j & 31) * rinv;
    if (e0 > j && e0 < n) r0 -= P0[j] * wj;
    if (e1 > j && e1 < n) r1 -= P1[j] * wj;
    if (lane == (j & 31)) {
      if (j & 32) r1 = wj; else r0 = wj;
    }
    pj += j + 1;
  }
  for (int j = n - 1; j >= 0; --j) {
    pj -= j + 1;
    const float* Pj = P + pj;
    const float rinv = __fdividef(1.0f, Pj[j]);
    const float mine = (j & 32) ? r1 : r0;
    const float uj = __shfl_sync(kFull, mine, j & 31) * rinv;
    if (e0 < j) r0 -= Pj[e0] * uj;
    if (e1 < j) r1 -= Pj[e1] * uj;
    if (lane == (j & 31)) {
      if (j & 32) r1 = uj; else r0 = uj;
    }
  }
}

// One scenario, s, on one warp.  Db, Lb, bb, xb, Cb point at the
// scenario's slices, lm[s] is its damping (lm null: undamped; the kernel's
// parameter and s, not a pointer kept through the scenario, which would hold
// registers); CS, M, v at the warp's shared memory.
__device__ void solve_scenario(const float* __restrict__ Db, const float* __restrict__ Lb,
                               const float* __restrict__ bb, float* __restrict__ xb,
                               float* __restrict__ Cb, const float* __restrict__ lm, size_t s,
                               float* CS, float* M, float* v, int K, int n, bool vec4, int lane) {
  const int lds = cs_pitch(n), ldm = n + 1, npk = packed_floats(n);
  const size_t nn = (size_t)n * n;
  const bool has0 = lane < n, has1 = lane + 32 < n;
  float* z = M + n * ldm;

  // ---- forward elimination ---------------------------------------------
  copy_block(CS, Db, n, lds, vec4, lane);
  if (K > 1) copy_block(M, Lb, n, ldm, vec4, lane);
  for (int i = lane; i < n; i += 32) {
    const float y = bb[i];
    v[i] = y;
    xb[i] = y;
  }
  cp_wait();
  if (lm) { damp_diagonal(CS, n, lds, lm[s], lane, 32); __syncwarp(); }  // D_0
  chol_inplace(CS, K > 1 ? Cb : nullptr, n, lds, lane);

  for (int k = 1; k < K; ++k) {
    // L_{k-1} is in M (copied during the last Cholesky); C_{k-1} in CS.
    const float* bk = bb + (size_t)k * n;
    const float b0 = has0 ? bk[lane] : 0.f, b1 = has1 ? bk[lane + 32] : 0.f;
    for (int i = lane; i < n; i += 32) z[i] = v[i];
    cp_wait();
    forward_rows(M, CS, n + 1, n, ldm, lds, lane);  // M C^T = L_{k-1}; C z = y_{k-1}
    __syncwarp();

    copy_block(CS, Db + k * nn, n, lds, vec4, lane);  // waited for in rank_update
    // y_k = b_k - M z: lanes own rows; a lane without a second row runs
    // the second chain on its first row and drops it.
    float* yk = xb + (size_t)k * n;
    if (has0) {
      const float* M0 = M + lane * ldm;
      const float* M1 = has1 ? M0 + 32 * ldm : M0;
      float s0 = b0, s1 = b1;
#pragma unroll 4
      for (int c = 0; c < n; ++c) {
        const float zc = z[c];
        s0 -= M0[c] * zc;
        s1 -= M1[c] * zc;
      }
      v[lane] = s0;
      yk[lane] = s0;
      if (has1) {
        v[lane + 32] = s1;
        yk[lane + 32] = s1;
      }
    }
    rank_update(CS, M, n, lds, ldm, lane, lm, s);  // S_k = D_k - M M^T
    __syncwarp();
    if (k + 1 < K) copy_block(M, Lb + k * nn, n, ldm, vec4, lane);
    chol_inplace(CS, k + 1 < K ? Cb + (size_t)k * npk : nullptr, n, lds, lane);
  }

  // ---- back substitution -------------------------------------------------
  // CS holds C_{K-1}; v holds y_{K-1}.  The factors come back packed into
  // the two halves of M, L_k into CS, each copy started a step ahead.  Each
  // lane reads and writes only its own entries of v until the __syncwarp
  // that ends a step.
  float* const P1 = M + npk;  // C_{K-1}, C_{K-3}, ...; M holds C_{K-2}, C_{K-4}, ...
  pack_lower(P1, CS, n, lds, lane);
  float* xk = xb + (size_t)(K - 1) * n;
  const float* ynext = xb + (size_t)(K > 1 ? K - 2 : 0) * n;
  float y0 = has0 ? ynext[lane] : 0.f, y1 = has1 ? ynext[lane + 32] : 0.f;
  float r0 = has0 ? v[lane] : 0.f;
  float r1 = has1 ? v[lane + 32] : 0.f;
  __syncwarp();
  if (K > 1) {
    copy_flat(M, Cb + (size_t)(K - 2) * npk, npk, lane);
    copy_block(CS, Lb + (size_t)(K - 2) * nn, n, lds, vec4, lane);
  }
  chol_solve_vec(P1, r0, r1, n, lane);
  if (has0) { xk[lane] = r0; v[lane] = r0; }
  if (has1) { xk[lane + 32] = r1; v[lane + 32] = r1; }
  __syncwarp();

  for (int k = K - 2; k >= 0; --k) {
    const int odd = (K - 2 - k) & 1;
    cp_wait();  // L_k in CS, C_k in M (odd = 0) or P1 (odd = 1)
    // rhs = y_k - L_k^T x_{k+1}: lanes own columns.
    r0 = y0;
    r1 = y1;
    if (k > 0) {
      ynext = xb + (size_t)(k - 1) * n;
      y0 = has0 ? ynext[lane] : 0.f;
      y1 = has1 ? ynext[lane + 32] : 0.f;
    }
    if (has1) {
#pragma unroll 4
      for (int r = 0; r < n; ++r) {
        const float vr = v[r];
        r0 -= CS[r * lds + lane] * vr;
        r1 -= CS[r * lds + lane + 32] * vr;
      }
    } else if (has0) {
#pragma unroll 4
      for (int r = 0; r < n; ++r) r0 -= CS[r * lds + lane] * v[r];
    }
    __syncwarp();
    if (k > 0) {
      copy_block(CS, Lb + (size_t)(k - 1) * nn, n, lds, vec4, lane);
      copy_flat(odd ? M : P1, Cb + (size_t)(k - 1) * npk, npk, lane);
    }
    chol_solve_vec(odd ? P1 : M, r0, r1, n, lane);
    xk = xb + (size_t)k * n;
    if (has0) { xk[lane] = r0; v[lane] = r0; }
    if (has1) { xk[lane + 32] = r1; v[lane + 32] = r1; }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
btd_kernel(const float* __restrict__ D, const float* __restrict__ L,
           const float* __restrict__ b, float* __restrict__ x,
           float* __restrict__ Cp, const float* __restrict__ lm, int B, int K, int n, int vec4) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* CS = smem + warp * warp_floats(n);
  float* M = CS + n * cs_pitch(n);
  float* v = M + m_floats(n);
  const size_t nn = (size_t)n * n, npk = packed_floats(n);
  for (size_t s = (size_t)blockIdx.x * kWarps + warp; s < (size_t)B;
       s += (size_t)gridDim.x * kWarps) {
    solve_scenario(D + s * K * nn, L + s * (K - 1) * nn, b + s * K * n, x + s * K * n,
                   Cp + s * (K - 1) * npk, lm, s, CS, M, v, K, n, vec4 != 0, lane);
    __syncwarp();
  }
}

// Sets the kernel's shared-memory attributes for width n and returns how
// many of its blocks fit on one SM (0 on error, with *err set).
int blocks_per_sm(size_t smem, cudaError_t* err) {
  *err = cudaFuncSetAttribute(btd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (*err != cudaSuccess) return 0;
  *err = cudaFuncSetAttribute(btd_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
  if (*err != cudaSuccess) return 0;
  int blocks = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, btd_kernel, kWarps * 32, smem);
  if (*err == cudaSuccess && blocks < 1) *err = cudaErrorInvalidConfiguration;
  return *err == cudaSuccess ? blocks : 0;
}

// ---- the small-batch kernel ------------------------------------------------
//
// One scenario on one block of kSmallThreads threads, for batches too small
// to fill the card with btd_kernel's warps (btd_pick_small says when): there
// each scenario's dependent chain sets the time, about 1 ms at K = 41, n = 36
// for 1 or 132 scenarios alike.  Same recursion and, entry by entry, the
// same expressions in the same order as btd_kernel, so x equals
// btd_kernel's bit for bit; only who computes an entry, and when, differs:
//   - b for every knot comes in by cp.async at the start, D_k and L_k a knot
//     ahead, each copy spread over all threads;
//   - the Cholesky of S_k runs on warp 0 (chol_inplace), writing C_k packed
//     into shared memory, where all K factors stay for the back pass;
//   - beside it, the row solves of the next knot, M C_k^T = L_k and
//     C_k z = y_k, run one row per thread on warps 1.. (forward_row_block),
//     each column block as soon as the Cholesky has finished it: warp 0
//     arrives at a named barrier per block (or group of blocks), the row
//     warps, whole, wait there;
//   - then the rank update S_{k+1} = D_{k+1} - M M^T runs on 2 x 2 tiles over
//     warps 0-5 (rank_tiles), y_{k+1} = b_{k+1} - M z on warps 6-7 beside it;
//   - the back pass runs on warp 0, lane t owning rows 4t..4t+3: L_k^T x_{k+1}
//     four rows a lane, and the vector solves a 4 x 4 diagonal block at a
//     time (chol_solve_rows), so a shuffle is on the chain once per four
//     entries, not once per entry.
// A knot's two stages (Cholesky and row solves; rank update) end at
// __syncthreads.  Shared memory (floats; P = cs_pitch(n), every part a
// multiple of 4):
//   CS0, CS1  n x P each: D_k -> S_k -> C_k in CS(k & 1); in the back pass
//             the L_k, alternately
//   Ls0, Ls1  n x n each: L_k as copied, in Ls(k & 1)
//   M         (n+1) x (n+1): M, and z in its last row
//   Y         K x n: b_k -> y_k
//   F         K x packed_floats(n): C_0 .. C_{K-1}, packed
//   v         n: x_{k+1} in the back pass
// At n = 36, K = 41: 141,824 B (F is 109,552 of them), one block per SM.
//
// What bounds it: one scenario's dependent chain, as for btd_kernel alone
// on an SM; its bytes (0.43 MB a scenario at K = 41, n = 36) take 0.13 us.
// The chain's floor at the card's latencies, counted in
// qtos_torch/tools/btd_floor.py, is 0.113 ms at K = 41, n = 36, most of it
// the Cholesky's 4 x 4 diagonal factors (four reciprocal square roots each)
// and the vector solves' shuffles; the design takes the rest of the work
// off that chain (PERF.md has its times).

constexpr int kSmallThreads = 256;
constexpr int kTileThreads = 192;  // warps 0-5: the rank update; warps 6-7: y_k (n <= 64)
constexpr int kNamedBarriers = 15;  // named barriers 1..15 (0 is __syncthreads')
// The crossover, measured on an H100 at K = 41, n = 36 (PERF.md): two rounds
// of one block per SM (B = 264, 0.92 ms) still beat btd_kernel (0.99 ms),
// three do not.  The small kernel up to this many scenarios per SM,
// btd_kernel above.
constexpr int kSmallPerSm = 2;

__host__ __device__ constexpr int round4(int f) { return (f + 3) & ~3; }

__host__ __device__ constexpr size_t small_floats(int n, int K) {
  return (size_t)2 * n * cs_pitch(n) + 2 * round4(n * n) + round4((n + 1) * (n + 1)) + round4(K * n) +
         (size_t)K * packed_floats(n) + round4(n);
}

#ifndef QTOS_EMU_NAMED_BARRIERS
// Named barrier `id` (1..15) of `count` threads, whole warps that reach it
// together (bar.sync and bar.arrive are .aligned): bar_sync waits for the
// others, bar_arrive counts the warp and goes on; both order the
// shared-memory accesses before them for the barrier's threads.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}
#endif

// Starts the copy of `count` floats from device memory, spread over the
// `nthreads` threads numbered from 0 (tid): 16-byte copies when both ends
// are 16-byte aligned and count is a multiple of 4, else 4-byte ones.
__device__ __forceinline__ void copy_span(float* dst, const float* __restrict__ src, int count,
                                          int tid, int nthreads) {
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0 &&
      (count & 3) == 0) {
    for (int e = 4 * tid; e < count; e += 4 * nthreads) __pipeline_memcpy_async(dst + e, src + e, 16);
  } else {
    for (int e = tid; e < count; e += nthreads) __pipeline_memcpy_async(dst + e, src + e, 4);
  }
  __pipeline_commit();
}

// Starts the copy dst[i * ld + j] = src[i * n + j] of an n x n block (dst
// 16-byte aligned, ld a multiple of 4), spread as copy_span's.
__device__ __forceinline__ void copy_rows(float* dst, int ld, const float* __restrict__ src, int n,
                                          int tid, int nthreads) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (n & 3) == 0) {
    const int q = n >> 2;
    for (int e = tid; e < n * q; e += nthreads) {
      const int i = e / q, j = 4 * (e - i * q);
      __pipeline_memcpy_async(dst + i * ld + j, src + i * n + j, 16);
    }
  } else {
    for (int e = tid; e < n * n; e += nthreads) {
      const int i = e / n;
      __pipeline_memcpy_async(dst + i * ld + (e - i * n), src + e, 4);
    }
  }
  __pipeline_commit();
}

// Column block j0 of forward_rows for one row, read from `in` and written
// to `out` (its columns < j0 done): out[j] = (in[j] - sum_{c<j} out[c]
// C[j][c]) / C[j][j] for j in j0..j0+3, with forward_rows' expressions in
// its order.
__device__ __forceinline__ void forward_row_block(float* out, const float* in, const float* C, int n,
                                                  int ldc, int j0) {
  const int nb = min(4, n - j0);
  const float* Cr[4];
  float s[4], rinv[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    Cr[b] = C + min(j0 + b, n - 1) * ldc;
    rinv[b] = __fdividef(1.0f, Cr[b][min(j0 + b, n - 1)]);
    s[b] = b < nb ? in[j0 + b] : 0.f;
  }
  for (int c = 0; c < j0; c += 4) {
    const float a[4] = {out[c], out[c + 1], out[c + 2], out[c + 3]};
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float4 q = ld4(Cr[b] + c);
      s[b] -= a[0] * q.x;
      s[b] -= a[1] * q.y;
      s[b] -= a[2] * q.z;
      s[b] -= a[3] * q.w;
    }
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (b < nb) {
      s[b] *= rinv[b];
#pragma unroll
      for (int b2 = b + 1; b2 < 4; ++b2)
        if (b2 < nb) s[b2] -= s[b] * Cr[b2][j0 + b];
      out[j0 + b] = s[b];
    }
  }
}

// rank_update's lower triangle of S = D - M M^T on 2 x 2 tiles, tile t0,
// t0 + stride, ...: each sum taken over c = 0, 1, ... and subtracted once,
// the diagonal entries damped by lm[s] first where lm is not null (the
// kernel's parameter and its scenario s, as in btd_kernel).
__device__ void rank_tiles(float* S, const float* M, int n, int lds, int ldm, int t0, int stride,
                           const float* __restrict__ lm, int s) {
  const int T = (n + 1) >> 1;
  const int nt = T * (T + 1) / 2;
  for (int t = t0; t < nt; t += stride) {
    int ti = 0, tl = t;
    while (tl > ti) { tl -= ti + 1; ++ti; }
    const int i = 2 * ti, l = 2 * tl;
    const float* A0 = M + i * ldm;
    const float* A1 = M + min(i + 1, n - 1) * ldm;
    const float* B0 = M + l * ldm;
    const float* B1 = M + min(l + 1, n - 1) * ldm;
    float acc00 = 0.f, acc01 = 0.f, acc10 = 0.f, acc11 = 0.f;
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const float x0 = A0[c], x1 = A1[c], y0 = B0[c], y1 = B1[c];
      acc00 += x0 * y0;
      acc01 += x0 * y1;
      acc10 += x1 * y0;
      acc11 += x1 * y1;
    }
    const bool diag = lm != nullptr && i == l;
    const float lv = diag ? lm[s] : 0.f;
    const float d00 = S[i * lds + l];
    S[i * lds + l] = (diag ? damped(d00, lv) : d00) - acc00;
    if (l + 1 <= i) S[i * lds + l + 1] -= acc01;
    if (i + 1 < n) {
      S[(i + 1) * lds + l] -= acc10;
      const float d11 = S[(i + 1) * lds + l + 1];
      S[(i + 1) * lds + l + 1] = (diag ? damped(d11, lv) : d11) - acc11;
    }
  }
}

// One diagonal block jb of the vector solves below, C w = r (kForward) or
// C^T u = w: every lane takes the owner's steps on a copy t of its entries
// and the other lanes' update u, so the warp does not diverge, and keeps
// the results that are its own.  kWhole: the block has all four columns
// (nb = 4), and no step is predicated.
template <bool kForward, bool kWhole>
__device__ __forceinline__ void solve_block(float (&r)[4], const float (&q)[4][4], const float (&dg)[4][4],
                                            const float (&rinv)[4], int nb, int jb, int lane) {
  float t[4] = {r[0], r[1], r[2], r[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = kForward ? i : 3 - i;
    if (kWhole || a < nb) {
      t[a] *= rinv[a];
#pragma unroll
      for (int a2 = 0; a2 < 4; ++a2) {
        if (kForward ? (a2 > a && (kWhole || a2 < nb)) : a2 < a) t[a2] -= (kForward ? dg[a2][a] : dg[a][a2]) * t[a];
      }
    }
  }
  float w[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) w[b] = __shfl_sync(kFull, t[b], jb);
  const bool owner = lane == jb, other = kForward ? lane > jb : lane < jb;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float u = r[a];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = kForward ? i : 3 - i;
      if (kWhole || b < nb) u -= q[a][b] * w[b];
    }
    r[a] = owner ? t[a] : other ? u : r[a];
  }
}

// chol_solve_vec for lane t's rows 4t..4t+3 (r[a] = r[4t + a]; t <
// ceil(n/4)), with its expressions in its order: (C C^T) u = r in place, C
// packed row by row in P.  A 4 x 4 diagonal block at a time (solve_block),
// its owner lane solves the block's entries from registers (its block's
// entries and reciprocals, read once), then four shuffles hand them to the
// lanes of the other blocks, which take them in the order of their
// columns, with the factor's entries read a step ahead.
__device__ __forceinline__ void chol_solve_rows(const float* P, float (&r)[4], int n, int lane) {
  const int T = (n + 3) >> 2, i0 = 4 * lane;
  const float* Pr[4];
  float rinv[4], dg[4][4] = {};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = min(i0 + a, n - 1);
    Pr[a] = P + i * (i + 1) / 2;
    rinv[a] = __fdividef(1.0f, Pr[a][i]);
  }
#pragma unroll
  for (int a = 1; a < 4; ++a) {
#pragma unroll
    for (int a2 = 0; a2 < a; ++a2) dg[a][a2] = Pr[a][min(i0 + a2, n - 1)];
  }
  // C w = r; q holds P[4t + a][j0 + b] for the block column in hand (past
  // the last block, the last block's again: every read stays inside the
  // packed factors and v).
  float q[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) q[a][b] = Pr[a][b];
  }
  for (int jb = 0; jb < T; ++jb) {
    const int j0 = 4 * jb, nb = min(4, n - j0), jn = min(j0 + 4, 4 * (T - 1));
    float qn[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) qn[a][b] = Pr[a][jn + b];
    }
    if (nb == 4)
      solve_block<true, true>(r, q, dg, rinv, nb, jb, lane);
    else
      solve_block<true, false>(r, q, dg, rinv, nb, jb, lane);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) q[a][b] = qn[a][b];
    }
  }
  // C^T u = w; q holds P[j0 + b][4t + a] for the block row in hand.  The
  // lanes past the last block read that block's columns (and drop them),
  // so that every read stays inside the packed factors and v.
  const int c0 = min(i0, 4 * (T - 1));
  const float* Pj[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int j = min(4 * (T - 1) + b, n - 1);
    Pj[b] = P + j * (j + 1) / 2 + c0;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) q[a][b] = Pj[b][a];
  }
  for (int jb = T - 1; jb >= 0; --jb) {
    const int j0 = 4 * jb, nb = min(4, n - j0);
    float qn[4][4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = max(j0 - 4 + b, 0);
      Pj[b] = P + j * (j + 1) / 2 + c0;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) qn[a][b] = Pj[b][a];
    }
    if (nb == 4)
      solve_block<false, true>(r, q, dg, rinv, nb, jb, lane);
    else
      solve_block<false, false>(r, q, dg, rinv, nb, jb, lane);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) q[a][b] = qn[a][b];
    }
  }
}

__global__ void __launch_bounds__(kSmallThreads, 1)
btd_small_kernel(const float* __restrict__ D, const float* __restrict__ L,
                 const float* __restrict__ b, float* __restrict__ x,
                 const float* __restrict__ lm, int K, int n) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lds = cs_pitch(n), ldm = n + 1, npk = packed_floats(n);
  const size_t nn = (size_t)n * n, s = blockIdx.x;
  // CS(i) and Ls(i), i = 0, 1: the two buffers of each kind
  float* const cs0 = reinterpret_cast<float*>(smem4);
  float* const ls0 = cs0 + 2 * n * lds;
  auto CS = [=](int i) { return cs0 + i * n * lds; };
  auto Ls = [=](int i) { return ls0 + i * round4(n * n); };
  float* const M = ls0 + 2 * round4(n * n);
  float* const Y = M + round4((n + 1) * (n + 1));
  float* const F = Y + round4(K * n);
  float* const v = F + (size_t)K * npk;
  const float* const Db = D + s * K * nn;
  const float* const Lb = L + s * (K - 1) * nn;
  float* const xb = x + s * K * n;

  // The row solves' warps 1..row_warps and the named barriers they share
  // with warp 0: column block jb of a Cholesky is handed on at barrier
  // 1 + group(jb), in at most kNamedBarriers groups of blocks.
  const int row_warps = (n + 32) / 32, T = (n + 3) >> 2, G = min(T, kNamedBarriers);
  const int hand_count = 32 * (1 + row_warps);
  auto group = [=](int jb) { return jb * G / T; };
  auto hand_on = [=](int j0) {  // warp 0, after block j0 of the Cholesky
    const int jb = j0 >> 2;
    if (jb == T - 1 || group(jb + 1) != group(jb)) bar_arrive(1 + group(jb), hand_count);
  };
  auto take = [=](int j0) {  // the row warps, before block j0 of the row solves
    const int jb = j0 >> 2;
    if (jb == 0 || group(jb - 1) != group(jb)) bar_sync(1 + group(jb), hand_count);
  };

  copy_span(Y, b + s * K * n, K * n, tid, kSmallThreads);
  copy_rows(CS(0), lds, Db, n, tid, kSmallThreads);
  if (K > 1) {
    copy_span(Ls(0), Lb, n * n, tid, kSmallThreads);
    copy_rows(CS(1), lds, Db + nn, n, tid, kSmallThreads);
  }
  if (K > 2) copy_span(Ls(1), Lb + nn, n * n, tid, kSmallThreads);
  __pipeline_wait_prior(0);
  __syncthreads();
  if (warp == 0 && lm) damp_diagonal(CS(0), n, lds, lm[s], lane, 32);  // D_0, before warp 0's Cholesky

  for (int k = 0; k < K; ++k) {
    float* const S = CS(k & 1);  // D_k -> S_k -> C_k
    if (k > 0) {
      // D_{k+1} and L_{k+1} into the buffers the row solves are done with
      if (k + 1 < K) copy_rows(CS((k + 1) & 1), lds, Db + (k + 1) * nn, n, tid, kSmallThreads);
      if (k + 1 < K - 1) copy_span(Ls((k + 1) & 1), Lb + (k + 1) * nn, n * n, tid, kSmallThreads);
      if (tid < kTileThreads) {
        rank_tiles(S, M, n, lds, ldm, tid, kTileThreads, lm, (int)s);  // S_k = D_k - M M^T
      } else if (tid - kTileThreads < n) {                // y_k = b_k - M z
        const int i = tid - kTileThreads;
        const float* Mi = M + i * ldm;
        const float* z = M + n * ldm;
        float* yk = Y + (size_t)k * n;
        float y = yk[i];
#pragma unroll 4
        for (int c = 0; c < n; ++c) {
          const float zc = z[c];
          y -= Mi[c] * zc;
        }
        yk[i] = y;
      }
      __syncthreads();
    }
    if (warp == 0) {  // C_k
      if (k + 1 < K)
        chol_inplace(S, F + (size_t)k * npk, n, lds, lane, hand_on);
      else
        chol_inplace(S, F + (size_t)k * npk, n, lds, lane);
    } else if (k + 1 < K && warp <= row_warps) {  // M C_k^T = L_k and C_k z = y_k, behind it
      const int r = tid - 32;
      float* const out = M + min(r, n) * ldm;
      const float* const in = r < n ? Ls(k & 1) + r * n : Y + (size_t)k * n;
      for (int j0 = 0; j0 < n; j0 += 4) {
        __syncwarp();  // the whole warp, threads without a row too, at the barrier
        take(j0);
        if (r <= n) forward_row_block(out, in, S, n, lds, j0);
      }
    }
    __pipeline_wait_prior(0);
    __syncthreads();
  }

  // ---- back substitution (warp 0) -----------------------------------------
  // L_k comes into CS(0) or CS(1), alternately, a step ahead.
  if (warp != 0) return;
  const int i0 = 4 * lane;
  float rr[4];
  const float* yk = Y + (size_t)(K - 1) * n;
#pragma unroll
  for (int a = 0; a < 4; ++a) rr[a] = i0 + a < n ? yk[i0 + a] : 0.f;
  if (K > 1) copy_span(CS(0), Lb + (K - 2) * nn, n * n, lane, 32);
  chol_solve_rows(F + (size_t)(K - 1) * npk, rr, n, lane);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if (i0 + a < n) {
      xb[(size_t)(K - 1) * n + i0 + a] = rr[a];
      v[i0 + a] = rr[a];
    }
  }
  for (int k = K - 2; k >= 0; --k) {
    const int odd = (K - 2 - k) & 1;
    const float* const Lc = CS(odd);
    cp_wait();  // L_k in Lc; x_{k+1} in v
    if (k > 0) copy_span(CS(odd ^ 1), Lb + (k - 1) * nn, n * n, lane, 32);
    // rhs = y_k - L_k^T x_{k+1}, in the order of btd_kernel's
    yk = Y + (size_t)k * n;
#pragma unroll
    for (int a = 0; a < 4; ++a) rr[a] = i0 + a < n ? yk[i0 + a] : 0.f;
    if ((n & 3) == 0 && i0 < n) {
#pragma unroll 4
      for (int q = 0; q < n; ++q) {
        const float vq = v[q];
        const float4 l4 = ld4(Lc + q * n + i0);
        rr[0] -= l4.x * vq;
        rr[1] -= l4.y * vq;
        rr[2] -= l4.z * vq;
        rr[3] -= l4.w * vq;
      }
    } else if (i0 < n) {
#pragma unroll 4
      for (int q = 0; q < n; ++q) {
        const float vq = v[q];
        const float* Lq = Lc + q * n + i0;
#pragma unroll
        for (int a = 0; a < 4; ++a)
          if (i0 + a < n) rr[a] -= Lq[a] * vq;
      }
    }
    // Every lane's reads of v feed its shuffles in chol_solve_rows, and the
    // writes of x_k come after the last of them.
    chol_solve_rows(F + (size_t)k * npk, rr, n, lane);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (i0 + a < n) {
        xb[(size_t)k * n + i0 + a] = rr[a];
        v[i0 + a] = rr[a];
      }
    }
  }
}

}  // namespace

// ---- the long-horizon kernel: block cyclic reduction ------------------------
//
// One launch solves a few scenarios whose horizons are too long for the small
// kernel's shared memory (btd_pick_reduce says when), with each scenario's
// knots spread over the whole card: at B = 1, K = 154 a walk of K dependent
// knot steps on one warp (btd_kernel) becomes ceil(log2 K) = 8 levels, each
// of which eliminates half of the knots left, all at once.
//
// The recursion is block Cholesky in odd-even order.  At level l the knots
// left are the multiples of 2^l; those at odd multiples are eliminated.  For
// an eliminated knot i with neighbours a = i - 2^l and c = i + 2^l (c < K) of
// the current, reduced system H' (D'_i its diagonal block, H'[i][a] and
// H'[c][i] its couplings, b'_i its right-hand side):
//   C_i = chol(D'_i), pivots clamped at 1e-12 (chol_inplace)
//   W_i = C_i^-1 H'[i][a],  V_i = C_i^-1 H'[c][i]^T,  y_i = C_i^-1 b'_i
// and the kept neighbours take
//   D'_a -= W_i^T W_i,  D'_c -= V_i^T V_i,  H''[c][a] = -V_i^T W_i,
//   b'_a -= W_i^T y_i,  b'_c -= V_i^T y_i.
// At the last level one knot is left, knot 0: x_0 = C_0^-T y_0.  The back
// pass runs the levels top down: x_i = C_i^-T (y_i - W_i x_a - V_i x_c).
//
// A phase per level, with a grid barrier between two phases.  Phase l has
// one item per knot left at level l (at level 0 only the eliminated ones):
// the block that takes it first applies level l - 1's updates to its own
// knot, from the two eliminated neighbours k +- 2^(l-1), whose W, V and y
// level l - 1 stored (so no two blocks write one block of memory, and the
// updates of one level cost no barrier of their own); a kept knot stores
// D'_k and b'_k, an eliminated one also forms its two couplings of level l
// from those neighbours, H'[k][a] = -V_e^T W_e with e = k - 2^(l-1) and
// H'[c][k] = -V_e'^T W_e' with e' = k + 2^(l-1), and is eliminated:
//   - copies in: D_k (the original, damped as it lands, through level 1;
//     from the scratch after), b_k (from b through level 1; from x's slot
//     after), the neighbours' W^T, V^T and y, or at level 0 the original
//     L_{k-1} (transposed) and L_k;
//   - the products on 4 x 4 register tiles over all threads: the lower
//     triangle of D'_k, the rows H'[k][a]^T and H'[c][k] (W_k^T's and
//     V_k^T's right-hand sides) and b'_k;
//   - the Cholesky on warp 0 (chol_inplace) and, behind it, each column
//     block as the Cholesky hands it on at a named barrier (as in the small
//     kernel), the 2n + 1 row solves W_k^T C_k^T = H'[k][a]^T,
//     V_k^T C_k^T = H'[c][k] and C_k y_k = b'_k, one row per thread of
//     warps 1.. (forward_row_block);
//   - C_k, W_k^T and V_k^T out to the scratch, y_k into x's slot k.
// The back pass gives each eliminated knot of a level to one warp: C_k and
// the two neighbours' x by cp.async, y_k - W_k x_a - V_k x_c with lanes
// owning entries, then C_k^T x_k = r on the warp (back_solve_vec).  Every
// expression is float32, rounded as written (no tensor core, no TF32).
//
// Scratch per scenario (floats; nn = n * n): C_k at k nn, W_k^T at (K + k) nn,
// V_k^T at (2 K + k) nn, and D'_k of the knots kept past level 1 (the
// multiples of 4) at (3 K + k / 4) nn.  x holds b'_k, then y_k, then x_k.
//
// Mapping: a cooperative launch of at most as many blocks as the card holds
// at once, each of kThreads threads, walking the items of a phase (and the
// warps those of a back level) by grid stride; the grid barrier is
// cooperative_groups' grid sync.  Its name, reduce::btd_kernel, keeps the
// word btd_kernel that the profiler's traces of the BTD solve are read by.

#ifndef QTOS_EMU_GRID_SYNC
#include <cooperative_groups.h>
#endif

namespace {
namespace reduce {

constexpr int kThreads = 256;
constexpr int kBackWarps = kThreads / 32;
// The crossover, measured on an H100 at K = 154, n = 36 against btd_kernel
// at B = 1, 2, 4, ..., 64 (PERF.md): this kernel took 0.198 ms at B = 1 and
// 1.54 ms at B = 64, about 0.2 + 0.021 B, btd_kernel 3.82-3.90 ms at all of
// them.  This kernel up to the largest of those batches, btd_kernel above.
constexpr int kMaxBatch = 64;

#ifndef QTOS_EMU_GRID_SYNC
// Every thread of the grid waits here for all the others; the writes to
// global memory before it are seen by every read after it.
__device__ __forceinline__ void grid_sync() { cooperative_groups::this_grid().sync(); }
#endif
#ifndef QTOS_EMU_BLOCK_SMEM
// The block's dynamic shared memory.
__device__ __forceinline__ float* block_smem() {
  extern __shared__ float4 smem4[];
  return reinterpret_cast<float*>(smem4);
}
#endif

// Shared memory of a phase's item (floats): S (n x cs_pitch(n)) for
// D_k -> D'_k -> C_k; R, 2n + 1 rows at pitch n + 1, for the right-hand
// sides of W_k^T, V_k^T and y_k and then those; the four neighbour blocks of
// level l - 1 at pitch n + 1 (odd pitches: one row per thread, or one row of
// a tile per thread, fall in distinct banks); and their two y.
__host__ __device__ constexpr size_t item_floats(int n) {
  return (size_t)n * cs_pitch(n) + round4((2 * n + 1) * (n + 1)) + 4 * (size_t)n * (n + 1) + round4(2 * n);
}
// Shared memory of one warp in the back pass: C_k (n x cs_pitch(n)) and the
// neighbours' x.
__host__ __device__ constexpr size_t back_floats(int n) {
  return (size_t)n * cs_pitch(n) + round4(2 * n);
}
__host__ __device__ constexpr size_t smem_floats(int n) {
  return item_floats(n) > kBackWarps * back_floats(n) ? item_floats(n) : kBackWarps * back_floats(n);
}
// Scratch floats of one scenario.
__host__ __device__ constexpr size_t scenario_floats(int K, int n) {
  return (size_t)(3 * K + (K + 3) / 4) * n * n;
}

// The levels below the last: the least Lv with 2^Lv >= K.
__host__ __device__ inline int levels(int K) {
  int l = 0;
  while ((1 << l) < K) ++l;
  return l;
}
// Items of phase l and the knot of item j: at level 0 the odd knots (the
// even ones have nothing to do yet), after it every knot left.
__device__ __forceinline__ int phase_items(int K, int l, int Lv) {
  return l == 0 && Lv > 0 ? K / 2 : (K + (1 << l) - 1) >> l;
}
__device__ __forceinline__ int phase_knot(int j, int l, int Lv) { return l == 0 && Lv > 0 ? 2 * j + 1 : j << l; }
// Knots eliminated at level l < Lv: the odd multiples of 2^l below K.
__device__ __forceinline__ int back_items(int K, int l) { return (((K - 1) >> l) + 1) >> 1; }

// Starts the 4-byte copies dst[i * ld + j] = src[i * n + j] (transposed:
// dst[j * ld + i]) of an n x n block, spread over nthreads threads.
__device__ __forceinline__ void copy_pitched(float* dst, int ld, const float* src, int n, bool transposed,
                                             int tid, int nthreads) {
  for (int e = tid; e < n * n; e += nthreads) {
    const int i = e / n, j = e - i * n;
    __pipeline_memcpy_async(transposed ? dst + j * ld + i : dst + i * ld + j, src + e, 4);
  }
}

// acc[a][b] += sum_c X[xi + a][c] Y[yi + b][c] over c = 0, 1, ..., n - 1
// (rows at pitch ld; rows past n read row n - 1).
__device__ __forceinline__ void tile_nt(float (&acc)[4][4], const float* X, const float* Y, int ld, int n,
                                        int xi, int yi) {
  const float* A[4];
  const float* Bq[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    A[a] = X + min(xi + a, n - 1) * ld;
    Bq[a] = Y + min(yi + a, n - 1) * ld;
  }
#pragma unroll 2
  for (int c = 0; c < n; ++c) {
    float u[4], w[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) { u[a] = A[a][c]; w[a] = Bq[a][c]; }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] += u[a] * w[b];
    }
  }
}

// The second half of chol_solve_vec: C^T u = r in place for the lane's
// entries r0 = r[lane] and r1 = r[lane + 32], C lower at pitch ld, each
// solved entry broadcast from its lane by shuffle.
__device__ void back_solve_vec(const float* C, int ld, float& r0, float& r1, int n, int lane) {
  for (int j = n - 1; j >= 0; --j) {
    const float* Cj = C + j * ld;
    const float rinv = __fdividef(1.0f, Cj[j]);
    const float mine = (j & 32) ? r1 : r0;
    const float uj = __shfl_sync(kFull, mine, j & 31) * rinv;
    if (lane < j) r0 -= Cj[lane] * uj;
    if (lane + 32 < j) r1 -= Cj[lane + 32] * uj;
    if (lane == (j & 31)) {
      if (j & 32) r1 = uj; else r0 = uj;
    }
  }
}

struct Problem {
  const float* __restrict__ D;
  const float* __restrict__ L;
  const float* __restrict__ b;
  const float* __restrict__ lm;
  float* x;
  float* scratch;
  int K, n, Lv;
};

// Phase l's item (s, k), on the whole block.
__device__ void phase_item(const Problem& p, int s, int k, int l, float* sm, int tid) {
  const int K = p.K, n = p.n, lds = cs_pitch(n), ldr = n + 1, lane = tid & 31;
  const size_t nn = (size_t)n * n;
  float* const S = sm;
  float* const R = S + n * lds;  // rows 0..n-1: W_k^T; n..2n-1: V_k^T; 2n: b'_k -> y_k
  float* const Ar = R + round4((2 * n + 1) * ldr);  // W^T of the right neighbour e' = k + h
  float* const Br = Ar + n * ldr;                   // V^T of e'
  float* const Al = Br + n * ldr;                   // W^T of the left neighbour e = k - h
  float* const Bl = Al + n * ldr;                   // V^T of e
  float* const yr = Bl + n * ldr;
  float* const yl = yr + n;
  float* const yk = R + 2 * n * ldr;
  float* const xs = p.x + (size_t)s * K * n;
  float* const Cs = p.scratch + (size_t)s * scenario_floats(K, n);
  float* const Ws = Cs + K * nn;
  float* const Vs = Ws + K * nn;
  float* const Ds = Vs + K * nn;
  const bool last = l == p.Lv;
  const bool elim = last || ((k >> l) & 1);
  const int step = 1 << l, h = step >> 1;
  const bool left = elim && k > 0, right = elim && k + step < K;  // neighbours a, c at level l
  const bool er = l > 0 && k + h < K, el = l > 0 && k > 0;       // neighbours eliminated at level l - 1

  copy_rows(S, lds, l <= 1 ? p.D + ((size_t)s * K + k) * nn : Ds + (k >> 2) * nn, n, tid, kThreads);
  copy_span(yk, l <= 1 ? p.b + ((size_t)s * K + k) * n : xs + (size_t)k * n, n, tid, kThreads);
  if (l == 0) {
    const float* Lb = p.L + (size_t)s * (K - 1) * nn;
    if (left) copy_pitched(R, ldr, Lb + (k - 1) * nn, n, true, tid, kThreads);      // H[k][k-1]^T = L_{k-1}^T
    if (right) copy_pitched(R + n * ldr, ldr, Lb + k * nn, n, false, tid, kThreads);  // H[k+1][k] = L_k
  } else {
    if (er) {
      copy_pitched(Ar, ldr, Ws + (k + h) * nn, n, false, tid, kThreads);
      copy_span(yr, xs + (size_t)(k + h) * n, n, tid, kThreads);
      if (right) copy_pitched(Br, ldr, Vs + (k + h) * nn, n, false, tid, kThreads);
    }
    if (el) {
      copy_pitched(Bl, ldr, Vs + (k - h) * nn, n, false, tid, kThreads);
      copy_span(yl, xs + (size_t)(k - h) * n, n, tid, kThreads);
      if (left) copy_pitched(Al, ldr, Ws + (k - h) * nn, n, false, tid, kThreads);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  if (l > 0) {
    // Level l - 1's updates, on 4 x 4 tiles: the lower triangle of
    // D'_k = D_k - W_e'^T W_e' - V_e^T V_e (damped first at level 1, where
    // D_k is the original), the rows -W_e^T V_e = H'[k][a]^T and
    // -V_e'^T W_e' = H'[c][k], and b'_k = b_k - W_e'^T y_e' - V_e^T y_e.
    const int T = (n + 3) >> 2, nS = T * (T + 1) / 2, nW = left ? T * T : 0, nV = right ? T * T : 0;
    const bool damp = l == 1 && p.lm != nullptr;
    for (int job = tid; job < nS + nW + nV + n; job += kThreads) {
      if (job < nS + nW + nV) {
        float acc[4][4] = {};
        int ti, tj;
        float* out;
        if (job < nS) {
          ti = 0, tj = job;
          while (tj > ti) { tj -= ti + 1; ++ti; }
          if (er) tile_nt(acc, Ar, Ar, ldr, n, 4 * ti, 4 * tj);
          if (el) tile_nt(acc, Bl, Bl, ldr, n, 4 * ti, 4 * tj);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int i = 4 * ti + a, j = 4 * tj + b;
              if (i < n && j < n) {
                const float d = S[i * lds + j];
                S[i * lds + j] = (damp && i == j ? damped(d, p.lm[s]) : d) - acc[a][b];
              }
            }
          }
          continue;
        }
        if (job < nS + nW) {
          ti = (job - nS) / T, tj = (job - nS) - ti * T;
          tile_nt(acc, Al, Bl, ldr, n, 4 * ti, 4 * tj);
          out = R;
        } else {
          ti = (job - nS - nW) / T, tj = (job - nS - nW) - ti * T;
          tile_nt(acc, Br, Ar, ldr, n, 4 * ti, 4 * tj);
          out = R + n * ldr;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int i = 4 * ti + a, j = 4 * tj + b;
            if (i < n && j < n) out[i * ldr + j] = -acc[a][b];
          }
        }
      } else {
        const int i = job - nS - nW - nV;
        float v = yk[i];
        if (er) {
          float sum = 0.f;
          for (int c = 0; c < n; ++c) sum += Ar[i * ldr + c] * yr[c];
          v -= sum;
        }
        if (el) {
          float sum = 0.f;
          for (int c = 0; c < n; ++c) sum += Bl[i * ldr + c] * yl[c];
          v -= sum;
        }
        yk[i] = v;
      }
    }
    __syncthreads();
  }

  if (!elim) {  // a kept knot: D'_k and b'_k wait for the next level
    float* const Dk = Ds + (k >> 2) * nn;
    for (int e = tid; e < (int)nn; e += kThreads) {
      const int i = e / n;
      Dk[e] = S[i * lds + e - i * n];
    }
    for (int i = tid; i < n; i += kThreads) xs[(size_t)k * n + i] = yk[i];
    return;
  }

  // C_k on warp 0 and, behind it on warps 1..row_warps, the row solves
  // against it, W_k^T, V_k^T and y_k in place, one row a thread: column
  // block jb of the Cholesky is handed on at named barrier 1 + group(jb), in
  // at most kNamedBarriers groups of blocks, as in the small kernel.
  const int row_warps = (2 * n + 32) / 32, T = (n + 3) >> 2, G = min(T, kNamedBarriers);
  const int hand_count = 32 * (1 + row_warps);
  auto group = [=](int jb) { return jb * G / T; };
  if (tid < 32) {
    // No barrier after the damping: lane i damps S[i][i], which the first
    // column block reads on lane i (i < 4), a later one after the __syncwarp
    // that ends the first.
    if (l == 0 && p.lm) damp_diagonal(S, n, lds, p.lm[s], lane, 32);
    chol_inplace(S, nullptr, n, lds, lane, [=](int j0) {
      const int jb = j0 >> 2;
      if (jb == T - 1 || group(jb + 1) != group(jb)) bar_arrive(1 + group(jb), hand_count);
    });
  } else if (tid < hand_count) {
    const int r = tid - 32;
    const bool mine = r <= 2 * n && (r < n ? left : r < 2 * n ? right : true);
    float* const row = R + min(r, 2 * n) * ldr;
    for (int j0 = 0; j0 < n; j0 += 4) {
      const int jb = j0 >> 2;
      // bar.sync is .aligned: the whole warp, threads without a row too,
      // reaches it together (which the CPU stand-in, whose named barriers
      // count threads, cannot show).
      __syncwarp();
      if (jb == 0 || group(jb - 1) != group(jb)) bar_sync(1 + group(jb), hand_count);
      if (mine) forward_row_block(row, row, S, n, lds, j0);
    }
  }
  __syncthreads();
  if (!last) {
    float* const Ck = Cs + k * nn;  // C_k for the back pass
    for (int e = tid; e < (int)nn; e += kThreads) {
      const int i = e / n, j = e - i * n;
      Ck[e] = S[i * lds + j];
      if (left) Ws[k * nn + e] = R[i * ldr + j];
      if (right) Vs[k * nn + e] = R[(n + i) * ldr + j];
    }
    for (int i = tid; i < n; i += kThreads) xs[(size_t)k * n + i] = yk[i];
    return;
  }
  if (tid < 32) {  // the last knot, 0: x_0 = C_0^-T y_0
    float r0 = lane < n ? yk[lane] : 0.f, r1 = lane + 32 < n ? yk[lane + 32] : 0.f;
    back_solve_vec(S, lds, r0, r1, n, lane);
    if (lane < n) xs[lane] = r0;
    if (lane + 32 < n) xs[lane + 32] = r1;
  }
}

// The back pass's item (s, k) at level l, on one warp with its shared
// memory at sm: x_k = C_k^-T (y_k - W_k x_{k-2^l} - V_k x_{k+2^l}).
__device__ void back_item(const Problem& p, int s, int k, int l, float* sm, int lane) {
  const int K = p.K, n = p.n, lds = cs_pitch(n), step = 1 << l;
  const size_t nn = (size_t)n * n;
  float* const Cw = sm;
  float* const xa = Cw + n * lds;
  float* const xc = xa + n;
  float* const xs = p.x + (size_t)s * K * n;
  const float* const Cs = p.scratch + (size_t)s * scenario_floats(K, n);
  const float* const Wk = Cs + (K + k) * nn;
  const float* const Vk = Cs + (2 * K + k) * nn;
  const bool right = k + step < K;
  copy_rows(Cw, lds, Cs + k * nn, n, lane, 32);
  copy_span(xa, xs + (size_t)(k - step) * n, n, lane, 32);
  if (right) copy_span(xc, xs + (size_t)(k + step) * n, n, lane, 32);
  __pipeline_commit();
  const float* const y = xs + (size_t)k * n;
  float r0 = lane < n ? y[lane] : 0.f, r1 = lane + 32 < n ? y[lane + 32] : 0.f;
  cp_wait();
  if (lane < n) {
    const int j1 = lane + 32 < n ? lane + 32 : lane;  // a lane without a second entry runs it on its first
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
    for (int r = 0; r < n; ++r) {
      s0 += Wk[r * n + lane] * xa[r];
      s1 += Wk[r * n + j1] * xa[r];
    }
    r0 -= s0;
    if (lane + 32 < n) r1 -= s1;
    if (right) {
      s0 = s1 = 0.f;
#pragma unroll 4
      for (int r = 0; r < n; ++r) {
        s0 += Vk[r * n + lane] * xc[r];
        s1 += Vk[r * n + j1] * xc[r];
      }
      r0 -= s0;
      if (lane + 32 < n) r1 -= s1;
    }
  }
  back_solve_vec(Cw, lds, r0, r1, n, lane);
  if (lane < n) xs[(size_t)k * n + lane] = r0;
  if (lane + 32 < n) xs[(size_t)k * n + lane + 32] = r1;
  // Every lane's loads of Cw are done before the warp's next copies
  // overwrite it (a write after a read, which the CPU stand-in, completing
  // each load at once, cannot show).
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads, 1)
btd_kernel(const float* __restrict__ D, const float* __restrict__ L, const float* __restrict__ b, float* x,
           float* scratch, const float* __restrict__ lm, int B, int K, int n) {
  float* const sm = block_smem();
  const int tid = threadIdx.x, warp = tid >> 5;
  const Problem p{D, L, b, lm, x, scratch, K, n, levels(K)};
  for (int l = 0; l <= p.Lv; ++l) {
    if (l > 0) grid_sync();
    const int count = phase_items(K, l, p.Lv);
    for (long long item = blockIdx.x; item < (long long)B * count; item += gridDim.x) {
      phase_item(p, (int)(item / count), phase_knot((int)(item % count), l, p.Lv), l, sm, tid);
      __syncthreads();
    }
  }
  // Warp w of block g takes the items w * gridDim.x + g, ...: the first
  // ones each on a block of its own.
  for (int l = p.Lv - 1; l >= 0; --l) {
    grid_sync();
    const int count = back_items(K, l);
    for (long long item = (long long)warp * gridDim.x + blockIdx.x; item < (long long)B * count;
         item += (long long)gridDim.x * kBackWarps) {
      const int j = (int)(item % count);
      back_item(p, (int)(item / count), (2 * j + 1) << l, l, sm + warp * back_floats(n), tid & 31);
    }
  }
}

// Sets the kernel's shared-memory attribute for width n and returns the
// blocks of a launch at (B, K, n): one per item of the busiest phase, at
// most as many as the card holds at once (0 on error, with *err set).
int grid_blocks(int B, int K, int n, cudaError_t* err) {
  const size_t smem = sizeof(float) * smem_floats(n);
  *err = cudaFuncSetAttribute(btd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (*err != cudaSuccess) return 0;
  int per_sm = 0, dev = 0, sms = 0;
  if ((*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, btd_kernel, kThreads, smem)) != cudaSuccess ||
      (*err = cudaGetDevice(&dev)) != cudaSuccess ||
      (*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return 0;
  if (per_sm < 1) {
    *err = cudaErrorInvalidConfiguration;
    return 0;
  }
  const long long want = (long long)B * ((K + 1) / 2), cap = (long long)per_sm * sms;
  return (int)(want < cap ? want : cap);
}

}  // namespace reduce
}  // namespace

extern "C" size_t btd_smem_bytes(int n) {
  return sizeof(float) * (size_t)kWarps * warp_floats(n);
}

// Floats per factor in the scratch C: n(n+1)/2 rounded up to a multiple of 4.
extern "C" int btd_packed_floats(int n) { return packed_floats(n); }

// Warps of btd_kernel resident on one SM at width n (its occupancy), or
// minus a CUDA error code.
extern "C" int btd_resident_warps(int n) {
  if (n <= 0 || n > kMaxN) return -(int)cudaErrorInvalidValue;
  cudaError_t err;
  const int blocks = blocks_per_sm(btd_smem_bytes(n), &err);
  return blocks > 0 ? blocks * kWarps : -(int)err;
}

// Launches one solve on `stream`; returns the launch's CUDA error (0 when
// it was accepted).  C is 16-byte aligned, with room for
// btd_packed_floats(n) floats per factor.  lm: B floats, the damping of each
// scenario's diagonal blocks (see the top of this file), or null.
extern "C" int btd_solve_f32(const void* D, const void* L, const void* b, void* x,
                             void* C, int B, int K, int n, void* stream, const void* lm) {
  if (B <= 0 || K <= 0 || n <= 0 || n > kMaxN || (uintptr_t)C % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = btd_smem_bytes(n);
  cudaError_t err;
  const int per_sm = blocks_per_sm(smem, &err);
  if (per_sm == 0) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const long long want = ((long long)B + kWarps - 1) / kWarps;
  const long long cap = (long long)per_sm * sms;
  const int grid = (int)(want < cap ? want : cap);
  int vec4 = ((uintptr_t)D % 16 == 0) && ((uintptr_t)L % 16 == 0) ? 1 : 0;
  const float* Df = static_cast<const float*>(D);
  const float* Lf = static_cast<const float*>(L);
  const float* bf = static_cast<const float*>(b);
  float* xf = static_cast<float*>(x);
  float* Cf = static_cast<float*>(C);
  const float* lmf = static_cast<const float*>(lm);
  void* args[] = {&Df, &Lf, &bf, &xf, &Cf, &lmf, &B, &K, &n, &vec4};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(&btd_kernel), dim3(grid), dim3(kWarps * 32),
                         args, smem, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// Shared memory of the small kernel at width n and K knots, in bytes.
extern "C" size_t btd_small_smem_bytes(int n, int K) {
  return sizeof(float) * small_floats(n, K);
}

// Which kernel a solve at (B, K, n) takes: 1 the small kernel
// (btd_small_solve_f32), while B is at most kSmallPerSm scenarios per SM of
// the current device and its factors fit in a block's shared memory; 0
// btd_kernel (btd_solve_f32); minus a CUDA error code on error.
extern "C" int btd_pick_small(int B, int K, int n) {
  if (B <= 0 || K <= 0 || n <= 0 || n > kMaxN) return -(int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != cudaSuccess)
    return -(int)err;
  return (long long)B <= (long long)kSmallPerSm * sms && btd_small_smem_bytes(n, K) <= (size_t)optin;
}

// Launches one solve by the small kernel, one block per scenario, on
// `stream`; returns the launch's CUDA error (0 when it was accepted).  Its
// arguments are btd_solve_f32's; it takes no scratch (C is not read).
extern "C" int btd_small_solve_f32(const void* D, const void* L, const void* b, void* x, void* C,
                                   int B, int K, int n, void* stream, const void* lm) {
  (void)C;
  if (B <= 0 || K <= 0 || n <= 0 || n > kMaxN) return (int)cudaErrorInvalidValue;
  const size_t smem = btd_small_smem_bytes(n, K);
  cudaError_t err = cudaFuncSetAttribute(btd_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float* Df = static_cast<const float*>(D);
  const float* Lf = static_cast<const float*>(L);
  const float* bf = static_cast<const float*>(b);
  float* xf = static_cast<float*>(x);
  const float* lmf = static_cast<const float*>(lm);
  void* args[] = {&Df, &Lf, &bf, &xf, &lmf, &K, &n};
  err = cudaLaunchKernel(btd_small_kernel, dim3(B), dim3(kSmallThreads), args, smem,
                         static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// Scratch floats of one launch of the long-horizon kernel at (B, K, n):
// C_k, W_k^T, V_k^T and the kept D'_k of every scenario.
extern "C" size_t btd_reduce_scratch_floats(int B, int K, int n) {
  return B > 0 && K > 0 && n > 0 ? (size_t)B * reduce::scenario_floats(K, n) : 0;
}

// Blocks of the long-horizon kernel's cooperative launch at (B, K, n) on the
// current device, or minus a CUDA error code.
extern "C" int btd_reduce_grid(int B, int K, int n) {
  if (B <= 0 || K <= 0 || n <= 0 || n > kMaxN) return -(int)cudaErrorInvalidValue;
  cudaError_t err;
  const int grid = reduce::grid_blocks(B, K, n, &err);
  return grid > 0 ? grid : -(int)err;
}

// Which kernel a solve at (B, K, n) takes when the small kernel's shared
// memory cannot hold K's factors: 1 the long-horizon kernel
// (btd_reduce_solve_f32), while B is at most reduce::kMaxBatch; 0
// btd_kernel; 0 too where the small kernel's shared memory holds them;
// minus a CUDA error code on error.
extern "C" int btd_pick_reduce(int B, int K, int n) {
  if (B <= 0 || K <= 0 || n <= 0 || n > kMaxN) return -(int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != cudaSuccess)
    return -(int)err;
  return B <= reduce::kMaxBatch && btd_small_smem_bytes(n, K) > (size_t)optin;
}

// Launches one solve by the long-horizon kernel, a cooperative launch on
// `stream`; returns the launch's CUDA error (0 when it was accepted).  Its
// arguments are btd_solve_f32's, but C is its scratch: 16-byte aligned,
// btd_reduce_scratch_floats(B, K, n) floats.
extern "C" int btd_reduce_solve_f32(const void* D, const void* L, const void* b, void* x, void* C, int B,
                                    int K, int n, void* stream, const void* lm) {
  if (B <= 0 || K <= 0 || n <= 0 || n > kMaxN || (uintptr_t)C % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const int grid = reduce::grid_blocks(B, K, n, &err);
  if (grid == 0) return (int)err;
  const float* Df = static_cast<const float*>(D);
  const float* Lf = static_cast<const float*>(L);
  const float* bf = static_cast<const float*>(b);
  float* xf = static_cast<float*>(x);
  float* Cf = static_cast<float*>(C);
  const float* lmf = static_cast<const float*>(lm);
  void* args[] = {&Df, &Lf, &bf, &xf, &Cf, &lmf, &B, &K, &n};
  err = cudaLaunchCooperativeKernel(reduce::btd_kernel, dim3(grid), dim3(reduce::kThreads), args,
                                    sizeof(float) * reduce::smem_floats(n), static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
