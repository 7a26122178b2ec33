// The Gauss-Newton assembly of qtos_torch's LM loop as one kernel launch per
// iteration.
//
// Replaces qtos_tpu's lanes-major assembly (qtos_tpu/solver/assemble_lanes.py:610,
// `assemble_lanes`, run inside the `fori_loop` of `_solve_batch_lanes` in
// qtos_tpu/solver/solve.py:209), which has no Pallas kernel: XLA fuses it
// with the damping and the BTD solve into one program.  The port's plain
// version is qtos_torch/solver/assemble.py (`knot_normal` + `interval_normal`
// of qtos_torch/solver/normal_eq.py), ~2,700 aten operations per call.
//
// What it computes, for a batch of gait windows x (B, K, 36):
//   D (B, K, 36, 36), L (B, K-1, 36, 36), g (B, K, 36), merit (B,),
// D_k = J_k^T J_k of the knot residuals plus Daa of interval (k, k+1) and Dbb
// of interval (k-1, k); L_k = Lba of interval (k, k+1); g likewise; merit =
// 0.5 |rho|^2.  The closed forms are normal_eq.py's, term by term.
//
// What bounds it on an H100 is bytes: the outputs are 2,628 floats per knot
// (D and L dense, zeros included).  At (8192, 41) D is 1.741 GB, L 1.699 GB,
// g and x 0.048 GB each: ~3.54 GB, ~1.067 ms at 3.35 TB/s; ~0.13 ms at
// (1024, 41).  This design's own floor is its Gram products' work
// (qtos_torch/tools/assemble_floor.py counts it from this source): per
// knot 45 + 45 lower-triangle 4 x 4 tiles of Daa and Dbb, 81 of Lba and 2 x 9
// four-entry pieces of g, 12 rows each: ~66 k float32 instructions (no fused
// multiply-adds) and ~84 KB of shared-memory traffic, 0.66 ms and 0.84 ms
// at (8192, 41) against 128 float32 lanes and 128 B of shared memory per
// clock on each of the 132 SMs at 1.98 GHz.  Measured: 2.7 ms on an H100.
//
// Design.  One block of 256 threads (8 warps) per window, two blocks per SM
// (at most 113 KB of shared memory each; `__launch_bounds__` holds the
// registers to 128).  The block stages its work by kind over a chunk of the
// window's knots (the whole window for K <= 41), with __syncthreads between
// the stages:
//   A. x of the chunk's knots and of the next chunk's first one (the halo)
//      into shared memory by 16-byte cp.async;
//   B. each knot's endpoint terms on one thread per knot (euler rate,
//      accelerations, `wdot_and_derivs` and the 3 x 3 blocks of its
//      dynamics rows: 126 floats, `EpTerms`), and the knot family of each
//      (knot, foot) on one thread each (its blocks, 216 floats a knot with
//      the shared ones, `FamTerms`; its share of the shared blocks,
//      `FootShare`); the endpoints on whole warps of their own;
//   C. the knot family's shared blocks and squared sum on one thread per
//      knot, and each interval's residual and diagonal terms
//      (`interval_terms`) on one thread per interval;
//   D. in groups of at most 4 knots: (1) one thread per row expands Wa(x_k),
//      Wb(x_k) (and Wb of the group's next knot) from the endpoint terms and
//      D_k's 36 x 36 knot tile from the family's blocks into shared memory;
//      (2) the Gram products as 4 x 4 register tiles: a thread owns a tile of
//      D_k (lower triangle; Daa and Dbb are symmetric, so the tile above the
//      diagonal takes the same sums), of L_k (all 81) or four entries of g_k,
//      reads float4 rows of W (144-byte pitch) and writes its tiles to device
//      memory with 16-byte streaming stores.
// Each chunk hands its last endpoint terms and interval to the next (the
// one-knot halo), so every closed form runs once.  The kernel's first design
// (one warp per knot, commit 5a6d09c) computed each knot's endpoint terms four
// times and each interval twice, on 4 of a warp's 32 lanes at a time, in
// branches the warp ran one after another, and its Gram products read two
// floats from shared memory per multiply-add; here the closed forms run on
// one lane per knot, foot or interval across the block, and a Gram tile reads
// half a float per multiply-add.  Thread 0 sums the per-knot and per-interval
// squared sums in knot order into merit.  No atomics: every value is computed
// by one thread in a fixed order, so two launches on one input agree bit for
// bit.
//
// Arithmetic.  Each value is the plain version's expression in its order of
// operations (sums of 3-term products from the first term, feet in order
// 0..3, a Python number met by a float32 tensor taken as float32); built with
// --fmad=false (nvcc) or -ffp-contract=off (g++) and without fast math, so
// each product rounds on its own.  Every value is also the expression of the
// kernel's first design (one warp per knot), in the same order: a Gram entry
// sums its 12 products from row 0, zeros included, and A[r][i] * A[r][j] ==
// A[r][j] * A[r][i]; Wa and Wb are rebuilt from one knot's stored terms by
// the first design's expressions; D_k's entry is (tile + Daa) + Dbb.  So the
// outputs are that design's bit for bit.  The plain version's batched matrix
// products (12-row Gram products, einsum contractions) sum in an order the
// BLAS chooses, so the two agree to rounding, not bit for bit.  Constants
// come from Python (qtos_torch/ops/assemble.py) in the layout
// `assemble_param_layout()` names; the tensors' pointers in the order
// `assemble_tensor_layout()` names.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#define DEV __device__ __forceinline__

// Scalar constants, each a float in the layout below.
#define ASM_SCALARS(X)                                                                                  \
  X(half_dt) X(m_half_dt) X(c_vr) X(c_fv) X(c_kw) X(c_kwf) X(dyn_r) X(dyn_th) X(dyn_v) X(dyn_w) X(stat) \
  X(terr) X(fzero) X(init) X(goal) X(fric) X(rom) X(clear) X(body) X(acc_reg) X(f_reg) X(footvel_reg)   \
  X(post_reg) X(slope) X(acc_reg2) X(f_reg2) X(post_reg2) X(mu_t) X(fz_max) X(swing_clearance)          \
  X(body_clearance) X(slope_margin) X(force_scale) X(mass) X(gravity_z) X(pi) X(pen_margin)             \
  X(terrain_x0) X(terrain_y0) X(terrain_res) X(terrain_cx_max) X(terrain_cy_max)
// Array constants: name and length.
#define ASM_ARRAYS(X) X(nominal_feet, 12) X(rom_box, 3) X(inertia, 3) X(inertia_inv, 3)
// The tensors, by pointer, in this order: inputs, then outputs.
#define ASM_TENSORS(X)                                                                                   \
  X(x) X(contact) X(swing_prog) X(terr_slack) X(box_widen) X(first_stance) X(is_first) X(is_last)        \
  X(interval_contact) X(start_r) X(start_eul) X(start_v) X(start_omega) X(start_feet) X(goal_r)          \
  X(goal_yaw) X(height) X(slope_height) X(D) X(L) X(g) X(merit)

// The most knots a chunk may hold (0: as many as the shared memory of two
// blocks per SM allows).  The CPU tests build the source with a small value
// so that their windows run in several chunks.
#ifndef ASM_MAX_CHUNK
#define ASM_MAX_CHUNK 0
#endif

namespace {

constexpr int kNV = 36;          // knot state width
constexpr int kBlk = kNV * kNV;  // floats of one 36 x 36 block
constexpr int kRows = 12;        // dynamics rows of one interval
constexpr int kWFloats = kRows * kNV;
constexpr int kThreads = 256;    // 8 warps
constexpr int kMinBlocks = 2;    // blocks per SM
constexpr int kGroup = 4;        // knots per Gram group (stage D)
constexpr int kTile = 4;         // a thread's register tile: kTile x kTile
constexpr int kTiles = kNV / kTile;                  // tiles per row of a block
constexpr int kDUnits = kTiles * (kTiles + 1) / 2;   // lower-triangle tiles of D_k
constexpr int kLUnits = kTiles * kTiles;             // tiles of L_k
// Shared memory of an SM on an H100 (228 KB) shared by kMinBlocks blocks,
// each with its 1 KB reserve.
constexpr int kSmemBudget = 233472 / kMinBlocks - 1024;
constexpr int C_R = 0, C_TH = 3, C_V = 6, C_W = 9, C_P = 12, C_F = 24;  // column offsets

static_assert(kNV % kTile == 0, "the register tiles cover a block");

struct AsmParams {
#define ASM_SCALAR_FIELD(n) float n;
  ASM_SCALARS(ASM_SCALAR_FIELD)
#undef ASM_SCALAR_FIELD
#define ASM_ARRAY_FIELD(n, len) float n[len];
  ASM_ARRAYS(ASM_ARRAY_FIELD)
#undef ASM_ARRAY_FIELD
  int hf_rows, hf_cols;
};

struct AsmTensors {
#define ASM_TENSOR_FIELD(n) float* n;
  ASM_TENSORS(ASM_TENSOR_FIELD)
#undef ASM_TENSOR_FIELD
};

// One knot's endpoint terms: what an interval's residual needs of it, and
// the 3 x 3 blocks of its dynamics rows from which Wa and Wb are rebuilt.
struct EpTerms {
  float rate[3], acc[3], wd[3];
  float hdE[9];   // half_dt * d(euler rate)/d(th), the th block of the th rows before sgn
  float thW[9];   // the w block of the th rows
  float wR[9], wTH[9];
  float wW[9];    // c_kw * d(omega_dot)/dw, before the sgn * dyn_w diagonal
  float wP[4][9], wF[4][9];
};

// One knot's family blocks of D_k, in the order of the tile's writes, and
// its entries of g.
struct FamTerms {
  float rr[9], rth[9], thr[9], thth[9];          // (r, r), (r, th), (th, r), (th, th)
  float pp[4][9], RR[4][9], TP[4][9], ff[4][9];  // (p_i, p_i); -(r, p_i); (th, p_i); (f_i, f_i)
  float gk[kNV];
};

// One foot's share of the knot family that knot_shared sums over the feet,
// and its residuals for the knot's squared sum.
struct FootShare {
  float RT[9], coef[3], dd[9], gc[3], R[9];
  float terr, clear, nopen, fzero[3], fric[6], hi[3], lo[3], post[3], sl;
};

// One interval's residual rows and diagonal terms.
struct IntervalTerms {
  float res[kRows], dcoef[kNV], gdiag[kNV];
};

constexpr int kEpFloats = sizeof(EpTerms) / sizeof(float);
constexpr int kFamFloats = sizeof(FamTerms) / sizeof(float);
constexpr int kFootFloats = sizeof(FootShare) / sizeof(float);
constexpr int kIvFloats = sizeof(IntervalTerms) / sizeof(float);
static_assert(kEpFloats == 126 && kFamFloats == 216 && kFootFloats == 55 && kIvFloats == 84,
              "the compact stores hold floats only");

__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int max_i(int a, int b) { return a > b ? a : b; }

// The block's shared memory for chunks of C knots, as float offsets (each a
// multiple of 4, so every part is 16-byte aligned): x of C + 1 knots, their
// endpoint terms, C + 1 intervals (the one before the chunk and its own),
// the chunk's family blocks, its squared sums, and one region that holds the
// feet's shares in stages B-C and the Gram group's W rows and tiles in D.
struct Layout {
  int xs, ep, iv, fam, sq, un, total;
};

__host__ __device__ constexpr Layout layout(int C) {
  const int xs = 0;
  const int ep = xs + up4(kNV * (C + 1));
  const int iv = ep + up4(kEpFloats * (C + 1));
  const int fam = iv + up4(kIvFloats * (C + 1));
  const int sq = fam + up4(kFamFloats * C);
  const int un = sq + up4(2 * C);
  const int total = un + up4(max_i(kFootFloats * 4 * C, kWFloats * (2 * kGroup + 1) + kBlk * kGroup));
  return Layout{xs, ep, iv, fam, sq, un, total};
}

DEV float clamp0(float x) { return x < 0.0f ? 0.0f : x; }  // torch.clamp(min=0): NaN passes through
DEV float step(bool c) { return c ? 1.0f : 0.0f; }

// ---- ops/rotations.py, solver/jacobians.py -----------------------------------

// C = A @ B, each entry summed from its first term (PyTorch's small batched
// product on the CPU).
DEV void mm3(const float A[3][3], const float B[3][3], float C[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) C[i][j] = A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j];
}

DEV void mv3(const float A[3][3], const float v[3], float r[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) r[i] = A[i][0] * v[0] + A[i][1] * v[1] + A[i][2] * v[2];
}

DEV void cross3(const float a[3], const float b[3], float r[3]) {
  r[0] = a[1] * b[2] - a[2] * b[1];
  r[1] = a[2] * b[0] - a[0] * b[2];
  r[2] = a[0] * b[1] - a[1] * b[0];
}

DEV void skew3(const float v[3], float S[3][3]) {
  S[0][0] = 0.0f;  S[0][1] = -v[2]; S[0][2] = v[1];
  S[1][0] = v[2];  S[1][1] = 0.0f;  S[1][2] = -v[0];
  S[2][0] = -v[1]; S[2][1] = v[0];  S[2][2] = 0.0f;
}

// `rot_derivs`: R = (Rz Ry) Rx and dR/d(roll, pitch, yaw) =
// [(Rz Ry) dRx, (Rz dRy) Rx, (dRz Ry) Rx].
DEV void rot_derivs(const float th[3], float R[3][3], float dR[3][3][3]) {
  const float cr = cosf(th[0]), sr = sinf(th[0]);
  const float cp = cosf(th[1]), sp = sinf(th[1]);
  const float cy = cosf(th[2]), sy = sinf(th[2]);
  const float Rz[3][3] = {{cy, -sy, 0.0f}, {sy, cy, 0.0f}, {0.0f, 0.0f, 1.0f}};
  const float Ry[3][3] = {{cp, 0.0f, sp}, {0.0f, 1.0f, 0.0f}, {-sp, 0.0f, cp}};
  const float Rx[3][3] = {{1.0f, 0.0f, 0.0f}, {0.0f, cr, -sr}, {0.0f, sr, cr}};
  const float dRx[3][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, -sr, -cr}, {0.0f, cr, -sr}};
  const float dRy[3][3] = {{-sp, 0.0f, cp}, {0.0f, 0.0f, 0.0f}, {-cp, 0.0f, -sp}};
  const float dRz[3][3] = {{-sy, -cy, 0.0f}, {cy, -sy, 0.0f}, {0.0f, 0.0f, 0.0f}};
  float ZY[3][3], T[3][3];
  mm3(Rz, Ry, ZY);
  mm3(ZY, Rx, R);
  mm3(ZY, dRx, dR[0]);
  mm3(Rz, dRy, T);
  mm3(T, Rx, dR[1]);
  mm3(dRz, Ry, T);
  mm3(T, Rx, dR[2]);
}

// `inv_cos_pitch`: 1 / cos(pitch) with |cos(pitch)| held at >= 1e-6.
DEV float inv_cos_pitch(float cp) {
  const float small = cp > 0.0f ? 1e-6f : (cp < 0.0f ? -1e-6f : 1e-6f);
  return 1.0f / (fabsf(cp) < 1e-6f ? small : cp);
}

// `euler_rate_matrix_inv` and `euler_rate_jac` at th for angular velocity w.
DEV void euler_rate_terms(const float th[3], const float w[3], float E[3][3], float J[3][3]) {
  const float cp = cosf(th[1]), sp = sinf(th[1]);
  const float cy = cosf(th[2]), sy = sinf(th[2]);
  const float ic = inv_cos_pitch(cp);
  E[0][0] = cy * ic;        E[0][1] = sy * ic;        E[0][2] = 0.0f;
  E[1][0] = -sy;            E[1][1] = cy;             E[1][2] = 0.0f;
  E[2][0] = cy * sp * ic;   E[2][1] = sy * sp * ic;   E[2][2] = 1.0f;
  const float dic = fabsf(cp) < 1e-6f ? 0.0f : sp * ic * ic;
  const float a = cy * w[0] + sy * w[1];
  const float a_y = -sy * w[0] + cy * w[1];
  J[0][0] = 0.0f; J[0][1] = a * dic;                   J[0][2] = a_y * ic;
  J[1][0] = 0.0f; J[1][1] = 0.0f;                      J[1][2] = -a;
  J[2][0] = 0.0f; J[2][1] = a * (cp * ic + sp * dic);  J[2][2] = a_y * sp * ic;
}

// ---- terrain/heightfield.py --------------------------------------------------

// `height_at` and `grad_at` of the grid h at (x, y): `_corners`'s clamp,
// floor and h[iy, ix] order.
DEV void terrain_at(const AsmParams& p, const float* __restrict__ h, float x, float y, float* hgt, float* gx,
                    float* gy) {
  float cx = (x - p.terrain_x0) / p.terrain_res - 0.5f;
  float cy = (y - p.terrain_y0) / p.terrain_res - 0.5f;
  cx = cx < 0.0f ? 0.0f : (cx > p.terrain_cx_max ? p.terrain_cx_max : cx);
  cy = cy < 0.0f ? 0.0f : (cy > p.terrain_cy_max ? p.terrain_cy_max : cy);
  const float fcx = floorf(cx), fcy = floorf(cy);
  // for finite x and y the clamp keeps the cell inside the grid; the bounds
  // on the indices only keep a NaN from reading outside it
  const int ix = min(max((int)fcx, 0), p.hf_cols - 2), iy = min(max((int)fcy, 0), p.hf_rows - 2);
  const float fx = cx - fcx, fy = cy - fcy;
  const int W = p.hf_cols;
  const float h00 = h[iy * W + ix], h01 = h[iy * W + ix + 1];
  const float h10 = h[(iy + 1) * W + ix], h11 = h[(iy + 1) * W + ix + 1];
  *hgt = h00 * (1.0f - fx) * (1.0f - fy) + h01 * fx * (1.0f - fy) + h10 * (1.0f - fx) * fy + h11 * fx * fy;
  *gx = ((h01 - h00) * (1.0f - fy) + (h11 - h10) * fy) / p.terrain_res;
  *gy = ((h10 - h00) * (1.0f - fx) + (h11 - h01) * fx) / p.terrain_res;
}

DEV float delta(int a, int b) { return a == b ? 1.0f : 0.0f; }

// ---- solver/normal_eq.py: knot_normal ------------------------------------------

// Foot i of knot k (x_k at xk): its blocks (p_i, p_i), (r, p_i), (th, p_i)
// and (f_i, f_i) and its entries of g into fam, its share of the rest into F.
DEV void foot_terms(const AsmParams& p, const AsmTensors& t, const float* xk, FamTerms& fam, FootShare& F, int b,
                    int k, int K, int i) {
  const float r[3] = {xk[C_R], xk[C_R + 1], xk[C_R + 2]};
  const float th[3] = {xk[C_TH], xk[C_TH + 1], xk[C_TH + 2]};
  const float* pp = xk + C_P + 3 * i;
  const float* fs = xk + C_F + 3 * i;
  const size_t bki = ((size_t)b * K + k) * 4 + i;
  const float c = t.contact[bki], sprog = t.swing_prog[bki], slack = t.terr_slack[bki];
  const float fst = t.first_stance[bki];
  const float* bw = t.box_widen + bki * 3;
  const float* st_feet = t.start_feet + ((size_t)b * 4 + i) * 3;
  const float m0 = t.is_first[k] * p.init;
  const float m02 = m0 * m0;
  const float swing = 1.0f - c;
  const int P = C_P + 3 * i, Fc = C_F + 3 * i;

  // terrain, clearance, no-penetration: one direction a_dir on p_i
  float h, hx, hy;
  terrain_at(p, t.height, pp[0], pp[1], &h, &hx, &hy);
  const float a_dir[3] = {-hx, -hy, 1.0f};
  const float mT = c * p.terr;
  const float res_terr = (pp[2] - h - slack) * mT;
  const float bell = sinf(p.pi * sprog);
  const float mC = swing * p.clear;
  const float res_clear = (pp[2] - (h + p.swing_clearance * bell)) * mC;
  const float gpen = h - p.pen_margin - pp[2];
  const float mN = step(gpen > 0.0f) * swing * p.terr;
  const float res_nopen = clamp0(gpen) * swing * p.terr;
  const float coef_p = mT * mT + mC * mC + mN * mN;
  const float gcoef_p = mT * res_terr + mC * res_clear - mN * res_nopen;
  F.terr = res_terr;
  F.clear = res_clear;
  F.nopen = res_nopen;

  // swing force zero and the friction pyramid
  const float mF = swing * p.fzero;
  float res_fzero[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) F.fzero[a] = res_fzero[a] = fs[a] * mF;
  const float fx = fs[0], fy = fs[1], fz = fs[2];
  const float fr[6] = {clamp0(fx - p.mu_t * fz), clamp0(-fx - p.mu_t * fz), clamp0(fy - p.mu_t * fz),
                       clamp0(-fy - p.mu_t * fz), clamp0(-fz) * 2.0f, clamp0(fz - p.fz_max)};
  const float base_rows[6][3] = {{1.0f, 0.0f, -p.mu_t}, {-1.0f, 0.0f, -p.mu_t}, {0.0f, 1.0f, -p.mu_t},
                                 {0.0f, -1.0f, -p.mu_t}, {0.0f, 0.0f, -2.0f},   {0.0f, 0.0f, 1.0f}};
  const float cf = c * p.fric;
  float fv[6][3], res_fric[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    F.fric[j] = res_fric[j] = fr[j] * cf;
    const float gate = step(fr[j] > 0.0f) * cf;
#pragma unroll
    for (int a = 0; a < 3; ++a) fv[j][a] = gate * base_rows[j][a];
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int bb = 0; bb < 3; ++bb) {
      float ftf = fv[0][a] * fv[0][bb];
#pragma unroll
      for (int j = 1; j < 6; ++j) ftf = ftf + fv[j][a] * fv[j][bb];
      fam.ff[i][3 * a + bb] = mF * mF * delta(a, bb) + ftf;
    }
    float gfr = fv[0][a] * res_fric[0];
#pragma unroll
    for (int j = 1; j < 6; ++j) gfr = gfr + fv[j][a] * res_fric[j];
    fam.gk[Fc + a] = mF * res_fzero[a] + gfr;
  }

  // range-of-motion hinges and posture: d = R^T (p - r) - nominal
  float R[3][3], dR[3][3][3];
  rot_derivs(th, R, dR);
  const float pr[3] = {pp[0] - r[0], pp[1] - r[1], pp[2] - r[2]};
  float d[3], hi[3], lo[3], coef[3], gc[3], dd[3][3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    d[m] = pr[0] * R[0][m] + pr[1] * R[1][m] + pr[2] * R[2][m] - p.nominal_feet[3 * i + m];
    const float box = p.rom_box[m] + bw[m];
    hi[m] = clamp0(d[m] - box) * p.rom;
    lo[m] = clamp0(-d[m] - box) * p.rom;
    const float post = d[m] * p.post_reg;
    const float act_hi = step(d[m] - box > 0.0f) * p.rom;
    const float act_lo = step(-d[m] - box > 0.0f) * p.rom;
    coef[m] = act_hi * act_hi + act_lo * act_lo + p.post_reg2;
    gc[m] = act_hi * hi[m] - act_lo * lo[m] + p.post_reg * post;
    F.hi[m] = hi[m];
    F.lo[m] = lo[m];
    F.post[m] = post;
#pragma unroll
    for (int j = 0; j < 3; ++j) dd[m][j] = pr[0] * dR[j][0][m] + pr[1] * dR[j][1][m] + pr[2] * dR[j][2][m];
  }
  float RR[3][3], gprom[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int bb = 0; bb < 3; ++bb) {
      float rr = coef[0] * R[a][0] * R[bb][0], rt = coef[0] * R[a][0] * dd[0][bb];
      float tp = coef[0] * dd[0][a] * R[bb][0];
#pragma unroll
      for (int m = 1; m < 3; ++m) {
        rr = rr + coef[m] * R[a][m] * R[bb][m];
        rt = rt + coef[m] * R[a][m] * dd[m][bb];
        tp = tp + coef[m] * dd[m][a] * R[bb][m];
      }
      RR[a][bb] = rr;
      fam.RR[i][3 * a + bb] = rr;
      fam.TP[i][3 * a + bb] = tp;
      F.RT[3 * a + bb] = rt;
      F.R[3 * a + bb] = R[a][bb];
      F.dd[3 * a + bb] = dd[a][bb];
    }
    gprom[a] = gc[0] * R[a][0] + gc[1] * R[a][1] + gc[2] * R[a][2];
    F.coef[a] = coef[a];
    F.gc[a] = gc[a];
  }

  // foothold slope hinge (first-stance feet exempt)
  float sl, slx, sly;
  terrain_at(p, t.slope_height, pp[0], pp[1], &sl, &slx, &sly);
  const float w_sl = c * (1.0f - fst) * p.slope;
  const float m_sl = step(sl - p.slope_margin > 0.0f) * w_sl;
  const float res_sl = clamp0(sl - p.slope_margin) * w_sl;
  const float u_sl[3] = {slx, sly, 0.0f};
  F.sl = res_sl;

#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int bb = 0; bb < 3; ++bb)
      fam.pp[i][3 * a + bb] =
          coef_p * (a_dir[a] * a_dir[bb]) + RR[a][bb] + m_sl * m_sl * (u_sl[a] * u_sl[bb]) + m02 * delta(a, bb);
    fam.gk[P + a] = gcoef_p * a_dir[a] + gprom[a] + m_sl * res_sl * u_sl[a] + m02 * (pp[a] - st_feet[a]);
  }
}

DEV float sum_sq(const float* v, int n) {
  float acc = v[0] * v[0];
  for (int j = 1; j < n; ++j) acc = acc + v[j] * v[j];
  return acc;
}

// Knot k (x_k at xk): the blocks of r and th (the feet's shares, base
// clearance, init, goal) into fam, its entries of g for r, th, v and w, and
// the knot's squared residual sum.
DEV float knot_shared(const AsmParams& p, const AsmTensors& t, const float* xk, FamTerms& fam,
                      const FootShare* F, int b, int k) {
  const float* r = xk + C_R;
  const float* th = xk + C_TH;
  const float* v = xk + C_V;
  const float* w = xk + C_W;
  const float m0 = t.is_first[k] * p.init, mG = t.is_last[k] * p.goal;
  const float m02 = m0 * m0, mG2 = mG * mG;
  const float* st_r = t.start_r + (size_t)b * 3;
  const float* st_eul = t.start_eul + (size_t)b * 3;
  const float* st_v = t.start_v + (size_t)b * 3;
  const float* st_w = t.start_omega + (size_t)b * 3;
  const float* st_feet = t.start_feet + (size_t)b * 12;
  const float* goal_r = t.goal_r + (size_t)b * 3;
  const float dyaw = th[2] - t.goal_yaw[b];

  // base clearance hinge
  float hb, hbx, hby;
  terrain_at(p, t.height, r[0], r[1], &hb, &hbx, &hby);
  const float gb = hb + p.body_clearance - r[2];
  const float act_b = step(gb > 0.0f) * p.body;
  const float res_b = clamp0(gb) * p.body;
  const float u_b[3] = {hbx, hby, -1.0f};

#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int bb = 0; bb < 3; ++bb) {
      const int e = 3 * a + bb;
      const float rr = fam.RR[0][e] + fam.RR[1][e] + fam.RR[2][e] + fam.RR[3][e];
      const float rt = F[0].RT[e] + F[1].RT[e] + F[2].RT[e] + F[3].RT[e];
      const float rt_t = F[0].RT[3 * bb + a] + F[1].RT[3 * bb + a] + F[2].RT[3 * bb + a] + F[3].RT[3 * bb + a];
      float tt = 0.0f;
      bool first = true;
#pragma unroll
      for (int f = 0; f < 4; ++f)
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          const float term = F[f].coef[m] * F[f].dd[3 * m + a] * F[f].dd[3 * m + bb];
          tt = first ? term : tt + term;
          first = false;
        }
      fam.rr[e] = rr + act_b * act_b * (u_b[a] * u_b[bb]) + m02 * delta(a, bb) + mG2 * delta(a, bb);
      fam.rth[e] = -rt;
      fam.thr[e] = -rt_t;
      fam.thth[e] = tt + m02 * delta(a, bb) + mG2 * (a == 2 && bb == 2 ? 1.0f : 0.0f);
    }
    float gr = 0.0f, gth = 0.0f;
    bool first = true;
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const float tr = F[f].gc[m] * F[0].R[3 * a + m], tth = F[f].gc[m] * F[f].dd[3 * m + a];
        gr = first ? tr : gr + tr;
        gth = first ? tth : gth + tth;
        first = false;
      }
    fam.gk[C_R + a] = -gr + act_b * res_b * u_b[a] + m02 * (r[a] - st_r[a]) + mG2 * (r[a] - goal_r[a]);
    fam.gk[C_TH + a] = gth + m02 * (th[a] - st_eul[a]) + mG2 * dyaw * (a == 2 ? 1.0f : 0.0f);
    fam.gk[C_V + a] = m02 * (v[a] - st_v[a]) + 0.25f * mG2 * v[a];
    fam.gk[C_W + a] = m02 * (w[a] - st_w[a]) + 0.25f * mG2 * w[a];
  }

  // the squared sum, family by family as knot_normal adds it
  float terr[4], clear[4], nopen[4], fzero[12], fric[24], hi[12], lo[12], post[12], sl[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    terr[f] = F[f].terr;
    clear[f] = F[f].clear;
    nopen[f] = F[f].nopen;
    sl[f] = F[f].sl;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      fzero[3 * f + a] = F[f].fzero[a];
      hi[3 * f + a] = F[f].hi[a];
      lo[3 * f + a] = F[f].lo[a];
      post[3 * f + a] = F[f].post[a];
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) fric[6 * f + j] = F[f].fric[j];
  }
  float sq = sum_sq(terr, 4) + sum_sq(clear, 4) + sum_sq(nopen, 4);
  sq = sq + sum_sq(fzero, 12);
  sq = sq + sum_sq(fric, 24);
  sq = sq + sum_sq(hi, 12) + sum_sq(lo, 12) + sum_sq(post, 12);
  sq = sq + sum_sq(sl, 4);
  sq = sq + res_b * res_b;
  for (int gi = 0; gi < 8; ++gi) {
    const float* cur = gi < 4 ? xk + 3 * gi : xk + C_P + 3 * (gi - 4);
    const float* ref = gi == 0 ? st_r : gi == 1 ? st_eul : gi == 2 ? st_v : gi == 3 ? st_w : st_feet + 3 * (gi - 4);
    float blk[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) blk[a] = m0 * (cur[a] - ref[a]);
    sq = sq + sum_sq(blk, 3);
  }
  float dg[3], hv[3], hw[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    dg[a] = mG * (r[a] - goal_r[a]);
    hv[a] = 0.5f * mG * v[a];
    hw[a] = 0.5f * mG * w[a];
  }
  sq = sq + sum_sq(dg, 3) + (mG * dyaw) * (mG * dyaw);
  sq = sq + sum_sq(hv, 3) + sum_sq(hw, 3);
  return sq;
}

// ---- solver/normal_eq.py: interval_normal ----------------------------------------

// The terms of one knot x_j that the dynamics rows of its two intervals
// need: the euler rate, the linear acceleration and omega_dot
// (`wdot_and_derivs`), and the 3 x 3 blocks of the rows' Jacobian with
// respect to x_j from which `w_row` rebuilds Wa (x_j the interval's first
// knot) and Wb (its second).
DEV void endpoint_terms(const AsmParams& p, const float* xj, EpTerms& ep) {
  const float r[3] = {xj[C_R], xj[C_R + 1], xj[C_R + 2]};
  const float th[3] = {xj[C_TH], xj[C_TH + 1], xj[C_TH + 2]};
  const float w[3] = {xj[C_W], xj[C_W + 1], xj[C_W + 2]};
  float f[4][3], fsum[3];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int a = 0; a < 3; ++a) f[i][a] = xj[C_F + 3 * i + a] * p.force_scale;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    fsum[a] = f[0][a] + f[1][a] + f[2][a] + f[3][a];
    ep.acc[a] = fsum[a] / p.mass;
  }
  ep.acc[2] = ep.acc[2] + p.gravity_z;

  float E[3][3], dE[3][3];
  euler_rate_terms(th, w, E, dE);
  mv3(E, w, ep.rate);

  // wdot_and_derivs
  float R[3][3], dR[3][3][3], RT[3][3], T[3][3], Iw[3][3], Iwinv[3][3];
  rot_derivs(th, R, dR);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int bb = 0; bb < 3; ++bb) RT[a][bb] = R[bb][a];
  const float Ib[3][3] = {{p.inertia[0], 0.0f, 0.0f}, {0.0f, p.inertia[1], 0.0f}, {0.0f, 0.0f, p.inertia[2]}};
  const float Ibinv[3][3] = {
      {p.inertia_inv[0], 0.0f, 0.0f}, {0.0f, p.inertia_inv[1], 0.0f}, {0.0f, 0.0f, p.inertia_inv[2]}};
  mm3(R, Ib, T);
  mm3(T, RT, Iw);
  mm3(R, Ibinv, T);
  mm3(T, RT, Iwinv);
  float tau[3], pr[4][3];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float c[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) pr[i][a] = xj[C_P + 3 * i + a] - r[a];
    cross3(pr[i], f[i], c);
#pragma unroll
    for (int a = 0; a < 3; ++a) tau[a] = i == 0 ? c[a] : tau[a] + c[a];
  }
  float Iww[3], cw[3], rhs[3];
  mv3(Iw, w, Iww);
  cross3(w, Iww, cw);
#pragma unroll
  for (int a = 0; a < 3; ++a) rhs[a] = tau[a] - cw[a];
  mv3(Iwinv, rhs, ep.wd);

  float nIwinv[3][3], S[3][3], M[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int bb = 0; bb < 3; ++bb) {
      ep.hdE[3 * a + bb] = p.half_dt * dE[a][bb];
      ep.thW[3 * a + bb] = p.m_half_dt * E[a][bb] * p.dyn_th;
      nIwinv[a][bb] = -Iwinv[a][bb];
    }
  }
  // dwd_dr = I_winv skew(sum f); dwd_dp_i = -I_winv skew(f_i); dwd_df_i = I_winv skew(p_i - r)
  skew3(fsum, S);
  mm3(Iwinv, S, M);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int bb = 0; bb < 3; ++bb) ep.wR[3 * a + bb] = p.c_kw * M[a][bb];
  for (int i = 0; i < 4; ++i) {
    skew3(f[i], S);
    mm3(nIwinv, S, M);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) ep.wP[i][3 * a + bb] = p.c_kw * M[a][bb];
    skew3(pr[i], S);
    mm3(Iwinv, S, M);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) ep.wF[i][3 * a + bb] = p.c_kwf * M[a][bb];
  }
  // dwd_dw = -I_winv (skew(w) I_w - skew(I_w w))
  {
    float Sw[3][3], SI[3][3], A[3][3];
    skew3(w, Sw);
    skew3(Iww, SI);
    mm3(Sw, Iw, A);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) A[a][bb] = A[a][bb] - SI[a][bb];
    mm3(nIwinv, A, M);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) ep.wW[3 * a + bb] = p.c_kw * M[a][bb];
  }
  // dwd_dth: column j from d(R I R^T)/dth_j = dR_j I R^T + its transpose
  for (int j = 0; j < 3; ++j) {
    float dIw[3][3], dIinv[3][3], t1[3], u[3], t2[3], q[3];
    mm3(dR[j], Ib, T);
    mm3(T, RT, M);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) dIw[a][bb] = M[a][bb] + M[bb][a];
    mm3(dR[j], Ibinv, T);
    mm3(T, RT, M);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) dIinv[a][bb] = M[a][bb] + M[bb][a];
    mv3(dIinv, rhs, t1);
    mv3(dIw, w, u);
    cross3(w, u, t2);
    mv3(Iwinv, t2, q);
#pragma unroll
    for (int a = 0; a < 3; ++a) ep.wTH[3 * a + j] = p.c_kw * (t1[a] - q[a]);
  }
}

// The dynamics residual of the interval (x_a, x_b), its diagonal families
// (stationarity, foot velocity, accelerations, force rate) and their terms
// of D and g; returns the interval's squared residual sum.
DEV float interval_terms(const AsmParams& p, const float* xa, const float* xb, const EpTerms& ea,
                         const EpTerms& eb, const float* ca, const float* cb, IntervalTerms& it) {
  float sq = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    it.res[a] = (xb[C_R + a] - xa[C_R + a] - p.half_dt * (xa[C_V + a] + xb[C_V + a])) * p.dyn_r;
    it.res[3 + a] = (xb[C_TH + a] - xa[C_TH + a] - p.half_dt * (ea.rate[a] + eb.rate[a])) * p.dyn_th;
    it.res[6 + a] = (xb[C_V + a] - xa[C_V + a] - p.half_dt * (ea.acc[a] + eb.acc[a])) * p.dyn_v;
    it.res[9 + a] = (xb[C_W + a] - xa[C_W + a] - p.half_dt * (ea.wd[a] + eb.wd[a])) * p.dyn_w;
  }
  sq = sum_sq(it.res, kRows);
  float stat[12], fv[12], av[3], aw[3], df[12];
  for (int e = 0; e < 6; ++e) it.dcoef[e] = it.gdiag[e] = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float both = ca[i] * cb[i];
    const float ms = both * p.stat, mv = (1.0f - both) * p.footvel_reg;
    const float cpp = ms * ms + mv * mv;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int e = 3 * i + a;
      const float dp = xb[C_P + e] - xa[C_P + e];
      stat[e] = dp * ms;
      fv[e] = dp * mv;
      it.dcoef[C_P + e] = cpp;
      it.gdiag[C_P + e] = ms * stat[e] + mv * fv[e];
      df[e] = (xb[C_F + e] * p.force_scale - xa[C_F + e] * p.force_scale) / p.force_scale * p.f_reg;
      it.dcoef[C_F + e] = p.f_reg2;
      it.gdiag[C_F + e] = p.f_reg * df[e];
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    av[a] = (xb[C_V + a] - xa[C_V + a]) * p.acc_reg;
    aw[a] = (xb[C_W + a] - xa[C_W + a]) * p.acc_reg;
    it.dcoef[C_V + a] = it.dcoef[C_W + a] = p.acc_reg2;
    it.gdiag[C_V + a] = p.acc_reg * av[a];
    it.gdiag[C_W + a] = p.acc_reg * aw[a];
  }
  sq = sq + sum_sq(stat, 12) + sum_sq(fv, 12);
  sq = sq + sum_sq(av, 3) + sum_sq(aw, 3);
  sq = sq + sum_sq(df, 12);
  return sq;
}

// ---- stage D: the rows in shared memory, the Gram products -----------------------

DEV float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
DEV void zero_row(float* row) {
#pragma unroll
  for (int c = 0; c < kNV; c += 4) *reinterpret_cast<float4*>(row + c) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
// A 16-byte store to device memory that is not read again by this kernel.
DEV void st4(float* dst, float a, float b, float c, float d) {
  __stcs(reinterpret_cast<float4*>(dst), make_float4(a, b, c, d));
}

// Row r of the interval Jacobian of the knot whose endpoint terms are e, as
// its first knot (Wa, sgn -1) or its second (Wb, sgn +1): rows 0-2 dyn_r,
// 3-5 dyn_th, 6-8 dyn_v, 9-11 dyn_w; zeros where it has none.
DEV void w_row(const AsmParams& p, const EpTerms& e, float sgn, int r, float* row) {
  zero_row(row);
  const int a = r % 3;
  switch (r / 3) {
    case 0:
      row[C_R + a] = sgn > 0.0f ? p.dyn_r : -p.dyn_r;
      row[C_V + a] = p.c_vr;
      break;
    case 1:
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) {
        row[C_TH + bb] = (sgn * delta(a, bb) - e.hdE[3 * a + bb]) * p.dyn_th;
        row[C_W + bb] = e.thW[3 * a + bb];
      }
      break;
    case 2:
      row[C_V + a] = sgn > 0.0f ? p.dyn_v : -p.dyn_v;
#pragma unroll
      for (int i = 0; i < 4; ++i) row[C_F + 3 * i + a] = p.c_fv;
      break;
    default:
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) {
        row[C_R + bb] = e.wR[3 * a + bb];
        row[C_TH + bb] = e.wTH[3 * a + bb];
        row[C_W + bb] = sgn * p.dyn_w * delta(a, bb) + e.wW[3 * a + bb];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          row[C_P + 3 * i + bb] = e.wP[i][3 * a + bb];
          row[C_F + 3 * i + bb] = e.wF[i][3 * a + bb];
        }
      }
  }
}

// Row i of knot k's 36 x 36 knot-family tile from its blocks in F; zeros
// where the family has none.
DEV void tile_row(const AsmParams& p, const AsmTensors& t, const FamTerms& F, int k, int i, float* row) {
  zero_row(row);
  const int gi = i / 3, a = i % 3;
  if (gi == 0) {
#pragma unroll
    for (int bb = 0; bb < 3; ++bb) {
      row[C_R + bb] = F.rr[3 * a + bb];
      row[C_TH + bb] = F.rth[3 * a + bb];
#pragma unroll
      for (int f = 0; f < 4; ++f) row[C_P + 3 * f + bb] = -F.RR[f][3 * a + bb];
    }
  } else if (gi == 1) {
#pragma unroll
    for (int bb = 0; bb < 3; ++bb) {
      row[C_R + bb] = F.thr[3 * a + bb];
      row[C_TH + bb] = F.thth[3 * a + bb];
#pragma unroll
      for (int f = 0; f < 4; ++f) row[C_P + 3 * f + bb] = F.TP[f][3 * a + bb];
    }
  } else if (gi < 4) {  // the (v, v) and (w, w) blocks of init and goal
    const float m0 = t.is_first[k] * p.init, mG = t.is_last[k] * p.goal;
    const float m02 = m0 * m0, mG2 = mG * mG;
    const int c = gi == 2 ? C_V : C_W;
#pragma unroll
    for (int bb = 0; bb < 3; ++bb) row[c + bb] = m02 * delta(a, bb) + 0.25f * mG2 * delta(a, bb);
  } else if (gi < 8) {  // foot f's rows of p_f
    const int f = gi - 4;
#pragma unroll
    for (int bb = 0; bb < 3; ++bb) {
      row[C_R + bb] = -F.RR[f][3 * bb + a];
      row[C_TH + bb] = F.TP[f][3 * bb + a];
      row[C_P + 3 * f + bb] = F.pp[f][3 * a + bb];
    }
  } else {  // foot f's rows of f_f
    const int f = gi - 8;
#pragma unroll
    for (int bb = 0; bb < 3; ++bb) row[C_F + 3 * f + bb] = F.ff[f][3 * a + bb];
  }
}

// acc[p][q] = sum over the 12 rows r, from the first, of A[r][ci + p] *
// Bm[r][cj + q]: a 4 x 4 tile of A^T Bm, its two operands read as float4.
DEV void gram_tile(const float* A, const float* Bm, int ci, int cj, float acc[kTile][kTile]) {
  float4 va = ld4(A + ci), vb = ld4(Bm + cj);
  {
    const float a[4] = {va.x, va.y, va.z, va.w}, b[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
    for (int p = 0; p < kTile; ++p)
#pragma unroll
      for (int q = 0; q < kTile; ++q) acc[p][q] = a[p] * b[q];
  }
#pragma unroll
  for (int r = 1; r < kRows; ++r) {
    va = ld4(A + r * kNV + ci);
    vb = ld4(Bm + r * kNV + cj);
    const float a[4] = {va.x, va.y, va.z, va.w}, b[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
    for (int p = 0; p < kTile; ++p)
#pragma unroll
      for (int q = 0; q < kTile; ++q) acc[p][q] = acc[p][q] + a[p] * b[q];
  }
}

// acc[q] = sum over the 12 rows r, from the first, of A[r][c + q] * v[r].
DEV void gram_vec4(const float* A, const float* v, int c, float acc[kTile]) {
  float4 va = ld4(A + c);
  acc[0] = va.x * v[0];
  acc[1] = va.y * v[0];
  acc[2] = va.z * v[0];
  acc[3] = va.w * v[0];
#pragma unroll
  for (int r = 1; r < kRows; ++r) {
    va = ld4(A + r * kNV + c);
    acc[0] = acc[0] + va.x * v[r];
    acc[1] = acc[1] + va.y * v[r];
    acc[2] = acc[2] + va.z * v[r];
    acc[3] = acc[3] + va.w * v[r];
  }
}

// The tile (ti, tj), tj <= ti, of D_k = tile + Daa + Dbb and, above the
// diagonal, its mirror (tj, ti): Daa and Dbb are symmetric entry for entry,
// the knot tile is not.  Wm = Wa(x_k), Wp = Wb(x_k); ia, ib intervals k and
// k-1.
DEV void d_tile(const float* tile, const float* Wm, const float* Wp, const IntervalTerms& ia,
                const IntervalTerms& ib, bool has_a, bool has_b, int ti, int tj, float* Dk) {
  const int ci = kTile * ti, cj = kTile * tj;
  const bool mirror = ti != tj;
  float v[kTile][kTile], m[kTile][kTile], acc[kTile][kTile];
#pragma unroll
  for (int p = 0; p < kTile; ++p) {
    const float4 row = ld4(tile + (ci + p) * kNV + cj);
    v[p][0] = row.x, v[p][1] = row.y, v[p][2] = row.z, v[p][3] = row.w;
  }
  if (mirror) {
#pragma unroll
    for (int q = 0; q < kTile; ++q) {
      const float4 row = ld4(tile + (cj + q) * kNV + ci);
      m[q][0] = row.x, m[q][1] = row.y, m[q][2] = row.z, m[q][3] = row.w;
    }
  }
  if (has_a) {
    gram_tile(Wm, Wm, ci, cj, acc);
    if (!mirror) {
#pragma unroll
      for (int p = 0; p < kTile; ++p) acc[p][p] = acc[p][p] + ia.dcoef[ci + p];
    }
#pragma unroll
    for (int p = 0; p < kTile; ++p)
#pragma unroll
      for (int q = 0; q < kTile; ++q) {
        v[p][q] = v[p][q] + acc[p][q];
        if (mirror) m[q][p] = m[q][p] + acc[p][q];
      }
  }
  if (has_b) {
    gram_tile(Wp, Wp, ci, cj, acc);
    if (!mirror) {
#pragma unroll
      for (int p = 0; p < kTile; ++p) acc[p][p] = acc[p][p] + ib.dcoef[ci + p];
    }
#pragma unroll
    for (int p = 0; p < kTile; ++p)
#pragma unroll
      for (int q = 0; q < kTile; ++q) {
        v[p][q] = v[p][q] + acc[p][q];
        if (mirror) m[q][p] = m[q][p] + acc[p][q];
      }
  }
#pragma unroll
  for (int p = 0; p < kTile; ++p) st4(Dk + (ci + p) * kNV + cj, v[p][0], v[p][1], v[p][2], v[p][3]);
  if (mirror) {
#pragma unroll
    for (int q = 0; q < kTile; ++q) st4(Dk + (cj + q) * kNV + ci, m[q][0], m[q][1], m[q][2], m[q][3]);
  }
}

// The tile (ti, tj) of L_k = Lba = Wb(x_{k+1})^T Wa(x_k) of interval k.
DEV void l_tile(const float* Wn, const float* Wm, const IntervalTerms& ia, int ti, int tj, float* Lk) {
  const int ci = kTile * ti, cj = kTile * tj;
  float acc[kTile][kTile];
  gram_tile(Wn, Wm, ci, cj, acc);
  if (ti == tj) {
#pragma unroll
    for (int p = 0; p < kTile; ++p) acc[p][p] = acc[p][p] - ia.dcoef[ci + p];
  }
#pragma unroll
  for (int p = 0; p < kTile; ++p) st4(Lk + (ci + p) * kNV + cj, acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
}

// Entries 4c..4c+3 of g_k = gk + Wa^T res_k - gdiag_k + Wb^T res_{k-1} + gdiag_{k-1}.
DEV void g_piece(const float* gk, const float* Wm, const float* Wp, const IntervalTerms& ia,
                 const IntervalTerms& ib, bool has_a, bool has_b, int c, float* g) {
  const int c4 = kTile * c;
  float v[kTile], acc[kTile];
#pragma unroll
  for (int q = 0; q < kTile; ++q) v[q] = gk[c4 + q];
  if (has_a) {
    gram_vec4(Wm, ia.res, c4, acc);
#pragma unroll
    for (int q = 0; q < kTile; ++q) v[q] = v[q] + (acc[q] - ia.gdiag[c4 + q]);
  }
  if (has_b) {
    gram_vec4(Wp, ib.res, c4, acc);
#pragma unroll
    for (int q = 0; q < kTile; ++q) v[q] = v[q] + (acc[q] + ib.gdiag[c4 + q]);
  }
  st4(g + c4, v[0], v[1], v[2], v[3]);
}

// Starts a 16-byte copy from device memory to shared memory (cp.async);
// complete after cp_wait.
DEV void cp_async16(float* dst, const float* src) { __pipeline_memcpy_async(dst, src, 16); }
// Waits for the thread's copies; the __syncthreads that follows makes every
// thread's copies visible to the block.
DEV void cp_wait() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
assemble_kernel(AsmParams p, AsmTensors t, int B, int K, int C) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Layout lay = layout(C);
  float* xs = sm + lay.xs;                                        // x_{k0} .. x_{k0+C}
  EpTerms* ep = reinterpret_cast<EpTerms*>(sm + lay.ep);          // slot s: knot k0 + s
  IntervalTerms* iv = reinterpret_cast<IntervalTerms*>(sm + lay.iv);  // slot s: interval k0 - 1 + s
  FamTerms* fam = reinterpret_cast<FamTerms*>(sm + lay.fam);      // slot s: knot k0 + s
  float* sq_knot = sm + lay.sq;
  float* sq_int = sq_knot + C;
  FootShare* foot = reinterpret_cast<FootShare*>(sm + lay.un);    // stages B-C: (knot slot, foot)
  float* WA = sm + lay.un;                                        // stage D: Wa of the group's knots,
  float* WB = WA + kGroup * kWFloats;                             // Wb of them and of the next knot,
  float* tiles = WB + (kGroup + 1) * kWFloats;                    // their knot tiles
  const int tid = threadIdx.x, b = blockIdx.x;
  const float* xb = t.x + (size_t)b * K * kNV;
  const float* ic = t.interval_contact + (size_t)b * K * 4;
  float sk = 0.0f, si = 0.0f;  // thread 0: the squared sums so far, in knot order

  for (int k0 = 0; k0 < K; k0 += C) {
    const int n = min(C, K - k0);         // the chunk's knots k0 .. k0+n-1
    const int kx = min(k0 + n, K - 1);    // the chunk's last knot, or the next chunk's first (the halo)
    const int ni = kx - k0;               // the chunk's intervals k0 .. kx-1
    // A. x_{k0} .. x_{kx}
    for (int e = tid; e < (kx - k0 + 1) * (kNV / 4); e += kThreads)
      cp_async16(xs + 4 * e, xb + (size_t)k0 * kNV + 4 * e);
    cp_wait();
    __syncthreads();

    // B. endpoint terms of knots e0 .. kx on whole warps of their own; the
    // feet of the chunk's knots on the warps after them
    const int e0 = k0 == 0 ? 0 : k0 + 1;  // knot k0's terms came with the chunk before
    const int nE = kx - e0 + 1;
    const int nEw = (nE + 31) & ~31;
    for (int it = tid; it < nEw + 4 * n; it += kThreads) {
      if (it < nE) {
        const int s = e0 + it - k0;
        endpoint_terms(p, xs + s * kNV, ep[s]);
      } else if (it >= nEw) {
        const int s = (it - nEw) >> 2, i = (it - nEw) & 3;
        foot_terms(p, t, xs + s * kNV, fam[s], foot[4 * s + i], b, k0 + s, K, i);
      }
    }
    __syncthreads();

    // C. the knots' shared blocks; the intervals
    const int nw = (n + 31) & ~31;
    for (int it = tid; it < nw + ni; it += kThreads) {
      if (it < n) {
        sq_knot[it] = knot_shared(p, t, xs + it * kNV, fam[it], foot + 4 * it, b, k0 + it);
      } else if (it >= nw) {
        const int s = it - nw, k = k0 + s;
        sq_int[s] = interval_terms(p, xs + s * kNV, xs + (s + 1) * kNV, ep[s], ep[s + 1], ic + k * 4,
                                   ic + (k + 1) * 4, iv[s + 1]);
      }
    }
    __syncthreads();
    if (tid == 0) {
      for (int s = 0; s < n; ++s) sk = k0 + s == 0 ? sq_knot[s] : sk + sq_knot[s];
      for (int s = 0; s < ni; ++s) si = k0 + s == 0 ? sq_int[s] : si + sq_int[s];
    }

    // D. groups of at most kGroup knots, spread evenly
    const int groups = (n + kGroup - 1) / kGroup, base = n / groups, extra = n % groups;
    for (int gr = 0; gr < groups; ++gr) {
      const int gs = gr * base + min(gr, extra), gn = base + (gr < extra ? 1 : 0);
      const int ks = k0 + gs;  // the group's knots ks .. ks+gn-1
      // 1. Wa(x_k), Wb(x_k), Wb(x_{ks+gn}) and the knot tiles, one row per thread
      const int wrows = (2 * gn + 1) * kRows;
      for (int job = tid; job < wrows + gn * kNV; job += kThreads) {
        if (job < wrows) {
          const int m = job / kRows, r = job - m * kRows;
          const bool wa = m < gn;  // Wa(x_{ks+m}), else Wb(x_{ks+m-gn})
          const int k = wa ? ks + m : ks + m - gn;
          float* W = wa ? WA + m * kWFloats : WB + (m - gn) * kWFloats;
          if (wa ? k < K - 1 : k > 0 && k < K) w_row(p, ep[k - k0], wa ? -1.0f : 1.0f, r, W + r * kNV);
        } else {
          const int q = job - wrows, j = q / kNV, i = q - j * kNV;
          tile_row(p, t, fam[ks + j - k0], ks + j, i, tiles + j * kBlk + i * kNV);
        }
      }
      __syncthreads();
      // 2. the tiles of D_k (lower triangle), L_k and the pieces of g_k
      const int na = ks + gn - 1 < K - 1 ? gn : gn - 1;  // knots with an interval k
      const int nd = gn * kDUnits, nl = na * kLUnits;
      for (int it = tid; it < nd + nl + gn * kTiles; it += kThreads) {
        if (it < nd) {
          const int j = it / kDUnits, k = ks + j;
          int u = it - j * kDUnits, ti = 0;
          while (u > ti) u -= ++ti;
          d_tile(tiles + j * kBlk, WA + j * kWFloats, WB + j * kWFloats, iv[k - k0 + 1], iv[k - k0], k < K - 1,
                 k > 0, ti, u, t.D + ((size_t)b * K + k) * kBlk);
        } else if (it < nd + nl) {
          const int j = (it - nd) / kLUnits, u = it - nd - j * kLUnits, k = ks + j;
          l_tile(WB + (j + 1) * kWFloats, WA + j * kWFloats, iv[k - k0 + 1], u / kTiles, u % kTiles,
                 t.L + ((size_t)b * (K - 1) + k) * kBlk);
        } else {
          const int j = (it - nd - nl) / kTiles, c = it - nd - nl - j * kTiles, k = ks + j;
          g_piece(fam[k - k0].gk, WA + j * kWFloats, WB + j * kWFloats, iv[k - k0 + 1], iv[k - k0], k < K - 1,
                  k > 0, c, t.g + ((size_t)b * K + k) * kNV);
        }
      }
      __syncthreads();
    }
    // the halo: knot k0+n's endpoint terms and interval k0+n-1 start the next chunk
    if (k0 + n < K) {
      for (int e = tid; e < kEpFloats; e += kThreads) (&ep[0].rate[0])[e] = (&ep[n].rate[0])[e];
      for (int e = tid; e < kIvFloats; e += kThreads) (&iv[0].res[0])[e] = (&iv[n].res[0])[e];
    }
  }
  if (tid == 0) t.merit[b] = 0.5f * (sk + si);
}

// Knots per chunk for windows of K knots: the fewest chunks whose shared
// memory fits two blocks per SM, spread evenly (K = 41: one chunk).
int chunk_for(int K) {
  int cmax = 1;
  while (cmax < K && (size_t)layout(cmax + 1).total * sizeof(float) <= (size_t)kSmemBudget) ++cmax;
  if (ASM_MAX_CHUNK > 0 && cmax > ASM_MAX_CHUNK) cmax = ASM_MAX_CHUNK;
  const int chunks = (K + cmax - 1) / cmax;
  return (K + chunks - 1) / chunks;
}

size_t smem_for(int K) { return (size_t)layout(chunk_for(K)).total * sizeof(float); }

}  // namespace

#define ASM_STR_(x) #x
#define ASM_STR(x) ASM_STR_(x)
#define ASM_SCALAR_NAME(n) #n ":1,"
#define ASM_ARRAY_NAME(n, len) #n ":" ASM_STR(len) ","
#define ASM_TENSOR_NAME(n) #n ","

// The constants' layout as "name:count," pairs in order: the float array
// `assemble_run` takes holds them back to back.
extern "C" const char* assemble_param_layout() { return ASM_SCALARS(ASM_SCALAR_NAME) ASM_ARRAYS(ASM_ARRAY_NAME); }

// The tensors' names, in the order of the pointer array `assemble_run` takes.
extern "C" const char* assemble_tensor_layout() { return ASM_TENSORS(ASM_TENSOR_NAME); }

// Knots per chunk, and bytes of shared memory per block, for windows of K knots.
extern "C" int assemble_chunk(int K) { return K > 1 ? chunk_for(K) : 0; }
extern "C" int assemble_smem_bytes(int K) { return K > 1 ? (int)smem_for(K) : 0; }

// Blocks of the kernel that fit on one SM for windows of K knots (the
// runtime's occupancy, after the kernel's attributes are set).
extern "C" int assemble_blocks_per_sm(int K) {
  if (K < 2) return 0;
  const int smem = (int)smem_for(K);
  if (cudaFuncSetAttribute(assemble_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess ||
      cudaFuncSetAttribute(assemble_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, assemble_kernel, kThreads, smem) != cudaSuccess)
    return -1;
  return blocks;
}

// Launches one assembly of B windows of K knots on `stream`, one block per
// window.  `tensors` holds the pointers of `assemble_tensor_layout()`, every
// tensor float32 and contiguous in the shapes of qtos_torch/ops/assemble.py;
// `height` and `slope_height` are (hf_rows, hf_cols) grids.  Returns the
// launch's CUDA error (0 when it was accepted).
extern "C" int assemble_run(const float* params, int n_params, void* const* tensors, int n_tensors, int B, int K,
                            int hf_rows, int hf_cols, void* stream) {
  AsmParams p;
  AsmTensors t;
  const int want = (int)(offsetof(AsmParams, hf_rows) / sizeof(float));
  if (n_params != want || n_tensors != (int)(sizeof(AsmTensors) / sizeof(float*)) || B <= 0 || K < 2 ||
      hf_rows < 2 || hf_cols < 2)
    return (int)cudaErrorInvalidValue;
  float* dst = reinterpret_cast<float*>(&p);
  for (int i = 0; i < n_params; ++i) dst[i] = params[i];
  p.hf_rows = hf_rows;
  p.hf_cols = hf_cols;
  float** tp = reinterpret_cast<float**>(&t);
  for (int i = 0; i < n_tensors; ++i) {
    if (tensors[i] == nullptr) return (int)cudaErrorInvalidValue;
    tp[i] = static_cast<float*>(tensors[i]);
  }
  int C = chunk_for(K);
  const size_t smem = smem_for(K);
  cudaError_t err = cudaFuncSetAttribute(assemble_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(assemble_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p, &t, &B, &K, &C};
  err = cudaLaunchKernel(assemble_kernel, dim3(B), dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
