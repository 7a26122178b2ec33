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
// g and x 0.048 GB each: ~3.54 GB, ~1.06 ms at 3.35 TB/s; ~0.44 GB, ~0.13 ms at
// (1024, 41).  The arithmetic (~50 k multiply-adds per knot for the three
// 12-row Gram products, a few thousand for the closed forms) is far below
// the card's float32 rate at that size.
//
// Design (a first design that is right and simple).  One block per scenario,
// `assemble_warps(K)` warps (7 for every K the solver uses: K=13..41 fit in
// whole rounds), each warp walking knots k = warp, warp + warps, ...  Per knot
// the warp keeps in shared memory the 36 x 37 tile of D_k (padded pitch), the
// three 12 x 36 dynamics row blocks it needs (Wb of x_k for Dbb of interval
// k-1, Wa of x_k for Daa and L of interval k, Wb of x_{k+1} for L), and the
// knots x_{k-1}, x_k, x_{k+1}.  Every interval's rows are computed by both
// knots that share it.  Four stages, a __syncwarp between them:
//   0. all lanes: load the three knots, zero the tile;
//   1. lanes 0-3: the knot family of foot 0-3 (terrain, clearance and
//      no-penetration, swing force and friction, range of motion and
//      posture, slope), its own blocks into the tile and its share of the
//      blocks of r and th into the warp's scratch; lanes 8-11: the endpoint
//      terms of x_k (as Wb and as Wa), x_{k+1} (as Wb) and x_{k-1}: euler
//      rates, linear and angular accelerations, and their rows;
//   2. lane 0: the blocks of r, th, v, w (the feet's shares summed in foot
//      order, base clearance, init, goal) and the knot's squared sum; lanes
//      1-2: the residuals and diagonal terms of intervals k-1 and k;
//   3. all lanes: D_k = tile + Daa + Dbb, L_k and g_k, written whole (zeros
//      included) by consecutive lanes at consecutive addresses.
// The block's last step sums the per-knot squared sums in knot order into
// merit.  No atomics: every value is computed by one thread in a fixed order,
// so two launches on one input agree bit for bit.
//
// Arithmetic.  Each value is the plain version's expression in its order of
// operations (sums of 3-term products from the first term, feet in order
// 0..3, a Python number met by a float32 tensor taken as float32); built with
// --fmad=false (nvcc) or -ffp-contract=off (g++) and without fast math, so
// each product rounds on its own.  The plain version's batched matrix
// products (12-row Gram products, einsum contractions) sum in an order the
// BLAS chooses, so the two agree to rounding, not bit for bit.  Constants
// come from Python (qtos_torch/ops/assemble.py) in the layout
// `assemble_param_layout()` names; the tensors' pointers in the order
// `assemble_tensor_layout()` names.

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

namespace {

constexpr int kNV = 36;         // knot state width
constexpr int kBlk = kNV * kNV;  // floats of one 36 x 36 block
constexpr int kPitch = 37;      // the tile's row pitch in shared memory
constexpr int kRows = 12;       // dynamics rows of one interval
constexpr int kMaxWarps = 8;
constexpr int C_R = 0, C_TH = 3, C_V = 6, C_W = 9, C_P = 12, C_F = 24;  // column offsets

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

// One foot's share of the knot family that lane 0 sums over the feet, and
// its residuals for the knot's squared sum.
struct FootShare {
  float R[9], RR[9], RT[9], coef[3], dd[9], gc[3];
  float terr, clear, nopen, fzero[3], fric[6], hi[3], lo[3], post[3], sl;
};

// What an interval's residual needs of one of its knots.
struct Endpoint {
  float rate[3], acc[3], wd[3];
};

// One interval's residual rows and diagonal terms.
struct IntervalTerms {
  float res[kRows], dcoef[kNV], gdiag[kNV];
};

// The shared memory of one warp.
struct WarpSmem {
  float tile[kNV * kPitch];   // D_k's knot family
  float W[3][kRows * kNV];    // Wb(x_k), Wa(x_k), Wb(x_{k+1})
  float xs[3][kNV];           // x_{k-1}, x_k, x_{k+1}
  float gk[kNV];              // g_k's knot family
  Endpoint ep[4];             // x_k (as lane 8), x_k (lane 9), x_{k+1}, x_{k-1}
  IntervalTerms iv[2];        // intervals k-1 and k
  FootShare foot[4];
};

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

DEV float& at(float* tile, int i, int j) { return tile[i * kPitch + j]; }
DEV float delta(int a, int b) { return a == b ? 1.0f : 0.0f; }

// ---- solver/normal_eq.py: knot_normal ------------------------------------------

// Foot i of knot k (lane i): its blocks (p_i, p_i), (r, p_i), (th, p_i),
// their transposes and (f_i, f_i), its entries of g, and its share of the
// rest in s.foot[i].
DEV void foot_terms(const AsmParams& p, const AsmTensors& t, WarpSmem& s, int b, int k, int K, int i) {
  const float* xk = s.xs[1];
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
  FootShare& F = s.foot[i];
  float* tile = s.tile;
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
      at(tile, Fc + a, Fc + bb) = mF * mF * delta(a, bb) + ftf;
    }
    float gfr = fv[0][a] * res_fric[0];
#pragma unroll
    for (int j = 1; j < 6; ++j) gfr = gfr + fv[j][a] * res_fric[j];
    s.gk[Fc + a] = mF * res_fzero[a] + gfr;
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
  float RR[3][3], TP[3][3], gprom[3];
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
      TP[a][bb] = tp;
      F.RR[3 * a + bb] = rr;
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
    for (int bb = 0; bb < 3; ++bb) {
      at(tile, P + a, P + bb) =
          coef_p * (a_dir[a] * a_dir[bb]) + RR[a][bb] + m_sl * m_sl * (u_sl[a] * u_sl[bb]) + m02 * delta(a, bb);
      at(tile, C_R + a, P + bb) = -RR[a][bb];
      at(tile, P + a, C_R + bb) = -RR[bb][a];
      at(tile, C_TH + a, P + bb) = TP[a][bb];
      at(tile, P + a, C_TH + bb) = TP[bb][a];
    }
    s.gk[P + a] = gcoef_p * a_dir[a] + gprom[a] + m_sl * res_sl * u_sl[a] + m02 * (pp[a] - st_feet[a]);
  }
}

DEV float sum_sq(const float* v, int n) {
  float acc = v[0] * v[0];
  for (int j = 1; j < n; ++j) acc = acc + v[j] * v[j];
  return acc;
}

// Lane 0: the blocks of r, th, v and w (the feet's shares, base clearance,
// init, goal), their entries of g, and the knot's squared residual sum.
DEV float knot_shared(const AsmParams& p, const AsmTensors& t, WarpSmem& s, int b, int k) {
  const float* xk = s.xs[1];
  const float* r = xk + C_R;
  const float* th = xk + C_TH;
  const float* v = xk + C_V;
  const float* w = xk + C_W;
  const FootShare* F = s.foot;
  float* tile = s.tile;
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
      const float rr = F[0].RR[e] + F[1].RR[e] + F[2].RR[e] + F[3].RR[e];
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
      at(tile, C_R + a, C_R + bb) = rr + act_b * act_b * (u_b[a] * u_b[bb]) + m02 * delta(a, bb) + mG2 * delta(a, bb);
      at(tile, C_R + a, C_TH + bb) = -rt;
      at(tile, C_TH + a, C_R + bb) = -rt_t;
      at(tile, C_TH + a, C_TH + bb) = tt + m02 * delta(a, bb) + mG2 * (a == 2 && bb == 2 ? 1.0f : 0.0f);
      at(tile, C_V + a, C_V + bb) = m02 * delta(a, bb) + 0.25f * mG2 * delta(a, bb);
      at(tile, C_W + a, C_W + bb) = m02 * delta(a, bb) + 0.25f * mG2 * delta(a, bb);
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
    s.gk[C_R + a] = -gr + act_b * res_b * u_b[a] + m02 * (r[a] - st_r[a]) + mG2 * (r[a] - goal_r[a]);
    s.gk[C_TH + a] = gth + m02 * (th[a] - st_eul[a]) + mG2 * dyaw * (a == 2 ? 1.0f : 0.0f);
    s.gk[C_V + a] = m02 * (v[a] - st_v[a]) + 0.25f * mG2 * v[a];
    s.gk[C_W + a] = m02 * (w[a] - st_w[a]) + 0.25f * mG2 * w[a];
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

// The terms of one knot x_j that an interval's dynamics rows need: the euler
// rate, the linear acceleration and omega_dot (`wdot_and_derivs`) into ep,
// and, if W is given, the 12 x 36 rows of the interval's Jacobian with
// respect to x_j: Wa (sgn -1, x_j the interval's first knot) or Wb (sgn +1),
// into rows the warp has zeroed.
DEV void endpoint_terms(const AsmParams& p, const float* xj, float sgn, float* W, Endpoint& ep) {
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
  if (W == nullptr) return;

  float* Wr = W;                 // rows 0-2: dyn_r
  float* Wth = W + 3 * kNV;      // rows 3-5: dyn_th
  float* Wv = W + 6 * kNV;       // rows 6-8: dyn_v
  float* Ww = W + 9 * kNV;       // rows 9-11: dyn_w
  float nIwinv[3][3], S[3][3], M[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    Wr[a * kNV + C_R + a] = sgn > 0.0f ? p.dyn_r : -p.dyn_r;
    Wr[a * kNV + C_V + a] = p.c_vr;
    Wv[a * kNV + C_V + a] = sgn > 0.0f ? p.dyn_v : -p.dyn_v;
#pragma unroll
    for (int i = 0; i < 4; ++i) Wv[a * kNV + C_F + 3 * i + a] = p.c_fv;
#pragma unroll
    for (int bb = 0; bb < 3; ++bb) {
      Wth[a * kNV + C_TH + bb] = (sgn * delta(a, bb) - p.half_dt * dE[a][bb]) * p.dyn_th;
      Wth[a * kNV + C_W + bb] = p.m_half_dt * E[a][bb] * p.dyn_th;
      nIwinv[a][bb] = -Iwinv[a][bb];
    }
  }
  // dwd_dr = I_winv skew(sum f); dwd_dp_i = -I_winv skew(f_i); dwd_df_i = I_winv skew(p_i - r)
  skew3(fsum, S);
  mm3(Iwinv, S, M);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int bb = 0; bb < 3; ++bb) Ww[a * kNV + C_R + bb] = p.c_kw * M[a][bb];
  for (int i = 0; i < 4; ++i) {
    skew3(f[i], S);
    mm3(nIwinv, S, M);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) Ww[a * kNV + C_P + 3 * i + bb] = p.c_kw * M[a][bb];
    skew3(pr[i], S);
    mm3(Iwinv, S, M);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) Ww[a * kNV + C_F + 3 * i + bb] = p.c_kwf * M[a][bb];
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
      for (int bb = 0; bb < 3; ++bb)
        Ww[a * kNV + C_W + bb] = sgn * p.dyn_w * delta(a, bb) + p.c_kw * M[a][bb];
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
    for (int a = 0; a < 3; ++a) Ww[a * kNV + C_TH + j] = p.c_kw * (t1[a] - q[a]);
  }
}

// Lanes 1-2: the dynamics residual of the interval (x_a, x_b), its diagonal
// families (stationarity, foot velocity, accelerations, force rate) and
// their terms of D and g; returns the interval's squared residual sum.
DEV float interval_terms(const AsmParams& p, const float* xa, const float* xb, const Endpoint& ea,
                         const Endpoint& eb, const float* ca, const float* cb, IntervalTerms& it) {
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

// sum_r A[r][i] * B[r][j] over the 12 rows, from the first.
DEV float gram(const float* A, const float* B, int i, int j) {
  float acc = A[i] * B[j];
#pragma unroll
  for (int r = 1; r < kRows; ++r) acc = acc + A[r * kNV + i] * B[r * kNV + j];
  return acc;
}

DEV float gram_vec(const float* A, const float* v, int i) {
  float acc = A[i] * v[0];
#pragma unroll
  for (int r = 1; r < kRows; ++r) acc = acc + A[r * kNV + i] * v[r];
  return acc;
}

// Two blocks per SM: ptxas then holds the kernel to 128 registers without
// spills (182 with one block per SM); 14 % faster at (8192, 41) on an H100,
// bit for bit the same.
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
assemble_kernel(AsmParams p, AsmTensors t, int B, int K) {
  extern __shared__ float4 smem4[];
  WarpSmem* all = reinterpret_cast<WarpSmem*>(smem4);
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  WarpSmem& s = all[warp];
  float* sq_knot = reinterpret_cast<float*>(all + warps);  // (K,) then (K-1,) of intervals
  float* sq_int = sq_knot + K;
  const int b = blockIdx.x;
  const float* xs_b = t.x + (size_t)b * K * kNV;
  const float* ic = t.interval_contact + (size_t)b * K * 4;

  for (int k = warp; k < K; k += warps) {
    const bool has_a = k < K - 1, has_b = k > 0;  // interval k, interval k-1
    // 0. the three knots, a zero tile
    float* xs = &s.xs[0][0];
    for (int e = lane; e < 3 * kNV; e += 32) {
      const int j = k - 1 + e / kNV;
      xs[e] = (j >= 0 && j < K) ? xs_b[(size_t)j * kNV + e % kNV] : 0.0f;
    }
    for (int e = lane; e < kNV * kPitch; e += 32) s.tile[e] = 0.0f;
    for (int e = lane; e < 3 * kRows * kNV; e += 32) (&s.W[0][0])[e] = 0.0f;
    for (int e = lane; e < kNV; e += 32) s.gk[e] = 0.0f;
    __syncwarp();
    // 1. the feet of the knot family; the endpoint terms
    if (lane < 4) {
      foot_terms(p, t, s, b, k, K, lane);
    } else if (lane >= 8 && lane < 12) {
      const int q = lane - 8;  // 0: Wb(x_k), 1: Wa(x_k), 2: Wb(x_{k+1}), 3: x_{k-1}
      const bool need = (q == 0 || q == 3) ? has_b : has_a;
      if (need)
        endpoint_terms(p, s.xs[q == 2 ? 2 : (q == 3 ? 0 : 1)], q == 1 ? -1.0f : 1.0f, q < 3 ? s.W[q] : nullptr,
                       s.ep[q]);
    }
    __syncwarp();
    // 2. the knot family's shared blocks; the two intervals' residuals
    if (lane == 0) {
      sq_knot[k] = knot_shared(p, t, s, b, k);
    } else if (lane == 1 && has_b) {
      interval_terms(p, s.xs[0], s.xs[1], s.ep[3], s.ep[0], ic + (k - 1) * 4, ic + k * 4, s.iv[0]);
    } else if (lane == 2 && has_a) {
      sq_int[k] = interval_terms(p, s.xs[1], s.xs[2], s.ep[1], s.ep[2], ic + k * 4, ic + (k + 1) * 4, s.iv[1]);
    }
    __syncwarp();
    // 3. D_k, L_k and g_k, written whole
    float* Dk = t.D + ((size_t)b * K + k) * kBlk;
    float* Lk = t.L + ((size_t)b * (K - 1) + k) * kBlk;
    const float* Wp = s.W[0];  // Wb(x_k): Dbb of interval k-1
    const float* Wm = s.W[1];  // Wa(x_k): Daa of interval k
    const float* Wn = s.W[2];  // Wb(x_{k+1}): Lba = Wb^T Wa of interval k
    for (int e = lane; e < kBlk; e += 32) {
      const int i = e / kNV, j = e - i * kNV;
      float v = s.tile[i * kPitch + j];
      if (has_a) {
        float daa = gram(Wm, Wm, i, j);
        if (i == j) daa = daa + s.iv[1].dcoef[i];
        v = v + daa;
        float lba = gram(Wn, Wm, i, j);
        if (i == j) lba = lba - s.iv[1].dcoef[i];
        Lk[e] = lba;
      }
      if (has_b) {
        float dbb = gram(Wp, Wp, i, j);
        if (i == j) dbb = dbb + s.iv[0].dcoef[i];
        v = v + dbb;
      }
      Dk[e] = v;
    }
    for (int i = lane; i < kNV; i += 32) {
      float v = s.gk[i];
      if (has_a) v = v + (gram_vec(Wm, s.iv[1].res, i) - s.iv[1].gdiag[i]);
      if (has_b) v = v + (gram_vec(Wp, s.iv[0].res, i) + s.iv[0].gdiag[i]);
      t.g[((size_t)b * K + k) * kNV + i] = v;
    }
    __syncwarp();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sk = sq_knot[0], si = 0.0f;
    for (int k = 1; k < K; ++k) sk = sk + sq_knot[k];
    if (K > 1) si = sq_int[0];
    for (int k = 1; k < K - 1; ++k) si = si + sq_int[k];
    t.merit[b] = 0.5f * (sk + si);
  }
}

// Warps per block: the fewest rounds of at most kMaxWarps knots, spread
// evenly (7 warps for K = 13, 25, 33 and 41).
int warps_for(int K) {
  const int rounds = (K + kMaxWarps - 1) / kMaxWarps;
  return (K + rounds - 1) / rounds;
}

size_t smem_for(int K) { return sizeof(WarpSmem) * warps_for(K) + sizeof(float) * 2 * K; }

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

// Warps per block for windows of K knots.
extern "C" int assemble_warps(int K) { return K > 0 ? warps_for(K) : 0; }

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
  const size_t smem = smem_for(K);
  cudaError_t err = cudaFuncSetAttribute(assemble_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p, &t, &B, &K};
  err = cudaLaunchKernel(assemble_kernel, dim3(B), dim3(warps_for(K) * 32), args, smem,
                         static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
