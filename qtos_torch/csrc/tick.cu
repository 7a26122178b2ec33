// The 1 kHz control loop of qtos_torch as one kernel launch per chunk.
//
// Replaces the compiled `lax.scan` of qtos_tpu's playback and stance warm-up
// (qtos_tpu/control/loop.py: `_scan_ticks`, `playback`, `stance_warmup`),
// which has no Pallas kernel: XLA compiles the whole scan into one program.
// The port's plain version is the eager tick of qtos_torch/control/loop.py
// (`_tick`, `_scan_ticks`, `_hold_ticks`), about 650 small kernels per tick.
//
// Design.  One thread per episode; the carry (the sim state, the previous
// planned joints and the three controller filters, ~90 floats) stays in
// registers across all T ticks, and the next table row is loaded while the
// current tick computes.  What bounds it on an H100 is the dependent chain of
// one tick (~100 transcendental calls and ~2k other operations in sequence),
// not bytes: a launch moves B * T * (37 + 56) floats, the row reads and the
// trace writes.
//
// Arithmetic.  Every sum and product is taken in the plain version's order on
// the CPU: 3x3 products and row-times-matrix left to right from the first
// term, the four feet summed in order, cross products as torch.linalg.cross,
// a tensor divided by a Python number by a true division.  Built with
// --fmad=false (nvcc) or -ffp-contract=off (g++), and without fast math, so
// each product rounds on its own as it does there.  Constants come from
// Python (`qtos_torch/ops/tick.py`) in the layout `tick_param_layout()`
// names; nothing here repeats a number of the model.
//
// Modes.  0: playback of a (B, T, 37) table with per-episode `n_valid` (at
// t >= n_valid the carry is frozen and the trace row is still written from
// it); 1: stance hold, T steps of PD to the initial joints with zero desired
// velocity, no controller and no traces.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#define DEV __device__ __forceinline__

// Scalar constants, each a float in the layout below.
#define TICK_SCALARS(X)                                                                     \
  X(dt) X(contact_kp) X(contact_kd) X(friction) X(tangent_kp) X(tangent_kd)                 \
  X(joint_inertia) X(joint_damping) X(inertia_scale) X(base_radius) X(damp_pen)             \
  X(kp) X(kd) X(t_max) X(ee_shift) X(base_corr) X(max_corr) X(vel_corr) X(yaw_corr)        \
  X(max_yaw_corr) X(beta) X(gamma) X(alpha) X(one_minus_base_corr) X(l_up) X(l_low)         \
  X(ik_l1l1) X(ik_l2l2) X(ik_2l1l2) X(mass) X(weight_z) X(terrain_x0) X(terrain_y0)         \
  X(terrain_res) X(terrain_cx_max) X(terrain_cy_max)
// Array constants: name and length.
#define TICK_ARRAYS(X) \
  X(hips, 12) X(lateral, 4) X(knee, 4) X(inertia, 3) X(inertia_inv, 3) X(gain, 12)

namespace {

constexpr int kRow = 37;      // columns of a trajectory row
constexpr int kState = 45;    // pos 3, quat 4, v 3, w 3, q 12, qd 12, anchor 8
constexpr int kTrace = 56;    // com_err, ee_err, pos 3, feet 12, q 12, qd 12, tau 12, eul 3
constexpr int kThreads = 32;  // episodes per block

struct TickParams {
#define TICK_SCALAR_FIELD(n) float n;
  TICK_SCALARS(TICK_SCALAR_FIELD)
#undef TICK_SCALAR_FIELD
#define TICK_ARRAY_FIELD(n, len) float n[len];
  TICK_ARRAYS(TICK_ARRAY_FIELD)
#undef TICK_ARRAY_FIELD
  int frame;          // 0 live, 1 hybrid, 2 plan
  int use_force_ff;
  int hf_rows, hf_cols;
};

struct State {
  float pos[3], quat[4], v[3], w[3], q[12], qd[12], anchor[4][2];
};

// Foot kinematics of one state: world feet, their world velocities, the
// world lever arms, the leg Jacobians and the base rotation.
struct Kin {
  float feet_w[4][3], feet_vw[4][3], arm_w[4][3], J[4][3][3], R[3][3];
};

DEV float clampf(float x, float lo, float hi) {  // torch.clamp: NaN passes through
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}
DEV float clamp_min(float x, float lo) { return x < lo ? lo : x; }
DEV float clamp_max(float x, float hi) { return x > hi ? hi : x; }

// ---- ops/rotations.py ------------------------------------------------------

// rz(yaw) @ ry(pitch) @ rx(roll), each product summed from its first term.
DEV void euler_to_rot(const float e[3], float R[3][3]) {
  const float cr = cosf(e[0]), sr = sinf(e[0]);
  const float cp = cosf(e[1]), sp = sinf(e[1]);
  const float cy = cosf(e[2]), sy = sinf(e[2]);
  const float a[3][3] = {{cy * cp, -sy, cy * sp}, {sy * cp, cy, sy * sp}, {-sp, 0.0f, cp}};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    R[i][0] = a[i][0];
    R[i][1] = a[i][1] * cr + a[i][2] * sr;
    R[i][2] = a[i][1] * (-sr) + a[i][2] * cr;
  }
}

DEV void rot_to_euler(const float R[3][3], float e[3]) {
  const float cy = sqrtf(clamp_min(R[0][0] * R[0][0] + R[1][0] * R[1][0], 1e-12f));
  e[1] = atan2f(-R[2][0], cy);
  e[0] = atan2f(R[2][1], R[2][2]);
  e[2] = atan2f(R[1][0], R[0][0]);
}

DEV void quat_to_rot(const float q[4], float R[3][3]) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float n = x * x + y * y + z * z + w * w;
  const float s = n > 1e-12f ? (1.0f / n) * 2.0f : 0.0f;  // 2.0 / n is reciprocal(n) * 2
  const float xx = x * x * s, yy = y * y * s, zz = z * z * s;
  const float xy = x * y * s, xz = x * z * s, yz = y * z * s;
  const float wx = w * x * s, wy = w * y * s, wz = w * z * s;
  R[0][0] = 1.0f - (yy + zz); R[0][1] = xy - wz;          R[0][2] = xz + wy;
  R[1][0] = xy + wz;          R[1][1] = 1.0f - (xx + zz); R[1][2] = yz - wx;
  R[2][0] = xz - wy;          R[2][1] = yz + wx;          R[2][2] = 1.0f - (xx + yy);
}

DEV float norm3(float a, float b, float c) { return sqrtf(a * a + b * b + c * c); }

DEV void cross3(const float a[3], const float b[3], float r[3]) {
  r[0] = a[1] * b[2] - a[2] * b[1];
  r[1] = a[2] * b[0] - a[0] * b[2];
  r[2] = a[0] * b[1] - a[1] * b[0];
}

// q (x, y, z, w) advanced by the world angular velocity om over dt.
DEV void quat_integrate(float q[4], const float om[3], float dt) {
  const float ang = norm3(om[0], om[1], om[2]);
  const float half = 0.5f * ang * dt;
  const float den = clamp_min(ang, 1e-9f);
  const float sh = sinf(half);
  const float x1 = om[0] / den * sh, y1 = om[1] / den * sh, z1 = om[2] / den * sh;
  const float w1 = cosf(half);
  const float x2 = q[0], y2 = q[1], z2 = q[2], w2 = q[3];
  const float o[4] = {
      w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
      w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
      w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
      w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
  };
  const float n = sqrtf(o[0] * o[0] + o[1] * o[1] + o[2] * o[2] + o[3] * o[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = o[i] / n;
}

// ---- models/solo12.py --------------------------------------------------------

// Foot of leg l relative to its hip (x, yb, zb) and, if J is given, its
// Jacobian d(foot)/d(q0, q1, q2).
DEV void leg_fk(const TickParams& p, const float* ql, int l, float f[3], float (*J)[3]) {
  const float s1 = sinf(ql[1]), s12 = sinf(ql[1] + ql[2]);
  const float c1 = cosf(ql[1]), c12 = cosf(ql[1] + ql[2]);
  const float x = -p.l_up * s1 - p.l_low * s12;
  const float z = -p.l_up * c1 - p.l_low * c12;
  const float y = p.lateral[l];
  const float c0 = cosf(ql[0]), s0 = sinf(ql[0]);
  f[0] = x;
  f[1] = c0 * y - s0 * z;
  f[2] = s0 * y + c0 * z;
  if (J) {
    const float dx1 = -p.l_up * c1 - p.l_low * c12;
    const float dx2 = -p.l_low * c12;
    const float dz1 = p.l_up * s1 + p.l_low * s12;
    const float dz2 = p.l_low * s12;
    J[0][0] = 0.0f;   J[0][1] = dx1;        J[0][2] = dx2;
    J[1][0] = -f[2];  J[1][1] = -s0 * dz1;  J[1][2] = -s0 * dz2;
    J[2][0] = f[1];   J[2][1] = c0 * dz1;   J[2][2] = c0 * dz2;
  }
}

// Feet in the base frame (4, 3), with the hip offsets.
DEV void fk(const TickParams& p, const float q[12], float feet[4][3], float (*J)[3][3]) {
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    float f[3];
    leg_fk(p, q + 3 * l, l, f, J ? J[l] : nullptr);
#pragma unroll
    for (int j = 0; j < 3; ++j) feet[l][j] = p.hips[3 * l + j] + f[j];
  }
}

// Closed-form IK of the four legs from base-frame feet; `ee_shift` is added
// to z when it is not 0.  Clips unreachable targets to the workspace.
DEV void ik(const TickParams& p, const float feet[4][3], float q[12]) {
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const float fz = p.ee_shift != 0.0f ? feet[l][2] + p.ee_shift : feet[l][2];
    const float vx = feet[l][0] - p.hips[3 * l], vy = feet[l][1] - p.hips[3 * l + 1];
    const float vz = fz - p.hips[3 * l + 2];
    const float d = p.lateral[l];
    const float r2 = vy * vy + vz * vz;
    const float zeta = sqrtf(clamp_min(r2 - d * d, 1e-10f));
    float q0 = atan2f(vz, vy) - atan2f(-zeta, d);
    q0 = atan2f(sinf(q0), cosf(q0));
    const float px = vx, pz = -zeta;
    float c2 = (px * px + pz * pz - p.ik_l1l1 - p.ik_l2l2) / p.ik_2l1l2;
    c2 = clampf(c2, -1.0f, 1.0f);
    const float q2 = p.knee[l] * acosf(c2);
    const float k1 = p.l_up + p.l_low * cosf(q2);
    const float k2 = p.l_low * sinf(q2);
    float q1 = atan2f(-px, -pz) - atan2f(k2, k1);
    q1 = atan2f(sinf(q1), cosf(q1));
    q[3 * l] = q0;
    q[3 * l + 1] = q1;
    q[3 * l + 2] = q2;
  }
}

// ---- terrain/heightfield.py ----------------------------------------------------

DEV float height_at(const TickParams& p, const float* __restrict__ h, float x, float y) {
  const float cx = clampf((x - p.terrain_x0) / p.terrain_res - 0.5f, 0.0f, p.terrain_cx_max);
  const float cy = clampf((y - p.terrain_y0) / p.terrain_res - 0.5f, 0.0f, p.terrain_cy_max);
  const float fcx = floorf(cx), fcy = floorf(cy);
  // The clamp above keeps a finite cell in the grid; the index clamp only
  // keeps a NaN coordinate (whose height is NaN all the same) inside it.
  const int ix = min(max((int)fcx, 0), p.hf_cols - 2), iy = min(max((int)fcy, 0), p.hf_rows - 2);
  const float fx = cx - fcx, fy = cy - fcy;
  const float* r0 = h + (size_t)iy * p.hf_cols + ix;
  const float* r1 = r0 + p.hf_cols;
  return r0[0] * (1.0f - fx) * (1.0f - fy) + r0[1] * fx * (1.0f - fy) +
         r1[0] * (1.0f - fx) * fy + r1[1] * fx * fy;
}

// ---- sim/engine.py, sim/motor.py ----------------------------------------------

DEV void foot_kinematics(const TickParams& p, const State& s, Kin& k) {
  quat_to_rot(s.quat, k.R);
  float feet_b[4][3];
  fk(p, s.q, feet_b, k.J);
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    float vj[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      k.arm_w[l][i] = feet_b[l][0] * k.R[i][0] + feet_b[l][1] * k.R[i][1] + feet_b[l][2] * k.R[i][2];
      vj[i] = k.J[l][i][0] * s.qd[3 * l] + k.J[l][i][1] * s.qd[3 * l + 1] +
              k.J[l][i][2] * s.qd[3 * l + 2];
    }
    float c[3];
    cross3(s.w, k.arm_w[l], c);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      k.feet_w[l][i] = s.pos[i] + k.arm_w[l][i];
      k.feet_vw[l][i] = s.v[i] + c[i] + (vj[0] * k.R[i][0] + vj[1] * k.R[i][1] + vj[2] * k.R[i][2]);
    }
  }
}

DEV void pd_torque(const TickParams& p, const float q_des[12], const float* qd_des, const State& s,
                   const float* tau_ff, float tau[12]) {
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const float dqd = qd_des ? qd_des[j] - s.qd[j] : 0.0f - s.qd[j];
    float t = p.kp * p.gain[j] * (q_des[j] - s.q[j]) + p.kd * p.gain[j] * dqd;
    if (tau_ff) t = t + tau_ff[j];
    tau[j] = clampf(t, -p.t_max, p.t_max);
  }
}

// One semi-implicit Euler step of `s` under `tau`, given its kinematics.
DEV void step_from_kinematics(const TickParams& p, const float* __restrict__ hf, const State& s,
                              const float tau[12], const Kin& k, State& n) {
  // Penalty contact with stiction at each foot.
  float fc[4][3];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const float h = height_at(p, hf, k.feet_w[l][0], k.feet_w[l][1]);
    const float pen = h - k.feet_w[l][2];
    const bool active = pen > 0.0f;
    const float gate = clampf(pen / p.damp_pen, 0.0f, 1.0f);
    float fn = active ? p.contact_kp * pen - p.contact_kd * gate * k.feet_vw[l][2] : 0.0f;
    fn = clampf(fn, 0.0f, 200.0f);
    float ft[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float raw = -p.tangent_kp * (k.feet_w[l][i] - s.anchor[l][i]) - p.tangent_kd * k.feet_vw[l][i];
      ft[i] = active ? raw : 0.0f;
    }
    const float mag = sqrtf(ft[0] * ft[0] + ft[1] * ft[1]);
    const float limit = p.friction * fn;
    const float scale = clamp_max(limit / clamp_min(mag, 1e-9f), 1.0f);
    const bool sliding = (mag > limit + 1e-9f) && active;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ft[i] = ft[i] * scale;
      const float slide = k.feet_w[l][i] + (ft[i] + p.tangent_kd * k.feet_vw[l][i]) / p.tangent_kp;
      n.anchor[l][i] = active ? (sliding ? slide : s.anchor[l][i]) : k.feet_w[l][i];
      fc[l][i] = ft[i];
    }
    fc[l][2] = fn;
  }

  // Base wrench: feet, gravity, and the base collision sphere.
  const float hb = height_at(p, hf, s.pos[0], s.pos[1]);
  const float penb = hb + p.base_radius - s.pos[2];
  const float fbz = clampf(penb > 0.0f ? p.contact_kp * penb - p.contact_kd * s.v[2] : 0.0f, 0.0f, 200.0f);
  float F[3], T[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 3; ++i) F[i] = fc[0][i] + fc[1][i] + fc[2][i] + fc[3][i];
  F[2] = F[2] + p.weight_z + fbz;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    float c[3];
    cross3(k.arm_w[l], fc[l], c);
#pragma unroll
    for (int i = 0; i < 3; ++i) T[i] = l == 0 ? c[i] : T[i] + c[i];
  }
  const float(&R)[3][3] = k.R;
  float Iw[3][3], Iinv[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      Iw[i][j] = p.inertia_scale * (R[i][0] * p.inertia[0] * R[j][0] + R[i][1] * p.inertia[1] * R[j][1] +
                                    R[i][2] * p.inertia[2] * R[j][2]);
      Iinv[i][j] = (R[i][0] * p.inertia_inv[0] * R[j][0] + R[i][1] * p.inertia_inv[1] * R[j][1] +
                    R[i][2] * p.inertia_inv[2] * R[j][2]) / p.inertia_scale;
    }
  }
  float Iww[3], c[3], m[3], wd[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) Iww[i] = Iw[i][0] * s.w[0] + Iw[i][1] * s.w[1] + Iw[i][2] * s.w[2];
  cross3(s.w, Iww, c);
#pragma unroll
  for (int i = 0; i < 3; ++i) m[i] = T[i] - c[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) wd[i] = Iinv[i][0] * m[0] + Iinv[i][1] * m[1] + Iinv[i][2] * m[2];

  // Joints: motor torque and the contact reaction J^T R^T f per leg.
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    float fb[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) fb[j] = fc[l][0] * R[0][j] + fc[l][1] * R[1][j] + fc[l][2] * R[2][j];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int i = 3 * l + j;
      const float tc = fb[0] * k.J[l][0][j] + fb[1] * k.J[l][1][j] + fb[2] * k.J[l][2][j];
      const float qdd = (tau[i] + tc - p.joint_damping * s.qd[i]) / p.joint_inertia;
      n.qd[i] = s.qd[i] + p.dt * qdd;
      n.q[i] = s.q[i] + p.dt * n.qd[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    n.v[i] = s.v[i] + p.dt * (F[i] / p.mass);
    n.w[i] = s.w[i] + p.dt * wd[i];
    n.pos[i] = s.pos[i] + p.dt * n.v[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) n.quat[i] = s.quat[i];
  quat_integrate(n.quat, n.w, p.dt);
}

// ---- control/loop.py ----------------------------------------------------------

// Planned feet of a row in the planned base frame: (feet - r) @ R(eul).
DEV void plan_feet_base(const float* row, float fpb[4][3]) {
  float R[3][3];
  euler_to_rot(row + 4, R);
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const float d0 = row[7 + 3 * l] - row[1], d1 = row[8 + 3 * l] - row[2], d2 = row[9 + 3 * l] - row[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) fpb[l][j] = d0 * R[0][j] + d1 * R[1][j] + d2 * R[2][j];
  }
}

// (Rz(a) - I) p in xy for one foot.
DEV void rotz_delta(const float p3[3], float ca, float sa, float out[2]) {
  out[0] = ca * p3[0] - sa * p3[1];
  out[1] = sa * p3[0] + ca * p3[1];
}

struct Filters {
  float corr[4][3], verr[3], yerr;
};

// One tick of the controller and the physics (`_tick`): from carry
// (s, q_prev, flt) and `row` to the next carry (n, q_plan, nf) and the
// tick's trace row `out`.
DEV void tick(const TickParams& p, const float* __restrict__ hf, const float* row, const State& s,
              const float q_prev[12], const Filters& flt, State& n, float q_plan[12], Filters& nf,
              float out[kTrace]) {
  float fpb[4][3];
  plan_feet_base(row, fpb);
  ik(p, fpb, q_plan);
  float qd_des[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) qd_des[j] = (q_plan[j] - q_prev[j]) / p.dt;
  Kin k;
  foot_kinematics(p, s, k);
  float eul_live[3];
  rot_to_euler(k.R, eul_live);
  nf = flt;

  float q_des[12];
  if (p.frame == 0) {
#pragma unroll
    for (int j = 0; j < 12; ++j) q_des[j] = q_plan[j];
  } else if (p.frame == 1) {
    float corr_w[3], corr_b[3], verr_w[3], cp_w[3], cp_b[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) corr_w[i] = clampf(p.base_corr * (s.pos[i] - row[1 + i]), -p.max_corr, p.max_corr);
#pragma unroll
    for (int j = 0; j < 3; ++j) corr_b[j] = corr_w[0] * k.R[0][j] + corr_w[1] * k.R[1][j] + corr_w[2] * k.R[2][j];
    verr_w[0] = (s.v[0] - row[19]) * 1.0f;
    verr_w[1] = (s.v[1] - row[20]) * 1.0f;
    verr_w[2] = (s.v[2] - row[21]) * 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      nf.verr[i] = flt.verr[i] + p.beta * (verr_w[i] - flt.verr[i]);
      cp_w[i] = clampf(p.vel_corr * nf.verr[i], -p.max_corr, p.max_corr);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) cp_b[j] = cp_w[0] * k.R[0][j] + cp_w[1] * k.R[1][j] + cp_w[2] * k.R[2][j];
    const float yd = eul_live[2] - row[6];
    const float yaw_err = atan2f(sinf(yd), cosf(yd));
    nf.yerr = flt.yerr + p.gamma * (yaw_err - flt.yerr);
    const float yawc = clampf(p.yaw_corr * nf.yerr, -p.max_yaw_corr, p.max_yaw_corr);
    const float ca_st = cosf(yawc) - 1.0f, sa_st = sinf(yawc);
    const float ca_sw = cosf(-yawc) - 1.0f, sa_sw = sinf(-yawc);
    float target[4][3];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      float delta[3], rd[2];
      if (row[27 + 3 * l] > 1.0f) {  // planned contact: +err and +yaw
        rotz_delta(fpb[l], ca_st, sa_st, rd);
        delta[0] = corr_b[0] + rd[0];
        delta[1] = corr_b[1] + rd[1];
        delta[2] = corr_b[2] + 0.0f;
      } else {                      // swing: -err and the capture point in xy, -yaw
        rotz_delta(fpb[l], ca_sw, sa_sw, rd);
        delta[0] = (-corr_b[0] + cp_b[0]) * 1.0f + rd[0];
        delta[1] = (-corr_b[1] + cp_b[1]) * 1.0f + rd[1];
        delta[2] = (-corr_b[2] + cp_b[2]) * 0.0f + 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        nf.corr[l][i] = flt.corr[l][i] + p.alpha * (delta[i] - flt.corr[l][i]);
        target[l][i] = fpb[l][i] + nf.corr[l][i];
      }
    }
    ik(p, target, q_des);
  } else {
    float shift[3], feet_b[4][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) shift[i] = (s.pos[i] - row[1 + i]) * p.one_minus_base_corr;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      float d[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) d[i] = row[7 + 3 * l + i] + shift[i] - s.pos[i];
#pragma unroll
      for (int j = 0; j < 3; ++j) feet_b[l][j] = d[0] * k.R[0][j] + d[1] * k.R[1][j] + d[2] * k.R[2][j];
    }
    ik(p, feet_b, q_des);
  }

  float tau_ff[12];
  if (p.use_force_ff) {
    // -J^T R(eul_live)^T f per leg: the reaction to the planned contact force
    float Rf[3][3];
    euler_to_rot(eul_live, Rf);
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const float* f = row + 25 + 3 * l;
      float fb[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) fb[j] = f[0] * Rf[0][j] + f[1] * Rf[1][j] + f[2] * Rf[2][j];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        tau_ff[3 * l + j] = -(fb[0] * k.J[l][0][j] + fb[1] * k.J[l][1][j] + fb[2] * k.J[l][2][j]);
    }
  }
  float tau[12];
  pd_torque(p, q_des, qd_des, s, p.use_force_ff ? tau_ff : nullptr, tau);
  step_from_kinematics(p, hf, s, tau, k, n);

  // The trace row.
  float Rq[3][3], eul[3], Rn[3][3], feet_b[4][3];
  quat_to_rot(n.quat, Rq);
  rot_to_euler(Rq, eul);
  euler_to_rot(eul, Rn);
  fk(p, n.q, feet_b, nullptr);
  out[0] = norm3(n.pos[0] - row[1], n.pos[1] - row[2], n.pos[2] - row[3]);
  float ee = 0.0f;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    float fw[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      fw[j] = n.pos[j] + (feet_b[l][0] * Rn[j][0] + feet_b[l][1] * Rn[j][1] + feet_b[l][2] * Rn[j][2]);
      out[5 + 3 * l + j] = fw[j];
    }
    const float e = norm3(fw[0] - row[7 + 3 * l], fw[1] - row[8 + 3 * l], fw[2] - row[9 + 3 * l]);
    ee = l == 0 ? e : ee + e;
  }
  out[1] = ee / 4.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[2 + i] = n.pos[i];
    out[53 + i] = eul[i];
  }
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    out[17 + j] = n.q[j];
    out[29 + j] = n.qd[j];
    out[41 + j] = tau[j];
  }
}

DEV void load_state(const float* x, State& s) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.pos[i] = x[i];
    s.v[i] = x[7 + i];
    s.w[i] = x[10 + i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) s.quat[i] = x[3 + i];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    s.q[i] = x[13 + i];
    s.qd[i] = x[25 + i];
  }
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    s.anchor[l][0] = x[37 + 2 * l];
    s.anchor[l][1] = x[38 + 2 * l];
  }
}

DEV void store_state(const State& s, float* x) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    x[i] = s.pos[i];
    x[7 + i] = s.v[i];
    x[10 + i] = s.w[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) x[3 + i] = s.quat[i];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    x[13 + i] = s.q[i];
    x[25 + i] = s.qd[i];
  }
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    x[37 + 2 * l] = s.anchor[l][0];
    x[38 + 2 * l] = s.anchor[l][1];
  }
}

__global__ void __launch_bounds__(kThreads)
tick_kernel(TickParams p, const float* __restrict__ table, const float* __restrict__ state_in,
            const int* __restrict__ n_valid, const float* __restrict__ hf, float* __restrict__ state_out,
            float* __restrict__ traces, int B, int T, int mode) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  State s;
  load_state(state_in + (size_t)b * kState, s);

  if (mode == 1) {  // stance hold: PD to the initial joints, zero desired velocity
    float q_hold[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) q_hold[j] = s.q[j];
    for (int t = 0; t < T; ++t) {
      Kin k;
      foot_kinematics(p, s, k);
      float tau[12];
      pd_torque(p, q_hold, nullptr, s, nullptr, tau);
      State n;
      step_from_kinematics(p, hf, s, tau, k, n);
      s = n;
    }
    store_state(s, state_out + (size_t)b * kState);
    return;
  }

  const float* rows = table + (size_t)b * T * kRow;
  float* tr = traces + (size_t)b * T * kTrace;
  const int nv = n_valid[b];
  float cur[kRow], nxt[kRow];
#pragma unroll
  for (int i = 0; i < kRow; ++i) nxt[i] = T > 0 ? rows[i] : 0.0f;
  float q_prev[12];
  {
    float fpb[4][3];
    plan_feet_base(nxt, fpb);
    ik(p, fpb, q_prev);
  }
  Filters flt;
#pragma unroll
  for (int l = 0; l < 4; ++l)
#pragma unroll
    for (int i = 0; i < 3; ++i) flt.corr[l][i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) flt.verr[i] = 0.0f;
  flt.yerr = 0.0f;

  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < kRow; ++i) cur[i] = nxt[i];
    if (t + 1 < T) {  // the next row's loads are in flight during this tick
      const float* r = rows + (size_t)(t + 1) * kRow;
#pragma unroll
      for (int i = 0; i < kRow; ++i) nxt[i] = r[i];
    }
    State n;
    float q_plan[12], out[kTrace];
    Filters nf;
    tick(p, hf, cur, s, q_prev, flt, n, q_plan, nf, out);
    float* o = tr + (size_t)t * kTrace;
#pragma unroll
    for (int i = 0; i < kTrace; ++i) o[i] = out[i];
    if (t < nv) {  // ticks at or past n_valid leave the carry as it was
      s = n;
#pragma unroll
      for (int j = 0; j < 12; ++j) q_prev[j] = q_plan[j];
      flt = nf;
    }
  }
  store_state(s, state_out + (size_t)b * kState);
}

}  // namespace

#define TICK_STR_(x) #x
#define TICK_STR(x) TICK_STR_(x)
#define TICK_SCALAR_NAME(n) #n ":1,"
#define TICK_ARRAY_NAME(n, len) #n ":" TICK_STR(len) ","

// The constants' layout as "name:count," pairs in order: the float array
// `tick_run` takes holds them back to back.
extern "C" const char* tick_param_layout() {
  return TICK_SCALARS(TICK_SCALAR_NAME) TICK_ARRAYS(TICK_ARRAY_NAME);
}

extern "C" int tick_state_floats() { return kState; }
extern "C" int tick_trace_floats() { return kTrace; }

// Launches one chunk on `stream`: mode 0 plays `table` (B, T, 37) from
// `state_in` (B, 45) with per-episode `n_valid` (B,) and writes `state_out`
// (B, 45) and `traces` (B, T, 56); mode 1 holds for T steps (table, n_valid
// and traces unused).  `hf` is the (rows, cols) height grid.  Returns the
// launch's CUDA error (0 when it was accepted).
extern "C" int tick_run(const float* params, int n_params, int frame, int use_force_ff, const void* table,
                        const void* state_in, const void* n_valid, const void* hf, int hf_rows, int hf_cols,
                        void* state_out, void* traces, int B, int T, int mode, void* stream) {
  TickParams p;
  const int want = (int)(offsetof(TickParams, frame) / sizeof(float));
  if (n_params != want || B <= 0 || T < 0 || hf_rows < 2 || hf_cols < 2 || (mode != 0 && mode != 1) ||
      frame < 0 || frame > 2 || (mode == 0 && (!table || !n_valid || !traces)))
    return (int)cudaErrorInvalidValue;
  float* dst = reinterpret_cast<float*>(&p);
  for (int i = 0; i < n_params; ++i) dst[i] = params[i];
  p.frame = frame;
  p.use_force_ff = use_force_ff;
  p.hf_rows = hf_rows;
  p.hf_cols = hf_cols;
  const float* table_f = static_cast<const float*>(table);
  const float* state_in_f = static_cast<const float*>(state_in);
  const int* n_valid_i = static_cast<const int*>(n_valid);
  const float* hf_f = static_cast<const float*>(hf);
  float* state_out_f = static_cast<float*>(state_out);
  float* traces_f = static_cast<float*>(traces);
  void* args[] = {&p, &table_f, &state_in_f, &n_valid_i, &hf_f, &state_out_f, &traces_f, &B, &T, &mode};
  cudaError_t err = cudaLaunchKernel(tick_kernel, dim3((B + kThreads - 1) / kThreads), dim3(kThreads), args,
                                     0, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
