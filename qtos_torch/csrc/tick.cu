// The 1 kHz control loop of qtos_torch as one kernel launch per chunk.
//
// Replaces the compiled `lax.scan` of qtos_tpu's playback and stance warm-up
// (qtos_tpu/control/loop.py: `_scan_ticks`, `playback`, `stance_warmup`),
// which has no Pallas kernel: XLA compiles the whole scan into one program.
// The port's plain version is the eager tick of qtos_torch/control/loop.py
// (`_tick`, `_scan_ticks`, `_hold_ticks`), about 650 small kernels per tick.
//
// What bounds it on an H100 is the dependent chain of the ticks, not bytes:
// a launch moves B * T * (37 + 56) floats, the rows and the traces, and each
// tick needs the one before it.  So the design keeps on that chain only what
// the next tick needs, and spreads it over four lanes.  A block of 256
// threads holds 8 episodes and runs three phases, a block barrier between
// them:
//
//   1. Table pass, every thread, in parallel over (episode, tick): the
//      planned feet in the planned base frame and their IK for every row,
//      then the desired joint velocities (q_plan[t] - q_prev) / dt with
//      q_prev = q_plan[min(t, n_valid) - 1] (q_plan[0] when that is 0), into
//      the scratch.  These read only the table and n_valid.
//   2. Chain, warp 0: four lanes per episode, leg l on lane l.  Each lane
//      computes its leg (FK and Jacobian, the controller's IK, PD with the
//      force feed-forward, contact with stiction, the joint update) and all
//      four compute the base (rotation, Euler angles, filters, wrench,
//      inertia, base contact, Euler step) alike from the legs' forces taken
//      by shuffles; the carry stays in registers.  Each tick writes pos, q,
//      qd and tau of the trace row and the new quaternion into the scratch.
//      Groups past B run masked to the end: every lane reaches every
//      shuffle.
//   3. Trace pass, every thread, in parallel over (episode, tick): com_err,
//      ee_err, the world feet and the Euler angles of the trace row from the
//      state the chain recorded.
//
// Arithmetic.  Every value is the expression of the one-thread-per-episode
// version, which took every sum and product in the plain version's order on
// the CPU: 3x3 products and row-times-matrix left to right from the first
// term, the four feet summed in order 0..3, cross products as
// torch.linalg.cross, a tensor divided by a Python number by a true division.
// Built with --fmad=false (nvcc) or -ffp-contract=off (g++), and without fast
// math, so each product rounds on its own as it does there; only the thread
// that computes a value and the time it is computed have moved.  Constants
// come from Python (`qtos_torch/ops/tick.py`) in the layout
// `tick_param_layout()` names; nothing here repeats a number of the model.
//
// Modes.  0: playback of a (B, T, 37) table with per-episode `n_valid` (at
// t >= n_valid the carry is frozen and the trace row is still written from
// one tick past it); 1: stance hold, T steps of PD to the initial joints with
// zero desired velocity, no controller and no traces: phase 2 alone.

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

constexpr int kRow = 37;       // columns of a trajectory row
constexpr int kState = 45;     // pos 3, quat 4, v 3, w 3, q 12, qd 12, anchor 8
constexpr int kTrace = 56;     // com_err, ee_err, pos 3, feet 12, q 12, qd 12, tau 12, eul 3
constexpr int kEpisodes = 8;   // episodes per block, four lanes each: one warp's chain
constexpr int kThreads = 256;  // threads per block, all of which run phases 1 and 3
// The scratch row of one (episode, tick): per leg l at 9 l the planned foot
// in the planned base frame (3), its IK (3) and the desired joint velocities
// (3); at kQuat the quaternion after the tick.
constexpr int kPlanLeg = 9;
constexpr int kQuat = 36;
constexpr int kScratch = 40;
constexpr unsigned kFullMask = 0xffffffffu;

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

// The constants of one leg, picked once per lane (a register array indexed by
// the lane's leg would live in local memory).
struct Leg {
  float hip[3], gain[3], lateral, knee;
};

DEV Leg leg_params(const TickParams& p, int l) {
  Leg g;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (l == k) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        g.hip[j] = p.hips[3 * k + j];
        g.gain[j] = p.gain[3 * k + j];
      }
      g.lateral = p.lateral[k];
      g.knee = p.knee[k];
    }
  }
  return g;
}

// Foot of a leg relative to its hip (x, yb, zb) and, if J is given, its
// Jacobian d(foot)/d(q0, q1, q2); y is the leg's lateral offset.
DEV void leg_fk(const TickParams& p, const float* ql, float y, float f[3], float (*J)[3]) {
  const float s1 = sinf(ql[1]), s12 = sinf(ql[1] + ql[2]);
  const float c1 = cosf(ql[1]), c12 = cosf(ql[1] + ql[2]);
  const float x = -p.l_up * s1 - p.l_low * s12;
  const float z = -p.l_up * c1 - p.l_low * c12;
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

// Closed-form IK of one leg from its base-frame foot; `ee_shift` is added to
// z when it is not 0.  Clips an unreachable target to the workspace.
DEV void leg_ik(const TickParams& p, const float foot[3], const float hip[3], float d, float knee, float q[3]) {
  const float fz = p.ee_shift != 0.0f ? foot[2] + p.ee_shift : foot[2];
  const float vx = foot[0] - hip[0], vy = foot[1] - hip[1];
  const float vz = fz - hip[2];
  const float r2 = vy * vy + vz * vz;
  const float zeta = sqrtf(clamp_min(r2 - d * d, 1e-10f));
  float q0 = atan2f(vz, vy) - atan2f(-zeta, d);
  q0 = atan2f(sinf(q0), cosf(q0));
  const float px = vx, pz = -zeta;
  float c2 = (px * px + pz * pz - p.ik_l1l1 - p.ik_l2l2) / p.ik_2l1l2;
  c2 = clampf(c2, -1.0f, 1.0f);
  const float q2 = knee * acosf(c2);
  const float k1 = p.l_up + p.l_low * cosf(q2);
  const float k2 = p.l_low * sinf(q2);
  float q1 = atan2f(-px, -pz) - atan2f(k2, k1);
  q1 = atan2f(sinf(q1), cosf(q1));
  q[0] = q0;
  q[1] = q1;
  q[2] = q2;
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

// ---- sim/engine.py, sim/motor.py: one leg per lane ------------------------------

// The base's carry, the same on the four lanes of an episode, and the carry
// of the lane's leg.
struct Base {
  float pos[3], quat[4], v[3], w[3];
};
struct LegState {
  float q[3], qd[3], anchor[2];
};

// Kinematics of the lane's leg in a state: its Jacobian, the world lever
// arm, the world foot and its world velocity.
struct LegKin {
  float J[3][3], arm_w[3], feet_w[3], feet_vw[3];
};

DEV void leg_kinematics(const TickParams& p, const Leg& g, const Base& s, const float R[3][3],
                        const LegState& ls, LegKin& k) {
  float f[3], feet_b[3], vj[3];
  leg_fk(p, ls.q, g.lateral, f, k.J);
#pragma unroll
  for (int j = 0; j < 3; ++j) feet_b[j] = g.hip[j] + f[j];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    k.arm_w[i] = feet_b[0] * R[i][0] + feet_b[1] * R[i][1] + feet_b[2] * R[i][2];
    vj[i] = k.J[i][0] * ls.qd[0] + k.J[i][1] * ls.qd[1] + k.J[i][2] * ls.qd[2];
  }
  float c[3];
  cross3(s.w, k.arm_w, c);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    k.feet_w[i] = s.pos[i] + k.arm_w[i];
    k.feet_vw[i] = s.v[i] + c[i] + (vj[0] * R[i][0] + vj[1] * R[i][1] + vj[2] * R[i][2]);
  }
}

DEV void pd_torque(const TickParams& p, const Leg& g, const float q_des[3], const float* qd_des,
                   const LegState& ls, const float* tau_ff, float tau[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float dqd = qd_des ? qd_des[j] - ls.qd[j] : 0.0f - ls.qd[j];
    float t = p.kp * g.gain[j] * (q_des[j] - ls.q[j]) + p.kd * g.gain[j] * dqd;
    if (tau_ff) t = t + tau_ff[j];
    tau[j] = clampf(t, -p.t_max, p.t_max);
  }
}

// One semi-implicit Euler step of the episode under the lane's joint torques
// `tau`, given the lane's leg kinematics and the base rotation R: the
// contact of the lane's foot; the wrench of the four feet, taken from the
// group's lanes by shuffles (`lane0` is the group's first lane) and summed in
// leg order; the base's step, the same on every lane; the lane's joints.
DEV void step(const TickParams& p, const float* __restrict__ hf, int lane0, const Base& s, const LegState& ls,
              const float R[3][3], const LegKin& k, const float tau[3], Base& n, LegState& nl) {
  // Penalty contact with stiction at the lane's foot.
  float fc[3];
  {
    const float h = height_at(p, hf, k.feet_w[0], k.feet_w[1]);
    const float pen = h - k.feet_w[2];
    const bool active = pen > 0.0f;
    const float gate = clampf(pen / p.damp_pen, 0.0f, 1.0f);
    float fn = active ? p.contact_kp * pen - p.contact_kd * gate * k.feet_vw[2] : 0.0f;
    fn = clampf(fn, 0.0f, 200.0f);
    float ft[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float raw = -p.tangent_kp * (k.feet_w[i] - ls.anchor[i]) - p.tangent_kd * k.feet_vw[i];
      ft[i] = active ? raw : 0.0f;
    }
    const float mag = sqrtf(ft[0] * ft[0] + ft[1] * ft[1]);
    const float limit = p.friction * fn;
    const float scale = clamp_max(limit / clamp_min(mag, 1e-9f), 1.0f);
    const bool sliding = (mag > limit + 1e-9f) && active;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ft[i] = ft[i] * scale;
      const float slide = k.feet_w[i] + (ft[i] + p.tangent_kd * k.feet_vw[i]) / p.tangent_kp;
      nl.anchor[i] = active ? (sliding ? slide : ls.anchor[i]) : k.feet_w[i];
      fc[i] = ft[i];
    }
    fc[2] = fn;
  }
  float cl[3];
  cross3(k.arm_w, fc, cl);

  // The four legs' forces and moments, on every lane of the group.
  float fcs[4][3], cs[4][3];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      fcs[l][i] = __shfl_sync(kFullMask, fc[i], lane0 + l);
      cs[l][i] = __shfl_sync(kFullMask, cl[i], lane0 + l);
    }
  }

  // Base wrench: feet, gravity, and the base collision sphere.
  const float hb = height_at(p, hf, s.pos[0], s.pos[1]);
  const float penb = hb + p.base_radius - s.pos[2];
  const float fbz = clampf(penb > 0.0f ? p.contact_kp * penb - p.contact_kd * s.v[2] : 0.0f, 0.0f, 200.0f);
  float F[3], T[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 3; ++i) F[i] = fcs[0][i] + fcs[1][i] + fcs[2][i] + fcs[3][i];
  F[2] = F[2] + p.weight_z + fbz;
#pragma unroll
  for (int l = 0; l < 4; ++l)
#pragma unroll
    for (int i = 0; i < 3; ++i) T[i] = l == 0 ? cs[l][i] : T[i] + cs[l][i];
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

  // The lane's joints: motor torque and the contact reaction J^T R^T f.
  float fb[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) fb[j] = fc[0] * R[0][j] + fc[1] * R[1][j] + fc[2] * R[2][j];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float tc = fb[0] * k.J[0][j] + fb[1] * k.J[1][j] + fb[2] * k.J[2][j];
    const float qdd = (tau[j] + tc - p.joint_damping * ls.qd[j]) / p.joint_inertia;
    nl.qd[j] = ls.qd[j] + p.dt * qdd;
    nl.q[j] = ls.q[j] + p.dt * nl.qd[j];
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

// The controller's filters: the correction of the lane's leg, and the
// base's velocity and yaw errors (the same on the four lanes).
struct Filters {
  float corr[3], verr[3], yerr;
};

// What one lane reads of a tick's row and of its scratch row: the planned
// base position, yaw and velocity, and the lane's leg's planned force and
// foot; the planned foot in the planned base frame, the planned joints and
// the desired joint velocities of phase 1.
struct RowIn {
  float r[3], yaw, v[3], f[3], foot[3], fpb[3], q_plan[3], qd_des[3];
};

DEV void load_row(const float* row, const float* plan, int l, RowIn& in) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    in.r[i] = row[1 + i];
    in.v[i] = row[19 + i];
    in.f[i] = row[25 + 3 * l + i];
    in.foot[i] = row[7 + 3 * l + i];
    in.fpb[i] = plan[kPlanLeg * l + i];
    in.q_plan[i] = plan[kPlanLeg * l + 3 + i];
    in.qd_des[i] = plan[kPlanLeg * l + 6 + i];
  }
  in.yaw = row[6];
}

// The joint targets of the lane's leg (`_tick`'s three frames) and the
// updated filters; tau_ff the force feed-forward when it is on.
DEV void controller(const TickParams& p, const Leg& g, const RowIn& in, const Base& s, const float R[3][3],
                    const LegKin& k, const Filters& flt, float q_des[3], Filters& nf, float tau_ff[3]) {
  float eul_live[3];
  rot_to_euler(R, eul_live);
  nf = flt;
  if (p.frame == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) q_des[j] = in.q_plan[j];
  } else if (p.frame == 1) {
    float corr_w[3], corr_b[3], verr_w[3], cp_w[3], cp_b[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) corr_w[i] = clampf(p.base_corr * (s.pos[i] - in.r[i]), -p.max_corr, p.max_corr);
#pragma unroll
    for (int j = 0; j < 3; ++j) corr_b[j] = corr_w[0] * R[0][j] + corr_w[1] * R[1][j] + corr_w[2] * R[2][j];
    verr_w[0] = (s.v[0] - in.v[0]) * 1.0f;
    verr_w[1] = (s.v[1] - in.v[1]) * 1.0f;
    verr_w[2] = (s.v[2] - in.v[2]) * 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      nf.verr[i] = flt.verr[i] + p.beta * (verr_w[i] - flt.verr[i]);
      cp_w[i] = clampf(p.vel_corr * nf.verr[i], -p.max_corr, p.max_corr);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) cp_b[j] = cp_w[0] * R[0][j] + cp_w[1] * R[1][j] + cp_w[2] * R[2][j];
    const float yd = eul_live[2] - in.yaw;
    const float yaw_err = atan2f(sinf(yd), cosf(yd));
    nf.yerr = flt.yerr + p.gamma * (yaw_err - flt.yerr);
    const float yawc = clampf(p.yaw_corr * nf.yerr, -p.max_yaw_corr, p.max_yaw_corr);
    float delta[3], rd[2];
    if (in.f[2] > 1.0f) {  // planned contact: +err and +yaw
      rotz_delta(in.fpb, cosf(yawc) - 1.0f, sinf(yawc), rd);
      delta[0] = corr_b[0] + rd[0];
      delta[1] = corr_b[1] + rd[1];
      delta[2] = corr_b[2] + 0.0f;
    } else {               // swing: -err and the capture point in xy, -yaw
      rotz_delta(in.fpb, cosf(-yawc) - 1.0f, sinf(-yawc), rd);
      delta[0] = (-corr_b[0] + cp_b[0]) * 1.0f + rd[0];
      delta[1] = (-corr_b[1] + cp_b[1]) * 1.0f + rd[1];
      delta[2] = (-corr_b[2] + cp_b[2]) * 0.0f + 0.0f;
    }
    float target[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      nf.corr[i] = flt.corr[i] + p.alpha * (delta[i] - flt.corr[i]);
      target[i] = in.fpb[i] + nf.corr[i];
    }
    leg_ik(p, target, g.hip, g.lateral, g.knee, q_des);
  } else {
    float shift[3], d[3], feet_b[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) shift[i] = (s.pos[i] - in.r[i]) * p.one_minus_base_corr;
#pragma unroll
    for (int i = 0; i < 3; ++i) d[i] = in.foot[i] + shift[i] - s.pos[i];
#pragma unroll
    for (int j = 0; j < 3; ++j) feet_b[j] = d[0] * R[0][j] + d[1] * R[1][j] + d[2] * R[2][j];
    leg_ik(p, feet_b, g.hip, g.lateral, g.knee, q_des);
  }
  if (p.use_force_ff) {
    // -J^T R(eul_live)^T f: the reaction to the planned contact force
    float Rf[3][3], fb[3];
    euler_to_rot(eul_live, Rf);
#pragma unroll
    for (int j = 0; j < 3; ++j) fb[j] = in.f[0] * Rf[0][j] + in.f[1] * Rf[1][j] + in.f[2] * Rf[2][j];
#pragma unroll
    for (int j = 0; j < 3; ++j) tau_ff[j] = -(fb[0] * k.J[0][j] + fb[1] * k.J[1][j] + fb[2] * k.J[2][j]);
  }
}

// Picks a[l] of a register array with a runtime l, without local memory.
template <int N>
DEV float pick(const float (&a)[N], int l) {
  float r = a[0];
#pragma unroll
  for (int i = 1; i < N; ++i) r = l == i ? a[i] : r;
  return r;
}

DEV void load_state(const float* x, int l, Base& s, LegState& ls) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.pos[i] = x[i];
    s.v[i] = x[7 + i];
    s.w[i] = x[10 + i];
    ls.q[i] = x[13 + 3 * l + i];
    ls.qd[i] = x[25 + 3 * l + i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) s.quat[i] = x[3 + i];
  ls.anchor[0] = x[37 + 2 * l];
  ls.anchor[1] = x[38 + 2 * l];
}

// Each lane writes its leg; lane l < 3 writes pos[l], v[l] and w[l], lane l
// quat[l].
DEV void store_state(const Base& s, const LegState& ls, int l, float* x) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    x[13 + 3 * l + i] = ls.q[i];
    x[25 + 3 * l + i] = ls.qd[i];
  }
  x[37 + 2 * l] = ls.anchor[0];
  x[38 + 2 * l] = ls.anchor[1];
  x[3 + l] = pick(s.quat, l);
  if (l < 3) {
    x[l] = pick(s.pos, l);
    x[7 + l] = pick(s.v, l);
    x[10 + l] = pick(s.w, l);
  }
}

// Phase 1 for rows [0, n * T) of the block's episodes from b0.
DEV void plan_pass(const TickParams& p, const float* __restrict__ table, const int* __restrict__ n_valid,
                   float* scratch, int b0, int n, int T) {
  const int rows = n * T;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const size_t r = (size_t)b0 * T + i;
    float fpb[4][3], q_plan[12];
    plan_feet_base(table + r * kRow, fpb);
#pragma unroll
    for (int l = 0; l < 4; ++l) leg_ik(p, fpb[l], p.hips + 3 * l, p.lateral[l], p.knee[l], q_plan + 3 * l);
    float* o = scratch + r * kScratch;
#pragma unroll
    for (int l = 0; l < 4; ++l)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        o[kPlanLeg * l + j] = fpb[l][j];
        o[kPlanLeg * l + 3 + j] = q_plan[3 * l + j];
      }
  }
  __syncthreads();
  // q_prev at tick t is the plan of the carry's last committed tick: ticks
  // at or past n_valid commit nothing.
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const int t = i % T;
    const int k = min(t, n_valid[b0 + i / T]);
    const size_t r = (size_t)b0 * T + i;
    const float* prev = scratch + (r - t + (k > 0 ? k - 1 : 0)) * kScratch;
    float* o = scratch + r * kScratch;
#pragma unroll
    for (int l = 0; l < 4; ++l)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        o[kPlanLeg * l + 6 + j] = (o[kPlanLeg * l + 3 + j] - prev[kPlanLeg * l + 3 + j]) / p.dt;
  }
}

// Phase 3 for rows [0, n * T) of the block's episodes from b0: the trace
// entries of the state after each tick that the chain left out.
DEV void trace_pass(const TickParams& p, const float* __restrict__ table, const float* scratch, float* traces,
                    int b0, int n, int T) {
  const int rows = n * T;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const size_t r = (size_t)b0 * T + i;
    const float* row = table + r * kRow;
    float* out = traces + r * kTrace;
    float pos[3], q[12], quat[4];
#pragma unroll
    for (int j = 0; j < 3; ++j) pos[j] = out[2 + j];
#pragma unroll
    for (int j = 0; j < 12; ++j) q[j] = out[17 + j];
#pragma unroll
    for (int j = 0; j < 4; ++j) quat[j] = scratch[r * kScratch + kQuat + j];
    float Rq[3][3], eul[3], Rn[3][3], feet_b[4][3];
    quat_to_rot(quat, Rq);
    rot_to_euler(Rq, eul);
    euler_to_rot(eul, Rn);
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      float f[3];
      leg_fk(p, q + 3 * l, p.lateral[l], f, nullptr);
#pragma unroll
      for (int j = 0; j < 3; ++j) feet_b[l][j] = p.hips[3 * l + j] + f[j];
    }
    out[0] = norm3(pos[0] - row[1], pos[1] - row[2], pos[2] - row[3]);
    float ee = 0.0f;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      float fw[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        fw[j] = pos[j] + (feet_b[l][0] * Rn[j][0] + feet_b[l][1] * Rn[j][1] + feet_b[l][2] * Rn[j][2]);
        out[5 + 3 * l + j] = fw[j];
      }
      const float e = norm3(fw[0] - row[7 + 3 * l], fw[1] - row[8 + 3 * l], fw[2] - row[9 + 3 * l]);
      ee = l == 0 ? e : ee + e;
    }
    out[1] = ee / 4.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) out[53 + j] = eul[j];
  }
}

// One block per SM is enough: without the 1, ptxas held the kernel to 128
// registers and spilled.
__global__ void __launch_bounds__(kThreads, 1)
tick_kernel(TickParams p, const float* __restrict__ table, const float* __restrict__ state_in,
            const int* __restrict__ n_valid, const float* __restrict__ hf, float* __restrict__ state_out,
            float* traces, float* scratch, int B, int T, int mode) {
  const int b0 = blockIdx.x * kEpisodes;
  const int n = min(kEpisodes, B - b0);  // the block's episodes
  if (mode == 0) {
    plan_pass(p, table, n_valid, scratch, b0, n, T);
    __syncthreads();
  }
  if (threadIdx.x < 32) {
    // Phase 2: lane 4 g + l carries leg l of episode b0 + g.
    const int lane = threadIdx.x, l = lane & 3, lane0 = lane & ~3;
    const int b = b0 + (lane >> 2);
    const bool live = b < B;
    const int bl = live ? b : B - 1;  // a group past B plays the last episode again, writing nothing
    const Leg g = leg_params(p, l);
    Base s;
    LegState ls;
    load_state(state_in + (size_t)bl * kState, l, s, ls);
    if (mode == 1) {  // stance hold: PD to the initial joints, zero desired velocity
      float q_hold[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) q_hold[j] = ls.q[j];
      for (int t = 0; t < T; ++t) {
        float R[3][3];
        quat_to_rot(s.quat, R);
        LegKin k;
        leg_kinematics(p, g, s, R, ls, k);
        float tau[3];
        pd_torque(p, g, q_hold, nullptr, ls, nullptr, tau);
        Base ns;
        LegState nl;
        step(p, hf, lane0, s, ls, R, k, tau, ns, nl);
        s = ns;
        ls = nl;
      }
    } else {
      const float* rows = table + (size_t)bl * T * kRow;
      const float* plan = scratch + (size_t)bl * T * kScratch;
      float* tr = traces + (size_t)bl * T * kTrace;
      float* quats = scratch + (size_t)bl * T * kScratch + kQuat;
      const int nv = n_valid[bl];
      Filters flt;
#pragma unroll
      for (int i = 0; i < 3; ++i) flt.corr[i] = flt.verr[i] = 0.0f;
      flt.yerr = 0.0f;
      RowIn nxt;
      if (T > 0) load_row(rows, plan, l, nxt);
      for (int t = 0; t < T; ++t) {
        const RowIn in = nxt;
        if (t + 1 < T)  // the next row's loads are in flight during this tick
          load_row(rows + (size_t)(t + 1) * kRow, plan + (size_t)(t + 1) * kScratch, l, nxt);
        float R[3][3];
        quat_to_rot(s.quat, R);
        LegKin k;
        leg_kinematics(p, g, s, R, ls, k);
        float q_des[3], tau_ff[3], tau[3];
        Filters nf;
        controller(p, g, in, s, R, k, flt, q_des, nf, tau_ff);
        pd_torque(p, g, q_des, in.qd_des, ls, p.use_force_ff ? tau_ff : nullptr, tau);
        Base ns;
        LegState nl;
        step(p, hf, lane0, s, ls, R, k, tau, ns, nl);
        if (live) {
          float* o = tr + (size_t)t * kTrace;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            o[17 + 3 * l + j] = nl.q[j];
            o[29 + 3 * l + j] = nl.qd[j];
            o[41 + 3 * l + j] = tau[j];
          }
          if (l < 3) o[2 + l] = pick(ns.pos, l);
          quats[(size_t)t * kScratch + l] = pick(ns.quat, l);
        }
        if (t < nv) {  // ticks at or past n_valid leave the carry as it was
          s = ns;
          ls = nl;
          flt = nf;
        }
      }
    }
    if (live) store_state(s, ls, l, state_out + (size_t)b * kState);
  }
  if (mode == 0) {
    __syncthreads();
    trace_pass(p, table, scratch, traces, b0, n, T);
  }
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
// Floats of scratch per (episode, tick) that a playback needs.
extern "C" int tick_scratch_floats() { return kScratch; }

// Launches one chunk on `stream`: mode 0 plays `table` (B, T, 37) from
// `state_in` (B, 45) with per-episode `n_valid` (B,) and writes `state_out`
// (B, 45) and `traces` (B, T, 56), using `scratch` (B, T,
// tick_scratch_floats()); mode 1 holds for T steps (table, n_valid, traces
// and scratch unused).  `hf` is the (rows, cols) height grid.  Returns the
// launch's CUDA error (0 when it was accepted).
extern "C" int tick_run(const float* params, int n_params, int frame, int use_force_ff, const void* table,
                        const void* state_in, const void* n_valid, const void* hf, int hf_rows, int hf_cols,
                        void* state_out, void* traces, void* scratch, int B, int T, int mode, void* stream) {
  TickParams p;
  const int want = (int)(offsetof(TickParams, frame) / sizeof(float));
  if (n_params != want || B <= 0 || T < 0 || hf_rows < 2 || hf_cols < 2 || (mode != 0 && mode != 1) ||
      frame < 0 || frame > 2 || (mode == 0 && (!table || !n_valid || !traces || !scratch)))
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
  float* scratch_f = static_cast<float*>(scratch);
  void* args[] = {&p, &table_f, &state_in_f, &n_valid_i, &hf_f, &state_out_f, &traces_f, &scratch_f,
                  &B, &T, &mode};
  cudaError_t err = cudaLaunchKernel(tick_kernel, dim3((B + kEpisodes - 1) / kEpisodes), dim3(kThreads), args,
                                     0, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
