// The humanoid's whole control step (B5), whole rollout (B6) and DeepMimic
// tracking reward (B7), float32, for sm_90a.
//
// Replaces the TPU kernels of deepmimic_diffusion_mujoco_tpu/physics/
// dynamics_pallas.py: control_step_pallas (:561; _kernel :539, _substep
// :303, _chol_solve6 :218), rollout_pallas (:830; _rollout_kernel :795,
// _rollout_env_step :776) and tracking_reward_pallas (:937; the components
// :725). Their plain versions, and the wrappers that launch these entry
// points, are physics/dynamics_kernel.py.
//
// What bounds it: the latency of each env's chain of dependent float
// operations (about 15,000 a substep: FK, PD, 37 contact points, RNEA, a
// 28-link zero-velocity ABA sweep, a 6x6 Cholesky, semi-implicit Euler; 17
// substeps a control step), against 1.4 KB of state read and written once.
// With one thread per env, N 4096 is one warp per SM, and a substep took
// 139k SM cycles.
//
// Design: one env over a group of L lanes (L = 8 or 16) of one warp, E envs
// a block, the env's state and per-link, per-body arrays in a Slot of the
// block's shared memory; the lanes meet at __syncwarp over the group's mask.
// The lanes run the same instructions on lane-dependent data: every table a
// lane reads with its own index is a __device__ array of humanoid_tables.h,
// generated by physics/dynamics_kernel.py:tables_header().
// - Chains: lanes 0-4 walk the tree's five root-to-leaf paths (chest and
//   neck, the two arms, the two legs) slot by slot, at most 7 slots. A link
//   belongs to one chain; the arms walk the chest's three links again for
//   their FK and velocities but write nothing of them.
// - A substep: (1) chains: FK, motion subspaces, velocity and bias
//   acceleration sweeps, PD torques; (2) every lane: its bodies' spatial
//   inertias, contacts (a body's contacts in order on its lane), body
//   forces and IO + h K; (3) chains, leaf to root: the RNEA force sweep and
//   the ABA backward sweep in one pass; the chains that hang from the
//   chest's link 2 leave their contribution in the Slot, and the chest lane
//   adds them in the plain version's order; (4) lane 0: the root's sums (in
//   the same order), its 6x6 Cholesky solve and Euler step; (5) chains, root
//   to leaf: accelerations and each link's Euler step.
// - The reward: the chains walk the FK of the state and of the reference;
//   every lane takes its share of joints, velocities, end effectors and
//   geoms; the partial sums meet in lane order.
// - B6 keeps its T loop in the launch. An env that is done before a step
//   skips its substeps (a branch uniform over its group).
// - Structural zeros fold at compile time: the root's unit translation
//   subspaces, anchors off the body's x axis and slots where no chain has an
//   anchor, the zero blocks of the spatial inertias and of the contact
//   damping. Results then differ from the plain version's only in the sign
//   of zeros and by the rounding of contracted FMAs and of sums taken in
//   another order; every sum across lanes is in a fixed order, so two
//   launches give the same bits.
//
// No fast math: rsqrtf where the JAX kernel uses lax.rsqrt, sincosf and
// IEEE sqrtf and division elsewhere. Launches go on the caller's stream;
// each entry point returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

#include "humanoid_tables.h"

// phase stamps: nothing, unless a probe build defines them
#ifndef HUM_PHASE
#define HUM_PHASE(k) \
  do {               \
  } while (0)
#define HUM_MARK() \
  do {             \
  } while (0)
#endif

#define HD __device__ __forceinline__

namespace hum {

using T = Tables;

template <int I>
struct Int {
  static constexpr int value = I;
};

// f(Int<I>{}) for I = B .. E-1, each I a compile-time constant
template <int B, int E, class F>
HD void static_for(F&& f) {
  if constexpr (B < E) {
    f(Int<B>{});
    static_for<B + 1, E>(f);
  }
}

// f(Int<I>{}) for I = E-1 down to B
template <int B, int E, class F>
HD void static_for_down(F&& f) {
  if constexpr (B < E) {
    f(Int<E - 1>{});
    static_for_down<B, E - 1>(f);
  }
}

#define CI(i) decltype(i)::value

constexpr int MAX_THREADS = 256;

struct V3 {
  float x, y, z;
};
struct Q4 {
  float w, x, y, z;
};
struct SV {  // spatial vector: motion [w; v_O] or force [n_O; f]
  float a[6];
};
struct S6 {  // symmetric 6x6, upper triangle by rows
  float m[21];
};

struct StepParams {  // per launch; equal to dynamics_kernel._StepParams
  float h, half_h;
  float kp[NJ], kd[NJ], d_extra[NJ];
  float fall_height;
  int substeps, contacts, limits;
};
constexpr int PARAMS_BYTES = (sizeof(StepParams) + 15) / 16 * 16;

// One env's state and the arrays its lanes share.
struct Slot {
  float qp[NQ], qv[NV], tg[NQ], rqv[NV];      // state, this step's target and reference
  float pos[NB][3], quat[NB][4];              // body poses (the reward: of the state)
  float rpos[NB][3], rquat[NB][4];            // the reward: body poses of the reference
  float vb[NB][6], ab[NB][6];                 // body velocity, RNEA bias acceleration
  float sc[NJ][2];                            // sin, cos of half of each hinge angle
  float S[NJ][6];                             // motion subspace
  float fb[NB][6];                            // body force (RNEA)
  float IA0[NB][21];                          // IO + h K
  float work[WORK_FLOATS];                    // contact_of(), then U_of() and join_of()
  float a_root[6], a_join[6];                 // root and JOIN_LINK accelerations
  float part[MAX_LANES][9];                   // the reward's partial sums
};
static_assert(sizeof(Slot) == 4 * SLOT_FLOATS, "Slot must match dynamics_kernel.SLOT_FLOATS");
static_assert(WORK_FLOATS >= 8 * NC && WORK_FLOATS >= 6 * NJ + 33 * NROLES, "Slot::work");

// Slot::work holds, in a substep's phase (2), each contact point's x (3), f (3),
// c_t and W2; from phase (3) on, each link's IA S (6), then each chain's Ia
// (21), pa (6) and fl (6) to its parent.
__device__ __forceinline__ float* contact_of(Slot& s, int c) { return s.work + 8 * c; }
__device__ __forceinline__ float* U_of(Slot& s, int li) { return s.work + 6 * li; }
__device__ __forceinline__ float* join_of(Slot& s, int r) { return s.work + 6 * NJ + 33 * r; }

HD constexpr int sidx(int i, int j) {
  return i <= j ? i * 6 - i * (i - 1) / 2 + (j - i) : j * 6 - j * (j - 1) / 2 + (i - j);
}
// entries that are zero in every body's spatial inertia and contact damping:
// the B block's diagonal and the D block off the diagonal
HD constexpr bool io_zero(int i, int j) {
  return (i < 3 && j == i + 3) || (j < 3 && i == j + 3) || (i >= 3 && j >= 3 && i != j);
}

HD V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
HD float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
HD V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
HD V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
HD V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }

HD Q4 qmul(Q4 a, Q4 b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

// v + 2 qw (qv x v) + 2 qv x (qv x v)
HD V3 qrot(Q4 q, V3 v) {
  V3 qv = {q.x, q.y, q.z};
  V3 t = scale(cross(qv, v), 2.0f);
  return add(add(v, scale(t, q.w)), cross(qv, t));
}
// qrot(q, (px, 0, 0))
HD V3 qrot_x(Q4 q, float px) {
  float ty = 2.0f * (q.z * px), tz = 2.0f * (-(q.y * px));
  return {px + (q.y * tz - q.z * ty), q.w * ty - q.x * tz, q.w * tz + q.x * ty};
}
// qrot(q, e_K)
template <int K>
HD V3 qrot_e(Q4 q) {
  if constexpr (K == 0) return qrot_x(q, 1.f);
  if constexpr (K == 1) {
    float tx = 2.0f * (-q.z), tz = 2.0f * q.x;
    return {q.w * tx + q.y * tz, 1.f + (q.z * tx - q.x * tz), q.w * tz - q.y * tx};
  }
  if constexpr (K == 2) {
    float tx = 2.0f * q.y, ty = 2.0f * (-q.x);
    return {q.w * tx - q.z * ty, q.w * ty + q.z * tx, 1.f + (q.x * ty - q.y * tx)};
  }
}

HD V3 top(const SV& s) { return {s.a[0], s.a[1], s.a[2]}; }
HD V3 bot(const SV& s) { return {s.a[3], s.a[4], s.a[5]}; }
HD SV cat(V3 t, V3 b) { return {{t.x, t.y, t.z, b.x, b.y, b.z}}; }

HD SV sadd(const SV& a, const SV& b) {
  SV r;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.a[k] = a.a[k] + b.a[k];
  return r;
}
HD SV ssub(const SV& a, const SV& b) {
  SV r;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.a[k] = a.a[k] - b.a[k];
  return r;
}
HD SV sscale(const SV& a, float s) {
  SV r;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.a[k] = a.a[k] * s;
  return r;
}
HD float sdot(const SV& a, const SV& b) {
  float s = a.a[0] * b.a[0];
#pragma unroll
  for (int k = 1; k < 6; ++k) s = s + a.a[k] * b.a[k];
  return s;
}
HD SV szero() { return {{0.f, 0.f, 0.f, 0.f, 0.f, 0.f}}; }
HD S6 s6zero() {
  S6 r;
#pragma unroll
  for (int k = 0; k < 21; ++k) r.m[k] = 0.f;
  return r;
}
HD S6 s6add(const S6& a, const float* b) {
  S6 r;
#pragma unroll
  for (int k = 0; k < 21; ++k) r.m[k] = a.m[k] + b[k];
  return r;
}

// spatial motion cross product a x_m b
HD SV mcross(const SV& a, const SV& b) {
  V3 w = top(a), vo = bot(a);
  return cat(cross(w, top(b)), add(cross(w, bot(b)), cross(vo, top(b))));
}
// spatial force cross product a x* f
HD SV fcross(const SV& a, const SV& f) {
  V3 w = top(a), vo = bot(a);
  return cat(add(cross(w, top(f)), cross(vo, bot(f))), cross(w, bot(f)));
}

// M v, M symmetric; with IO, the entries io_zero() names are skipped
template <bool IO = false>
HD SV mat6vec(const S6& M, const SV& v) {
  SV r;
  static_for<0, 6>([&](auto i_) {
    constexpr int i = CI(i_);
    float s = 0.f;
    bool first = true;
    static_for<0, 6>([&](auto j_) {
      constexpr int j = CI(j_);
      if constexpr (!(IO && io_zero(i, j))) {
        s = first ? M.m[sidx(i, j)] * v.a[j] : s + M.m[sidx(i, j)] * v.a[j];
        first = false;
      }
    });
    r.a[i] = s;
  });
  return r;
}

HD V3 ld3(const float* p) { return {p[0], p[1], p[2]}; }
HD void st3(float* p, V3 v) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
}
HD Q4 ld4(const float* p) { return {p[0], p[1], p[2], p[3]}; }
HD void st4(float* p, Q4 q) {
  p[0] = q.w;
  p[1] = q.x;
  p[2] = q.y;
  p[3] = q.z;
}
HD SV ld6(const float* p) { return {{p[0], p[1], p[2], p[3], p[4], p[5]}}; }
HD void st6(float* p, const SV& v) {
#pragma unroll
  for (int k = 0; k < 6; ++k) p[k] = v.a[k];
}
HD S6 ld21(const float* p) {
  S6 r;
#pragma unroll
  for (int k = 0; k < 21; ++k) r.m[k] = p[k];
  return r;
}

// ---------------------------------------------------------------------------
// The lane group
// ---------------------------------------------------------------------------

// the group's lanes within the warp
template <int L>
HD unsigned group_mask() {
  if constexpr (L == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << L) - 1u) << ((threadIdx.x & 31) / L * L);
  }
}

// each lane's share of the reward's and the substep's items (-1 pads)
template <int L>
struct Lanes;
template <>
struct Lanes<8> {
  static constexpr int NBODY = sizeof(BODIES_L8[0]) / sizeof(int);
  static constexpr int NJOINT = sizeof(JOINTS_L8[0]) / sizeof(int);
  static constexpr int NEEL = sizeof(EES_L8[0]) / sizeof(int);
  static constexpr int NGEOM = sizeof(GEOMS_L8[0]) / sizeof(int);
  HD static const int* bodies(int l) { return BODIES_L8[l]; }
  HD static const int* joints(int l) { return JOINTS_L8[l]; }
  HD static const int* ees(int l) { return EES_L8[l]; }
  HD static const int* geoms(int l) { return GEOMS_L8[l]; }
};
template <>
struct Lanes<16> {
  static constexpr int NBODY = sizeof(BODIES_L16[0]) / sizeof(int);
  static constexpr int NJOINT = sizeof(JOINTS_L16[0]) / sizeof(int);
  static constexpr int NEEL = sizeof(EES_L16[0]) / sizeof(int);
  static constexpr int NGEOM = sizeof(GEOMS_L16[0]) / sizeof(int);
  HD static const int* bodies(int l) { return BODIES_L16[l]; }
  HD static const int* joints(int l) { return JOINTS_L16[l]; }
  HD static const int* ees(int l) { return EES_L16[l]; }
  HD static const int* geoms(int l) { return GEOMS_L16[l]; }
};

// the group's copy of one row: lane l moves elements l, l + L, ...
HD void load_row(float* dst, const float* __restrict__ src, int n, int lane, int L) {
  for (int k = lane; k < n; k += L) dst[k] = src[k];
}
HD void store_row(float* __restrict__ dst, const float* src, int n, int lane, int L) {
  for (int k = lane; k < n; k += L) dst[k] = src[k];
}

// ---------------------------------------------------------------------------
// The root's pose and spatial terms (every lane computes them)
// ---------------------------------------------------------------------------

struct Root {
  V3 p0;
  Q4 q0;
  V3 n[3];    // the body-frame rotation axes in the world: Sr[3 + k] = (n_k, p0 x n_k)
  SV v, a_b;  // the root's velocity and RNEA bias acceleration (gravity included)
};

HD void root_pose(const float* qp, V3& p0, Q4& q0) {
  float inv = rsqrtf(qp[3] * qp[3] + qp[4] * qp[4] + qp[5] * qp[5] + qp[6] * qp[6]);
  p0 = {qp[0], qp[1], qp[2]};
  q0 = {qp[3] * inv, qp[4] * inv, qp[5] * inv, qp[6] * inv};
}

// v_root = sum_k Sr[k] qv[k] with Sr[k] = e_{3+k} for k < 3
HD Root root_terms(const float* qp, const float* qv) {
  Root R;
  root_pose(qp, R.p0, R.q0);
  R.n[0] = qrot_e<0>(R.q0);
  R.n[1] = qrot_e<1>(R.q0);
  R.n[2] = qrot_e<2>(R.q0);
  V3 c0 = cross(R.p0, R.n[0]), c1 = cross(R.p0, R.n[1]), c2 = cross(R.p0, R.n[2]);
  V3 w = add(add(scale(R.n[0], qv[3]), scale(R.n[1], qv[4])), scale(R.n[2], qv[5]));
  V3 cw = add(add(scale(c0, qv[3]), scale(c1, qv[4])), scale(c2, qv[5]));
  R.v = cat(w, add({qv[0], qv[1], qv[2]}, cw));
  R.a_b = mcross(R.v, cat(w, cw));
  R.a_b.a[5] = GRAVITY + R.a_b.a[5];
  return R;
}

// ---------------------------------------------------------------------------
// (1) chains: FK; with DYN also subspaces, velocities, bias accelerations
// and PD torques. Writes the poses of the bodies the chain owns.
// ---------------------------------------------------------------------------

HD float pd_torque(int li, float q, float qd, float t, const StepParams& p) {
  float tau = p.kp[li] * (t - q) - p.kd[li] * qd;
  tau = tau - JOINT_STIFFNESS * q - JOINT_DAMPING * qd;
  if (p.limits) {
    float over = fmaxf(q - D_LIMIT_HI[li], 0.f);
    float under = fmaxf(D_LIMIT_LO[li] - q, 0.f);
    float gate = (over > 0.f || under > 0.f) ? 1.f : 0.f;
    tau = tau - LIMIT_K * over + LIMIT_K * under - LIMIT_C * qd * gate;
  }
  return tau;
}

template <bool DYN>
HD void chain_walk(Slot& s, const float* qp, float (*pos)[3], float (*quat)[4], int r, V3 p0,
                   Q4 q0, const SV& v_root, const SV& a_root_b, const StepParams* p,
                   float (&tau)[NSLOTS]) {
  V3 ppar = p0, tl = {0.f, 0.f, 0.f};
  Q4 qpar = q0, ql = {1.f, 0.f, 0.f, 0.f};
  V3 off = ld3(CH_OFFSET[r][0]);
  int body = CH_START[r][0];
  bool owned_last = false;
  SV vp = v_root, ap = a_root_b;
  static_for<0, NSLOTS>([&](auto k_) {
    constexpr int k = CI(k_);
    const int li = CH_LINK[r][k];
    if (li < 0) return;
    const bool owned = CH_OWNED[r][k] != 0;
    if constexpr (k > 0) {
      const int st = CH_START[r][k];
      if (st >= 0) {  // the body before this slot is complete
        V3 pb = add(ppar, qrot(qpar, add(off, tl)));
        Q4 qb = qmul(qpar, ql);
        if (owned_last) {
          st3(pos[body], pb);
          st4(quat[body], qb);
        }
        ppar = pb;
        qpar = qb;
        ql = {1.f, 0.f, 0.f, 0.f};
        tl = {0.f, 0.f, 0.f};
        off = ld3(CH_OFFSET[r][k]);
        body = st;
      }
    }
    const V3 a = ld3(CH_AXIS[r][k]);
    const float px = CH_ANCHOR_X[r][k];
    const float q = qp[7 + li];
    if constexpr (DYN) {
      V3 ax = qrot(qpar, qrot(ql, a));
      V3 lp = add(off, tl);
      if constexpr (T::SLOT_HAS_ANCHOR[k] != 0) lp = add(lp, qrot_x(ql, px));
      V3 anch = add(ppar, qrot(qpar, lp));
      SV S = cat(ax, cross(anch, ax));
      const float qd = s.qv[6 + li];
      SV Sq = sscale(S, qd);
      SV acc = sadd(ap, mcross(vp, Sq));
      vp = sadd(vp, Sq);
      ap = acc;
      if (owned) {
        st6(s.S[li], S);
        tau[k] = pd_torque(li, q, qd, s.tg[7 + li], *p);
        const int cb = CH_CARRIER[r][k];
        if (cb >= 0) {
          st6(s.vb[cb], vp);
          st6(s.ab[cb], ap);
        }
      }
    }
    float sh, ch;
    if constexpr (DYN) {  // phase (0) took them
      sh = s.sc[li][0];
      ch = s.sc[li][1];
    } else {
      sincosf(0.5f * q, &sh, &ch);
    }
    Q4 qk = {ch, sh * a.x, sh * a.y, sh * a.z};
    if constexpr (T::SLOT_HAS_ANCHOR[k] != 0) {
      V3 tk = sub({px, 0.f, 0.f}, qrot_x(qk, px));
      tl = add(tl, qrot(ql, tk));
    }
    ql = qmul(ql, qk);
    owned_last = owned;
  });
  V3 pb = add(ppar, qrot(qpar, add(off, tl)));
  Q4 qb = qmul(qpar, ql);
  if (owned_last) {
    st3(pos[body], pb);
    st4(quat[body], qb);
  }
}

// ---------------------------------------------------------------------------
// (2) bodies: spatial inertia about the world origin, contacts, body force
// ---------------------------------------------------------------------------

// [[I_c + m cx cx^T, m cx], [-(m cx), m 1]]; the body-frame inertias are
// diagonal, and io_zero() entries stay 0
HD S6 spatial_inertia(int b, Q4 q, V3 c) {
  const float m = D_BODY_MASS[b];
  const float ib[3] = {D_BODY_INERTIA[b][0], D_BODY_INERTIA[b][1], D_BODY_INERTIA[b][2]};
  float w = q.w, x = q.x, y = q.y, z = q.z;
  float xx = x * x, yy = y * y, zz = z * z;
  float xy = x * y, xz = x * z, yz = y * z;
  float wx = w * x, wy = w * y, wz = w * z;
  float R[3][3] = {{1.f - 2.f * (yy + zz), 2.f * (xy - wz), 2.f * (xz + wy)},
                   {2.f * (xy + wz), 1.f - 2.f * (xx + zz), 2.f * (yz - wx)},
                   {2.f * (xz - wy), 2.f * (yz + wx), 1.f - 2.f * (xx + yy)}};
  float tmp[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int l = 0; l < 3; ++l) tmp[i][l] = R[i][l] * ib[l];
  float cv[3] = {c.x, c.y, c.z};
  float cc = dot(c, c);
  float ct[3][3] = {{0.f, -c.z, c.y}, {c.z, 0.f, -c.x}, {-c.y, c.x, 0.f}};
  S6 M;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = i; j < 3; ++j) {
      float iw = tmp[i][0] * R[j][0] + tmp[i][1] * R[j][1] + tmp[i][2] * R[j][2];
      float cij = cv[i] * cv[j];
      M.m[sidx(i, j)] = iw + m * (i == j ? cc - cij : -cij);
      M.m[sidx(3 + i, 3 + j)] = i == j ? m : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) M.m[sidx(i, 3 + j)] = i == j ? 0.f : m * ct[i][j];
  }
  return M;
}

// Contact point c (of its body at pose (pb, q), moving with vb): its
// position x, force f and the damping weights c_t (tangential) and W2
// (normal), into contact_of(s, c) where ``store``.
HD void contact_record(Slot& s, int c, bool store) {
  const int b = D_CONTACT_BODY[c];
  const V3 pb = ld3(s.pos[b]);
  const Q4 q = ld4(s.quat[b]);
  const SV vb = ld6(s.vb[b]);
  V3 x = add(pb, qrot(q, ld3(D_CONTACT_POINT[c])));
  V3 xdot = add(bot(vb), cross(top(vb), x));
  float depth = D_CONTACT_RADIUS[c] - x.z;
  float active = depth > 0.f ? 1.f : 0.f;
  float fn = fmaxf(STIFFNESS * depth * active - DAMPING * xdot.z * active, 0.f);
  float vt0 = xdot.x, vt1 = xdot.y;
  float vt_norm = sqrtf(vt0 * vt0 + vt1 * vt1 + V_REG2);
  float c_t = MU * fn / vt_norm;
  if (!store) return;
  float* r = contact_of(s, c);
  st3(r, x);
  st3(r + 3, {-c_t * vt0, -c_t * vt1, fn});
  r[6] = c_t;
  r[7] = DAMPING * active;
}

// (2a) every lane: the records of contact points lane, lane + L, ...; the
// index is clamped rather than branched on, so a lane's points overlap
template <int L>
HD void contacts(Slot& s, int lane) {
#pragma unroll
  for (int i = 0; i < (NC + L - 1) / L; ++i) {
    const int c = lane + i * L;
    contact_record(s, min(c, NC - 1), c < NC);
  }
}

// A contact record's force into fext and its implicit damping into K
// (upper triangle; io_zero() entries stay 0), W0 = W1 = c_t.
HD void add_contact(const float* r, SV& fext, float (&k)[21]) {
  const V3 x = ld3(r), f = ld3(r + 3);
  const float W0 = r[6], W1 = r[6], W2 = r[7];
  fext = sadd(fext, cat(cross(x, f), f));
  // C block: sum_k xt[i][k] W[k] xt[j][k] with xt = skew(x)
  k[sidx(0, 0)] = k[sidx(0, 0)] + ((-x.z * W1) * -x.z + (x.y * W2) * x.y);
  k[sidx(0, 1)] = k[sidx(0, 1)] + (x.y * W2) * -x.x;
  k[sidx(0, 2)] = k[sidx(0, 2)] + (-x.z * W1) * x.x;
  k[sidx(1, 1)] = k[sidx(1, 1)] + ((x.z * W0) * x.z + (-x.x * W2) * -x.x);
  k[sidx(1, 2)] = k[sidx(1, 2)] + (x.z * W0) * -x.y;
  k[sidx(2, 2)] = k[sidx(2, 2)] + ((-x.y * W0) * -x.y + (x.x * W1) * x.x);
  // B block: xt[i][j] W[j] at (i, 3+j) and (3+j, i)
  k[sidx(0, 4)] = k[sidx(0, 4)] + -x.z * W1;
  k[sidx(0, 5)] = k[sidx(0, 5)] + x.y * W2;
  k[sidx(1, 3)] = k[sidx(1, 3)] + x.z * W0;
  k[sidx(1, 5)] = k[sidx(1, 5)] + -x.x * W2;
  k[sidx(2, 3)] = k[sidx(2, 3)] + -x.y * W0;
  k[sidx(2, 4)] = k[sidx(2, 4)] + x.x * W1;
  // D block
  k[sidx(3, 3)] = k[sidx(3, 3)] + W0;
  k[sidx(4, 4)] = k[sidx(4, 4)] + W1;
  k[sidx(5, 5)] = k[sidx(5, 5)] + W2;
}

template <int L>
HD void bodies(Slot& s, const StepParams& p, int lane) {
  const int* mine = Lanes<L>::bodies(lane);
  static_for<0, Lanes<L>::NBODY>([&](auto j_) {
    const int b = mine[CI(j_)];
    if (b < 0) return;
    const Q4 q = ld4(s.quat[b]);
    const V3 pb = ld3(s.pos[b]);
    const S6 IO = spatial_inertia(b, q, add(pb, qrot(q, ld3(D_BODY_COM[b]))));
    const SV vb = ld6(s.vb[b]), ab = ld6(s.ab[b]);
    SV fext = szero();
    float k[21];
#pragma unroll
    for (int e = 0; e < 21; ++e) k[e] = 0.f;
    if (p.contacts) {  // the body's points in order: a fixed order of sums
      const int c0 = D_BODY_CONTACT0[b], nc = D_BODY_NCONTACT[b];
#pragma unroll
      for (int c = 0; c < MAX_BODY_CONTACTS; ++c)
        if (c < nc) add_contact(contact_of(s, c0 + c), fext, k);
    }
    SV Ivb = mat6vec<true>(IO, vb);
    st6(s.fb[b], ssub(sadd(mat6vec<true>(IO, ab), fcross(vb, Ivb)), fext));
    float* ia = s.IA0[b];
    static_for<0, 6>([&](auto i_) {
      constexpr int i = CI(i_);
      static_for<i, 6>([&](auto c_) {
        constexpr int c = CI(c_);
        if constexpr (io_zero(i, c)) {
          ia[sidx(i, c)] = 0.f;
        } else {
          ia[sidx(i, c)] = IO.m[sidx(i, c)] + p.h * k[sidx(i, c)];
        }
      });
    });
  });
}

// ---------------------------------------------------------------------------
// (3) chains, leaf to root: RNEA forces and the ABA backward sweep
// ---------------------------------------------------------------------------

HD void add_join(S6& IA, SV& pA, SV& fl, const float* J) {
  IA = s6add(IA, J);
  pA = sadd(pA, ld6(J + 21));
  fl = sadd(fl, ld6(J + 27));
}

HD void chain_backward(Slot& s, const StepParams& p, int r, bool chain,
                       const float (&tau)[NSLOTS], float (&dinv)[NSLOTS], float (&uu)[NSLOTS],
                       unsigned mask) {
  S6 Ic;
  SV pc, fc;
  bool have = false;
  static_for_down<0, NSLOTS>([&](auto k_) {
    constexpr int k = CI(k_);
    if constexpr (k == JOIN_SLOT) __syncwarp(mask);  // the chains into JOIN_LINK are in s.join
    if (!chain) return;
    const int li = CH_LINK[r][k];
    if (li < 0 || CH_OWNED[r][k] == 0) return;
    const int cb = CH_CARRIER[r][k];
    S6 IA = cb >= 0 ? ld21(s.IA0[cb]) : s6zero();
    SV fl = cb >= 0 ? ld6(s.fb[cb]) : szero();
    SV pA = szero();
    if constexpr (k == JOIN_SLOT) {
      if (li == JOIN_LINK) {
        static_for<0, sizeof(T::JOIN_ROLES) / sizeof(int)>([&](auto j_) {
          constexpr int role = T::JOIN_ROLES[CI(j_)];
          add_join(IA, pA, fl, join_of(s, role));
        });
      }
    }
    if (have) {
      IA = s6add(IA, Ic.m);
      pA = sadd(pA, pc);
      fl = sadd(fl, fc);
    }
    const SV S = ld6(s.S[li]);
    const float rhs = tau[k] - sdot(S, fl);
    const SV U = mat6vec(IA, S);
    const float di = 1.0f / (sdot(S, U) + p.d_extra[li]);
    const float u = rhs - sdot(S, pA);
    const SV Ud = sscale(U, di);
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int c = a; c < 6; ++c) Ic.m[sidx(a, c)] = IA.m[sidx(a, c)] - U.a[a] * Ud.a[c];
    pc = sadd(pA, sscale(U, u * di));
    fc = fl;
    have = true;
    st6(U_of(s, li), U);
    dinv[k] = di;
    uu[k] = u;
    if (k == CH_FIRST_OWNED[r]) {
      float* J = join_of(s, r);
#pragma unroll
      for (int e = 0; e < 21; ++e) J[e] = Ic.m[e];
      st6(J + 21, pc);
      st6(J + 27, fc);
    }
  });
}

// ---------------------------------------------------------------------------
// (4) the root: its sums, the 6x6 solve and its Euler step (one lane)
// ---------------------------------------------------------------------------

// Solve the SPD system A x = b; A given by its lower triangle A[i][j], j <= i.
HD void chol_solve6(const float (&A)[6][6], const float (&b)[6], float (&x)[6]) {
  float L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    float inv = rsqrtf(s);
    L[j][j] = inv;  // 1 / L_jj
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t * inv;
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s * L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s * L[i][i];
  }
}

HD void root_solve(Slot& s, const StepParams& p, const Root& R) {
  S6 IA = ld21(s.IA0[0]);
  SV pA = szero(), f = ld6(s.fb[0]);
  static_for<0, sizeof(T::ROOT_ROLES) / sizeof(int)>([&](auto j_) {
    constexpr int role = T::ROOT_ROLES[CI(j_)];
    add_join(IA, pA, f, join_of(s, role));
  });
  // Sr[k] = e_{3+k} for k < 3, (n, p0 x n) after
  SV Sr[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) Sr[k] = cat(R.n[k], cross(R.p0, R.n[k]));
  float D0[6][6], u0[6], qdd0[6];
#pragma unroll
  for (int b = 0; b < 6; ++b) {
    SV W;
    if (b < 3) {
#pragma unroll
      for (int i = 0; i < 6; ++i) W.a[i] = IA.m[sidx(i, 3 + b)];
    } else {
      W = mat6vec(IA, Sr[b - 3]);
    }
#pragma unroll
    for (int a = b; a < 6; ++a) D0[a][b] = a < 3 ? W.a[3 + a] : sdot(Sr[a - 3], W);
  }
#pragma unroll
  for (int k = 0; k < 6; ++k)
    u0[k] = k < 3 ? -f.a[3 + k] - pA.a[3 + k] : -sdot(Sr[k - 3], f) - sdot(Sr[k - 3], pA);
  chol_solve6(D0, u0, qdd0);
  SV a = sadd(sadd(sscale(Sr[0], qdd0[3]), sscale(Sr[1], qdd0[4])), sscale(Sr[2], qdd0[5]));
  a.a[3] = qdd0[0] + a.a[3];
  a.a[4] = qdd0[1] + a.a[4];
  a.a[5] = qdd0[2] + a.a[5];
  st6(s.a_root, a);

  // semi-implicit Euler, the root quaternion on the exponential map
  const float h = p.h;
#pragma unroll
  for (int k = 0; k < 6; ++k) s.qv[k] = s.qv[k] + h * qdd0[k];
  float w0 = s.qv[3], w1 = s.qv[4], w2 = s.qv[5];
  float n2 = w0 * w0 + w1 * w1 + w2 * w2;
  bool big = n2 > 1e-16f;
  float norm = sqrtf(big ? n2 : 1.f);
  float half = p.half_h * norm;
  float sh, ch;
  sincosf(half, &sh, &ch);
  float kfac = big ? sh / norm : p.half_h;
  Q4 qn = qmul(ld4(s.qp + 3), {ch, kfac * w0, kfac * w1, kfac * w2});
  float qinv = rsqrtf(qn.w * qn.w + qn.x * qn.x + qn.y * qn.y + qn.z * qn.z);
#pragma unroll
  for (int k = 0; k < 3; ++k) s.qp[k] = s.qp[k] + h * s.qv[k];
  st4(s.qp + 3, {qn.w * qinv, qn.x * qinv, qn.y * qinv, qn.z * qinv});
}

// ---------------------------------------------------------------------------
// (5) chains, root to leaf: accelerations and each link's Euler step
// ---------------------------------------------------------------------------

HD void chain_forward(Slot& s, const StepParams& p, int r, bool chain,
                      const float (&dinv)[NSLOTS], const float (&uu)[NSLOTS], unsigned mask) {
  SV ap = szero();
  static_for<0, NSLOTS>([&](auto k_) {
    constexpr int k = CI(k_);
    if constexpr (k == JOIN_SLOT + 1) __syncwarp(mask);  // JOIN_LINK's acceleration is in s.a_join
    if (!chain) return;
    const int li = CH_LINK[r][k];
    if (li < 0 || CH_OWNED[r][k] == 0) return;
    if (k == CH_FIRST_OWNED[r]) ap = ld6(k == 0 ? s.a_root : s.a_join);
    const float qdd = (uu[k] - sdot(ld6(U_of(s, li)), ap)) * dinv[k];
    ap = sadd(ap, sscale(ld6(s.S[li]), qdd));
    if (li == JOIN_LINK) st6(s.a_join, ap);
    const float v = s.qv[6 + li] + p.h * qdd;
    s.qv[6 + li] = v;
    s.qp[7 + li] = s.qp[7 + li] + p.h * v;
  });
}

// One substep of the env in s, on the group's L lanes; ends with the group
// synchronised.
template <int L>
__device__ __noinline__ void substep(Slot& s, const StepParams& p, int lane, unsigned mask) {
  HUM_MARK();
  const bool chain = lane < NROLES;
  // (0) every lane: sin and cos of half of hinges lane, lane + L, ...
  for (int li = lane; li < NJ; li += L) sincosf(0.5f * s.qp[7 + li], &s.sc[li][0], &s.sc[li][1]);
  const Root R = root_terms(s.qp, s.qv);
  float tau[NSLOTS], dinv[NSLOTS], uu[NSLOTS];
  __syncwarp(mask);
  if (chain) chain_walk<true>(s, s.qp, s.pos, s.quat, lane, R.p0, R.q0, R.v, R.a_b, &p, tau);
  if (lane == 0) {
    st3(s.pos[0], R.p0);
    st4(s.quat[0], R.q0);
    st6(s.vb[0], R.v);
    st6(s.ab[0], R.a_b);
  }
  __syncwarp(mask);
  HUM_PHASE(0);
  if (p.contacts) contacts<L>(s, lane);
  __syncwarp(mask);
  HUM_PHASE(4);
  bodies<L>(s, p, lane);
  __syncwarp(mask);
  HUM_PHASE(3);
  chain_backward(s, p, lane, chain, tau, dinv, uu, mask);
  __syncwarp(mask);
  HUM_PHASE(6);
  if (lane == 0) root_solve(s, p, R);
  __syncwarp(mask);
  HUM_PHASE(7);
  chain_forward(s, p, lane, chain, dinv, uu, mask);
  __syncwarp(mask);
  HUM_PHASE(8);
}

// ---------------------------------------------------------------------------
// DeepMimic tracking reward (Peng et al. 2018 weights) of (s.qp, s.qv)
// against (s.tg, s.rqv)
// ---------------------------------------------------------------------------

// arccos on [0, 1]: Abramowitz-Stegun 4.4.46, |err| <= 2e-8 rad
HD float acos01(float x) {
  constexpr float c[8] = {T::ACOS_COEF[0], T::ACOS_COEF[1], T::ACOS_COEF[2], T::ACOS_COEF[3],
                          T::ACOS_COEF[4], T::ACOS_COEF[5], T::ACOS_COEF[6], T::ACOS_COEF[7]};
  float s = c[7];
#pragma unroll
  for (int k = 6; k >= 0; --k) s = s * x + c[k];
  return sqrtf(fmaxf(1.f - x, 0.f)) * s;
}

// joint j's local rotation: intrinsic xyz Euler (3 dofs) or a hinge about -y
HD Q4 joint_quat(const float* qp, int j) {
  const int st = D_JOINT_QPOS[j];
  float s0, c0;
  sincosf(0.5f * qp[st], &s0, &c0);
  if (D_JOINT_DOF[j] == 3) {
    float s1, c1, s2, c2;
    sincosf(0.5f * qp[st + 1], &s1, &c1);
    sincosf(0.5f * qp[st + 2], &s2, &c2);
    return qmul({c0, s0, 0.f, 0.f}, qmul({c1, 0.f, s1, 0.f}, {c2, 0.f, 0.f, s2}));
  }
  return {c0, 0.f, -s0, 0.f};
}

template <int L>
HD float tracking_reward(Slot& s, int lane, unsigned mask) {
  float unused[NSLOTS];
  V3 p0, pr;
  Q4 q0, qr;
  root_pose(s.qp, p0, q0);
  root_pose(s.tg, pr, qr);
  if (lane < NROLES) {
    const SV z = szero();
    chain_walk<false>(s, s.qp, s.pos, s.quat, lane, p0, q0, z, z, nullptr, unused);
    chain_walk<false>(s, s.tg, s.rpos, s.rquat, lane, pr, qr, z, z, nullptr, unused);
  }
  if (lane == 0) {
    st3(s.pos[0], p0);
    st4(s.quat[0], q0);
    st3(s.rpos[0], pr);
    st4(s.rquat[0], qr);
  }
  __syncwarp(mask);
  float part[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int* joints = Lanes<L>::joints(lane);
#pragma unroll
  for (int i = 0; i < Lanes<L>::NJOINT; ++i) {
    const int j = joints[i];
    if (j < 0) continue;
    Q4 a = joint_quat(s.qp, j), b = joint_quat(s.tg, j);
    float d = a.w * b.w + a.x * b.x + a.y * b.y + a.z * b.z;
    d = fminf(fmaxf(fabsf(d), 0.f), 1.f);
    float ang = 2.f * acos01(d);
    part[0] = part[0] + D_JOINT_WEIGHT[j] * ang * ang;
  }
  for (int k = 6 + lane; k < NV; k += L) {
    float d = s.qv[k] - s.rqv[k];
    part[1] = part[1] + d * d;
  }
  const int* ees = Lanes<L>::ees(lane);
#pragma unroll
  for (int i = 0; i < Lanes<L>::NEEL; ++i) {
    const int e = ees[i];
    if (e < 0) continue;
    const int b = D_EE_BODY[e];
    const V3 pt = ld3(D_EE_POINT[e]);
    V3 d = sub(add(ld3(s.pos[b]), qrot(ld4(s.quat[b]), pt)),
               add(ld3(s.rpos[b]), qrot(ld4(s.rquat[b]), pt)));
    part[2] = part[2] + dot(d, d);
  }
  const int* geoms = Lanes<L>::geoms(lane);
#pragma unroll
  for (int i = 0; i < Lanes<L>::NGEOM; ++i) {
    const int g = geoms[i];
    if (g < 0) continue;
    const int b = D_GEOM_BODY[g];
    const V3 gc = ld3(D_GEOM_COM[g]);
    const float frac = D_GEOM_MASS_FRAC[g];
    V3 gp = scale(add(ld3(s.pos[b]), qrot(ld4(s.quat[b]), gc)), frac);
    V3 gr = scale(add(ld3(s.rpos[b]), qrot(ld4(s.rquat[b]), gc)), frac);
    part[3] = part[3] + gp.x;
    part[4] = part[4] + gp.y;
    part[5] = part[5] + gp.z;
    part[6] = part[6] + gr.x;
    part[7] = part[7] + gr.y;
    part[8] = part[8] + gr.z;
  }
#pragma unroll
  for (int e = 0; e < 9; ++e) s.part[lane][e] = part[e];
  __syncwarp(mask);
  // every lane adds the lanes' sums in lane order
  float tot[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) tot[e] = s.part[0][e];
#pragma unroll
  for (int l = 1; l < L; ++l)
#pragma unroll
    for (int e = 0; e < 9; ++e) tot[e] = tot[e] + s.part[l][e];
  const float vel_err = tot[1] / float(NV - 6);
  const float ee_err = tot[2] / float(NEE);
  V3 dc = sub({tot[3], tot[4], tot[5]}, {tot[6], tot[7], tot[8]});
  const float com_err = dot(dc, dc);
  return 0.65f * expf(-2.f * tot[0]) + 0.1f * expf(-0.1f * vel_err) +
         0.15f * expf(-40.f * ee_err) + 0.1f * expf(-10.f * com_err);
}

// ---------------------------------------------------------------------------
// Entry kernels: E envs a block, L lanes an env; the step parameters and
// the envs' Slots in dynamic shared memory
// ---------------------------------------------------------------------------

HD StepParams& shared_params(float4* smem, const StepParams& p_in) {
  StepParams& p = *reinterpret_cast<StepParams*>(smem);
  const int* src = reinterpret_cast<const int*>(&p_in);
  int* dst = reinterpret_cast<int*>(&p);
  for (int k = threadIdx.x; k < (int)(sizeof(StepParams) / 4); k += blockDim.x) dst[k] = src[k];
  __syncthreads();
  return p;
}

HD Slot* shared_slots(float4* smem) {
  return reinterpret_cast<Slot*>(reinterpret_cast<char*>(smem) + PARAMS_BYTES);
}

template <int L>
__global__ void __launch_bounds__(MAX_THREADS)
control_step_kernel(const float* __restrict__ qpos, const float* __restrict__ qvel,
                    const float* __restrict__ target, const float* __restrict__ ref_qvel,
                    float* __restrict__ qp_out, float* __restrict__ qv_out,
                    float* __restrict__ reward, int N, int envs, StepParams p_in) {
  extern __shared__ float4 smem[];
  const StepParams& p = shared_params(smem, p_in);
  const int lane = threadIdx.x % L, e = threadIdx.x / L;
  const size_t n = (size_t)blockIdx.x * envs + e;
  if (n >= (size_t)N) return;
  const unsigned mask = group_mask<L>();
  Slot& s = shared_slots(smem)[e];
  load_row(s.qp, qpos + n * NQ, NQ, lane, L);
  load_row(s.qv, qvel + n * NV, NV, lane, L);
  load_row(s.tg, target + n * NQ, NQ, lane, L);
  if (reward != nullptr) load_row(s.rqv, ref_qvel + n * NV, NV, lane, L);
  __syncwarp(mask);
  for (int i = 0; i < p.substeps; ++i) substep<L>(s, p, lane, mask);
  if (reward != nullptr) {
    const float r = tracking_reward<L>(s, lane, mask);
    if (lane == 0) reward[n] = r;
  }
  store_row(qp_out + n * NQ, s.qp, NQ, lane, L);
  store_row(qv_out + n * NV, s.qv, NV, lane, L);
}

template <int L>
__global__ void __launch_bounds__(MAX_THREADS)
rollout_kernel(const float* __restrict__ qpos, const float* __restrict__ qvel,
               const float* __restrict__ done, const float* __restrict__ targets,
               const float* __restrict__ ref_qvels, float* __restrict__ qp_out,
               float* __restrict__ qv_out, float* __restrict__ done_out,
               float* __restrict__ rewards, int N, int T_steps, int envs, StepParams p_in) {
  extern __shared__ float4 smem[];
  const StepParams& p = shared_params(smem, p_in);
  const int lane = threadIdx.x % L, e = threadIdx.x / L;
  const size_t n = (size_t)blockIdx.x * envs + e;
  if (n >= (size_t)N) return;
  const unsigned mask = group_mask<L>();
  Slot& s = shared_slots(smem)[e];
  load_row(s.qp, qpos + n * NQ, NQ, lane, L);
  load_row(s.qv, qvel + n * NV, NV, lane, L);
  float dn = done[n];
#pragma unroll 1
  for (int t = 0; t < T_steps; ++t) {
    const size_t row = (size_t)t * N + n;
    load_row(s.tg, targets + row * NQ, NQ, lane, L);
    load_row(s.rqv, ref_qvels + row * NV, NV, lane, L);
    __syncwarp(mask);
    if (!(dn > 0.f)) {  // done envs stay frozen; dn is the same on the group's lanes
#pragma unroll 1
      for (int i = 0; i < p.substeps; ++i) substep<L>(s, p, lane, mask);
    }
    dn = fmaxf(dn, s.qp[2] < p.fall_height ? 1.f : 0.f);
    HUM_MARK();
    const float r = tracking_reward<L>(s, lane, mask);
    HUM_PHASE(10);
    if (lane == 0) rewards[row] = r * (1.f - dn);
    __syncwarp(mask);  // every lane is done with s.tg and s.rqv
  }
  store_row(qp_out + n * NQ, s.qp, NQ, lane, L);
  store_row(qv_out + n * NV, s.qv, NV, lane, L);
  if (lane == 0) done_out[n] = dn;
}

template <int L>
__global__ void __launch_bounds__(MAX_THREADS)
reward_kernel(const float* __restrict__ qpos, const float* __restrict__ qvel,
              const float* __restrict__ ref_qpos, const float* __restrict__ ref_qvel,
              float* __restrict__ out, int N, int envs) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x % L, e = threadIdx.x / L;
  const size_t n = (size_t)blockIdx.x * envs + e;
  if (n >= (size_t)N) return;
  const unsigned mask = group_mask<L>();
  Slot& s = shared_slots(smem)[e];
  load_row(s.qp, qpos + n * NQ, NQ, lane, L);
  load_row(s.qv, qvel + n * NV, NV, lane, L);
  load_row(s.tg, ref_qpos + n * NQ, NQ, lane, L);
  load_row(s.rqv, ref_qvel + n * NV, NV, lane, L);
  __syncwarp(mask);
  const float r = tracking_reward<L>(s, lane, mask);
  if (lane == 0) out[n] = r;
}

int smem_bytes(int envs) { return PARAMS_BYTES + envs * (int)sizeof(Slot); }

template <class K>
int prepare(K kernel, int lanes, int envs, int N) {
  if (N <= 0 || envs <= 0 || envs * lanes > MAX_THREADS || (envs * lanes) % 32 != 0)
    return (int)cudaErrorInvalidValue;
  int smem = smem_bytes(envs);
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return 0;
}

int blocks(int N, int envs) { return (N + envs - 1) / envs; }

template <int L>
int control_step(const float* qpos, const float* qvel, const float* target,
                 const float* ref_qvel, float* qp_out, float* qv_out, float* reward, int N,
                 int envs, const StepParams* p, cudaStream_t stream) {
  int err = prepare(control_step_kernel<L>, L, envs, N);
  if (err) return err;
  control_step_kernel<L><<<blocks(N, envs), envs * L, smem_bytes(envs), stream>>>(
      qpos, qvel, target, ref_qvel, qp_out, qv_out, reward, N, envs, *p);
  return (int)cudaGetLastError();
}

template <int L>
int rollout(const float* qpos, const float* qvel, const float* done, const float* targets,
            const float* ref_qvels, float* qp_out, float* qv_out, float* done_out,
            float* rewards, int N, int T_steps, int envs, const StepParams* p,
            cudaStream_t stream) {
  int err = prepare(rollout_kernel<L>, L, envs, N);
  if (err) return err;
  rollout_kernel<L><<<blocks(N, envs), envs * L, smem_bytes(envs), stream>>>(
      qpos, qvel, done, targets, ref_qvels, qp_out, qv_out, done_out, rewards, N, T_steps, envs,
      *p);
  return (int)cudaGetLastError();
}

template <int L>
int tracking_reward_launch(const float* qpos, const float* qvel, const float* ref_qpos,
                           const float* ref_qvel, float* out, int N, int envs,
                           cudaStream_t stream) {
  int err = prepare(reward_kernel<L>, L, envs, N);
  if (err) return err;
  reward_kernel<L><<<blocks(N, envs), envs * L, smem_bytes(envs), stream>>>(
      qpos, qvel, ref_qpos, ref_qvel, out, N, envs);
  return (int)cudaGetLastError();
}

}  // namespace hum

extern "C" {

int humanoid_control_step_f32(const float* qpos, const float* qvel, const float* target,
                              const float* ref_qvel, float* qp_out, float* qv_out,
                              float* reward, int N, int lanes, int envs,
                              const hum::StepParams* p, cudaStream_t stream) {
  if (lanes == 8)
    return hum::control_step<8>(qpos, qvel, target, ref_qvel, qp_out, qv_out, reward, N, envs,
                                p, stream);
  if (lanes == 16)
    return hum::control_step<16>(qpos, qvel, target, ref_qvel, qp_out, qv_out, reward, N, envs,
                                 p, stream);
  return (int)cudaErrorInvalidValue;
}

int humanoid_rollout_f32(const float* qpos, const float* qvel, const float* done,
                         const float* targets, const float* ref_qvels, float* qp_out,
                         float* qv_out, float* done_out, float* rewards, int N, int T_steps,
                         int lanes, int envs, const hum::StepParams* p, cudaStream_t stream) {
  if (lanes == 8)
    return hum::rollout<8>(qpos, qvel, done, targets, ref_qvels, qp_out, qv_out, done_out,
                           rewards, N, T_steps, envs, p, stream);
  if (lanes == 16)
    return hum::rollout<16>(qpos, qvel, done, targets, ref_qvels, qp_out, qv_out, done_out,
                            rewards, N, T_steps, envs, p, stream);
  return (int)cudaErrorInvalidValue;
}

int humanoid_tracking_reward_f32(const float* qpos, const float* qvel, const float* ref_qpos,
                                 const float* ref_qvel, float* out, int N, int lanes, int envs,
                                 cudaStream_t stream) {
  if (lanes == 8)
    return hum::tracking_reward_launch<8>(qpos, qvel, ref_qpos, ref_qvel, out, N, envs, stream);
  if (lanes == 16)
    return hum::tracking_reward_launch<16>(qpos, qvel, ref_qpos, ref_qvel, out, N, envs, stream);
  return (int)cudaErrorInvalidValue;
}

const char* humanoid_dynamics_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
