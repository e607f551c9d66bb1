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
// What bounds it: operations. Each env runs a serial, straight-line chain
// of about 15,000 float operations a substep (FK, PD, 37 contact points,
// RNEA, a 28-link zero-velocity ABA sweep, a 6x6 Cholesky, semi-implicit
// Euler), 17 substeps a control step, against 1.4 KB of state read and
// written once; nothing is shared between envs.
//
// Design: one thread per env, 32 threads a block (so that N 4096 fills 128
// SMs), reading the public (N, 35) / (N, 34) rows directly. The tree loops
// run as static_for over the tables of humanoid_tables.h, so every table
// index, parent and carrier is a compile-time constant and every per-body
// and per-link value is a named scalar for the register allocator (no
// dynamically indexed arrays). Articulated inertias are kept symmetric (21
// floats). The substep and the reward are __noinline__ functions, so the
// module holds one copy of each; what does not fit in 255 registers spills
// to the thread's local memory. The association order follows the plain
// version (python's left-to-right sums); nvcc contracts a*b+c into FMAs,
// so float32 results differ from the plain version by rounding. No fast
// math: rsqrtf where the JAX kernel uses lax.rsqrt, sincosf and IEEE
// sqrtf and division elsewhere. B6 skips the substeps of envs that are
// done (their state is frozen either way) and computes every reward.
//
// Launches go on the caller's stream; each entry point returns
// cudaGetLastError() of its launch.

#include <cuda_runtime.h>

#include "humanoid_tables.h"

#define HD __device__ __forceinline__
#define HD_NOINLINE __device__ __noinline__

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

HD constexpr int sidx(int i, int j) {
  return i <= j ? i * 6 - i * (i - 1) / 2 + (j - i) : j * 6 - j * (j - 1) / 2 + (i - j);
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

HD SV mat6vec(const S6& M, const SV& v) {
  SV r;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = M.m[sidx(i, 0)] * v.a[0];
#pragma unroll
    for (int j = 1; j < 6; ++j) s = s + M.m[sidx(i, j)] * v.a[j];
    r.a[i] = s;
  }
  return r;
}
HD S6 s6zero() {
  S6 r;
#pragma unroll
  for (int k = 0; k < 21; ++k) r.m[k] = 0.f;
  return r;
}

template <class A>
HD constexpr V3 v3(const A& a) {
  return {a[0], a[1], a[2]};
}

// ---------------------------------------------------------------------------
// Forward kinematics: body poses, COMs, per-hinge world axes and anchors
// ---------------------------------------------------------------------------

template <bool DOFS>
HD void fk(const float* qp, V3 (&pos)[NB], Q4 (&quat)[NB], V3 (&ax)[NJ], V3 (&anch)[NJ]) {
  float inv = rsqrtf(qp[3] * qp[3] + qp[4] * qp[4] + qp[5] * qp[5] + qp[6] * qp[6]);
  pos[0] = {qp[0], qp[1], qp[2]};
  quat[0] = {qp[3] * inv, qp[4] * inv, qp[5] * inv, qp[6] * inv};
  static_for<1, NB>([&](auto bi_) {
    constexpr int bi = CI(bi_);
    constexpr int par = T::BODY_PARENT[bi];
    constexpr V3 off = v3(T::BODY_OFFSET[bi]);
    Q4 ql = {1.f, 0.f, 0.f, 0.f};
    V3 tl = {0.f, 0.f, 0.f};
    static_for<0, T::BODY_NLINKS[bi]>([&](auto k_) {
      constexpr int li = T::BODY_FIRST_LINK[bi] + CI(k_);
      constexpr V3 a = v3(T::JOINT_AXIS[li]);
      constexpr V3 pk = v3(T::JOINT_ANCHOR[li]);
      if constexpr (DOFS) {
        ax[li] = qrot(quat[par], qrot(ql, a));
        anch[li] = add(pos[par], qrot(quat[par], add(add(off, tl), qrot(ql, pk))));
      }
      float sh, ch;
      sincosf(0.5f * qp[7 + li], &sh, &ch);
      Q4 qk = {ch, sh * a.x, sh * a.y, sh * a.z};
      V3 tk = sub(pk, qrot(qk, pk));
      tl = add(tl, qrot(ql, tk));
      ql = qmul(ql, qk);
    });
    pos[bi] = add(pos[par], qrot(quat[par], add(off, tl)));
    quat[bi] = qmul(quat[par], ql);
  });
}

// Body b's spatial inertia about the world origin, [[I_c + m cx cx^T, m cx],
// [-(m cx), m 1]]; the body-frame inertias are diagonal.
template <int B>
HD S6 spatial_inertia(Q4 q, V3 c) {
  constexpr float m = T::BODY_MASS[B];
  constexpr float ib[3] = {T::BODY_INERTIA[B][0][0], T::BODY_INERTIA[B][1][1],
                           T::BODY_INERTIA[B][2][2]};
  static_assert(T::BODY_INERTIA[B][0][1] == 0.f && T::BODY_INERTIA[B][0][2] == 0.f &&
                    T::BODY_INERTIA[B][1][2] == 0.f && T::BODY_INERTIA[B][1][0] == 0.f &&
                    T::BODY_INERTIA[B][2][0] == 0.f && T::BODY_INERTIA[B][2][1] == 0.f,
                "body inertias must be diagonal");
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
  // m * skew(c), row-major
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

// ---------------------------------------------------------------------------
// One substep: PD + passive (+ limits) torques, FK, contacts, RNEA bias, the
// zero-velocity ABA solve of (M + h D) qacc = rhs, semi-implicit Euler.
// ---------------------------------------------------------------------------

HD_NOINLINE void substep(float* qp, float* qv, const float* tg, const StepParams& p) {
  V3 pos[NB], ax[NJ], anch[NJ];
  Q4 quat[NB];
  fk<true>(qp, pos, quat, ax, anch);
  V3 com[NB];
  static_for<0, NB>([&](auto b_) {
    constexpr int b = CI(b_);
    constexpr V3 cm = v3(T::BODY_COM[b]);
    com[b] = add(pos[b], qrot(quat[b], cm));
  });

  // joint-space applied torques
  float rhs[NJ];
  static_for<0, NJ>([&](auto i_) {
    constexpr int i = CI(i_);
    constexpr float hi = T::LIMIT_HI[i], lo = T::LIMIT_LO[i];
    float q = qp[7 + i], qd = qv[6 + i], t = tg[7 + i];
    float tau = p.kp[i] * (t - q) - p.kd[i] * qd;
    tau = tau - JOINT_STIFFNESS * q - JOINT_DAMPING * qd;
    if (p.limits) {
      float over = fmaxf(q - hi, 0.f);
      float under = fmaxf(lo - q, 0.f);
      float gate = (over > 0.f || under > 0.f) ? 1.f : 0.f;
      tau = tau - LIMIT_K * over + LIMIT_K * under - LIMIT_C * qd * gate;
    }
    rhs[i] = tau;
  });

  // motion subspaces: the root's 3 world translations and 3 body-frame
  // rotations, then one hinge per link
  SV Sr[6];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    Sr[k] = szero();
    Sr[k].a[3 + k] = 1.f;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    V3 e = {k == 0 ? 1.f : 0.f, k == 1 ? 1.f : 0.f, k == 2 ? 1.f : 0.f};
    V3 n = qrot(quat[0], e);
    Sr[3 + k] = cat(n, cross(pos[0], n));
  }
  SV S[NJ];
#pragma unroll
  for (int i = 0; i < NJ; ++i) S[i] = cat(ax[i], cross(anch[i], ax[i]));

  // velocity sweep
  SV v_root = sscale(Sr[0], qv[0]);
#pragma unroll
  for (int k = 1; k < 6; ++k) v_root = sadd(v_root, sscale(Sr[k], qv[k]));
  SV v[NJ];
  static_for<0, NJ>([&](auto i_) {
    constexpr int i = CI(i_);
    constexpr int par = T::LINK_PARENT[i];
    const SV& vp = par < 0 ? v_root : v[par < 0 ? 0 : par];
    v[i] = sadd(vp, sscale(S[i], qv[6 + i]));
  });
  auto body_v = [&](auto b_) -> const SV& {
    constexpr int b = CI(b_);
    constexpr int last = T::BODY_LAST_LINK[b];
    if constexpr (b == 0) return v_root;
    else return v[last];
  };

  // spatial inertias, contacts (forces and the implicit damping coupling)
  S6 IO[NB], K[NB];
  SV fext[NB];
  static_for<0, NB>([&](auto b_) {
    constexpr int b = CI(b_);
    IO[b] = spatial_inertia<b>(quat[b], com[b]);
    K[b] = s6zero();
    fext[b] = szero();
  });
  if (p.contacts) {
    static_for<0, NC>([&](auto c_) {
      constexpr int c = CI(c_);
      constexpr int b = T::CONTACT_BODY[c];
      constexpr V3 pt = v3(T::CONTACT_POINT[c]);
      constexpr float rad = T::CONTACT_RADIUS[c];
      V3 x = add(pos[b], qrot(quat[b], pt));
      const SV& vb = body_v(Int<b>{});
      V3 xdot = add(bot(vb), cross(top(vb), x));
      float depth = rad - x.z;
      float active = depth > 0.f ? 1.f : 0.f;
      float fn = fmaxf(STIFFNESS * depth * active - DAMPING * xdot.z * active, 0.f);
      float vt0 = xdot.x, vt1 = xdot.y;
      float vt_norm = sqrtf(vt0 * vt0 + vt1 * vt1 + V_REG2);
      float c_t = MU * fn / vt_norm;
      V3 f = {-c_t * vt0, -c_t * vt1, fn};
      fext[b] = sadd(fext[b], cat(cross(x, f), f));
      float W0 = c_t, W1 = c_t, W2 = DAMPING * active;
      float* k = K[b].m;
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
    });
  }

  // RNEA bias, gravity as a fictitious base acceleration
  SV w_rot = sadd(sadd(sscale(Sr[3], qv[3]), sscale(Sr[4], qv[4])), sscale(Sr[5], qv[5]));
  SV a_root_b = mcross(v_root, w_rot);
  a_root_b.a[5] = GRAVITY + a_root_b.a[5];
  SV a[NJ];
  static_for<0, NJ>([&](auto i_) {
    constexpr int i = CI(i_);
    constexpr int par = T::LINK_PARENT[i];
    const SV& vp = par < 0 ? v_root : v[par < 0 ? 0 : par];
    const SV& ap = par < 0 ? a_root_b : a[par < 0 ? 0 : par];
    a[i] = sadd(ap, mcross(vp, sscale(S[i], qv[6 + i])));
  });
  SV fb[NB];
  static_for<0, NB>([&](auto b_) {
    constexpr int b = CI(b_);
    const SV& vb = body_v(b_);
    constexpr int last = T::BODY_LAST_LINK[b];
    const SV& ab = b == 0 ? a_root_b : a[b == 0 ? 0 : last];
    SV Ivb = mat6vec(IO[b], vb);
    fb[b] = ssub(sadd(mat6vec(IO[b], ab), fcross(vb, Ivb)), fext[b]);
  });
  SV fl[NJ];
  static_for<0, NJ>([&](auto i_) {
    constexpr int i = CI(i_);
    constexpr int cb = T::LINK_CARRIER[i];
    fl[i] = cb >= 0 ? fb[cb < 0 ? 0 : cb] : szero();
  });
  SV f_root = fb[0];
  static_for_down<0, NJ>([&](auto i_) {
    constexpr int i = CI(i_);
    constexpr int par = T::LINK_PARENT[i];
    rhs[i] = rhs[i] - sdot(S[i], fl[i]);
    if constexpr (par < 0) f_root = sadd(f_root, fl[i]);
    else fl[par] = sadd(fl[par], fl[i]);
  });
  float rhs_root[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) rhs_root[k] = -sdot(Sr[k], f_root);

  // zero-velocity ABA; contact damping enters as h K_b, a spatial added
  // inertia of body b
  const float h = p.h;
  S6 IA[NJ];
  SV pA[NJ];
  static_for<0, NJ>([&](auto i_) {
    constexpr int i = CI(i_);
    constexpr int cb = T::LINK_CARRIER[i];
    if constexpr (cb >= 0) {
#pragma unroll
      for (int k = 0; k < 21; ++k) IA[i].m[k] = IO[cb].m[k] + h * K[cb].m[k];
    } else {
      IA[i] = s6zero();
    }
    pA[i] = szero();
  });
  S6 IA_root;
#pragma unroll
  for (int k = 0; k < 21; ++k) IA_root.m[k] = IO[0].m[k] + h * K[0].m[k];
  SV pA_root = szero();

  SV U[NJ];
  float d_inv[NJ], u[NJ];
  static_for_down<0, NJ>([&](auto i_) {
    constexpr int i = CI(i_);
    constexpr int par = T::LINK_PARENT[i];
    U[i] = mat6vec(IA[i], S[i]);
    d_inv[i] = 1.0f / (sdot(S[i], U[i]) + p.d_extra[i]);
    u[i] = rhs[i] - sdot(S[i], pA[i]);
    SV Ud = sscale(U[i], d_inv[i]);
    S6& IP = par < 0 ? IA_root : IA[par < 0 ? 0 : par];
    SV& pP = par < 0 ? pA_root : pA[par < 0 ? 0 : par];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int c = r; c < 6; ++c)
        IP.m[sidx(r, c)] = IP.m[sidx(r, c)] + (IA[i].m[sidx(r, c)] - U[i].a[r] * Ud.a[c]);
    pP = sadd(pP, sadd(pA[i], sscale(U[i], u[i] * d_inv[i])));
  });

  float D0[6][6], u0[6], qdd0[6];
#pragma unroll
  for (int b = 0; b < 6; ++b) {
    SV Wb = mat6vec(IA_root, Sr[b]);
#pragma unroll
    for (int a_ = b; a_ < 6; ++a_) D0[a_][b] = sdot(Sr[a_], Wb);
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) u0[k] = rhs_root[k] - sdot(Sr[k], pA_root);
  chol_solve6(D0, u0, qdd0);

  SV a_root = sscale(Sr[0], qdd0[0]);
#pragma unroll
  for (int k = 1; k < 6; ++k) a_root = sadd(a_root, sscale(Sr[k], qdd0[k]));
  float qdd[NJ];
  SV aL[NJ];
  static_for<0, NJ>([&](auto i_) {
    constexpr int i = CI(i_);
    constexpr int par = T::LINK_PARENT[i];
    const SV& ap = par < 0 ? a_root : aL[par < 0 ? 0 : par];
    qdd[i] = (u[i] - sdot(U[i], ap)) * d_inv[i];
    aL[i] = sadd(ap, sscale(S[i], qdd[i]));
  });

  // semi-implicit Euler, the root quaternion on the exponential map
#pragma unroll
  for (int k = 0; k < 6; ++k) qv[k] = qv[k] + h * qdd0[k];
#pragma unroll
  for (int i = 0; i < NJ; ++i) qv[6 + i] = qv[6 + i] + h * qdd[i];
  float w0 = qv[3], w1 = qv[4], w2 = qv[5];
  float n2 = w0 * w0 + w1 * w1 + w2 * w2;
  bool big = n2 > 1e-16f;
  float norm = sqrtf(big ? n2 : 1.f);
  float half = p.half_h * norm;
  float sh, ch;
  sincosf(half, &sh, &ch);
  float kfac = big ? sh / norm : p.half_h;
  Q4 qn = qmul({qp[3], qp[4], qp[5], qp[6]}, {ch, kfac * w0, kfac * w1, kfac * w2});
  float qinv = rsqrtf(qn.w * qn.w + qn.x * qn.x + qn.y * qn.y + qn.z * qn.z);
#pragma unroll
  for (int k = 0; k < 3; ++k) qp[k] = qp[k] + h * qv[k];
  qp[3] = qn.w * qinv;
  qp[4] = qn.x * qinv;
  qp[5] = qn.y * qinv;
  qp[6] = qn.z * qinv;
#pragma unroll
  for (int i = 0; i < NJ; ++i) qp[7 + i] = qp[7 + i] + h * qv[6 + i];
}

// ---------------------------------------------------------------------------
// DeepMimic tracking reward (Peng et al. 2018 weights)
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

HD void joint_quats(const float* qp, Q4 (&q)[NJOINTS]) {
  static_for<0, NJOINTS>([&](auto j_) {
    constexpr int j = CI(j_);
    constexpr int s = T::JOINT_QPOS[j];
    if constexpr (T::JOINT_DOF[j] == 3) {
      float s0, c0, s1, c1, s2, c2;
      sincosf(0.5f * qp[s], &s0, &c0);
      sincosf(0.5f * qp[s + 1], &s1, &c1);
      sincosf(0.5f * qp[s + 2], &s2, &c2);
      q[j] = qmul({c0, s0, 0.f, 0.f}, qmul({c1, 0.f, s1, 0.f}, {c2, 0.f, 0.f, s2}));
    } else {
      float s0, c0;
      sincosf(0.5f * qp[s], &s0, &c0);
      q[j] = {c0, 0.f, -s0, 0.f};
    }
  });
}

// end-effector positions and the geom-mass COM
HD void fk_reward(const float* qp, V3 (&ee)[NEE], V3& com) {
  V3 pos[NB], ax[NJ], anch[NJ];
  Q4 quat[NB];
  fk<false>(qp, pos, quat, ax, anch);
  static_for<0, NEE>([&](auto e_) {
    constexpr int e = CI(e_);
    constexpr int b = T::EE_BODY[e];
    constexpr V3 pt = v3(T::EE_POINT[e]);
    ee[e] = add(pos[b], qrot(quat[b], pt));
  });
  com = {0.f, 0.f, 0.f};
  static_for<0, NG>([&](auto g_) {
    constexpr int g = CI(g_);
    constexpr int b = T::GEOM_BODY[g];
    constexpr V3 gc = v3(T::GEOM_COM[g]);
    constexpr float frac = T::GEOM_MASS_FRAC[g];
    V3 gp = add(pos[b], qrot(quat[b], gc));
    com = add(com, scale(gp, frac));
  });
}

HD_NOINLINE float tracking_reward(const float* qp, const float* qv, const float* rqp,
                                  const float* rqv) {
  Q4 q[NJOINTS], qr[NJOINTS];
  joint_quats(qp, q);
  joint_quats(rqp, qr);
  float pose_err = 0.f;
  static_for<0, NJOINTS>([&](auto j_) {
    constexpr int j = CI(j_);
    constexpr float wj = T::JOINT_WEIGHT[j];
    float d = q[j].w * qr[j].w + q[j].x * qr[j].x + q[j].y * qr[j].y + q[j].z * qr[j].z;
    d = fminf(fmaxf(fabsf(d), 0.f), 1.f);
    float ang = 2.f * acos01(d);
    pose_err = pose_err + wj * ang * ang;
  });
  float vel_err = 0.f;
#pragma unroll
  for (int k = 6; k < NV; ++k) {
    float d = qv[k] - rqv[k];
    vel_err = vel_err + d * d;
  }
  vel_err = vel_err / float(NV - 6);
  V3 ee[NEE], eer[NEE], com, comr;
  fk_reward(qp, ee, com);
  fk_reward(rqp, eer, comr);
  float ee_err = 0.f;
#pragma unroll
  for (int e = 0; e < NEE; ++e) {
    V3 d = sub(ee[e], eer[e]);
    ee_err = ee_err + dot(d, d);
  }
  ee_err = ee_err / float(NEE);
  V3 dc = sub(com, comr);
  float com_err = dot(dc, dc);
  return 0.65f * expf(-2.f * pose_err) + 0.1f * expf(-0.1f * vel_err) +
         0.15f * expf(-40.f * ee_err) + 0.1f * expf(-10.f * com_err);
}

constexpr int THREADS = 32;

HD void load(float* dst, const float* __restrict__ src, int n) {
#pragma unroll
  for (int k = 0; k < 35; ++k)
    if (k < n) dst[k] = src[k];
}

__global__ void __launch_bounds__(THREADS)
control_step_kernel(const float* __restrict__ qpos, const float* __restrict__ qvel,
                    const float* __restrict__ target, const float* __restrict__ ref_qvel,
                    float* __restrict__ qp_out, float* __restrict__ qv_out,
                    float* __restrict__ reward, int N, StepParams p) {
  int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  float qp[NQ], qv[NV], tg[NQ];
  load(qp, qpos + (size_t)n * NQ, NQ);
  load(qv, qvel + (size_t)n * NV, NV);
  load(tg, target + (size_t)n * NQ, NQ);
#pragma unroll 1
  for (int s = 0; s < p.substeps; ++s) substep(qp, qv, tg, p);
#pragma unroll
  for (int k = 0; k < NQ; ++k) qp_out[(size_t)n * NQ + k] = qp[k];
#pragma unroll
  for (int k = 0; k < NV; ++k) qv_out[(size_t)n * NV + k] = qv[k];
  if (reward != nullptr) {
    float rqv[NV];
    load(rqv, ref_qvel + (size_t)n * NV, NV);
    reward[n] = tracking_reward(qp, qv, tg, rqv);
  }
}

__global__ void __launch_bounds__(THREADS)
rollout_kernel(const float* __restrict__ qpos, const float* __restrict__ qvel,
               const float* __restrict__ done, const float* __restrict__ targets,
               const float* __restrict__ ref_qvels, float* __restrict__ qp_out,
               float* __restrict__ qv_out, float* __restrict__ done_out,
               float* __restrict__ rewards, int N, int T_steps, StepParams p) {
  int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  float qp[NQ], qv[NV], tg[NQ], rqv[NV];
  load(qp, qpos + (size_t)n * NQ, NQ);
  load(qv, qvel + (size_t)n * NV, NV);
  float dn = done[n];
#pragma unroll 1
  for (int t = 0; t < T_steps; ++t) {
    size_t row = (size_t)t * N + n;
    load(tg, targets + row * NQ, NQ);
    load(rqv, ref_qvels + row * NV, NV);
    if (!(dn > 0.f)) {  // done envs stay frozen
#pragma unroll 1
      for (int s = 0; s < p.substeps; ++s) substep(qp, qv, tg, p);
    }
    dn = fmaxf(dn, qp[2] < p.fall_height ? 1.f : 0.f);
    rewards[row] = tracking_reward(qp, qv, tg, rqv) * (1.f - dn);
  }
#pragma unroll
  for (int k = 0; k < NQ; ++k) qp_out[(size_t)n * NQ + k] = qp[k];
#pragma unroll
  for (int k = 0; k < NV; ++k) qv_out[(size_t)n * NV + k] = qv[k];
  done_out[n] = dn;
}

__global__ void __launch_bounds__(THREADS)
reward_kernel(const float* __restrict__ qpos, const float* __restrict__ qvel,
              const float* __restrict__ ref_qpos, const float* __restrict__ ref_qvel,
              float* __restrict__ out, int N) {
  int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  float qp[NQ], qv[NV], rqp[NQ], rqv[NV];
  load(qp, qpos + (size_t)n * NQ, NQ);
  load(qv, qvel + (size_t)n * NV, NV);
  load(rqp, ref_qpos + (size_t)n * NQ, NQ);
  load(rqv, ref_qvel + (size_t)n * NV, NV);
  out[n] = tracking_reward(qp, qv, rqp, rqv);
}

int blocks(int N) { return (N + THREADS - 1) / THREADS; }

}  // namespace hum

extern "C" {

int humanoid_control_step_f32(const float* qpos, const float* qvel, const float* target,
                              const float* ref_qvel, float* qp_out, float* qv_out,
                              float* reward, int N, const hum::StepParams* p,
                              cudaStream_t stream) {
  hum::control_step_kernel<<<hum::blocks(N), hum::THREADS, 0, stream>>>(
      qpos, qvel, target, ref_qvel, qp_out, qv_out, reward, N, *p);
  return (int)cudaGetLastError();
}

int humanoid_rollout_f32(const float* qpos, const float* qvel, const float* done,
                         const float* targets, const float* ref_qvels, float* qp_out,
                         float* qv_out, float* done_out, float* rewards, int N, int T_steps,
                         const hum::StepParams* p, cudaStream_t stream) {
  hum::rollout_kernel<<<hum::blocks(N), hum::THREADS, 0, stream>>>(
      qpos, qvel, done, targets, ref_qvels, qp_out, qv_out, done_out, rewards, N, T_steps, *p);
  return (int)cudaGetLastError();
}

int humanoid_tracking_reward_f32(const float* qpos, const float* qvel, const float* ref_qpos,
                                 const float* ref_qvel, float* out, int N,
                                 cudaStream_t stream) {
  hum::reward_kernel<<<hum::blocks(N), hum::THREADS, 0, stream>>>(qpos, qvel, ref_qpos,
                                                                  ref_qvel, out, N);
  return (int)cudaGetLastError();
}

const char* humanoid_dynamics_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
