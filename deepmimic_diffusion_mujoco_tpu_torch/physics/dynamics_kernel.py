"""The whole-control-step, whole-rollout and tracking-reward kernels.

Replaces the TPU kernels of ``deepmimic_diffusion_mujoco_tpu/physics/
dynamics_pallas.py``: `control_step_pallas` (B5), `rollout_pallas` (B6) and
`tracking_reward_pallas` (B7). All three are entry points of one CUDA
source, ``csrc/humanoid_dynamics.cu``, which spreads one env over a group
of 8 or 16 lanes of a warp; its static tables, and which lane does what
(`chains`, `chain_tables`, `lane_items`), come from
``csrc/humanoid_tables.h``, which `tables_header()` writes from the
port's own tables. `dynamics_plan(N)` is the launch plan (lanes per env,
envs per block, shared memory).

- Plain versions: `control_step_components`, `tracking_reward_components`
  and `_rollout_env_step` are 1:1 transcriptions of the JAX component form
  (`_substep` :303-501, the reward :725, the rollout step :776) on lists of
  (N,) tensors, in float32 or float64, in the same association order;
  python floats keep the structural constants out of the arithmetic, as in
  the JAX trace. `control_step_plain`, `rollout_plain` and
  `tracking_reward_plain` take the public layout: qpos (N, 35), qvel
  (N, 34), targets (T, N, 35), reference velocities (T, N, 34).
- CUDA wrappers: `control_step_cuda` (B5, with or without the fused
  reward), `rollout_cuda` (B6) and `tracking_reward_cuda` (B7) take CUDA
  float32 tensors in the public layout and raise on anything else; each
  takes an optional ``plan=`` and counts its launches in `.launches`.
- Dispatchers `control_step`, `rollout` and `tracking_reward_fused`: the
  kernel for CUDA tensors, the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..data.skeleton import BODY_JOINTS, DOF_DEF, JOINT_WEIGHT, QPOS_JOINT_SLICES
from ..ops import _build
from .dynamics import (
    BODY_COM,
    BODY_INERTIA,
    BODY_MASS,
    CONTACT_BODY,
    CONTACT_POINT,
    CONTACT_RADIUS,
    JOINT_ANCHOR,
    JOINT_AXIS,
    LIMIT_HI,
    LIMIT_LO,
    NB,
    NJ,
    NQ,
    NV,
    PD_KD,
    PD_KP,
)
from .dynamics_aba import _BODY_LAST_LINK, LINK_CARRIER, LINK_PARENT
from .humanoid_model import (
    BODIES,
    BODY_INDEX,
    FLOOR_FRICTION,
    GRAVITY,
    JOINT_ARMATURE,
    JOINT_DAMPING,
    JOINT_STIFFNESS,
    TOTAL_MASS,
)

# Static tables as python floats (structural constants stay out of the
# tensor arithmetic).
_MASS = [float(m) for m in BODY_MASS]
_COM = [[float(x) for x in c] for c in BODY_COM]
_IB = [[[float(x) for x in row] for row in I] for I in BODY_INERTIA]
_CBODY = [int(b) for b in CONTACT_BODY]
_CPOINT = [[float(x) for x in p] for p in CONTACT_POINT]
_CRAD = [float(r) for r in CONTACT_RADIUS]
_KP = [float(k) for k in PD_KP]
_KD = [float(k) for k in PD_KD]
_LO = [float(v) for v in LIMIT_LO]
_HI = [float(v) for v in LIMIT_HI]
NC = len(_CBODY)

# contact model (dynamics.contact_terms' defaults)
STIFFNESS, DAMPING, MU, V_REG = 30000.0, 1000.0, FLOOR_FRICTION, 5e-3
# limit penalty (dynamics.limit_forces' defaults)
LIMIT_K, LIMIT_C = 300.0, 3.0

_JW = np.asarray([JOINT_WEIGHT[j] for j in BODY_JOINTS], np.float64)
_JW = [float(w) for w in (_JW / _JW.sum())]
_EE_BODIES = [
    (BODY_INDEX[b.name], tuple(float(x) for x in b.end_effector))
    for b in BODIES if b.end_effector
]
_GEOMS = [
    (bi, tuple(float(x) for x in g.com), float(g.mass))
    for bi, b in enumerate(BODIES) for g in b.geoms
]
_ACOS_COEF = (1.5707963050, -0.2145988016, 0.0889789874, -0.0501743046,
              0.0308918810, -0.0170881256, 0.0066700901, -0.0012624911)


# ---------------------------------------------------------------------------
# Component-form algebra: vectors are tuples of (N,) tensors (or python
# floats for structural constants); all loops unroll in Python.
# ---------------------------------------------------------------------------


def _cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _dot(a, b):
    return sum(x * y for x, y in zip(a, b))


def _add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _scale(a, s):
    return tuple(x * s for x in a)


def _qmul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    )


def _qrot(q, v):
    """Rotate vec3 v by quat q: v + 2 qw (qv x v) + 2 qv x (qv x v)."""
    qv = (q[1], q[2], q[3])
    t = _scale(_cross(qv, v), 2.0)
    return _add(_add(v, _scale(t, q[0])), _cross(qv, t))


def _rotmat(q):
    """Quat -> rotation matrix rows R[i][k] (world image of e_k, comp i)."""
    w, x, y, z = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return [
        [1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)],
        [2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)],
        [2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)],
    ]


def _mcross(a, b):
    """Spatial motion cross product a x_m b (6-tuples, [w; vO] order)."""
    w, vo = a[:3], a[3:]
    top = _cross(w, b[:3])
    bot = _add(_cross(w, b[3:]), _cross(vo, b[:3]))
    return top + bot


def _fcross(a, f):
    """Spatial force cross product a x* f ([n; f] force order)."""
    w, vo = a[:3], a[3:]
    top = _add(_cross(w, f[:3]), _cross(vo, f[3:]))
    bot = _cross(w, f[3:])
    return top + bot


def _mat6vec(M, v):
    return tuple(_dot(M[i], v) for i in range(6))


def _mat6_add(A, B):
    return [[A[i][j] + B[i][j] for j in range(6)] for i in range(6)]


def _mat6_zero():
    return [[0.0] * 6 for _ in range(6)]


def _relu(x):
    return torch.clamp_min(x, 0.0)


def _spatial_inertia(b, quat, com_w):
    """Body b's spatial inertia about the world origin, [n;f]/[w;v] coords:
    [[I_c + m cx cx^T, m cx], [-(m cx), m 1]]."""
    m = _MASS[b]
    R = _rotmat(quat)
    Ib = _IB[b]
    # I_w = R I_b R^T, unrolled with static I_b entries (skip exact zeros)
    tmp = [[sum(R[i][k] * Ib[k][l] for k in range(3) if Ib[k][l] != 0.0)
            for l in range(3)] for i in range(3)]
    Iw = [[sum(tmp[i][l] * R[j][l] for l in range(3)) for j in range(3)]
          for i in range(3)]
    c = com_w
    cc = _dot(c, c)
    ctil = [
        [0.0, -c[2], c[1]],
        [c[2], 0.0, -c[0]],
        [-c[1], c[0], 0.0],
    ]
    M = _mat6_zero()
    for i in range(3):
        for j in range(3):
            M[i][j] = Iw[i][j] + m * ((cc if i == j else 0.0) - c[i] * c[j])
            M[i][3 + j] = m * ctil[i][j]
            M[3 + i][j] = -m * ctil[i][j]
            M[3 + i][3 + j] = m if i == j else 0.0
    return M


def _chol_solve6(A, b):
    """Solve the SPD 6x6 system A x = b (nested-list component form)."""
    L = [[None] * 6 for _ in range(6)]
    for j in range(6):
        s = A[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        inv = torch.rsqrt(s)
        L[j][j] = inv  # store 1/L_jj
        for i in range(j + 1, 6):
            s = A[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    y = [None] * 6
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s * L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s * L[i][i]
    return tuple(x)


def _fk(qp, want_dofs=True):
    """qp: list of 35 tensors -> (pos[NB] vec3, quat[NB] quat4, com[NB]
    vec3, axis[NJ] vec3, anchor[NJ] vec3)."""
    inv = torch.rsqrt(qp[3] * qp[3] + qp[4] * qp[4] + qp[5] * qp[5] + qp[6] * qp[6])
    rq = (qp[3] * inv, qp[4] * inv, qp[5] * inv, qp[6] * inv)
    pos = [None] * NB
    quat = [None] * NB
    pos[0] = (qp[0], qp[1], qp[2])
    quat[0] = rq
    axes, anchors = [], []
    li = 0
    for bi, b in enumerate(BODIES[1:], start=1):
        parent = BODY_INDEX[b.parent]
        offset = tuple(float(x) for x in b.offset)
        q_local = (1.0, 0.0, 0.0, 0.0)
        t_local = (0.0, 0.0, 0.0)
        for hinge in b.joints:
            a_k = tuple(float(x) for x in hinge.axis)
            p_k = tuple(float(x) for x in hinge.pos)
            if want_dofs:
                axes.append(_qrot(quat[parent], _qrot(q_local, a_k)))
                anchors.append(_add(
                    pos[parent],
                    _qrot(quat[parent], _add(_add(offset, t_local), _qrot(q_local, p_k))),
                ))
            half = 0.5 * qp[7 + li]
            ch, sh = torch.cos(half), torch.sin(half)
            qk = (ch, sh * a_k[0], sh * a_k[1], sh * a_k[2])
            tk = _sub(p_k, _qrot(qk, p_k))
            t_local = _add(t_local, _qrot(q_local, tk))
            q_local = _qmul(q_local, qk)
            li += 1
        pos[bi] = _add(pos[parent], _qrot(quat[parent], _add(offset, t_local)))
        quat[bi] = _qmul(quat[parent], q_local)
    com = [_add(pos[b], _qrot(quat[b], tuple(_COM[b]))) for b in range(NB)]
    return pos, quat, com, axes, anchors


def _substep(qp, qv, tgt, h, kp_scale, kd_scale, contacts, limits):
    """One implicitly-damped semi-implicit Euler substep with PD torques
    toward `tgt` (dynamics_pallas._substep, line for line)."""
    pos, quat, com, S_ax, S_anch = _fk(qp)

    # ---- joint-space applied torques: PD + passive (+ limits) ------------
    rhs_j = [None] * NJ
    for i in range(NJ):
        q_i, qd_i, t_i = qp[7 + i], qv[6 + i], tgt[7 + i]
        tau = (_KP[i] * kp_scale) * (t_i - q_i) - (_KD[i] * kd_scale) * qd_i
        tau = tau - JOINT_STIFFNESS * q_i - JOINT_DAMPING * qd_i
        if limits:
            over = _relu(q_i - _HI[i])
            under = _relu(_LO[i] - q_i)
            gate = ((over > 0) | (under > 0)).to(q_i.dtype)
            tau = tau - LIMIT_K * over + LIMIT_K * under - LIMIT_C * qd_i * gate
        rhs_j[i] = tau

    # ---- motion subspaces (world-origin Plucker) --------------------------
    q0 = quat[0]
    p_r = pos[0]
    S_root = []
    for k in range(3):  # world translations
        e = [0.0, 0.0, 0.0]
        e[k] = 1.0
        S_root.append((0.0, 0.0, 0.0, e[0], e[1], e[2]))
    for k in range(3):  # body-frame rotation axes (MuJoCo free joint)
        e = [0.0, 0.0, 0.0]
        e[k] = 1.0
        n_k = _qrot(q0, tuple(e))
        S_root.append(n_k + _cross(p_r, n_k))
    S = [S_ax[i] + _cross(S_anch[i], S_ax[i]) for i in range(NJ)]

    # ---- velocity sweep ----------------------------------------------------
    v_root = _scale(S_root[0], qv[0])
    for k in range(1, 6):
        v_root = _add(v_root, _scale(S_root[k], qv[k]))
    v = [None] * NJ
    for i in range(NJ):
        p = int(LINK_PARENT[i])
        vp = v_root if p < 0 else v[p]
        v[i] = _add(vp, _scale(S[i], qv[6 + i]))
    body_v = [v_root] + [v[_BODY_LAST_LINK[b]] for b in range(1, NB)]

    # ---- spatial inertias + contacts ---------------------------------------
    I_O = [_spatial_inertia(b, quat[b], com[b]) for b in range(NB)]
    f_ext = [None] * NB
    I_K = [None] * NB
    if contacts:
        for b in range(NB):
            f_ext[b] = (0.0,) * 6
            I_K[b] = _mat6_zero()
        for p in range(NC):
            b = _CBODY[p]
            x = _add(pos[b], _qrot(quat[b], tuple(_CPOINT[p])))
            w_b, vO_b = body_v[b][:3], body_v[b][3:]
            xdot = _add(vO_b, _cross(w_b, x))
            depth = _CRAD[p] - x[2]
            active = (depth > 0.0).to(x[2].dtype)
            fn = _relu(STIFFNESS * depth * active - DAMPING * xdot[2] * active)
            vt0, vt1 = xdot[0], xdot[1]
            vt_norm = torch.sqrt(vt0 * vt0 + vt1 * vt1 + V_REG * V_REG)
            c_t = MU * fn / vt_norm
            f = (-c_t * vt0, -c_t * vt1, fn)
            f_ext[b] = _add(f_ext[b], _cross(x, f) + f)
            W = (c_t, c_t, DAMPING * active)
            xt = [
                [0.0, -x[2], x[1]],
                [x[2], 0.0, -x[0]],
                [-x[1], x[0], 0.0],
            ]
            K = I_K[b]
            for i in range(3):
                for j in range(3):
                    # C block: sum_k xt[i][k] W[k] xt[j][k]
                    K[i][j] = K[i][j] + sum(
                        xt[i][k] * W[k] * xt[j][k] for k in range(3)
                        if not (isinstance(xt[i][k], float) and xt[i][k] == 0.0)
                        and not (isinstance(xt[j][k], float) and xt[j][k] == 0.0)
                    )
                    # B block: xt[i][j] W[j]
                    if not (isinstance(xt[i][j], float) and xt[i][j] == 0.0):
                        bij = xt[i][j] * W[j]
                        K[i][3 + j] = K[i][3 + j] + bij
                        K[3 + j][i] = K[3 + j][i] + bij
                K[3 + i][3 + i] = K[3 + i][3 + i] + W[i]

    # ---- RNEA bias (gravity as fictitious base acceleration) --------------
    a_base = (0.0, 0.0, 0.0, 0.0, 0.0, GRAVITY)
    w_rot = _scale(S_root[3], qv[3])
    for k in (4, 5):
        w_rot = _add(w_rot, _scale(S_root[k], qv[k]))
    a_root_b = _add(a_base, _mcross(v_root, w_rot))
    a = [None] * NJ
    for i in range(NJ):
        p = int(LINK_PARENT[i])
        vp = v_root if p < 0 else v[p]
        ap = a_root_b if p < 0 else a[p]
        a[i] = _add(ap, _mcross(vp, _scale(S[i], qv[6 + i])))
    fb = [None] * NB
    for b in range(NB):
        vb = body_v[b]
        ab = a_root_b if b == 0 else a[_BODY_LAST_LINK[b]]
        Ivb = _mat6vec(I_O[b], vb)
        fb[b] = _add(_mat6vec(I_O[b], ab), _fcross(vb, Ivb))
        if contacts:
            fb[b] = _sub(fb[b], f_ext[b])
    fl = [fb[int(LINK_CARRIER[i])] if LINK_CARRIER[i] >= 0 else (0.0,) * 6 for i in range(NJ)]
    tau_rnea = [None] * NJ
    f_root = fb[0]
    for i in reversed(range(NJ)):
        tau_rnea[i] = _dot(S[i], fl[i])
        p = int(LINK_PARENT[i])
        if p < 0:
            f_root = _add(f_root, fl[i])
        else:
            fl[p] = _add(fl[p], fl[i])

    rhs_root = tuple(-_dot(S_root[k], f_root) for k in range(6))
    rhs = [rhs_j[i] - tau_rnea[i] for i in range(NJ)]

    # ---- zero-velocity ABA: exact solve of (M + h D) qacc = rhs ------------
    IA = [None] * NJ
    pA = [(0.0,) * 6 for _ in range(NJ)]
    for i in range(NJ):
        cb = int(LINK_CARRIER[i])
        if cb >= 0:
            M = I_O[cb]
            if contacts:
                M = _mat6_add(M, [[h * I_K[cb][r][c] for c in range(6)] for r in range(6)])
            IA[i] = M
        else:
            IA[i] = _mat6_zero()
    IA_root = I_O[0]
    if contacts:
        IA_root = _mat6_add(IA_root, [[h * I_K[0][r][c] for c in range(6)] for r in range(6)])
    pA_root = (0.0,) * 6

    U = [None] * NJ
    d_inv = [None] * NJ
    u = [None] * NJ
    for i in reversed(range(NJ)):
        d_extra = JOINT_ARMATURE + h * (JOINT_DAMPING + _KD[i] * kd_scale)
        U[i] = _mat6vec(IA[i], S[i])
        d_inv[i] = 1.0 / (_dot(S[i], U[i]) + d_extra)
        u[i] = rhs[i] - _dot(S[i], pA[i])
        Ud = _scale(U[i], d_inv[i])
        Ia = [[IA[i][r][c] - U[i][r] * Ud[c] for c in range(6)] for r in range(6)]
        pa = _add(pA[i], _scale(U[i], u[i] * d_inv[i]))
        p = int(LINK_PARENT[i])
        if p < 0:
            IA_root = _mat6_add(IA_root, Ia)
            pA_root = _add(pA_root, pa)
        else:
            IA[p] = _mat6_add(IA[p], Ia)
            pA[p] = _add(pA[p], pa)

    Wk = [_mat6vec(IA_root, S_root[k]) for k in range(6)]
    D0 = [[_dot(S_root[a_], Wk[b_]) for b_ in range(6)] for a_ in range(6)]
    u0 = tuple(rhs_root[k] - _dot(S_root[k], pA_root) for k in range(6))
    qdd0 = _chol_solve6(D0, u0)

    a_root = _scale(S_root[0], qdd0[0])
    for k in range(1, 6):
        a_root = _add(a_root, _scale(S_root[k], qdd0[k]))
    qdd = [None] * NJ
    aL = [None] * NJ
    for i in range(NJ):
        p = int(LINK_PARENT[i])
        ap = a_root if p < 0 else aL[p]
        qdd[i] = (u[i] - _dot(U[i], ap)) * d_inv[i]
        aL[i] = _add(ap, _scale(S[i], qdd[i]))

    # ---- integrate (semi-implicit Euler, root quat on the exp map) --------
    qv_new = [qv[k] + h * qdd0[k] for k in range(6)] + [qv[6 + i] + h * qdd[i] for i in range(NJ)]
    w0, w1, w2 = qv_new[3], qv_new[4], qv_new[5]
    n2 = w0 * w0 + w1 * w1 + w2 * w2
    big = n2 > 1e-16
    safe = torch.where(big, n2, torch.ones_like(n2))
    norm = torch.sqrt(safe)
    half = 0.5 * h * norm
    kfac = torch.where(big, torch.sin(half) / norm, torch.full_like(n2, 0.5 * h))
    dq = (torch.cos(half), kfac * w0, kfac * w1, kfac * w2)
    quat_new = _qmul((qp[3], qp[4], qp[5], qp[6]), dq)
    qinv = torch.rsqrt(sum(c * c for c in quat_new))
    qp_new = (
        [qp[k] + h * qv_new[k] for k in range(3)]
        + [c * qinv for c in quat_new]
        + [qp[7 + i] + h * qv_new[6 + i] for i in range(NJ)]
    )
    return qp_new, qv_new


def control_step_components(qp, qv, tgt, *, h, substeps, kp_scale=1.0, kd_scale=1.0,
                            contacts=True, limits=True):
    """The full control step on component lists of (N,) tensors."""
    qp, qv = list(qp), list(qv)
    for _ in range(substeps):
        qp, qv = _substep(qp, qv, tgt, h, kp_scale, kd_scale, contacts, limits)
    return qp, qv


# ---------------------------------------------------------------------------
# DeepMimic tracking reward in component form (env.tracking_reward twin)
# ---------------------------------------------------------------------------


def _acos01(x):
    """arccos for x in [0, 1] via the Abramowitz-Stegun 4.4.46 polynomial,
    |err| <= 2e-8 rad (the JAX kernel's, `dynamics_pallas.py:680-689`)."""
    p = _ACOS_COEF
    s = p[7]
    for c in p[6::-1]:
        s = s * x + c
    return torch.sqrt(_relu(1.0 - x)) * s


def _joint_quats_comp(qp):
    """Per-joint LOCAL rotations as quats: intrinsic-xyz Euler for 3-DOF
    joints, hinge about -y for 1-DOF."""
    quats = []
    for j in BODY_JOINTS:
        sl = QPOS_JOINT_SLICES[j]
        if DOF_DEF[j] == 3:
            h0 = 0.5 * qp[sl.start]
            h1 = 0.5 * qp[sl.start + 1]
            h2 = 0.5 * qp[sl.start + 2]
            qx = (torch.cos(h0), torch.sin(h0), 0.0, 0.0)
            qy = (torch.cos(h1), 0.0, torch.sin(h1), 0.0)
            qz = (torch.cos(h2), 0.0, 0.0, torch.sin(h2))
            quats.append(_qmul(qx, _qmul(qy, qz)))
        else:
            h = 0.5 * qp[sl.start]
            quats.append((torch.cos(h), 0.0, -torch.sin(h), 0.0))
    return quats


def _fk_reward(qp):
    """Body poses -> (end-effector positions [4 vec3], geom-mass COM)."""
    pos, quat, _, _, _ = _fk(qp, want_dofs=False)
    ees = [_add(pos[b], _qrot(quat[b], pt)) for b, pt in _EE_BODIES]
    com = (0.0, 0.0, 0.0)
    for bi, gcom, gm in _GEOMS:
        gpos = _add(pos[bi], _qrot(quat[bi], gcom))
        com = _add(com, _scale(gpos, gm / TOTAL_MASS))
    return ees, com


def tracking_reward_components(qp, qv, rqp, rqv):
    """env.tracking_reward (Peng et al. 2018 weights) on components."""
    q = _joint_quats_comp(qp)
    q_ref = _joint_quats_comp(rqp)
    pose_err = 0.0
    for j in range(len(q)):
        dot = q[j][0] * q_ref[j][0] + q[j][1] * q_ref[j][1] \
            + q[j][2] * q_ref[j][2] + q[j][3] * q_ref[j][3]
        dot = torch.clamp(torch.abs(dot), 0.0, 1.0)
        ang = 2.0 * _acos01(dot)
        pose_err = pose_err + _JW[j] * ang * ang

    vel_err = 0.0
    for k in range(6, NV):
        d = qv[k] - rqv[k]
        vel_err = vel_err + d * d
    vel_err = vel_err / float(NV - 6)

    ees, com = _fk_reward(qp)
    ees_r, com_r = _fk_reward(rqp)
    ee_err = 0.0
    for e, er in zip(ees, ees_r):
        d = _sub(e, er)
        ee_err = ee_err + _dot(d, d)
    ee_err = ee_err / float(len(ees))
    dc = _sub(com, com_r)
    com_err = _dot(dc, dc)

    return (0.65 * torch.exp(-2.0 * pose_err)
            + 0.1 * torch.exp(-0.1 * vel_err)
            + 0.15 * torch.exp(-40.0 * ee_err)
            + 0.1 * torch.exp(-10.0 * com_err))


def _rollout_env_step(qp, qv, dn, tgt, rqv, *, h, substeps, kp_scale, kd_scale, contacts,
                      limits, fall_height):
    """One env control step on components, with the PhysicsTrackingEnv
    bookkeeping (freeze done instances, detect falls, gate rewards). dn is
    a float 0/1 'done' tensor."""
    nqp, nqv = control_step_components(qp, qv, tgt, h=h, substeps=substeps, kp_scale=kp_scale,
                                       kd_scale=kd_scale, contacts=contacts, limits=limits)
    frozen = dn > 0
    qp = [torch.where(frozen, o, n) for o, n in zip(qp, nqp)]
    qv = [torch.where(frozen, o, n) for o, n in zip(qv, nqv)]
    fell = (qp[2] < fall_height).to(dn.dtype)
    dn = torch.maximum(dn, fell)
    # reward on the (frozen) post-step state; done instances gate to 0
    r = tracking_reward_components(qp, qv, tgt, rqv)
    r = r * (1.0 - dn)
    return qp, qv, dn, r


# ---------------------------------------------------------------------------
# Plain versions in the public layout
# ---------------------------------------------------------------------------


def _cols(x: torch.Tensor):
    return list(x.unbind(-1))


def control_step_plain(qpos, qvel, target, ref_qvel=None, *, h, substeps, kp_scale=1.0,
                       kd_scale=1.0, contacts=True, limits=True):
    """(N, 35), (N, 34), (N, 35) [, (N, 34)] -> qpos', qvel' [, reward]: B5's
    semantics in plain PyTorch, the reward on the post-step state against
    (target, ref_qvel)."""
    qp, qv = control_step_components(_cols(qpos), _cols(qvel), _cols(target), h=h,
                                     substeps=substeps, kp_scale=kp_scale, kd_scale=kd_scale,
                                     contacts=contacts, limits=limits)
    out = (torch.stack(qp, -1), torch.stack(qv, -1))
    if ref_qvel is None:
        return out
    return (*out, tracking_reward_components(qp, qv, _cols(target), _cols(ref_qvel)))


def rollout_plain(qpos, qvel, targets, ref_qvels, done, *, h, substeps, kp_scale=1.0,
                  kd_scale=1.0, contacts=True, limits=True, fall_height=0.3):
    """(N, 35), (N, 34), (T, N, 35), (T, N, 34), (N,) bool -> (qpos', qvel',
    rewards (T, N), done' (N,) bool): B6's semantics in plain PyTorch."""
    qp, qv = _cols(qpos), _cols(qvel)
    dn = done.to(qpos.dtype)
    rewards = []
    for t in range(targets.shape[0]):
        qp, qv, dn, r = _rollout_env_step(
            qp, qv, dn, _cols(targets[t]), _cols(ref_qvels[t]), h=h, substeps=substeps,
            kp_scale=kp_scale, kd_scale=kd_scale, contacts=contacts, limits=limits,
            fall_height=fall_height)
        rewards.append(r)
    rewards = torch.stack(rewards) if rewards else qpos.new_zeros((0, qpos.shape[0]))
    return torch.stack(qp, -1), torch.stack(qv, -1), rewards, dn > 0.5


def tracking_reward_plain(qpos, qvel, ref_qpos, ref_qvel):
    """(N, 35), (N, 34), (N, 35), (N, 34) -> (N,): B7's semantics."""
    return tracking_reward_components(_cols(qpos), _cols(qvel), _cols(ref_qpos), _cols(ref_qvel))


# ---------------------------------------------------------------------------
# The kernels' static tables as a C++ header
# ---------------------------------------------------------------------------


def _f32(x) -> str:
    return f"{float(np.float32(x))!r}f".replace("inf", "INFINITY")


def _arr(name: str, values, ctype: str = "float", device: bool = False) -> str:
    a = np.asarray(values)
    dims = "".join(f"[{n}]" for n in a.shape)

    def fmt(v):
        if v.ndim == 0:
            return _f32(v) if ctype == "float" else str(int(v))
        return "{" + ", ".join(fmt(x) for x in v) + "}"

    if device:
        return f"__device__ const {ctype} {name}{dims} = {fmt(a)};"
    return f"  static constexpr {ctype} {name}{dims} = {fmt(a)};"


# The lane groups. The kernels spread one env over a group of L lanes of a
# warp. Five lanes walk the tree's root-to-leaf paths (``chains``); every
# lane takes a fixed share of the bodies (inertia, contacts, body force) and
# of the reward's joints, end effectors and geoms (``lane_items``).
LANE_COUNTS = (8, 16)
N_CHAIN_SLOTS = 7
# LPT weights (float operations, roughly) of one item on a lane
_COST_BODY, _COST_CONTACT = 190, 30
_COST_JOINT = {3: 6, 1: 3}
_COST_EE, _COST_GEOM = 2, 2


def chains():
    """The tree's root-to-leaf paths of links, one per leaf in leaf order:
    [(link, owned), ...]. A link is owned by the path that goes on from it
    through the lowest-numbered child at every fork below it, so
    every link has exactly one owner; the others walk it again to reach
    their own links (the arms walk the chest's three links)."""
    children = {i: [] for i in range(-1, NJ)}
    for i in range(NJ):
        children[int(LINK_PARENT[i])].append(i)
    out = []

    def walk(link, path):
        path = path + [link]
        if not children[link]:
            lowest = [path[m + 1] == min(children[path[m]]) for m in range(len(path) - 1)]
            out.append([(li, all(lowest[k:])) for k, li in enumerate(path)])
        for c in children[link]:
            walk(c, path)

    for root in children[-1]:
        walk(root, [])
    out.sort(key=lambda ch: ch[-1][0])
    return out


def _link_body():
    first, body = _first_links(), [0] * NJ
    for b in range(1, NB):
        for k in range(len(BODIES[b].joints)):
            body[first[b] + k] = b
    return body


def _first_links():
    first, li = [], 0
    for b in BODIES:
        first.append(li)
        li += len(b.joints)
    return first


def chain_tables():
    """Per (chain, slot): link (-1 past the leaf), owned, the body that
    starts at the slot (-1), the body whose last link it is (-1), the hinge
    axis, the anchor's x (the anchors lie on the body's x axis) and the
    offset of the body that starts there; per chain, its first owned slot
    and the chains whose first owned link hangs from each link (joins)."""
    ch = chains()
    first_link = _first_links()
    body_of = _link_body()
    R, K = len(ch), N_CHAIN_SLOTS
    if max(len(c) for c in ch) > K:
        raise ValueError("a root-to-leaf path is longer than the chain slots")
    link = -np.ones((R, K), np.int64)
    owned = np.zeros((R, K), np.int64)
    start = -np.ones((R, K), np.int64)
    carrier = -np.ones((R, K), np.int64)
    axis = np.zeros((R, K, 3))
    anchor = np.zeros((R, K))
    offset = np.zeros((R, K, 3))
    for r, path in enumerate(ch):
        for k, (li, own) in enumerate(path):
            b = body_of[li]
            if np.any(JOINT_ANCHOR[li][1:] != 0):
                raise ValueError(f"link {li}: the kernels take anchors on the body's x axis")
            link[r, k], owned[r, k] = li, int(own)
            axis[r, k], anchor[r, k] = JOINT_AXIS[li], JOINT_ANCHOR[li][0]
            if first_link[b] == li:
                start[r, k] = b
                offset[r, k] = BODIES[b].offset
                prev = 0 if k == 0 else body_of[path[k - 1][0]]
                if BODY_INDEX[BODIES[b].parent] != prev:
                    raise ValueError(f"body {b} does not hang from the body before it")
            carrier[r, k] = LINK_CARRIER[li]
    first_owned = [int(np.argmax(owned[r])) for r in range(R)]
    # join[link] = chains whose first owned link hangs from link (root: -1),
    # in descending order of that first link: the order the plain version
    # adds children into their parent
    joins = {}
    for r in range(R):
        li = int(link[r, first_owned[r]])
        joins.setdefault(int(LINK_PARENT[li]), []).append((li, r))
    joins = {p: [r for _, r in sorted(v, reverse=True)] for p, v in joins.items()}
    inner = [p for p in joins if p >= 0]
    if len(inner) != 1:
        raise ValueError(f"the kernels take one join below the root, the tree has {inner}")
    jl = inner[0]
    owner = [r for r in range(R) for k in range(K) if link[r, k] == jl and owned[r, k]][0]
    slot = [k for k in range(K) if link[owner, k] == jl][0]
    # the owner's own chain continues through the join: its child comes last
    join_roles = [r for r in joins[jl] if r != owner]
    return dict(link=link, owned=owned, start=start, carrier=carrier, axis=axis,
                anchor=anchor, offset=offset, first_owned=first_owned, join_link=jl,
                join_owner=owner, join_slot=slot, join_roles=join_roles,
                root_roles=joins[-1])


def _lpt(costs, lanes):
    """Items (index, cost) onto lanes, longest first, each to the least
    loaded lane (the lowest on ties) -> per-lane lists in item order."""
    load = [0] * lanes
    out = [[] for _ in range(lanes)]
    for i, c in sorted(costs, key=lambda ic: (-ic[1], ic[0])):
        j = min(range(lanes), key=lambda j: (load[j], j))
        load[j] += c
        out[j].append(i)
    return [sorted(x) for x in out]


def lane_items(lanes: int):
    """Per lane: the contact points whose records it computes in a substep
    (point c on lane c mod L, the rule the kernel applies), the bodies it
    owns (inertia, its points' forces and damping added in point order,
    body force), and the reward's joints, end effectors and geoms."""
    if lanes not in LANE_COUNTS:
        raise ValueError(f"{lanes} lanes per env: the kernels take {LANE_COUNTS}")
    ncont = np.bincount(_CBODY, minlength=NB)
    bodies = _lpt([(b, _COST_BODY + _COST_CONTACT * int(ncont[b])) for b in range(NB)], lanes)
    dof = [DOF_DEF[j] for j in BODY_JOINTS]
    items = ([(("j", j), _COST_JOINT[dof[j]]) for j in range(len(dof))]
             + [(("e", e), _COST_EE) for e in range(len(_EE_BODIES))]
             + [(("g", g), _COST_GEOM) for g in range(len(_GEOMS))])
    reward = _lpt([(k, c) for k, (_, c) in enumerate(items)], lanes)
    kinds = [[items[k][0] for k in lst] for lst in reward]
    pick = lambda t: [[i for kind, i in lane if kind == t] for lane in kinds]  # noqa: E731
    return {"contacts": [list(range(lane, NC, lanes)) for lane in range(lanes)],
            "bodies": bodies, "joints": pick("j"), "ees": pick("e"), "geoms": pick("g")}


def _lists(name: str, lists) -> str:
    width = max(1, max(len(x) for x in lists))
    return _arr(name, [x + [-1] * (width - len(x)) for x in lists], "int", device=True)


# Per-env shared memory of the kernels: the floats of ``struct Slot`` in
# csrc/humanoid_dynamics.cu (the source static_asserts the size).
NROLES = len(chains())
# Slot::work: each contact point's record (8), later each link's IA S (6) and
# each chain's contribution to its parent (33)
WORK_FLOATS = max(8 * NC, 6 * NJ + 33 * NROLES)
SLOT_FLOATS = (2 * NQ + 2 * NV + 2 * NB * 7 + 2 * NB * 6 + NJ * 2 + NJ * 6 + NB * 6 + NB * 21
               + WORK_FLOATS + 12 + max(LANE_COUNTS) * 9)


def tables_header() -> str:
    """The text of ``csrc/humanoid_tables.h``: the port's static tables as
    constexpr data (float32 values of the same numbers the plain version
    uses), and the lane groups' tables as ``__device__`` arrays. The
    committed header must equal this text."""
    joint_qpos = [QPOS_JOINT_SLICES[j].start for j in BODY_JOINTS]
    joint_dof = [DOF_DEF[j] for j in BODY_JOINTS]
    ct = chain_tables()
    ncont = np.bincount(_CBODY, minlength=NB)
    scal = [
        ("NB", NB), ("NJ", NJ), ("NQ", NQ), ("NV", NV), ("NC", NC),
        ("NEE", len(_EE_BODIES)), ("NROLES", NROLES), ("NSLOTS", N_CHAIN_SLOTS),
        ("MAX_LANES", max(LANE_COUNTS)), ("MAX_BODY_CONTACTS", int(ncont.max())),
        ("WORK_FLOATS", WORK_FLOATS), ("SLOT_FLOATS", SLOT_FLOATS),
        ("JOIN_LINK", ct["join_link"]), ("JOIN_SLOT", ct["join_slot"]),
    ]
    floats = [
        ("GRAVITY", GRAVITY), ("JOINT_DAMPING", JOINT_DAMPING), ("JOINT_STIFFNESS", JOINT_STIFFNESS),
        ("STIFFNESS", STIFFNESS), ("DAMPING", DAMPING), ("MU", MU),
        ("V_REG2", V_REG * V_REG), ("LIMIT_K", LIMIT_K), ("LIMIT_C", LIMIT_C),
    ]
    lanes = {L: lane_items(L) for L in LANE_COUNTS}
    dev = [
        _arr("CH_LINK", ct["link"], "int", device=True),
        _arr("CH_OWNED", ct["owned"], "int", device=True),
        _arr("CH_START", ct["start"], "int", device=True),
        _arr("CH_CARRIER", ct["carrier"], "int", device=True),
        _arr("CH_AXIS", ct["axis"], device=True),
        _arr("CH_ANCHOR_X", ct["anchor"], device=True),
        _arr("CH_OFFSET", ct["offset"], device=True),
        _arr("CH_FIRST_OWNED", ct["first_owned"], "int", device=True),
        _arr("D_LIMIT_LO", _LO, device=True),
        _arr("D_LIMIT_HI", _HI, device=True),
        _arr("D_BODY_MASS", _MASS, device=True),
        _arr("D_BODY_COM", _COM, device=True),
        _arr("D_BODY_INERTIA", [[I[k][k] for k in range(3)] for I in _IB], device=True),
        _arr("D_BODY_CONTACT0", np.concatenate([[0], np.cumsum(ncont)[:-1]]), "int",
             device=True),
        _arr("D_BODY_NCONTACT", ncont, "int", device=True),
        _arr("D_CONTACT_BODY", _CBODY, "int", device=True),
        _arr("D_CONTACT_POINT", _CPOINT, device=True),
        _arr("D_CONTACT_RADIUS", _CRAD, device=True),
        _arr("D_JOINT_QPOS", joint_qpos, "int", device=True),
        _arr("D_JOINT_DOF", joint_dof, "int", device=True),
        _arr("D_JOINT_WEIGHT", _JW, device=True),
        _arr("D_EE_BODY", [b for b, _ in _EE_BODIES], "int", device=True),
        _arr("D_EE_POINT", [pt for _, pt in _EE_BODIES], device=True),
        _arr("D_GEOM_BODY", [b for b, _, _ in _GEOMS], "int", device=True),
        _arr("D_GEOM_COM", [c for _, c, _ in _GEOMS], device=True),
        _arr("D_GEOM_MASS_FRAC", [gm / TOTAL_MASS for _, _, gm in _GEOMS], device=True),
    ]
    for L, it in lanes.items():
        dev += [_lists(f"BODIES_L{L}", it["bodies"]), _lists(f"JOINTS_L{L}", it["joints"]),
                _lists(f"EES_L{L}", it["ees"]), _lists(f"GEOMS_L{L}", it["geoms"])]
    slot_anchor = [int(np.any(ct["anchor"][:, k] != 0)) for k in range(N_CHAIN_SLOTS)]
    lines = [
        "// The humanoid's static tables for csrc/humanoid_dynamics.cu.",
        "// Generated by deepmimic_diffusion_mujoco_tpu_torch.physics.dynamics_kernel.tables_header()",
        "// from the port's tables (physics/humanoid_model.py, dynamics.py, dynamics_aba.py);",
        "// tests/test_torch_dynamics_kernel.py holds this file equal to it. Do not edit by hand.",
        "#pragma once",
        "",
        "namespace hum {",
        "",
        *[f"constexpr int {n} = {v};" for n, v in scal],
        *[f"constexpr float {n} = {_f32(v)};" for n, v in floats],
        "",
        "struct Tables {",
        _arr("ACOS_COEF", _ACOS_COEF),
        "  // the lane groups: the join chains (into JOIN_LINK, then into the root) in the",
        "  // order the plain version adds them, and the slots where any chain has an anchor",
        _arr("JOIN_ROLES", ct["join_roles"], "int"),
        _arr("ROOT_ROLES", ct["root_roles"], "int"),
        _arr("SLOT_HAS_ANCHOR", slot_anchor, "int"),
        "};",
        "",
        "// Tables the lane groups read with a lane-dependent index: per (chain, slot),",
        "// per body, contact, joint, end effector and geom, and each lane's share",
        "// (bodies, joints, end effectors, geoms; -1 pads) at each lane count.",
        *dev,
        "",
        "}  // namespace hum",
        "",
    ]
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


class _StepParams(ctypes.Structure):
    """The kernel's per-launch constants, made in double as the plain
    version makes them and rounded once to float32."""
    _fields_ = [("h", ctypes.c_float), ("half_h", ctypes.c_float),
                ("kp", ctypes.c_float * NJ), ("kd", ctypes.c_float * NJ),
                ("d_extra", ctypes.c_float * NJ), ("fall_height", ctypes.c_float),
                ("substeps", ctypes.c_int), ("contacts", ctypes.c_int),
                ("limits", ctypes.c_int)]


@functools.lru_cache(maxsize=64)
def _params(h, substeps, kp_scale, kd_scale, contacts, limits, fall_height=0.0):
    """The launch constants for one set of arguments, made once (callers
    only read them)."""
    p = _StepParams()
    p.h, p.half_h = float(h), 0.5 * float(h)
    for i in range(NJ):
        p.kp[i] = _KP[i] * kp_scale
        p.kd[i] = _KD[i] * kd_scale
        p.d_extra[i] = JOINT_ARMATURE + h * (JOINT_DAMPING + _KD[i] * kd_scale)
    p.fall_height = float(fall_height)
    p.substeps, p.contacts, p.limits = int(substeps), int(bool(contacts)), int(bool(limits))
    return p


# ---------------------------------------------------------------------------
# Launch plan
# ---------------------------------------------------------------------------

MAX_THREADS = 256         # the kernels' __launch_bounds__
SMEM_LIMIT = 232448       # an H100 block's shared memory
PARAMS_BYTES = -(-ctypes.sizeof(_StepParams) // 16) * 16
SLOT_BYTES = 4 * SLOT_FLOATS
# Default plans (physics/dynamics_sweep.py on an H100, PERF.md): 16 lanes
# while all the envs' warps fit on the card at once (the shorter chain wins),
# else 8 lanes (16 lanes' registers hold 10 warps an SM, so N 4096 would run
# in two waves, and capped at 128 registers they spill and run slower); 8-lane
# envs in 256-thread blocks from N 4096 (one block an SM), else 64-thread
# blocks.
SMALL_N, LARGE_N = 2048, 4096


@dataclasses.dataclass(frozen=True)
class DynPlan:
    """lanes per env, envs per block, threads and blocks of the launch, and
    its dynamic shared memory (the step constants and one Slot per env)."""
    lanes: int
    envs: int
    threads: int
    blocks: int
    smem_bytes: int


def dynamics_plan(N: int, lanes: int | None = None, envs: int | None = None) -> DynPlan:
    """The launch plan of B5, B6 and B7 for N envs; a keyword given fixes
    that choice. The defaults follow the plans ``physics/dynamics_sweep.py``
    timed on an H100 (see SMALL_N, LARGE_N). Raises for a plan the card
    cannot schedule."""
    if N < 0:
        raise ValueError(f"N {N} < 0")
    if lanes is None:
        lanes = 16 if N <= SMALL_N else 8
    lanes = int(lanes)
    if lanes not in LANE_COUNTS:
        raise ValueError(f"{lanes} lanes per env: the kernels take {LANE_COUNTS}")
    if envs is None:
        envs = (256 if lanes == 8 and N >= LARGE_N else 64) // lanes
    envs = int(envs)
    threads = envs * lanes
    if envs < 1 or threads % 32:
        raise ValueError(f"{envs} envs of {lanes} lanes: a block must be whole warps")
    if threads > MAX_THREADS:
        raise ValueError(f"{threads} threads a block: the kernels take at most {MAX_THREADS}")
    smem = PARAMS_BYTES + envs * SLOT_BYTES
    if smem > SMEM_LIMIT:
        raise ValueError(f"{smem} bytes of shared memory for {envs} envs: a block has "
                         f"{SMEM_LIMIT}")
    return DynPlan(lanes=lanes, envs=envs, threads=threads, blocks=-(-N // envs),
                   smem_bytes=smem)


def _plan_for(N, plan):
    if plan is None:
        return dynamics_plan(N)
    if not isinstance(plan, DynPlan):
        raise TypeError(f"plan must be a DynPlan, got {type(plan).__name__}")
    return dynamics_plan(N, plan.lanes, plan.envs)


def _library() -> ctypes.CDLL:
    lib = _build.load("humanoid_dynamics")
    if lib.humanoid_control_step_f32.argtypes is None:
        bind(lib)
    return lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C interface's argument types on a loaded library."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    pp = ctypes.POINTER(_StepParams)
    # qpos, qvel, target, ref_qvel (or null), qpos', qvel', reward (or null), N, lanes, envs
    lib.humanoid_control_step_f32.argtypes = [vp] * 7 + [i, i, i, pp, vp]
    # qpos, qvel, done, targets, ref_qvels, qpos', qvel', done', rewards, N, T, lanes, envs
    lib.humanoid_rollout_f32.argtypes = [vp] * 9 + [i, i, i, i, pp, vp]
    # qpos, qvel, ref_qpos, ref_qvel, reward, N, lanes, envs
    lib.humanoid_tracking_reward_f32.argtypes = [vp] * 5 + [i, i, i, vp]
    for fn in (lib.humanoid_control_step_f32, lib.humanoid_rollout_f32,
               lib.humanoid_tracking_reward_f32):
        fn.restype = i
    lib.humanoid_dynamics_error_string.argtypes = [i]
    lib.humanoid_dynamics_error_string.restype = ctypes.c_char_p
    return lib


def _check(fn: str, device, **tensors):
    for name, (t, shape) in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{fn}: {name} is on {t.device}, needs a CUDA tensor")
        if t.device != device:
            raise ValueError(f"{fn}: {name} is on {t.device}, the other operands on {device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} is {t.dtype}, the kernel takes float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} is {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")


def _raise_on_error(lib, err: int, fn: str):
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: "
                           + lib.humanoid_dynamics_error_string(err).decode())


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def control_step_cuda(qpos, qvel, target, ref_qvel=None, *, h, substeps, kp_scale=1.0,
                      kd_scale=1.0, contacts=True, limits=True, plan: DynPlan | None = None):
    """B5 on PyTorch's current stream: (N, 35), (N, 34), (N, 35) [, (N, 34)]
    CUDA float32 -> qpos', qvel' [, reward (N,)]. ``plan`` (default
    ``dynamics_plan(N)``) sets the lanes per env and envs per block. Raises
    on anything else."""
    fn = "control_step_cuda"
    N = qpos.shape[0] if qpos.dim() == 2 else -1
    args = dict(qpos=(qpos, (N, NQ)), qvel=(qvel, (N, NV)), target=(target, (N, NQ)))
    if ref_qvel is not None:
        args["ref_qvel"] = (ref_qvel, (N, NV))
    _check(fn, qpos.device, **args)
    pl = _plan_for(N, plan)
    lib = _library()
    qp_out, qv_out = torch.empty_like(qpos), torch.empty_like(qvel)
    reward = qpos.new_empty((N,)) if ref_qvel is not None else None
    if N == 0:
        return (qp_out, qv_out) if reward is None else (qp_out, qv_out, reward)
    p = _params(h, substeps, kp_scale, kd_scale, contacts, limits)
    with torch.cuda.device(qpos.device):
        err = lib.humanoid_control_step_f32(
            qpos.data_ptr(), qvel.data_ptr(), target.data_ptr(),
            ref_qvel.data_ptr() if ref_qvel is not None else None,
            qp_out.data_ptr(), qv_out.data_ptr(),
            reward.data_ptr() if reward is not None else None,
            N, pl.lanes, pl.envs, ctypes.byref(p), _stream(qpos))
    _raise_on_error(lib, err, fn)
    control_step_cuda.launches += 1
    return (qp_out, qv_out) if reward is None else (qp_out, qv_out, reward)


control_step_cuda.launches = 0


def rollout_cuda(qpos, qvel, targets, ref_qvels, done, *, h, substeps, kp_scale=1.0,
                 kd_scale=1.0, contacts=True, limits=True, fall_height=0.3,
                 plan: DynPlan | None = None):
    """B6 on PyTorch's current stream: T control steps with done-freeze, fall
    detection and reward gating in one launch. (N, 35), (N, 34), (T, N, 35),
    (T, N, 34) CUDA float32 and (N,) done (any dtype, nonzero = done) ->
    (qpos', qvel', rewards (T, N), done' (N,) bool)."""
    fn = "rollout_cuda"
    N = qpos.shape[0] if qpos.dim() == 2 else -1
    T = targets.shape[0] if targets.dim() == 3 else -1
    if not done.is_cuda or tuple(done.shape) != (N,):
        raise ValueError(f"{fn}: done must be a ({N},) CUDA tensor, got "
                         f"{tuple(done.shape)} on {done.device}")
    _check(fn, qpos.device, qpos=(qpos, (N, NQ)), qvel=(qvel, (N, NV)),
           targets=(targets, (T, N, NQ)), ref_qvels=(ref_qvels, (T, N, NV)))
    pl = _plan_for(N, plan)
    lib = _library()
    dn = done.to(torch.float32).contiguous()
    qp_out, qv_out, dn_out = torch.empty_like(qpos), torch.empty_like(qvel), torch.empty_like(dn)
    rewards = qpos.new_empty((T, N))
    if N == 0:
        return qp_out, qv_out, rewards, dn_out > 0.5
    p = _params(h, substeps, kp_scale, kd_scale, contacts, limits, fall_height)
    with torch.cuda.device(qpos.device):
        err = lib.humanoid_rollout_f32(
            qpos.data_ptr(), qvel.data_ptr(), dn.data_ptr(), targets.data_ptr(),
            ref_qvels.data_ptr(), qp_out.data_ptr(), qv_out.data_ptr(), dn_out.data_ptr(),
            rewards.data_ptr(), N, T, pl.lanes, pl.envs, ctypes.byref(p), _stream(qpos))
    _raise_on_error(lib, err, fn)
    rollout_cuda.launches += 1
    return qp_out, qv_out, rewards, dn_out > 0.5


rollout_cuda.launches = 0


def tracking_reward_cuda(qpos, qvel, ref_qpos, ref_qvel, *, plan: DynPlan | None = None):
    """B7 on PyTorch's current stream: (N, 35), (N, 34), (N, 35), (N, 34)
    CUDA float32 -> (N,) DeepMimic tracking reward, on the same lane-group
    code as B5's and B6's epilogue."""
    fn = "tracking_reward_cuda"
    N = qpos.shape[0] if qpos.dim() == 2 else -1
    _check(fn, qpos.device, qpos=(qpos, (N, NQ)), qvel=(qvel, (N, NV)),
           ref_qpos=(ref_qpos, (N, NQ)), ref_qvel=(ref_qvel, (N, NV)))
    pl = _plan_for(N, plan)
    lib = _library()
    out = qpos.new_empty((N,))
    if N == 0:
        return out
    with torch.cuda.device(qpos.device):
        err = lib.humanoid_tracking_reward_f32(
            qpos.data_ptr(), qvel.data_ptr(), ref_qpos.data_ptr(), ref_qvel.data_ptr(),
            out.data_ptr(), N, pl.lanes, pl.envs, _stream(qpos))
    _raise_on_error(lib, err, fn)
    tracking_reward_cuda.launches += 1
    return out


tracking_reward_cuda.launches = 0


# ---------------------------------------------------------------------------
# Dispatchers: the kernel for CUDA tensors, the plain version for CPU ones
# ---------------------------------------------------------------------------


def control_step(qpos, qvel, target, ref_qvel=None, **kw):
    impl = control_step_cuda if qpos.is_cuda else control_step_plain
    return impl(qpos, qvel, target, ref_qvel, **kw)


def rollout(qpos, qvel, targets, ref_qvels, done, **kw):
    impl = rollout_cuda if qpos.is_cuda else rollout_plain
    return impl(qpos, qvel, targets, ref_qvels, done, **kw)


def tracking_reward_fused(qpos, qvel, ref_qpos, ref_qvel):
    impl = tracking_reward_cuda if qpos.is_cuda else tracking_reward_plain
    return impl(qpos, qvel, ref_qpos, ref_qvel)
