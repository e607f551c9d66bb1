"""Env-last ("lanes") layout of the dense forward-dynamics engine.

The port of ``deepmimic_diffusion_mujoco_tpu/physics/dynamics_lanes.py``:
the rigid-body math of `dynamics.py` (the engine held against MuJoCo) with
the batch-of-envs axis N LAST in every tensor and the tiny physics
dimensions (3-vectors, 4-quats, NV=34 DOFs, NB=13 bodies) leading or
unrolled. Everything is a pure function of transposed state:

    qpos_T (35, N), qvel_T (34, N), tau_T (34, N)

`DynamicsEnv` (dynamics.py) transposes once per control step. The result
is the dense engine's up to float reassociation
(``tests/test_torch_dynamics_engines.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..data.skeleton import QPOS_JOINT_SLICES
from .dynamics import NB, NJ, NV, _tables_of, body_rates
from .humanoid_model import (
    BODIES,
    BODY_INDEX,
    FLOOR_FRICTION,
    JOINT_DAMPING,
    JOINT_STIFFNESS,
)

__all__ = [
    "fk_lanes",
    "step_physics_lanes",
    "forward_dynamics_lanes",
    "integrate_lanes",
    "pd_torques_lanes",
]


# ---------------------------------------------------------------------------
# Component-first quaternion/vector helpers: q is (4, ...), v is (3, ...)
# ---------------------------------------------------------------------------


def _qmul(a, b):
    """Hamilton product, (4, ...) x (4, ...) -> (4, ...)."""
    aw, ax, ay, az = a[0], a[1], a[2], a[3]
    bw, bx, by, bz = b[0], b[1], b[2], b[3]
    return torch.stack(torch.broadcast_tensors(
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ))


def _cross(a, b):
    """(3, ...) x (3, ...) -> (3, ...)."""
    return torch.stack(torch.broadcast_tensors(
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ))


def _qrot(q, v):
    """Rotate (3, ...) by (4, ...): v + 2 qw (qv x v) + 2 qv x (qv x v)."""
    qv = q[1:4]
    t = 2.0 * _cross(qv, v)
    return v + q[0] * t + _cross(qv, t)


def _qconj(q):
    return torch.stack([q[0], -q[1], -q[2], -q[3]])


# ---------------------------------------------------------------------------
# FK (env-last)
# ---------------------------------------------------------------------------


class LaneFK(NamedTuple):
    body_pos: torch.Tensor    # (NB, 3, N)
    body_quat: torch.Tensor   # (NB, 4, N)
    com_w: torch.Tensor       # (NB, 3, N)
    dof_axis: torch.Tensor    # (NJ, 3, N)
    dof_anchor: torch.Tensor  # (NJ, 3, N)


def fk_lanes(qpos_T: torch.Tensor) -> LaneFK:
    """(35, N) -> env-last FK. Mirrors dynamics.fk_dynamics exactly, with
    all per-env vectors component-first."""
    T = _tables_of(qpos_T)
    N = qpos_T.shape[-1]
    root_pos = qpos_T[0:3]
    rq = qpos_T[3:7]
    rq = rq / torch.sqrt((rq * rq).sum(0))

    pos = [None] * NB
    quat = [None] * NB
    pos[0], quat[0] = root_pos, rq
    axes, anchors = [], []
    j = 0
    for bi, b in enumerate(BODIES[1:], start=1):
        angles = qpos_T[QPOS_JOINT_SLICES[b.name]]           # (n_joints, N)
        parent = BODY_INDEX[b.parent]
        offset = T["offset"][bi][:, None]                    # (3, 1)
        q_local = T["unit_quat"][:, None].expand(4, N)
        t_local = qpos_T.new_zeros((3, N))
        for k in range(len(b.joints)):
            a_k = T["hinge_axis"][j][:, None]
            p_k = T["hinge_pos"][j][:, None]
            j += 1
            axes.append(_qrot(quat[parent], _qrot(q_local, a_k)))
            anchors.append(pos[parent]
                           + _qrot(quat[parent], offset + t_local + _qrot(q_local, p_k)))
            half = 0.5 * angles[k]                           # (N,)
            qk = torch.cat([torch.cos(half)[None], torch.sin(half)[None] * a_k])   # (4, N)
            tk = p_k - _qrot(qk, p_k)
            t_local = t_local + _qrot(q_local, tk)
            q_local = _qmul(q_local, qk)
        pos[bi] = pos[parent] + _qrot(quat[parent], offset + t_local)
        quat[bi] = _qmul(quat[parent], q_local)

    body_pos = torch.stack(pos)                              # (NB, 3, N)
    body_quat = torch.stack(quat)                            # (NB, 4, N)
    com = T["body_com"].T[:, :, None]                        # (3, NB, 1)
    # rotate each body's COM: component-first per body
    com_w = body_pos + torch.movedim(_qrot(torch.movedim(body_quat, 1, 0), com), 0, 1)
    return LaneFK(body_pos, body_quat, com_w, torch.stack(axes), torch.stack(anchors))


def body_jacobians_lanes(fk: LaneFK):
    """COM Jacobians, env-last: Jv, Jw (NB, 3, NV, N)."""
    T = _tables_of(fk.body_pos)
    N = fk.body_pos.shape[-1]
    q0 = fk.body_quat[0]                                     # (4, N)
    # world images of the basis vectors (root rotation matrix columns)
    eye = T["eye3"]
    R_cols = torch.stack([_qrot(q0, eye[k][:, None]) for k in range(3)])   # (k, 3comp, N)

    mask = T["ancestor_mask"]                                # (NB, NJ)
    n_c = torch.movedim(fk.dof_axis, 1, 0)                   # (3, NJ, N)
    anchor_c = torch.movedim(fk.dof_anchor, 1, 0)            # (3, NJ, N)
    com_c = torch.movedim(fk.com_w, 1, 0)                    # (3, NB, N)
    rel = com_c[:, :, None, :] - anchor_c[:, None, :, :]     # (3, NB, NJ, N)
    jv_h = _cross(n_c[:, None], rel) * mask[None, :, :, None]
    jw_h = n_c[:, None].expand(3, NB, NJ, N) * mask[None, :, :, None]

    rel0 = com_c - fk.body_pos[0][:, None, :]                # (3, NB, N)
    # root rotational linear part: column k = R_cols[k] x rel0[b]
    R_ckn = torch.movedim(R_cols, 0, 1)                      # (3comp, k, N)
    jv_rr = _cross(R_ckn[:, None, :, :], rel0[:, :, None, :])   # (3, NB, 3, N)
    jw_rr = R_ckn[:, None, :, :].expand(3, NB, 3, N)
    jv_rt = eye[:, None, :, None].expand(3, NB, 3, N)

    Jv = torch.cat([jv_rt, jv_rr, jv_h], dim=2)              # (3, NB, NV, N)
    Jw = torch.cat([torch.zeros_like(jv_rt), jw_rr, jw_h], dim=2)
    return torch.movedim(Jv, 0, 1), torch.movedim(Jw, 0, 1)  # (NB, 3, NV, N)


def _rot_mats(body_quat):
    """(NB, 4, N) -> world-from-body rotation matrices R (NB, row, col, N)
    with R[:, i, k] = (world image of e_k)_i."""
    eye = _tables_of(body_quat)["eye3"]
    q = torch.movedim(body_quat, 1, 0)                       # (4, NB, N)
    cols = [_qrot(q, eye[k][:, None, None]) for k in range(3)]
    stacked = torch.stack(cols, dim=1)                       # (row, col, NB, N)
    return torch.movedim(stacked, 2, 0)                      # (NB, row, col, N)


def _inertia_world(body_quat):
    """(NB, 4, N) -> I_w = R I_body R^T, (NB, 3, 3, N)."""
    R = _rot_mats(body_quat)                                 # (NB, i, k(col), N)
    tmp = torch.einsum("bikn,bkl->biln", R, _tables_of(body_quat)["body_inertia"])
    return torch.einsum("biln,bjln->bijn", tmp, R)


def mass_matrix_lanes(fk: LaneFK, Jv, Jw) -> torch.Tensor:
    """(NV, NV, N) joint-space inertia (CRB quadratic form + armature)."""
    T = _tables_of(Jv)
    M = torch.einsum("bavn,b,bawn->vwn", Jv, T["body_mass"], Jv)
    I_w = _inertia_world(fk.body_quat)
    tmp = torch.einsum("bijn,bjwn->biwn", I_w, Jw)
    M = M + torch.einsum("bivn,biwn->vwn", Jw, tmp)
    return M + T["armature"][:, :, None]


# ---------------------------------------------------------------------------
# Integration + bias forces (env-last)
# ---------------------------------------------------------------------------


def integrate_lanes(qpos_T, qvel_T, dt):
    """Env-last mirror of dynamics.integrate_qpos (dt a float or a 0-d
    tensor; no in-place writes)."""
    root_pos = qpos_T[0:3] + dt * qvel_T[0:3]
    w = qvel_T[3:6]                                          # (3, N)
    n2 = (w * w).sum(0, keepdim=True)
    safe = torch.where(n2 > 1e-16, n2, torch.ones_like(n2))
    norm = torch.sqrt(safe)
    half = 0.5 * dt * norm
    k = torch.where(n2 > 1e-16, torch.sin(half) / norm, 0.5 * dt * torch.ones_like(n2))
    dq = torch.cat([torch.cos(half), k * w])                 # (4, N)
    quat = _qmul(qpos_T[3:7], dq)
    quat = quat / torch.sqrt((quat * quat).sum(0, keepdim=True))
    joints = qpos_T[7:] + dt * qvel_T[6:]
    return torch.cat([root_pos, quat, joints])


def bias_forces_lanes(qpos_T, qvel_T, Jv, Jw) -> torch.Tensor:
    """(NV, N) Coriolis/centrifugal + gravity: Newton-Euler env-last on the
    body rates of dynamics.bias_forces (the kinematics differentiated twice
    in time along the qacc=0 trajectory, `dynamics.body_rates`)."""
    T = _tables_of(qpos_T)
    q0, a_com, w, alpha = (torch.movedim(x, 0, -1) for x in body_rates(qpos_T.T, qvel_T.T))
    I_w = _inertia_world(q0)                                 # (NB, 3, 3, N)
    F = T["body_mass"][:, None, None] * (a_com - T["gravity"][None, :, None])   # (NB, 3, N)
    Iw_w = torch.einsum("bijn,bjn->bin", I_w, w)
    wc = torch.movedim(w, 1, 0)
    N_t = torch.einsum("bijn,bjn->bin", I_w, alpha) + torch.movedim(
        _cross(wc, torch.movedim(Iw_w, 1, 0)), 0, 1)
    return (torch.einsum("bavn,ban->vn", Jv, F)
            + torch.einsum("bavn,ban->vn", Jw, N_t))


# ---------------------------------------------------------------------------
# Passive / limits / contacts (env-last)
# ---------------------------------------------------------------------------


def passive_forces_lanes(qpos_T, qvel_T):
    tau_j = -JOINT_STIFFNESS * qpos_T[7:] - JOINT_DAMPING * qvel_T[6:]
    return torch.cat([tau_j.new_zeros((6, tau_j.shape[-1])), tau_j])


def limit_forces_lanes(qpos_T, qvel_T, k: float = 300.0, c: float = 3.0):
    T = _tables_of(qpos_T)
    q = qpos_T[7:]
    over = torch.clamp_min(q - T["limit_hi"][:, None], 0.0)
    under = torch.clamp_min(T["limit_lo"][:, None] - q, 0.0)
    hit = ((over > 0) | (under > 0)).to(qpos_T.dtype)
    tau_j = -k * over + k * under - c * qvel_T[6:] * hit
    return torch.cat([tau_j.new_zeros((6, tau_j.shape[-1])), tau_j])


def _skew_lanes(r):
    """(3, P, N) -> (P, 3, 3, N)."""
    z = torch.zeros_like(r[0])
    rows = torch.stack([
        torch.stack([z, -r[2], r[1]]),
        torch.stack([r[2], z, -r[0]]),
        torch.stack([-r[1], r[0], z]),
    ])                                                       # (3, 3, P, N)
    return torch.movedim(rows, 2, 0)


def contact_terms_lanes(fk: LaneFK, Jv, Jw, qvel_T, stiffness: float = 30000.0,
                        damping: float = 1000.0, mu: float = FLOOR_FRICTION,
                        v_reg: float = 5e-3):
    """Env-last mirror of dynamics.contact_terms (body-aggregated: per-body
    3x3 moments, no (NC, 3, NV) tensors)."""
    T = _tables_of(qvel_T)
    dtype = qvel_T.dtype
    bidx = T["contact_body"]
    rad = T["contact_radius"][:, None]                       # (NC, 1)
    onehot = T["contact_onehot"]                             # (NB, NC)

    quat_c = torch.movedim(fk.body_quat, 1, 0)[:, bidx]      # (4, NC, N)
    pos_c = torch.movedim(fk.body_pos, 1, 0)[:, bidx]        # (3, NC, N)
    com_c = torch.movedim(fk.com_w, 1, 0)[:, bidx]
    pts_c = T["contact_point"].T[:, :, None]                 # (3, NC, 1)
    x = pos_c + _qrot(quat_c, pts_c)                         # (3, NC, N)
    r = x - com_c

    v_b = torch.einsum("bavn,vn->ban", Jv, qvel_T)           # (NB, 3, N)
    w_b = torch.einsum("bavn,vn->ban", Jw, qvel_T)
    v_c = torch.movedim(v_b, 1, 0)[:, bidx]                  # (3, NC, N)
    w_c = torch.movedim(w_b, 1, 0)[:, bidx]
    xdot = v_c + _cross(w_c, r)                              # (3, NC, N)

    depth = rad - x[2]                                       # (NC, N)
    active = (depth > 0.0).to(dtype)
    fn = torch.clamp_min(stiffness * depth * active - damping * xdot[2] * active, 0.0)
    vt = xdot[0:2]                                           # (2, NC, N)
    vt_norm = torch.sqrt((vt * vt).sum(0) + v_reg * v_reg)
    c_t = mu * fn / vt_norm                                  # (NC, N)
    f = torch.cat([-c_t[None] * vt, fn[None]])               # (3, NC, N)

    F = torch.einsum("bp,apn->ban", onehot, f)               # (NB, 3, N)
    Tq = torch.einsum("bp,apn->ban", onehot, _cross(r, f))
    tau_c = (torch.einsum("bavn,ban->vn", Jv, F)
             + torch.einsum("bavn,ban->vn", Jw, Tq))

    W = torch.stack([c_t, c_t, damping * active])            # (3, NC, N)
    S = _skew_lanes(r)                                       # (NC, 3, 3, N)
    WS = torch.movedim(W, 1, 0)[:, :, None, :] * S           # (NC, 3, 3, N)
    STWS = torch.einsum("pijn,pikn->pjkn", S, WS)
    A = torch.einsum("bp,ipn->bin", onehot, W)               # (NB, 3, N)
    B = torch.einsum("bp,pijn->bijn", onehot, WS)
    C = torch.einsum("bp,pijn->bijn", onehot, STWS)
    Adiag = A[:, :, None, :] * T["eye3"][None, :, :, None]   # (NB, 3, 3, N)
    top = torch.cat([Adiag, -B], dim=2)
    bot = torch.cat([-B.transpose(1, 2), C], dim=2)
    K = torch.cat([top, bot], dim=1)                         # (NB, 6, 6, N)
    G = torch.cat([Jv, Jw], dim=1)                           # (NB, 6, NV, N)
    tmp = torch.einsum("bijn,bjwn->biwn", K, G)
    JWJ = torch.einsum("bivn,biwn->vwn", G, tmp)
    return tau_c, JWJ


# ---------------------------------------------------------------------------
# SPD solve (unrolled Cholesky, env-last) + forward dynamics + stepping
# ---------------------------------------------------------------------------


def spd_solve_lanes(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve M x = b for (n, n, N) / (n, N): the unrolled augmented Cholesky
    of dynamics.spd_solve_unrolled, with the env axis last through every
    rank-1 update."""
    n = M.shape[0]
    A = torch.cat([M, b[:, None, :]], dim=1)                 # (n, n+1, N)
    last = torch.cat([b, torch.ones_like(b[:1])], dim=0)
    A = torch.cat([A, last[None]], dim=0)                    # (n+1, n+1, N)
    cols = []
    for _ in range(n):
        c = A[:, 0]                                          # (n+1-j, N)
        c = c * torch.rsqrt(c[0])
        cols.append(c)
        A = A[1:, 1:] - c[1:, None, :] * c[None, 1:, :]
    xs = [None] * n
    for i in reversed(range(n)):
        acc = cols[i][-1]
        if i < n - 1:
            acc = acc - (cols[i][1:-1] * torch.stack(xs[i + 1:])).sum(0)
        xs[i] = acc / cols[i][0]
    return torch.stack(xs)


def forward_dynamics_lanes(qpos_T, qvel_T, tau_T, *, contacts: bool = True,
                           limits: bool = True, h_implicit: float = 0.0,
                           kd_extra: torch.Tensor | None = None):
    """(NV, N) qacc; env-last mirror of dynamics.forward_dynamics (kd_extra
    is (NJ,))."""
    T = _tables_of(qpos_T)
    fk = fk_lanes(qpos_T)
    Jv, Jw = body_jacobians_lanes(fk)
    M = mass_matrix_lanes(fk, Jv, Jw)

    rhs = tau_T + passive_forces_lanes(qpos_T, qvel_T) - bias_forces_lanes(qpos_T, qvel_T, Jv, Jw)
    if limits:
        rhs = rhs + limit_forces_lanes(qpos_T, qvel_T)
    D = T["damping"][:, :, None]
    if kd_extra is not None:
        kd_full = torch.cat([kd_extra.new_zeros((6,)), kd_extra.to(qpos_T.dtype)])
        D = D + torch.diag(kd_full)[:, :, None]
    if contacts:
        tau_c, JWJ = contact_terms_lanes(fk, Jv, Jw, qvel_T)
        rhs = rhs + tau_c
        D = D + JWJ
    return spd_solve_lanes(M + h_implicit * D, rhs)


def step_physics_lanes(qpos_T, qvel_T, tau_T, h: float, *, contacts: bool = True,
                       limits: bool = True, kd_extra: torch.Tensor | None = None):
    """One implicitly-damped semi-implicit Euler substep, env-last."""
    qacc = forward_dynamics_lanes(qpos_T, qvel_T, tau_T, contacts=contacts, limits=limits,
                                  h_implicit=h, kd_extra=kd_extra)
    qvel_T = qvel_T + h * qacc
    return integrate_lanes(qpos_T, qvel_T, h), qvel_T


def pd_torques_lanes(qpos_T, qvel_T, target_T, kp_scale: float = 1.0, kd_scale: float = 1.0):
    """(NV, N) DeepMimic PD torques toward a target pose, env-last."""
    T = _tables_of(qpos_T)
    kp = T["pd_kp"][:, None] * kp_scale
    kd = T["pd_kd"][:, None] * kd_scale
    tau_j = kp * (target_T[7:] - qpos_T[7:]) - kd * qvel_T[6:]
    return torch.cat([tau_j.new_zeros((6, tau_j.shape[-1])), tau_j])
