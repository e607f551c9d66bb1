"""O(n) articulated-body forward dynamics (Featherstone), env-last layout.

The port of ``deepmimic_diffusion_mujoco_tpu/physics/dynamics_aba.py``. It
solves the dense engine's system (dynamics.forward_dynamics: (M + h D)^-1
rhs) in O(n), in WORLD-ORIGIN spatial (Plücker) coordinates, so there are
no inter-link coordinate transforms:

- **RNEA** (recursive Newton-Euler) replaces the nested-jvp bias replays:
  one velocity/acceleration sweep down the 34-link tree and one force sweep
  up, gravity folded in as a fictitious base acceleration. External
  (contact) forces ride the same backward sweep, so the body Jacobians are
  never built.
- **ABA** (articulated-body algorithm) replaces the mass matrix and the
  34x34 Cholesky: a zero-velocity ABA pass is an exact O(n) solver for
  M x = rhs, and the implicitly integrated damping folds in exactly: joint
  damping, PD kd and armature add to each link's joint-space inertia D_i,
  and the contact coupling J^T W J adds h*K_b to body b's spatial inertia
  before the backward sweep (K_b about the world origin is a spatial
  "added inertia").

Every quantity is env-last (dynamics_lanes.py): spatial vectors (6, N),
articulated inertias (6, 6, N), joint scalars (N,).

Spatial conventions (Featherstone, RBDA ch. 2, all world frame, origin O):
motion v = [omega; v_O], force f = [n_O; f]; a hinge through anchor p with
axis n has S = [n; p x n]; a body with mass m, world COM c and world
rotational inertia I_c has spatial inertia [[I_c + m cx cx^T, m cx],
[m cx^T, m 1]].

`_link_tables` also gives the whole-control-step kernel and its plain
version (``dynamics_kernel.py``) the tree they walk.
"""
from __future__ import annotations

import numpy as np
import torch

from .dynamics import JOINT_BODY, NB, NJ, _tables_of
from .dynamics_lanes import (
    _cross,
    _inertia_world,
    _qrot,
    _skew_lanes,
    fk_lanes,
    integrate_lanes,
    limit_forces_lanes,
    passive_forces_lanes,
    spd_solve_lanes,
)
from .humanoid_model import (
    BODIES,
    BODY_INDEX,
    FLOOR_FRICTION,
    GRAVITY,
    JOINT_ARMATURE,
    JOINT_DAMPING,
)

__all__ = ["forward_dynamics_aba", "step_physics_aba"]


def _link_tables():
    """Expand the (body, 1-3 hinge) tree into one link per hinge DOF.

    A body's hinges fold sequentially (declaration order), so hinge k of a
    body hangs off hinge k-1 of the same body; the first hinge hangs off the
    parent body's LAST hinge link (or the root). The body's inertia attaches
    to its last hinge link; intermediate links are massless (always
    well-posed: armature > 0 keeps every D_i > 0)."""
    parent = np.zeros(NJ, np.int32)
    carrier = -np.ones(NJ, np.int32)
    last_link: dict[int, int] = {}
    for i in range(NJ):
        b = int(JOINT_BODY[i])
        if i > 0 and int(JOINT_BODY[i - 1]) == b:
            parent[i] = i - 1
        else:
            pb = BODY_INDEX[BODIES[b].parent]
            parent[i] = -1 if pb == 0 else last_link[pb]
        last_link[b] = i
    for b, i in last_link.items():
        carrier[i] = b
    return parent, carrier, last_link


LINK_PARENT, LINK_CARRIER, _BODY_LAST_LINK = _link_tables()


def _mat6(M, v):
    """(6, 6, N) @ (6, N) -> (6, N) as a broadcast product and sum."""
    return (M * v[None, :, :]).sum(1)


def _mcross(a, b):
    """Spatial motion cross product a x_m b; a, b (6, N)."""
    w, vo = a[:3], a[3:]
    return torch.cat([_cross(w, b[:3]), _cross(w, b[3:]) + _cross(vo, b[:3])])


def _fcross(a, f):
    """Spatial force cross product a x* f; a motion, f force, both (6, N)."""
    w, vo = a[:3], a[3:]
    return torch.cat([_cross(w, f[:3]) + _cross(vo, f[3:]), _cross(w, f[3:])])


def _spatial_inertias(fk):
    """Per-body spatial inertia about the world origin: (NB, 6, 6, N)."""
    T = _tables_of(fk.body_pos)
    N = fk.body_pos.shape[-1]
    Iw = _inertia_world(fk.body_quat)                       # (NB, 3, 3, N)
    c = torch.movedim(fk.com_w, 1, 0)                       # (3, NB, N)
    ctil = _skew_lanes(c)                                   # (NB, 3, 3, N)
    mB = T["body_mass"][:, None, None, None]
    eye3 = T["eye3"][None, :, :, None]
    cc = (c * c).sum(0)                                     # (NB, N)
    ccT = torch.movedim(c[:, None] * c[None, :], 2, 0)      # (NB, 3, 3, N)
    # cx cx^T = |c|^2 I - c c^T
    A = Iw + mB * (cc[:, None, None, :] * eye3 - ccT)
    TR = mB * ctil
    BR = mB * eye3.expand(NB, 3, 3, N)
    return torch.cat([torch.cat([A, TR], dim=2), torch.cat([-TR, BR], dim=2)], dim=1)


def _contact_spatial(fk, body_v, *, stiffness=30000.0, damping=1000.0, mu=FLOOR_FRICTION,
                     v_reg=5e-3):
    """Penalty ground contacts as per-body SPATIAL quantities about the
    world origin: explicit force f_ext (NB, 6, N) and damping moment I_K
    (NB, 6, 6, N) such that sum_b J_b^T I_K,b J_b == the dense engine's JWJ
    exactly (the aggregation point cancels in the quadratic form; the same
    per-point W = diag(c_t, c_t, c_n) as dynamics.contact_terms)."""
    T = _tables_of(body_v)
    dtype = body_v.dtype
    bidx = T["contact_body"]
    pts = T["contact_point"].T[:, :, None]                  # (3, NC, 1)
    rad = T["contact_radius"][:, None]                      # (NC, 1)
    onehot = T["contact_onehot"]                            # (NB, NC)

    quat_c = torch.movedim(fk.body_quat, 1, 0)[:, bidx]     # (4, NC, N)
    pos_c = torch.movedim(fk.body_pos, 1, 0)[:, bidx]       # (3, NC, N)
    x = pos_c + _qrot(quat_c, pts)                          # (3, NC, N)

    w_c = torch.movedim(body_v[:, :3], 1, 0)[:, bidx]       # (3, NC, N)
    vO_c = torch.movedim(body_v[:, 3:], 1, 0)[:, bidx]
    xdot = vO_c + _cross(w_c, x)                            # (3, NC, N)

    depth = rad - x[2]                                      # (NC, N)
    active = (depth > 0.0).to(dtype)
    fn = torch.clamp_min(stiffness * depth * active - damping * xdot[2] * active, 0.0)
    vt = xdot[0:2]
    vt_norm = torch.sqrt((vt * vt).sum(0) + v_reg * v_reg)
    c_t = mu * fn / vt_norm                                 # (NC, N)
    f = torch.cat([-c_t[None] * vt, fn[None]])              # (3, NC, N)

    F = torch.einsum("bp,apn->ban", onehot, f)              # (NB, 3, N)
    Tq = torch.einsum("bp,apn->ban", onehot, _cross(x, f))  # torque about O
    f_ext = torch.cat([Tq, F], dim=1)                       # (NB, 6, N)

    W = torch.stack([c_t, c_t, damping * active])           # (3, NC, N)
    xt = _skew_lanes(x)                                     # (NC, 3, 3, N)
    Wp = torch.movedim(W, 1, 0)                             # (NC, 3, N)
    xW = xt * Wp[:, None, :, :]                             # xtilde diag(W)
    xWxT = torch.einsum("pikn,pjkn->pijn", xW, xt)          # xW x^T (PSD)
    A = torch.einsum("bp,ipn->bin", onehot, W)              # (NB, 3, N)
    B = torch.einsum("bp,pijn->bijn", onehot, xW)
    C = torch.einsum("bp,pijn->bijn", onehot, xWxT)
    Adiag = A[:, :, None, :] * T["eye3"][None, :, :, None]
    I_K = torch.cat([
        torch.cat([C, B], dim=2),
        torch.cat([B.transpose(1, 2), Adiag], dim=2),
    ], dim=1)                                               # (NB, 6, 6, N)
    return f_ext, I_K


def forward_dynamics_aba(qpos_T, qvel_T, tau_T, *, contacts: bool = True, limits: bool = True,
                         h_implicit: float = 0.0, kd_extra: torch.Tensor | None = None):
    """(NV, N) qacc = (M + h D)^-1 rhs via RNEA + zero-velocity ABA.

    Same semantics as dynamics.forward_dynamics / forward_dynamics_lanes
    (implicitly damped when h_implicit > 0), computed in O(n) without ever
    building M, the Jacobians or the bias jvp replays."""
    T = _tables_of(qpos_T)
    dtype = qpos_T.dtype
    N = qpos_T.shape[-1]
    fk = fk_lanes(qpos_T)

    # ---- motion subspaces (world-origin Plücker) -----------------------
    q0 = fk.body_quat[0]
    eye = T["eye3"]
    p_r = fk.body_pos[0]                                    # (3, N)
    zeros3 = qpos_T.new_zeros((3, N))
    # root: 3 world translations, then 3 BODY-frame rotation axes
    # (MuJoCo free-joint convention: qvel[3:6] is body-frame omega)
    S_root = [torch.cat([zeros3, eye[k][:, None].expand(3, N)]) for k in range(3)]
    for k in range(3):
        n_k = _qrot(q0, eye[k][:, None])
        S_root.append(torch.cat([n_k, _cross(p_r, n_k)]))
    S = [torch.cat([fk.dof_axis[i], _cross(fk.dof_anchor[i], fk.dof_axis[i])])
         for i in range(NJ)]

    # ---- velocity sweep --------------------------------------------------
    v_root = S_root[0] * qvel_T[0]
    for k in range(1, 6):
        v_root = v_root + S_root[k] * qvel_T[k]
    v = [None] * NJ
    for i in range(NJ):
        p = int(LINK_PARENT[i])
        vp = v_root if p < 0 else v[p]
        v[i] = vp + S[i] * qvel_T[6 + i]

    # ---- inertias + contacts -------------------------------------------
    I_O = _spatial_inertias(fk)                             # (NB, 6, 6, N)
    body_v = torch.stack([v_root] + [v[_BODY_LAST_LINK[b]] for b in range(1, NB)])
    if contacts:
        f_ext, I_K = _contact_spatial(fk, body_v)

    # ---- RNEA: bias - external, gravity via base acceleration ----------
    a_base = torch.cat([qpos_T.new_zeros((5, N)), qpos_T.new_full((1, N), GRAVITY)])
    # free-joint velocity-product term: the rotation columns of S_root are
    # fixed in the ROOT BODY (body-frame omega convention), so
    # Sdot_rot qd_rot = v_root x_m (S_rot qd_rot); translations constant
    w_rot = S_root[3] * qvel_T[3]
    for k in range(4, 6):
        w_rot = w_rot + S_root[k] * qvel_T[k]
    a_root_b = a_base + _mcross(v_root, w_rot)
    a = [None] * NJ
    for i in range(NJ):
        p = int(LINK_PARENT[i])
        vp = v_root if p < 0 else v[p]
        ap = a_root_b if p < 0 else a[p]
        a[i] = ap + _mcross(vp, S[i] * qvel_T[6 + i])
    fb = [None] * NB
    for b in range(NB):
        vb = v_root if b == 0 else v[_BODY_LAST_LINK[b]]
        ab = a_root_b if b == 0 else a[_BODY_LAST_LINK[b]]
        Ivb = _mat6(I_O[b], vb)
        fb[b] = _mat6(I_O[b], ab) + _fcross(vb, Ivb)
        if contacts:
            fb[b] = fb[b] - f_ext[b]
    fl = [fb[int(LINK_CARRIER[i])] if LINK_CARRIER[i] >= 0 else qpos_T.new_zeros((6, N))
          for i in range(NJ)]
    tau_rnea = [None] * NJ
    f_root = fb[0]
    for i in reversed(range(NJ)):
        tau_rnea[i] = (S[i] * fl[i]).sum(0)
        p = int(LINK_PARENT[i])
        if p < 0:
            f_root = f_root + fl[i]
        else:
            fl[p] = fl[p] + fl[i]
    rnea = torch.cat([torch.stack([(S_root[k] * f_root).sum(0) for k in range(6)]),
                      torch.stack(tau_rnea)])               # (NV, N)

    rhs = tau_T + passive_forces_lanes(qpos_T, qvel_T) - rnea
    if limits:
        rhs = rhs + limit_forces_lanes(qpos_T, qvel_T)

    # ---- zero-velocity ABA: exact O(n) solve of (M + h D) x = rhs ------
    d_extra = torch.as_tensor(np.full((NJ,), JOINT_ARMATURE + h_implicit * JOINT_DAMPING),
                              dtype=dtype, device=qpos_T.device)
    if kd_extra is not None:
        d_extra = d_extra + h_implicit * kd_extra.to(dtype)

    IA = [None] * NJ
    pA = [qpos_T.new_zeros((6, N)) for _ in range(NJ)]
    for i in range(NJ):
        cb = int(LINK_CARRIER[i])
        if cb >= 0:
            IA[i] = I_O[cb] + h_implicit * I_K[cb] if contacts else I_O[cb]
        else:
            IA[i] = qpos_T.new_zeros((6, 6, N))
    IA_root = I_O[0] + h_implicit * I_K[0] if contacts else I_O[0]
    pA_root = qpos_T.new_zeros((6, N))

    U = [None] * NJ
    d = [None] * NJ
    u = [None] * NJ
    for i in reversed(range(NJ)):
        U[i] = _mat6(IA[i], S[i])                           # (6, N)
        d[i] = (S[i] * U[i]).sum(0) + d_extra[i]            # (N,)
        u[i] = rhs[6 + i] - (S[i] * pA[i]).sum(0)
        Ia = IA[i] - U[i][:, None] * U[i][None, :] / d[i]
        pa = pA[i] + U[i] * (u[i] / d[i])
        p = int(LINK_PARENT[i])
        if p < 0:
            IA_root = IA_root + Ia
            pA_root = pA_root + pa
        else:
            IA[p] = IA[p] + Ia
            pA[p] = pA[p] + pa

    Wk = [_mat6(IA_root, S_root[k]) for k in range(6)]
    D0 = torch.stack([torch.stack([(S_root[a_] * Wk[b]).sum(0) for b in range(6)])
                      for a_ in range(6)])                  # (6, 6, N)
    u0 = torch.stack([rhs[k] - (S_root[k] * pA_root).sum(0) for k in range(6)])
    qdd0 = spd_solve_lanes(D0, u0)                          # (6, N)

    a_root = S_root[0] * qdd0[0]
    for k in range(1, 6):
        a_root = a_root + S_root[k] * qdd0[k]
    qdd = [None] * NJ
    aL = [None] * NJ
    for i in range(NJ):
        p = int(LINK_PARENT[i])
        ap = a_root if p < 0 else aL[p]
        qdd[i] = (u[i] - (U[i] * ap).sum(0)) / d[i]
        aL[i] = ap + S[i] * qdd[i]
    return torch.cat([qdd0, torch.stack(qdd)])


def step_physics_aba(qpos_T, qvel_T, tau_T, h: float, *, contacts: bool = True,
                     limits: bool = True, kd_extra: torch.Tensor | None = None):
    """One implicitly-damped semi-implicit Euler substep (env-last), the
    scheme of dynamics.step_physics."""
    qacc = forward_dynamics_aba(qpos_T, qvel_T, tau_T, contacts=contacts, limits=limits,
                                h_implicit=h, kd_extra=kd_extra)
    qvel_T = qvel_T + h * qacc
    return integrate_lanes(qpos_T, qvel_T, h), qvel_T
