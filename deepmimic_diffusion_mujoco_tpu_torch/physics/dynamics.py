"""Forward rigid-body dynamics for the DeepMimic humanoid: static tables,
the dense engine, PD actuation and the batched engine front door.

The port of ``deepmimic_diffusion_mujoco_tpu/physics/dynamics.py``. The
static tables (masses, COMs and inertias from the geom spec with MuJoCo's
solid-shape formulas, joint gains and limits, contact support points) are
numpy copies, equal to the JAX package's element for element. The model
is the reference's dynamical system (dp_env_v2.xml:4,9,110-145: armature
0.02, damping 5, stiffness 10, torque actuators) with penalty ground
contact.

The dense engine works on any leading batch shape ``(..., 35)``:

- ``fk_dynamics``: FK with per-DOF world axes and anchors;
  ``body_jacobians`` the COM Jacobians; ``mass_matrix`` the CRB quadratic
  form plus armature.
- ``bias_forces``: Coriolis/centrifugal + gravity by Newton-Euler on body
  COM velocities and accelerations that come from differentiating the
  position kinematics twice in time (``_trajectory_jets``: second-order
  Taylor jets through the same operations, equal to ``torch.func.jvp``
  nested twice, which is what the JAX package nests).
- ``passive_forces``, ``limit_forces``, ``contact_terms`` (penalty contact,
  body-aggregated, with its implicit damping coupling J^T W J).
- ``forward_dynamics`` solves (M + h D) qacc = rhs with
  ``spd_solve_unrolled`` (an augmented Cholesky unrolled over the 34
  columns); ``step_physics`` is one semi-implicit Euler substep.

It is the engine held against MuJoCo's ``mj_forward``/``mj_step``
(``tests/test_torch_dynamics_mujoco.py``). ``dynamics_lanes.py`` lays the
same math out env-last, ``dynamics_aba.py`` solves it in O(n).

`DynamicsEnv` steps N envs with PD torques recomputed every substep. Its
layout picks the engine: "vmap" (this dense engine), "lanes", "aba", or
"auto"/"pallas": the whole control step (`dynamics_kernel.control_step`,
the CUDA kernel for CUDA tensors, its plain version for CPU tensors).
Every contraction runs in the tensor's dtype; callers keep cuBLAS TF32 off
(a rounded mass matrix loses positive-definiteness).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..data.skeleton import PARAMS_KP_KD, QPOS_JOINT_SLICES
from .humanoid_model import (
    BODIES,
    BODY_INDEX,
    FLOOR_FRICTION,
    GRAVITY,
    JOINT_ARMATURE,
    JOINT_DAMPING,
    JOINT_STIFFNESS,
)
from .kinematics import _cross, quat_from_axis_angle, quat_mul, quat_rotate

NB = len(BODIES)           # 13 bodies
NJ = 28                    # hinge DOFs
NV = 6 + NJ                # free root + hinges
NQ = 7 + NJ


# ---------------------------------------------------------------------------
# Static tables: mass properties, joint topology, contact points
# ---------------------------------------------------------------------------


def _geom_inertia(g) -> np.ndarray:
    """Solid-shape inertia about the geom COM, body-frame axes (diagonal:
    every capsule in the spec is z-aligned, boxes axis-aligned). MuJoCo's
    `inertiafromgeom` formulas."""
    m = g.mass
    if g.kind == "sphere":
        r = g.size[0]
        i = 0.4 * m * r * r
        return np.diag([i, i, i])
    if g.kind == "box":
        hx, hy, hz = g.size
        return np.diag([
            m / 3.0 * (hy * hy + hz * hz),
            m / 3.0 * (hx * hx + hz * hz),
            m / 3.0 * (hx * hx + hy * hy),
        ])
    if g.kind == "capsule":
        r = g.size[0]
        zlo, zhi = g.fromto[2], g.fromto[5]
        hl = abs(zhi - zlo) / 2.0
        v_cyl = np.pi * r * r * (2 * hl)
        v_sph = 4.0 / 3.0 * np.pi * r**3
        mc = m * v_cyl / (v_cyl + v_sph)
        ms = m - mc
        izz = mc * r * r / 2.0 + 0.4 * ms * r * r
        ixx = (
            mc * (hl * hl / 3.0 + r * r / 4.0)
            + ms * (0.4 * r * r + hl * hl + 0.75 * hl * r)
        )
        return np.diag([ixx, ixx, izz])
    raise ValueError(g.kind)


def _mass_tables():
    """Per-body mass, COM (body frame) and inertia about the COM."""
    mass = np.zeros((NB,))
    com = np.zeros((NB, 3))
    inertia = np.zeros((NB, 3, 3))
    for bi, b in enumerate(BODIES):
        ms = np.asarray([g.mass for g in b.geoms])
        cs = np.asarray([g.com for g in b.geoms])
        mass[bi] = ms.sum()
        com[bi] = (ms[:, None] * cs).sum(0) / mass[bi]
        ine = np.zeros((3, 3))
        for g, c in zip(b.geoms, cs):
            d = c - com[bi]
            ine += _geom_inertia(g) + g.mass * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
        inertia[bi] = ine
    return mass, com, inertia


BODY_MASS, BODY_COM, BODY_INERTIA = _mass_tables()


def _joint_tables():
    """Per-hinge static data + the (body, dof) ancestor mask."""
    jbody, jaxis, janchor = [], [], []
    kp, kd, lo, hi = [], [], [], []
    for b in BODIES[1:]:
        gains = PARAMS_KP_KD[b.name]
        for h in b.joints:
            jbody.append(BODY_INDEX[b.name])
            jaxis.append(h.axis)
            janchor.append(h.pos)
            kp.append(gains[0])
            kd.append(gains[1])
            lo.append(np.deg2rad(h.range_deg[0]))
            hi.append(np.deg2rad(h.range_deg[1]))
    jbody = np.asarray(jbody, np.int32)
    # ancestor-or-self: DOF j affects body b iff j's body is on b's chain
    parent = np.asarray([-1] + [BODY_INDEX[b.parent] for b in BODIES[1:]], np.int32)
    mask = np.zeros((NB, NJ), np.float32)
    for bi in range(NB):
        a = bi
        while a >= 0:
            mask[bi, jbody == a] = 1.0
            a = parent[a]
    return (
        jbody,
        np.asarray(jaxis, np.float32),
        np.asarray(janchor, np.float32),
        mask,
        np.asarray(kp, np.float32),
        np.asarray(kd, np.float32),
        np.asarray(lo, np.float32),
        np.asarray(hi, np.float32),
    )


(JOINT_BODY, JOINT_AXIS, JOINT_ANCHOR, ANCESTOR_MASK,
 PD_KP, PD_KD, LIMIT_LO, LIMIT_HI) = _joint_tables()


def _contact_tables():
    """Support points: (body, local point, effective radius). Boxes
    contribute their 8 corners (radius 0); spheres their center (radius r);
    capsules both cap centers (radius r)."""
    body, point, radius = [], [], []
    for bi, b in enumerate(BODIES):
        for g in b.geoms:
            if g.kind == "sphere":
                body.append(bi); point.append(g.pos); radius.append(g.size[0])
            elif g.kind == "capsule":
                body.append(bi); point.append(g.fromto[:3]); radius.append(g.size[0])
                body.append(bi); point.append(g.fromto[3:]); radius.append(g.size[0])
            elif g.kind == "box":
                hx, hy, hz = g.size
                for sx in (-1, 1):
                    for sy in (-1, 1):
                        for sz in (-1, 1):
                            body.append(bi)
                            point.append((g.pos[0] + sx * hx,
                                          g.pos[1] + sy * hy,
                                          g.pos[2] + sz * hz))
                            radius.append(0.0)
    return (np.asarray(body, np.int32), np.asarray(point, np.float32),
            np.asarray(radius, np.float32))


CONTACT_BODY, CONTACT_POINT, CONTACT_RADIUS = _contact_tables()




# static one-hot (NB, NC) point->body aggregation matrix: per-body moment
# sums become one small matmul instead of scatter-adds
_CONTACT_ONEHOT = np.zeros((NB, len(CONTACT_BODY)), np.float32)
_CONTACT_ONEHOT[CONTACT_BODY, np.arange(len(CONTACT_BODY))] = 1.0


@functools.lru_cache(maxsize=None)
def _tables(dtype: torch.dtype, device: torch.device) -> dict[str, torch.Tensor]:
    """The static tables as tensors of one dtype on one device, made once
    per pair. Spec values (body offsets, hinge axes and anchors) are cast
    from their python floats, the numpy tables from their own dtype, as the
    JAX package casts them."""
    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    hinges = [h for b in BODIES[1:] for h in b.joints]
    arm = np.zeros(NV)
    arm[6:] = JOINT_ARMATURE
    damp = np.zeros(NV)
    damp[6:] = JOINT_DAMPING
    return {
        "offset": t([b.offset for b in BODIES]),
        "hinge_axis": t([h.axis for h in hinges]),
        "hinge_pos": t([h.pos for h in hinges]),
        "unit_quat": t([1.0, 0.0, 0.0, 0.0]),
        "eye3": t(np.eye(3)),
        "body_mass": t(BODY_MASS),
        "body_com": t(BODY_COM),
        "body_inertia": t(BODY_INERTIA),
        "ancestor_mask": t(ANCESTOR_MASK),
        "contact_body": torch.as_tensor(CONTACT_BODY, dtype=torch.long, device=device),
        "contact_point": t(CONTACT_POINT),
        "contact_radius": t(CONTACT_RADIUS),
        "contact_onehot": t(_CONTACT_ONEHOT),
        "limit_lo": t(LIMIT_LO),
        "limit_hi": t(LIMIT_HI),
        "pd_kp": t(PD_KP),
        "pd_kd": t(PD_KD),
        "armature": t(np.diag(arm)),
        "damping": t(np.diag(damp)),
        "gravity": t([0.0, 0.0, -GRAVITY]),
    }


def _tables_of(x: torch.Tensor) -> dict[str, torch.Tensor]:
    return _tables(x.dtype, x.device)


# ---------------------------------------------------------------------------
# Augmented FK: body poses + per-DOF world axes/anchors
# ---------------------------------------------------------------------------


class DynFK(NamedTuple):
    body_pos: torch.Tensor    # (..., NB, 3) body-frame origins, world
    body_quat: torch.Tensor   # (..., NB, 4)
    com_w: torch.Tensor       # (..., NB, 3) body COMs, world
    dof_axis: torch.Tensor    # (..., NJ, 3) hinge axes, world
    dof_anchor: torch.Tensor  # (..., NJ, 3) hinge anchor points, world


def fk_dynamics(qpos: torch.Tensor) -> DynFK:
    """(..., 35) augmented FK. Hinges fold in declaration order; hinge k's
    world axis/anchor account for the preceding hinges of the same body
    (kinematics.py's transform convention). No in-place writes: forward-mode
    AD runs through it."""
    T = _tables_of(qpos)
    root_pos = qpos[..., 0:3]
    root_quat = qpos[..., 3:7]
    root_quat = root_quat / torch.linalg.vector_norm(root_quat, dim=-1, keepdim=True)

    pos = [None] * NB
    quat = [None] * NB
    pos[0], quat[0] = root_pos, root_quat
    axes, anchors = [], []
    j = 0
    for bi, b in enumerate(BODIES[1:], start=1):
        angles = qpos[..., QPOS_JOINT_SLICES[b.name]]
        parent = BODY_INDEX[b.parent]
        offset = T["offset"][bi]
        q_local = T["unit_quat"]
        t_local = torch.zeros_like(offset)
        for k in range(len(b.joints)):
            a_k, p_k = T["hinge_axis"][j], T["hinge_pos"][j]
            j += 1
            # world axis/anchor BEFORE applying this hinge's rotation
            axes.append(quat_rotate(quat[parent], quat_rotate(q_local, a_k)))
            anchors.append(pos[parent] + quat_rotate(
                quat[parent], offset + t_local + quat_rotate(q_local, p_k)))
            qk = quat_from_axis_angle(a_k, angles[..., k])
            tk = p_k - quat_rotate(qk, p_k)
            t_local = t_local + quat_rotate(q_local, tk)
            q_local = quat_mul(q_local, qk)
        pos[bi] = pos[parent] + quat_rotate(quat[parent], offset + t_local)
        quat[bi] = quat_mul(quat[parent], q_local)

    body_pos = torch.stack(pos, dim=-2)
    body_quat = torch.stack(quat, dim=-2)
    com_w = body_pos + quat_rotate(body_quat, T["body_com"])
    return DynFK(body_pos, body_quat, com_w, torch.stack(axes, dim=-2),
                 torch.stack(anchors, dim=-2))


def body_jacobians(fk: DynFK):
    """COM Jacobians for every body: Jv (..., NB, 3, NV), Jw (..., NB, 3, NV).

    Free root: translation columns are the world basis; rotation columns
    are the root rotation matrix columns (BODY-frame angular velocity,
    MuJoCo free-joint convention). Hinge j contributes n_j (angular) and
    n_j x (com_b - anchor_j) (linear) to every descendant body."""
    T = _tables_of(fk.body_pos)
    eye = T["eye3"]
    batch = fk.body_pos.shape[:-2]
    R_cols = quat_rotate(fk.body_quat[..., 0:1, :], eye)     # rows = world images of e_k
    mask = T["ancestor_mask"][..., None]                     # (NB, NJ, 1)
    # hinge part
    n = fk.dof_axis[..., None, :, :]                         # (..., 1, NJ, 3)
    rel = fk.com_w[..., :, None, :] - fk.dof_anchor[..., None, :, :]   # (..., NB, NJ, 3)
    jv_h = torch.linalg.cross(n.expand(rel.shape), rel, dim=-1) * mask
    jw_h = n.expand(rel.shape) * mask
    # root part
    rel0 = fk.com_w - fk.body_pos[..., 0:1, :]               # (..., NB, 3)
    rr = batch + (NB, 3, 3)
    jv_rt = eye.expand(rr)
    jv_rr = torch.linalg.cross(R_cols[..., None, :, :].expand(rr),
                               rel0[..., :, None, :].expand(rr), dim=-1)
    jw_rr = R_cols[..., None, :, :].expand(rr)
    Jv = torch.cat([jv_rt, jv_rr, jv_h], dim=-2).transpose(-1, -2)
    Jw = torch.cat([torch.zeros_like(jv_rt), jw_rr, jw_h], dim=-2).transpose(-1, -2)
    return Jv, Jw


def _quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3)."""
    basis = _tables_of(q)["eye3"]
    return torch.stack([quat_rotate(q, basis[i].expand(q.shape[:-1] + (3,)))
                        for i in range(3)], dim=-1)


def _crb_mass(fk: DynFK, Jv: torch.Tensor, Jw: torch.Tensor) -> torch.Tensor:
    T = _tables_of(Jv)
    R = _quat_to_mat(fk.body_quat)                           # (..., NB, 3, 3)
    I_w = R @ T["body_inertia"] @ R.transpose(-1, -2)
    M = torch.einsum("...biv,b,...biw->...vw", Jv, T["body_mass"], Jv)
    M = M + torch.einsum("...biv,...bij,...bjw->...vw", Jw, I_w, Jw)
    return M + T["armature"]


def mass_matrix(fk: DynFK) -> torch.Tensor:
    """(..., NV, NV) joint-space inertia: CRB quadratic form + armature."""
    return _crb_mass(fk, *body_jacobians(fk))


# ---------------------------------------------------------------------------
# Position integration (exponential map) and bias forces via nested jvp
# ---------------------------------------------------------------------------


def integrate_qpos(qpos: torch.Tensor, qvel: torch.Tensor, dt) -> torch.Tensor:
    """Advance positions along velocities for time dt (a float or a 0-d
    tensor of the state's dtype): root translation is linear, the root
    quaternion moves on the exponential map of the BODY-frame angular
    velocity (right multiplication), hinges are linear. No in-place writes:
    forward-mode AD in dt runs through it."""
    root_pos = qpos[..., 0:3] + dt * qvel[..., 0:3]
    w = qvel[..., 3:6]
    n2 = (w * w).sum(-1, keepdim=True)
    safe = torch.where(n2 > 1e-16, n2, torch.ones_like(n2))
    norm = torch.sqrt(safe)
    half = 0.5 * dt * norm
    # sin(half)/norm, series-safe at |w| -> 0 (finite tangents there)
    k = torch.where(n2 > 1e-16, torch.sin(half) / norm, 0.5 * dt * torch.ones_like(n2))
    dq = torch.cat([torch.cos(half), k * w], dim=-1)
    quat = quat_mul(qpos[..., 3:7], dq)
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    joints = qpos[..., 7:] + dt * qvel[..., 6:]
    return torch.cat([root_pos, quat, joints], dim=-1)


def _quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


# Second-order Taylor-mode forward differentiation in time. A jet is a
# tensor whose leading axis of 3 holds a quantity along a trajectory and
# its first and second time derivatives at t = 0; each operation of the
# kinematics maps jets to jets by the chain and product rules. It computes
# what jax.jvp nested twice computes through integrate_qpos and fk_dynamics
# (tests/test_torch_dynamics_engines.py holds it against torch.func.jvp
# nested twice), with plain tensor operations: nested torch.func.jvp costs
# tens of microseconds of host time per operation and a multiple of that
# where a dual tensor meets a constant, 0.4-1.5 s per bias_forces call.

_BIL_A = [0, 1, 0, 2, 1, 0]   # f(a, b)'' = f(a'', b) + 2 f(a', b') + f(a, b'')
_BIL_B = [0, 0, 1, 0, 1, 2]


def _jlinear(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """x0 + t x1 as a jet (a constant when x1 is 0). Products and cross
    products of a jet with a constant act on each component; sums need the
    constant as a jet."""
    return torch.stack([x0, x1, torch.zeros_like(x0)])


def _jconst(c: torch.Tensor, shape) -> torch.Tensor:
    c = c.expand(shape)
    return _jlinear(c, torch.zeros_like(c))


def _jbil(f, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f(a, b) on two jets for a bilinear f: one call on the six pairs."""
    p = f(a[_BIL_A], b[_BIL_B])
    return torch.stack([p[0], p[1] + p[2], p[3] + 2.0 * p[4] + p[5]])


def _jfun(a: torch.Tensor, f0, f1, f2) -> torch.Tensor:
    """g(a) for a scalar function g with g = f0, g' = f1, g'' = f2."""
    d1 = f1(a[0])
    return torch.stack([f0(a[0]), d1 * a[1], f2(a[0]) * a[1] * a[1] + d1 * a[2]])


def _jsin(a):
    return _jfun(a, torch.sin, torch.cos, lambda x: -torch.sin(x))


def _jcos(a):
    return _jfun(a, torch.cos, lambda x: -torch.sin(x), lambda x: -torch.cos(x))


def _jnormalize(q):
    """q / |q| over the last axis."""
    r = _jfun(_jbil(torch.mul, q, q).sum(-1, keepdim=True), torch.rsqrt,
              lambda s: -0.5 * torch.rsqrt(s) / s, lambda s: 0.75 * torch.rsqrt(s) / (s * s))
    return _jbil(torch.mul, q, r)


def _jqrot(q, v):
    """kinematics.quat_rotate on jets: v + 2 (w (u x v) + u x (u x v))."""
    w, u = q[..., :1], q[..., 1:]
    uv = _jbil(_cross, u, v)
    return v + 2.0 * (_jbil(torch.mul, w, uv) + _jbil(_cross, u, uv))


def _trajectory_jets(qpos: torch.Tensor, qvel: torch.Tensor):
    """Body COMs (3, ..., NB, 3) and orientations (3, ..., NB, 4) of
    fk_dynamics(integrate_qpos(qpos, qvel, t)) as jets at t = 0: the same
    operations in the same order, each on value, velocity and acceleration."""
    T = _tables_of(qpos)
    # integrate_qpos(qpos, qvel, t)
    root_pos = _jlinear(qpos[..., 0:3], qvel[..., 0:3])
    w = qvel[..., 3:6]
    n2 = (w * w).sum(-1, keepdim=True)
    safe = torch.where(n2 > 1e-16, n2, torch.ones_like(n2))
    norm = torch.sqrt(safe)
    half = _jlinear(torch.zeros_like(norm), 0.5 * norm)
    k = torch.where(n2 > 1e-16, _jsin(half) / norm,
                    _jlinear(torch.zeros_like(n2), torch.full_like(n2, 0.5)))
    dq = torch.cat([_jcos(half), k * w], dim=-1)
    quat = _jnormalize(quat_mul(qpos[..., 3:7], dq))
    joints = _jlinear(qpos[..., 7:], qvel[..., 6:])

    # fk_dynamics: positions and orientations
    pos = [None] * NB
    rot = [None] * NB
    pos[0], rot[0] = root_pos, _jnormalize(quat)
    j = 0
    for bi, b in enumerate(BODIES[1:], start=1):
        sl = QPOS_JOINT_SLICES[b.name]
        angles = joints[..., sl.start - 7:sl.stop - 7]
        parent = BODY_INDEX[b.parent]
        q_local = _jconst(T["unit_quat"], rot[parent].shape[1:])
        t_local = torch.zeros_like(pos[parent])
        for k in range(len(b.joints)):
            a_k, p_k = T["hinge_axis"][j], T["hinge_pos"][j]
            j += 1
            half = angles[..., k:k + 1] * 0.5
            qk = torch.cat([_jcos(half), _jsin(half) * a_k], dim=-1)
            p_k = _jconst(p_k, t_local.shape[1:])
            tk = p_k - _jqrot(qk, p_k)
            t_local = t_local + _jqrot(q_local, tk)
            q_local = _jbil(quat_mul, q_local, qk)
        offset = _jconst(T["offset"][bi], t_local.shape[1:])
        pos[bi] = pos[parent] + _jqrot(rot[parent], offset + t_local)
        rot[bi] = _jbil(quat_mul, rot[parent], q_local)
    body_pos = torch.stack(pos, dim=-2)
    body_quat = torch.stack(rot, dim=-2)
    return body_pos + _jqrot(body_quat, _jconst(T["body_com"], body_pos.shape[1:])), body_quat


def body_rates(qpos: torch.Tensor, qvel: torch.Tensor):
    """Along the qacc = 0 trajectory from (qpos, qvel): body orientations
    q0, COM accelerations a_com and world angular velocities w and
    accelerations alpha, each (..., NB, 4 or 3)."""
    com, (q0, dq, ddq) = _trajectory_jets(qpos, qvel)
    # world angular velocity from qdot: w = 2 vec(qdot q*), and its rate
    w = 2.0 * quat_mul(dq, _quat_conj(q0))[..., 1:]
    alpha = 2.0 * (quat_mul(ddq, _quat_conj(q0)) + quat_mul(dq, _quat_conj(dq)))[..., 1:]
    return q0, com[2], w, alpha


def bias_forces(qpos: torch.Tensor, qvel: torch.Tensor,
                fk0: DynFK | None = None, JvJw=None) -> torch.Tensor:
    """(..., NV) generalized Coriolis/centrifugal + gravity forces c(q, qv)
    (MuJoCo's qfrc_bias sign convention: M qacc = tau - c).

    Body COM velocity/acceleration and angular velocity/acceleration along
    the exact qacc=0 trajectory come from differentiating the position
    kinematics twice in time (`body_rates`): no hand-derived velocity-product
    terms. Newton-Euler per body, mapped back through the Jacobians."""
    T = _tables_of(qpos)
    q0, a_com, w, alpha = body_rates(qpos, qvel)
    R = _quat_to_mat(q0)
    I_w = R @ T["body_inertia"] @ R.transpose(-1, -2)
    F = T["body_mass"][:, None] * (a_com - T["gravity"])     # (..., NB, 3)
    Iw_w = torch.einsum("...bij,...bj->...bi", I_w, w)
    N = torch.einsum("...bij,...bj->...bi", I_w, alpha) + torch.linalg.cross(w, Iw_w, dim=-1)

    # the caller (forward_dynamics) has usually already run the FK and
    # Jacobians for the mass matrix: reuse them instead of recomputing
    if JvJw is None:
        JvJw = body_jacobians(fk0 if fk0 is not None else fk_dynamics(qpos))
    Jv, Jw = JvJw
    return (torch.einsum("...biv,...bi->...v", Jv, F)
            + torch.einsum("...biv,...bi->...v", Jw, N))


# ---------------------------------------------------------------------------
# Passive forces, limits, contacts
# ---------------------------------------------------------------------------


def _root_zeros(x: torch.Tensor) -> torch.Tensor:
    return x.new_zeros(x.shape[:-1] + (6,))


def passive_forces(qpos: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
    """Hinge spring/damper from the XML defaults (stiffness 10 toward
    springref 0, damping 5; dp_env_v2.xml:4). Root is free."""
    tau_j = -JOINT_STIFFNESS * qpos[..., 7:] - JOINT_DAMPING * qvel[..., 6:]
    return torch.cat([_root_zeros(tau_j), tau_j], dim=-1)


def limit_forces(qpos: torch.Tensor, qvel: torch.Tensor,
                 k: float = 300.0, c: float = 3.0) -> torch.Tensor:
    """Soft joint-limit penalty (MuJoCo enforces limits in its constraint
    solver; a stiff one-sided spring is the penalty analog)."""
    T = _tables_of(qpos)
    q = qpos[..., 7:]
    over = torch.clamp_min(q - T["limit_hi"], 0.0)
    under = torch.clamp_min(T["limit_lo"] - q, 0.0)
    hit = ((over > 0) | (under > 0)).to(qpos.dtype)
    tau_j = -k * over + k * under - c * qvel[..., 6:] * hit
    return torch.cat([_root_zeros(tau_j), tau_j], dim=-1)


def _skew(r: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    z = torch.zeros_like(r[..., 0])
    return torch.stack([
        torch.stack([z, -r[..., 2], r[..., 1]], -1),
        torch.stack([r[..., 2], z, -r[..., 0]], -1),
        torch.stack([-r[..., 1], r[..., 0], z], -1),
    ], -2)


def _diag3(d: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) diagonal embedding."""
    return torch.diag_embed(d)


def contact_terms(fk: DynFK, Jv: torch.Tensor, Jw: torch.Tensor, qvel: torch.Tensor,
                  stiffness: float = 30000.0, damping: float = 1000.0,
                  mu: float = FLOOR_FRICTION, v_reg: float = 5e-3):
    """Penalty ground contacts at the static support points.

    Normal: one-sided spring-damper on penetration depth; tangential:
    viscous-in-Coulomb-cone friction, coefficient mu*f_n/|v_t|
    (regularized). Both damping-like parts come back as a velocity-coupling
    matrix J^T W J so the integrator can treat them implicitly.

    The point Jacobians are never built: everything aggregates to per-body
    3x3 moments first (exact algebra),

      xdot_p = v_b + w_b x r_p,  tau_c = sum_b [Jv_b^T F_b + Jw_b^T T_b],
      JWJ    = sum_b G_b^T K_b G_b,  G_b = [Jv_b; Jw_b],
      K_b    = [[A_b, -B_b], [-B_b^T, C_b]],  A_b = sum W_p,
      B_b    = sum W_p S_p,  C_b = sum S_p^T W_p S_p,
      S_p    = skew(r_p),  W_p = diag(c_t, c_t, c_n).

    Returns (tau_c (..., NV), JWJ (..., NV, NV))."""
    T = _tables_of(qvel)
    bidx = T["contact_body"]
    onehot = T["contact_onehot"]                                 # (NB, NC)
    NC = bidx.shape[0]
    batch = qvel.shape[:-1]

    x = fk.body_pos[..., bidx, :] + quat_rotate(fk.body_quat[..., bidx, :], T["contact_point"])
    r = x - fk.com_w[..., bidx, :]                               # (..., NC, 3)

    # body COM twist -> per-point velocity: xdot = v_b + w_b x r
    v_b = torch.einsum("...bav,...v->...ba", Jv, qvel)           # (..., NB, 3)
    w_b = torch.einsum("...bav,...v->...ba", Jw, qvel)
    xdot = v_b[..., bidx, :] + torch.linalg.cross(w_b[..., bidx, :], r, dim=-1)

    depth = T["contact_radius"] - x[..., 2]                      # >0: contact
    active = (depth > 0.0).to(qvel.dtype)
    fn_spring = stiffness * depth * active
    fn = torch.clamp_min(fn_spring - damping * xdot[..., 2] * active, 0.0)
    vt = xdot[..., 0:2]
    vt_norm = torch.sqrt((vt * vt).sum(-1) + v_reg * v_reg)
    c_t = mu * fn / vt_norm                                      # (..., NC)
    ft = -c_t[..., None] * vt
    f = torch.cat([ft, fn[..., None]], dim=-1)                   # (..., NC, 3)

    # force/torque resultants per body: F_b = sum f, T_b = sum r x f
    F = onehot @ f                                               # (..., NB, 3)
    Tq = onehot @ torch.linalg.cross(r, f, dim=-1)
    tau_c = (torch.einsum("...bav,...ba->...v", Jv, F)
             + torch.einsum("...bav,...ba->...v", Jw, Tq))

    # per-point world-frame diag(c_t, c_t, c_n) -> body moment matrices
    W = torch.stack([c_t, c_t, damping * active], dim=-1)       # (..., NC, 3)
    S = _skew(r)                                                 # (..., NC, 3, 3)
    WS = W[..., :, None] * S                                     # diag(W) S
    STWS = torch.einsum("...pij,...pik->...pjk", S, WS)          # S^T W S
    A = onehot @ W                                               # (..., NB, 3)
    B = (onehot @ WS.reshape(batch + (NC, 9))).reshape(batch + (NB, 3, 3))
    C = (onehot @ STWS.reshape(batch + (NC, 9))).reshape(batch + (NB, 3, 3))
    K = torch.cat([
        torch.cat([_diag3(A), -B], dim=-1),
        torch.cat([-B.transpose(-1, -2), C], dim=-1),
    ], dim=-2)                                                   # (..., NB, 6, 6)
    G = torch.cat([Jv, Jw], dim=-2)                              # (..., NB, 6, NV)
    JWJ = torch.einsum("...biv,...bij,...bjw->...vw", G, K, G)
    return tau_c, JWJ


# ---------------------------------------------------------------------------
# Forward dynamics + stepping
# ---------------------------------------------------------------------------


def forward_dynamics(qpos: torch.Tensor, qvel: torch.Tensor, tau: torch.Tensor, *,
                     contacts: bool = True, limits: bool = True, h_implicit: float = 0.0,
                     kd_extra: torch.Tensor | None = None) -> torch.Tensor:
    """qacc (..., NV) = (M + h*D)^-1 (tau + passive + limits + contacts - bias).

    `tau` is the applied generalized force (root rows usually 0). With
    h_implicit > 0 all damping-like forces (joint damping, the PD's kd given
    via kd_extra (NJ,) or (..., NJ), contact damping and friction) are
    integrated implicitly: they appear explicitly in the rhs AND as h*D on
    the solve matrix, the backward-Euler update for the velocity-linear part
    (MuJoCo's Euler does the same for joint damping). With h_implicit = 0
    this is the exact continuous forward dynamics."""
    T = _tables_of(qpos)
    fk = fk_dynamics(qpos)
    Jv, Jw = body_jacobians(fk)
    M = _crb_mass(fk, Jv, Jw)

    rhs = tau + passive_forces(qpos, qvel) - bias_forces(qpos, qvel, fk0=fk, JvJw=(Jv, Jw))
    if limits:
        rhs = rhs + limit_forces(qpos, qvel)
    D = T["damping"]
    if kd_extra is not None:
        D = D + torch.diag_embed(torch.cat([_root_zeros(kd_extra), kd_extra], dim=-1))
    if contacts:
        tau_c, JWJ = contact_terms(fk, Jv, Jw, qvel)
        rhs = rhs + tau_c
        D = D + JWJ
    return spd_solve_unrolled(M + h_implicit * D, rhs)


def spd_solve_unrolled(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the SPD system M x = b, (..., n, n) and (..., n), by a
    Cholesky factorization unrolled over its n column steps.

    The forward substitution comes for free: factoring the augmented matrix
    [[M, b], [b^T, 1]] puts y = L^-1 b in the last row of the augmented
    factor. Only the (also unrolled) backward substitution L^T x = y
    remains."""
    n = M.shape[-1]
    A = torch.cat([M, b[..., :, None]], dim=-1)
    # the trailing diagonal entry only keeps the rsqrt finite (its column is
    # never used)
    A = torch.cat([A, torch.cat([b, torch.ones_like(b[..., :1])], dim=-1)[..., None, :]], dim=-2)
    cols = []
    for _ in range(n):
        c = A[..., :, 0]
        c = c * torch.rsqrt(c[..., 0:1])                     # Cholesky column j
        cols.append(c)
        A = A[..., 1:, 1:] - c[..., 1:, None] * c[..., None, 1:]  # trailing Schur update
    # cols[j] is (..., n + 1 - j): [0] = L[j, j], [1:-1] = L[j+1:, j], and
    # the LAST entry L_aug[n, j] = y[j] (y solves L y = b)
    xs = [None] * n
    for i in reversed(range(n)):
        acc = cols[i][..., -1]
        if i < n - 1:
            acc = acc - (cols[i][..., 1:-1] * torch.stack(xs[i + 1:], dim=-1)).sum(-1)
        xs[i] = acc / cols[i][..., 0]
    return torch.stack(xs, dim=-1)


def step_physics(qpos: torch.Tensor, qvel: torch.Tensor, tau: torch.Tensor, h: float, *,
                 contacts: bool = True, limits: bool = True,
                 kd_extra: torch.Tensor | None = None):
    """One implicitly-damped semi-implicit Euler substep (velocity update
    first, then positions integrate with the NEW velocity: MuJoCo's Euler
    scheme)."""
    qacc = forward_dynamics(qpos, qvel, tau, contacts=contacts, limits=limits,
                            h_implicit=h, kd_extra=kd_extra)
    qvel = qvel + h * qacc
    return integrate_qpos(qpos, qvel, h), qvel


def pd_torques(qpos: torch.Tensor, qvel: torch.Tensor, target_qpos: torch.Tensor,
               kp_scale: float = 1.0, kd_scale: float = 1.0) -> torch.Tensor:
    """DeepMimic joint-space PD toward a target pose (PARAMS_KP_KD,
    mocap_util.py:22-25); root rows zero (unactuated free joint)."""
    T = _tables_of(qpos)
    kp = T["pd_kp"] * kp_scale
    kd = T["pd_kd"] * kd_scale
    tau_j = kp * (target_qpos[..., 7:] - qpos[..., 7:]) - kd * qvel[..., 6:]
    return torch.cat([_root_zeros(tau_j), tau_j], dim=-1)


# ---------------------------------------------------------------------------
# The engine front door
# ---------------------------------------------------------------------------

LAYOUTS = ("aba", "lanes", "vmap", "pallas")


class DynamicsEnv:
    """Vectorized forward-dynamics environment: N instances stepped in
    lockstep, DeepMimic PD actuation toward a target pose.

    dt is the 30 Hz control interval of the mocap clips; substeps at
    h = dt/substeps ~= the reference integrator timestep 0.002
    (dp_env_v2.xml:9). `layout` selects the engine, all the same math:

      - "vmap": the dense engine of this module on (N, 35) (the engine held
        against MuJoCo);
      - "lanes": the dense engine env-last on (35, N) (dynamics_lanes.py);
      - "aba": O(n) Featherstone, world-frame RNEA bias + a zero-velocity
        articulated-body solve, env-last (dynamics_aba.py);
      - "pallas" and "auto": the whole control step
        (`dynamics_kernel.control_step`: the CUDA kernel for CUDA tensors,
        its plain version for CPU tensors).

    The lanes and aba layouts transpose the state once per control step.
    Every layout recomputes the PD torques each substep against the fixed
    target and integrates the PD's kd implicitly (kd_extra)."""

    def __init__(self, dt: float = 1.0 / 30.0, substeps: int = 17,
                 kp_scale: float = 1.0, kd_scale: float = 1.0,
                 contacts: bool = True, limits: bool = True,
                 layout: str = "auto"):
        if layout == "auto":
            layout = "pallas"
        if layout not in LAYOUTS:
            raise ValueError(layout)
        self.dt = dt
        self.substeps = substeps
        self.h = dt / substeps
        self.kp_scale = kp_scale
        self.kd_scale = kd_scale
        self.contacts = contacts
        self.limits = limits
        self.layout = layout

    def kernel_args(self) -> dict:
        return dict(h=self.h, substeps=self.substeps, kp_scale=self.kp_scale,
                    kd_scale=self.kd_scale, contacts=self.contacts, limits=self.limits)

    def step(self, qpos: torch.Tensor, qvel: torch.Tensor, target_qpos: torch.Tensor):
        """(N, 35), (N, 34), (N, 35) -> stepped (qpos, qvel). PD torques are
        recomputed every substep against the fixed target."""
        if self.layout == "pallas":
            from .dynamics_kernel import control_step

            return control_step(qpos, qvel, target_qpos, **self.kernel_args())

        kd = _tables_of(qpos)["pd_kd"] * self.kd_scale
        kw = dict(contacts=self.contacts, limits=self.limits, kd_extra=kd)
        if self.layout == "vmap":
            for _ in range(self.substeps):
                tau = pd_torques(qpos, qvel, target_qpos, self.kp_scale, self.kd_scale)
                qpos, qvel = step_physics(qpos, qvel, tau, self.h, **kw)
            return qpos, qvel

        from . import dynamics_lanes as DL

        if self.layout == "aba":
            from .dynamics_aba import step_physics_aba as step_T
        else:
            step_T = DL.step_physics_lanes
        tgt_T, qp_T, qv_T = target_qpos.T, qpos.T, qvel.T
        for _ in range(self.substeps):
            tau_T = DL.pd_torques_lanes(qp_T, qv_T, tgt_T, self.kp_scale, self.kd_scale)
            qp_T, qv_T = step_T(qp_T, qv_T, tau_T, self.h, **kw)
        return qp_T.T.contiguous(), qv_T.T.contiguous()
