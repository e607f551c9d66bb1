"""Forward rigid-body dynamics for the DeepMimic humanoid: static tables,
PD actuation and the batched engine front door.

The port of ``deepmimic_diffusion_mujoco_tpu/physics/dynamics.py``. The
static tables (masses, COMs and inertias from the geom spec with MuJoCo's
solid-shape formulas, joint gains and limits, contact support points) are
numpy copies, equal to the JAX package's element for element. The model
is the reference's dynamical system (dp_env_v2.xml:4,9,110-145: armature
0.02, damping 5, stiffness 10, torque actuators) with penalty ground
contact; the algebra lives in ``dynamics_kernel.py``.

`DynamicsEnv.step` runs the whole control step (all substeps of PD + FK +
contacts + RNEA + zero-velocity ABA + semi-implicit Euler): the CUDA kernel
for CUDA tensors, its plain version for CPU tensors. The JAX package's
other engines (the dense `mass_matrix` / nested-jvp `bias_forces` /
`contact_terms` / `forward_dynamics` / `spd_solve_unrolled` /
`step_physics`, the env-last ABA and lanes layouts) are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.skeleton import PARAMS_KP_KD
from .humanoid_model import BODIES, BODY_INDEX
from .kinematics import quat_mul

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


# ---------------------------------------------------------------------------
# PD actuation and position integration
# ---------------------------------------------------------------------------


def pd_torques(qpos: torch.Tensor, qvel: torch.Tensor, target_qpos: torch.Tensor,
               kp_scale: float = 1.0, kd_scale: float = 1.0) -> torch.Tensor:
    """DeepMimic joint-space PD toward a target pose (PARAMS_KP_KD,
    mocap_util.py:22-25); root rows zero (unactuated free joint)."""
    kp = torch.as_tensor(PD_KP, dtype=qpos.dtype, device=qpos.device) * kp_scale
    kd = torch.as_tensor(PD_KD, dtype=qpos.dtype, device=qpos.device) * kd_scale
    tau_j = kp * (target_qpos[..., 7:] - qpos[..., 7:]) - kd * qvel[..., 6:]
    zeros = torch.zeros(qpos.shape[:-1] + (6,), dtype=qpos.dtype, device=qpos.device)
    return torch.cat([zeros, tau_j], dim=-1)


def integrate_qpos(qpos: torch.Tensor, qvel: torch.Tensor, dt) -> torch.Tensor:
    """Advance positions along velocities for time dt: root translation is
    linear, the root quaternion moves on the exponential map of the
    BODY-frame angular velocity (right multiplication), hinges are linear."""
    root_pos = qpos[..., 0:3] + dt * qvel[..., 0:3]
    w = qvel[..., 3:6]
    n2 = (w * w).sum(-1, keepdim=True)
    safe = torch.where(n2 > 1e-16, n2, torch.ones_like(n2))
    norm = torch.sqrt(safe)
    half = 0.5 * dt * norm
    # sin(half)/norm, series-safe at |w| -> 0
    k = torch.where(n2 > 1e-16, torch.sin(half) / norm, torch.full_like(n2, 0.5 * dt))
    dq = torch.cat([torch.cos(half), k * w], dim=-1)
    quat = quat_mul(qpos[..., 3:7], dq)
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    joints = qpos[..., 7:] + dt * qvel[..., 6:]
    return torch.cat([root_pos, quat, joints], dim=-1)


# ---------------------------------------------------------------------------
# The engine front door
# ---------------------------------------------------------------------------

_UNPORTED_LAYOUTS = {
    "aba": "the env-last O(n) ABA engine (dynamics_aba.py)",
    "lanes": "the env-last dense engine (dynamics_lanes.py)",
    "vmap": "the dense engine (dynamics.py mass_matrix / bias_forces / forward_dynamics)",
}


class DynamicsEnv:
    """Vectorized forward-dynamics environment: N instances stepped in
    lockstep, DeepMimic PD actuation toward a target pose.

    dt is the 30 Hz control interval of the mocap clips; substeps at
    h = dt/substeps ~= the reference integrator timestep 0.002
    (dp_env_v2.xml:9). `layout` "auto" and "pallas" both mean the
    whole-control-step path (`dynamics_kernel.control_step`: the CUDA
    kernel for CUDA tensors, its plain version for CPU tensors); the JAX
    package's "aba", "lanes" and "vmap" engines are not ported and raise."""

    def __init__(self, dt: float = 1.0 / 30.0, substeps: int = 17,
                 kp_scale: float = 1.0, kd_scale: float = 1.0,
                 contacts: bool = True, limits: bool = True,
                 layout: str = "auto"):
        if layout in _UNPORTED_LAYOUTS:
            raise NotImplementedError(
                f"DynamicsEnv layout {layout!r} ({_UNPORTED_LAYOUTS[layout]}) is not ported "
                "yet (ROADMAP Queue A, the other dynamics engines); use layout='auto'")
        if layout not in ("auto", "pallas"):
            raise ValueError(layout)
        self.dt = dt
        self.substeps = substeps
        self.h = dt / substeps
        self.kp_scale = kp_scale
        self.kd_scale = kd_scale
        self.contacts = contacts
        self.limits = limits
        self.layout = "pallas"

    def kernel_args(self) -> dict:
        return dict(h=self.h, substeps=self.substeps, kp_scale=self.kp_scale,
                    kd_scale=self.kd_scale, contacts=self.contacts, limits=self.limits)

    def step(self, qpos: torch.Tensor, qvel: torch.Tensor, target_qpos: torch.Tensor):
        """(N, 35), (N, 34), (N, 35) -> stepped (qpos, qvel). PD torques are
        recomputed every substep against the fixed target."""
        from .dynamics_kernel import control_step

        return control_step(qpos, qvel, target_qpos, **self.kernel_args())
