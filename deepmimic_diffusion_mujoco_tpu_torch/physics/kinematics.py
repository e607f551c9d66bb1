"""Batched forward kinematics for the DeepMimic humanoid on torch tensors.

The port of ``deepmimic_diffusion_mujoco_tpu/physics/kinematics.py``: the
tree is static and tiny (13 bodies), so FK is an unrolled sequence of
quaternion ops over any leading batch shape.

Conventions: quaternions are wxyz (MuJoCo order). A hinge with anchor `p`
and axis `a` contributes the local transform T(p) R(a, theta) T(-p);
multiple hinges in one body compose in declaration order (matching
mj_kinematics' sequential joint application).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..data.skeleton import QPOS_JOINT_SLICES
from .humanoid_model import BODIES, BODY_INDEX, END_EFFECTOR_BODIES, TOTAL_MASS


def quat_mul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = q.unbind(-1)
    w2, x2, y2, z2 = r.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q (wxyz)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    half = angle * 0.5
    return torch.cat([torch.cos(half)[..., None], torch.sin(half)[..., None] * axis], dim=-1)


class FKResult(NamedTuple):
    body_pos: torch.Tensor       # (..., n_bodies, 3) world positions
    body_quat: torch.Tensor      # (..., n_bodies, 4) world orientations
    com: torch.Tensor            # (..., 3) whole-body center of mass
    end_effectors: torch.Tensor  # (..., 4, 3) wrists + feet world positions


def _static_tables():
    geom_mass, geom_com, geom_body = [], [], []
    for b in BODIES:
        for g in b.geoms:
            geom_mass.append(g.mass)
            geom_com.append(g.com)
            geom_body.append(BODY_INDEX[b.name])
    return (np.asarray(geom_mass, np.float32), np.asarray(geom_com, np.float32),
            np.asarray(geom_body, np.int64))


_GMASS, _GCOM, _GBODY = _static_tables()
_EE_IDX = np.asarray([BODY_INDEX[n] for n in END_EFFECTOR_BODIES], np.int64)
_EE_PTS = np.asarray(
    [BODIES[BODY_INDEX[n]].end_effector for n in END_EFFECTOR_BODIES], np.float32
)


def _const(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=like.dtype, device=like.device)


def forward_kinematics(qpos: torch.Tensor) -> FKResult:
    """qpos (..., 35) -> world-frame body poses, COM, end-effectors."""
    root_pos = qpos[..., 0:3]
    root_quat = qpos[..., 3:7]
    root_quat = root_quat / torch.linalg.vector_norm(root_quat, dim=-1, keepdim=True)

    pos = [None] * len(BODIES)
    quat = [None] * len(BODIES)
    pos[0] = root_pos
    quat[0] = root_quat

    for bi, b in enumerate(BODIES[1:], start=1):
        angles = qpos[..., QPOS_JOINT_SLICES[b.name]]
        # fold the body's hinges in declaration order:
        # M = prod_i T(p_i) R_i T(-p_i) -> (q_local, t_local)
        q_local = _const([1.0, 0.0, 0.0, 0.0], qpos).expand(root_quat.shape)
        t_local = torch.zeros_like(root_pos)
        for k, hinge in enumerate(b.joints):
            axis = _const(hinge.axis, qpos)
            anchor = _const(hinge.pos, qpos)
            qk = quat_from_axis_angle(axis, angles[..., k])
            tk = anchor - quat_rotate(qk, anchor)
            t_local = t_local + quat_rotate(q_local, tk)
            q_local = quat_mul(q_local, qk)

        parent = BODY_INDEX[b.parent]
        offset = _const(b.offset, qpos)
        pos[bi] = pos[parent] + quat_rotate(quat[parent], offset + t_local)
        quat[bi] = quat_mul(quat[parent], q_local)

    body_pos = torch.stack(pos, dim=-2)
    body_quat = torch.stack(quat, dim=-2)

    gpos = body_pos[..., _GBODY, :] + quat_rotate(body_quat[..., _GBODY, :], _const(_GCOM, qpos))
    com = (gpos * _const(_GMASS, qpos)[:, None]).sum(-2) / TOTAL_MASS

    ee = body_pos[..., _EE_IDX, :] + quat_rotate(body_quat[..., _EE_IDX, :],
                                                 _const(_EE_PTS, qpos))
    return FKResult(body_pos, body_quat, com, ee)


forward_kinematics_batch = forward_kinematics


def quat_from_euler_rxyz(euler: torch.Tensor) -> torch.Tensor:
    """Intrinsic-xyz Euler triple -> wxyz quaternion (the mocap joint
    convention, utils/rotations.py host-side twin)."""
    ex = quat_from_axis_angle(_const([1.0, 0, 0], euler), euler[..., 0])
    ey = quat_from_axis_angle(_const([0, 1.0, 0], euler), euler[..., 1])
    ez = quat_from_axis_angle(_const([0, 0, 1.0], euler), euler[..., 2])
    return quat_mul(ex, quat_mul(ey, ez))


def quat_geodesic_angle(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Angle of the relative rotation between two quaternions."""
    dot = torch.clamp(torch.abs((q1 * q2).sum(-1)), 0.0, 1.0)
    return 2.0 * torch.arccos(dot)
