"""Rotation math for the mocap pipeline (host-side, numpy float64).

The port's own copy of ``deepmimic_diffusion_mujoco_tpu/utils/rotations.py``
(the port imports nothing of the JAX package); the two must give
array-equal results (``tests/test_torch_data.py``). All quaternions are
scalar-first ``(w, x, y, z)`` unless a function name says otherwise.

Reference behaviors reproduced (the original torch repository):
- coordinate alignment Y-up -> Z-up by quaternion conjugation
  (diffusion/utils/mocap_util.py:31-48),
- intrinsic-xyz ("rxyz") Euler extraction, matching the vendored Gohlke
  `euler_from_quaternion(q_xyzw, axes="rxyz")`
  (diffusion/utils/transformations.py:1089, used at diffusion/utils/mocap_v2.py:286),
- pyquaternion-style axis/angle used for angular velocities
  (diffusion/utils/mocap_v2.py:155-178): angle = wrap(2*acos(w)) into (-pi, pi].

All functions are vectorized over leading batch dimensions.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Core quaternion ops (w, x, y, z)
# ---------------------------------------------------------------------------


def quat_mul(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Hamilton product q1 * q2, scalar-first, broadcasting over batch dims."""
    q1 = np.asarray(q1, dtype=np.float64)
    q2 = np.asarray(q2, dtype=np.float64)
    w1, x1, y1, z1 = np.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(q2, -1, 0)
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_conjugate(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, dtype=np.float64)
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def quat_normalize(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, dtype=np.float64)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def quat_to_mat(q: np.ndarray) -> np.ndarray:
    """Rotation matrix from unit quaternion; shape (..., 3, 3)."""
    q = quat_normalize(q)
    w, x, y, z = np.moveaxis(q, -1, 0)
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = np.stack(
        [
            ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz,
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_from_axis_angle(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    half = 0.5 * np.asarray(angle, dtype=np.float64)
    return np.concatenate(
        [np.cos(half)[..., None], np.sin(half)[..., None] * axis], axis=-1
    )


def wrap_angle(theta: np.ndarray) -> np.ndarray:
    """Wrap angles into (-pi, pi] (pyquaternion `_wrap_angle` convention)."""
    theta = np.asarray(theta, dtype=np.float64)
    out = (-theta + np.pi) % (2.0 * np.pi)
    return -(out - np.pi)


def quat_axis_angle(q: np.ndarray, atol: float = 1e-12):
    """(axis, angle) with pyquaternion semantics.

    angle = wrap(2*acos(w_normalized)) into (-pi, pi]; axis is the unit
    imaginary part, or zeros for (near-)identity rotations.
    """
    q = quat_normalize(q)
    w = np.clip(q[..., 0], -1.0, 1.0)
    angle = wrap_angle(2.0 * np.arccos(w))
    v = q[..., 1:]
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    axis = np.where(n > atol, v / np.where(n > atol, n, 1.0), np.zeros_like(v))
    return axis, angle


def quat_angular_velocity(q0: np.ndarray, q1: np.ndarray, dt) -> np.ndarray:
    """Angular velocity taking q0 to q1 over dt.

    Matches MocapDM.calc_rot_vel (diffusion/utils/mocap_v2.py:155-178):
    q_diff = conj(q0) * q1; omega = angle/dt * axis.
    """
    q_diff = quat_mul(quat_conjugate(q0), q1)
    axis, angle = quat_axis_angle(q_diff)
    dt = np.asarray(dt, dtype=np.float64)
    return (angle / dt)[..., None] * axis


# ---------------------------------------------------------------------------
# Euler conversions, intrinsic xyz ("rxyz"): R = Rx(a) @ Ry(b) @ Rz(c)
# ---------------------------------------------------------------------------


def euler_rxyz_from_quat(q: np.ndarray) -> np.ndarray:
    """Intrinsic-xyz Euler angles (a, b, c) such that R(q) = Rx(a)Ry(b)Rz(c).

    Principal solution: b in [-pi/2, pi/2]; a, c in (-pi, pi]. Equals the
    vendored Gohlke `euler_from_quaternion([x,y,z,w], axes="rxyz")`.
    """
    m = quat_to_mat(q)
    # R = Rx Ry Rz =>
    # [ cb*cc,            -cb*sc,             sb    ]
    # [ ca*sc+sa*sb*cc,    ca*cc-sa*sb*sc,   -sa*cb ]
    # [ sa*sc-ca*sb*cc,    sa*cc+ca*sb*sc,    ca*cb ]
    r00, r01, r02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    r12, r22 = m[..., 1, 2], m[..., 2, 2]
    r10, r11 = m[..., 1, 0], m[..., 1, 1]
    cb = np.sqrt(r00 * r00 + r01 * r01)
    eps = 1e-12
    degenerate = cb < eps
    # Degenerate (|b| = pi/2) solution matches Gohlke: a = 0, angle folded
    # into c, so parity with the reference's Euler frames holds exactly.
    a = np.where(degenerate, 0.0, np.arctan2(-r12, r22))
    b = np.arctan2(r02, cb)
    c = np.where(degenerate, np.arctan2(r10, r11), np.arctan2(-r01, r00))
    return np.stack([a, b, c], axis=-1)


def quat_from_euler_rxyz(euler: np.ndarray) -> np.ndarray:
    """Inverse of :func:`euler_rxyz_from_quat`: q(Rx(a)) * q(Ry(b)) * q(Rz(c))."""
    euler = np.asarray(euler, dtype=np.float64)
    a, b, c = euler[..., 0], euler[..., 1], euler[..., 2]
    z = np.zeros_like(a)
    qx = np.stack([np.cos(a / 2), np.sin(a / 2), z, z], axis=-1)
    qy = np.stack([np.cos(b / 2), z, np.sin(b / 2), z], axis=-1)
    qz = np.stack([np.cos(c / 2), z, z, np.sin(c / 2)], axis=-1)
    return quat_mul(quat_mul(qx, qy), qz)


# ---------------------------------------------------------------------------
# DeepMimic Y-up -> MuJoCo Z-up alignment
# ---------------------------------------------------------------------------

# Rotation by +90deg about x (maps Y-up world into Z-up world); its inverse is
# the -90deg rotation. align_rotation conjugates: q' = q_left * q * q_right
# with q_left = Rx(+90), q_right = Rx(-90) (mocap_util.py:31-41).
_SQ2 = np.sqrt(0.5)
ALIGN_LEFT = np.array([_SQ2, _SQ2, 0.0, 0.0])    # Rx(+90deg)
ALIGN_RIGHT = np.array([_SQ2, -_SQ2, 0.0, 0.0])  # Rx(-90deg)


def align_rotation(q: np.ndarray) -> np.ndarray:
    """Conjugate a Y-up quaternion into the Z-up frame (wxyz in/out)."""
    return quat_mul(quat_mul(ALIGN_LEFT, q), ALIGN_RIGHT)


def align_position(pos: np.ndarray) -> np.ndarray:
    """(x, y, z)_Yup -> (x, -z, y)_Zup (mocap_util.py:42-48)."""
    pos = np.asarray(pos, dtype=np.float64)
    return np.stack([pos[..., 0], -pos[..., 2], pos[..., 1]], axis=-1)
