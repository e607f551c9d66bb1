"""DeepMimic mocap clips -> (qpos, qvel) trajectory arrays.

Functional, vectorized rewrite of the reference `MocapDM`
(diffusion/utils/mocap_v2.py:31-347). Produces numerically identical
`qpos` (35,) / `qvel` (34,) frames:

- root pos/rot coordinate-aligned from Y-up (DeepMimic) to Z-up (MuJoCo),
- joints reordered from DP order to MuJoCo order,
- 3-DOF joint quaternions converted to intrinsic-xyz Euler triples,
- velocities by finite differences; angular velocities via the quaternion
  axis-angle log (first frame's velocity is zero).

The port's own copy of ``deepmimic_diffusion_mujoco_tpu/data/mocap.py``;
the parse is pure numpy on the host and runs once per clip.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from ..utils import rotations as rot
from .skeleton import (
    BODY_JOINTS,
    BODY_JOINTS_IN_DP_ORDER,
    DOF_DEF,
    MOTION_CLASSES,
    QPOS_DIM,
    QVEL_DIM,
)

# Inside a DP frame: [dt, root_pos(3), root_quat(4), joints in DP order
# (4 floats per 3-DOF joint stored as wxyz quaternion, 1 float per hinge)].
_DP_FRAME_DIM = 1 + 3 + 4 + sum(4 if DOF_DEF[j] == 3 else 1 for j in BODY_JOINTS_IN_DP_ORDER)


def _dp_joint_offsets():
    """Start offset of each joint's block inside a raw DP frame."""
    off = 8
    table = {}
    for j in BODY_JOINTS_IN_DP_ORDER:
        width = 4 if DOF_DEF[j] == 3 else 1
        table[j] = (off, width)
        off += width
    return table


_DP_OFFSETS = _dp_joint_offsets()


@dataclass
class MocapClip:
    """A parsed DeepMimic clip in MuJoCo coordinates."""

    name: str
    qpos: np.ndarray          # (T, 35) float64
    qvel: np.ndarray          # (T, 34) float64
    durations: np.ndarray     # (T,) per-frame dt (source values)
    loop: str = "wrap"
    # Aligned intermediate representation (handy for FK/physics):
    root_pos: np.ndarray = field(default=None, repr=False)    # (T, 3)
    root_quat: np.ndarray = field(default=None, repr=False)   # (T, 4) wxyz
    joint_quats: dict = field(default=None, repr=False)       # name -> (T,4)|(T,1)

    @property
    def num_frames(self) -> int:
        return self.qpos.shape[0]

    @property
    def dt(self) -> float:
        return float(self.durations[0])

    @property
    def motion_class(self) -> int:
        return MOTION_CLASSES[self.name]

    def combined(self) -> np.ndarray:
        """(T, 69) qpos || qvel, the v2 feature layout."""
        return np.concatenate([self.qpos, self.qvel], axis=1)


def _effective_durations(durations: np.ndarray) -> np.ndarray:
    """Per-frame dt used for velocity finite differences.

    Frame k uses durations[k-1] (and frame 0 uses durations[0]); zero
    durations fall back to ~60 fps (mocap_v2.py:200-208).
    """
    dura = np.concatenate([durations[:1], durations[:-1]])
    return np.where(dura == 0.0, 0.0167, dura)


def parse_frames(frames: np.ndarray, name: str = "clip", loop: str = "wrap") -> MocapClip:
    """Convert raw DeepMimic frames (T, 44) into a :class:`MocapClip`."""
    frames = np.asarray(frames, dtype=np.float64)
    if frames.ndim != 2 or frames.shape[1] != _DP_FRAME_DIM:
        raise ValueError(
            f"expected (T, {_DP_FRAME_DIM}) DeepMimic frames, got {frames.shape}"
        )
    T = frames.shape[0]
    durations = frames[:, 0].copy()
    dura = _effective_durations(durations)

    root_pos = rot.align_position(frames[:, 1:4])           # (T, 3)
    root_quat = rot.align_rotation(frames[:, 4:8])          # (T, 4)

    joint_quats = {}
    for j in BODY_JOINTS:
        off, width = _DP_OFFSETS[j]
        block = frames[:, off : off + width]
        joint_quats[j] = rot.align_rotation(block) if width == 4 else block.copy()

    # qpos: root pos, root quat, then per-joint Euler (rxyz) or scalar.
    qpos_parts = [root_pos, root_quat]
    for j in BODY_JOINTS:
        q = joint_quats[j]
        qpos_parts.append(rot.euler_rxyz_from_quat(q) if q.shape[1] == 4 else q)
    qpos = np.concatenate(qpos_parts, axis=1)
    assert qpos.shape == (T, QPOS_DIM)

    # qvel: finite differences; angular velocity from quaternion difference.
    inv_dt = 1.0 / dura[1:]

    def lin_vel(x):
        v = np.zeros_like(x)
        v[1:] = (x[1:] - x[:-1]) * inv_dt[:, None]
        return v

    def ang_vel(q):
        v = np.zeros((T, 3))
        v[1:] = rot.quat_angular_velocity(q[1:], q[:-1], dura[1:])
        return v

    qvel_parts = [lin_vel(root_pos), ang_vel(root_quat)]
    for j in BODY_JOINTS:
        q = joint_quats[j]
        qvel_parts.append(ang_vel(q) if q.shape[1] == 4 else lin_vel(q))
    qvel = np.concatenate(qvel_parts, axis=1)
    assert qvel.shape == (T, QVEL_DIM)

    return MocapClip(
        name=name, qpos=qpos, qvel=qvel, durations=durations, loop=loop,
        root_pos=root_pos, root_quat=root_quat, joint_quats=joint_quats,
    )


def load_clip(filepath: str) -> MocapClip:
    """Load a DeepMimic JSON mocap file (e.g. humanoid3d_walk.txt)."""
    with open(filepath) as f:
        raw = json.load(f)
    name = os.path.splitext(os.path.basename(filepath))[0]
    return parse_frames(
        np.array(raw["Frames"], dtype=np.float64),
        name=name,
        loop=raw.get("Loop", "wrap"),
    )


def qpos_to_dp_frame(qpos: np.ndarray, dt: float) -> np.ndarray:
    """Inverse mapping: (T, 35) qpos -> raw DeepMimic frames (T, 44).

    Mirrors `MocapDM.extract_original_config_from_qna`'s inverse intent
    (mocap_v2.py:394-470): Euler triples -> quaternions, un-align back to
    Y-up, joints back to DP order.
    """
    qpos = np.atleast_2d(np.asarray(qpos, dtype=np.float64))
    T = qpos.shape[0]
    # Un-align: conjugate by the inverse alignment quaternions.
    inv_l, inv_r = rot.ALIGN_RIGHT, rot.ALIGN_LEFT  # inverses of left/right
    # inverse of align_position (x,y,z)->(x,-z,y) is (a,b,c)->(a,c,-b)
    root_pos_yup = np.stack([qpos[:, 0], qpos[:, 2], -qpos[:, 1]], axis=-1)
    root_quat_yup = rot.quat_mul(rot.quat_mul(inv_l, qpos[:, 3:7]), inv_r)

    out = np.zeros((T, _DP_FRAME_DIM))
    out[:, 0] = dt
    out[:, 1:4] = root_pos_yup
    out[:, 4:8] = root_quat_yup
    # qpos joint slices in MuJoCo order:
    off = 7
    mj_blocks = {}
    for j in BODY_JOINTS:
        d = DOF_DEF[j]
        mj_blocks[j] = qpos[:, off : off + d]
        off += d
    for j in BODY_JOINTS_IN_DP_ORDER:
        dp_off, width = _DP_OFFSETS[j]
        if width == 4:
            q = rot.quat_from_euler_rxyz(mj_blocks[j])
            q_yup = rot.quat_mul(rot.quat_mul(inv_l, q), inv_r)
            out[:, dp_off : dp_off + 4] = q_yup
        else:
            out[:, dp_off : dp_off + 1] = mj_blocks[j]
    return out
