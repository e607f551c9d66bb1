"""DeepMimic humanoid skeleton layout and trajectory feature contract.

The port's own copy of ``deepmimic_diffusion_mujoco_tpu/data/skeleton.py``:
joint ordering and the qpos/qvel index layout of the data pipeline.

Mirrors the reference constants (diffusion/utils/mocap_util.py:5-29) and the
README's documented feature indices (reference README.md:95): dims 13-15/17-19
are left/right-shoulder Euler triples and 16/20 the elbow scalars.
"""
from __future__ import annotations

from dataclasses import dataclass

# MuJoCo qpos joint order (after the free root): mocap_util.py:5-7
BODY_JOINTS = (
    "chest", "neck", "right_shoulder", "right_elbow",
    "left_shoulder", "left_elbow", "right_hip", "right_knee",
    "right_ankle", "left_hip", "left_knee", "left_ankle",
)

# Joint order inside DeepMimic mocap frames: mocap_util.py:9-11
BODY_JOINTS_IN_DP_ORDER = (
    "chest", "neck", "right_hip", "right_knee",
    "right_ankle", "right_shoulder", "right_elbow", "left_hip",
    "left_knee", "left_ankle", "left_shoulder", "left_elbow",
)

# Degrees of freedom per joint: mocap_util.py:13-16
DOF_DEF = {
    "root": 3, "chest": 3, "neck": 3, "right_shoulder": 3,
    "right_elbow": 1, "right_wrist": 0, "left_shoulder": 3, "left_elbow": 1,
    "left_wrist": 0, "right_hip": 3, "right_knee": 1, "right_ankle": 3,
    "left_hip": 3, "left_knee": 1, "left_ankle": 3,
}

BODY_DEFS = (
    "root", "chest", "neck", "right_hip", "right_knee",
    "right_ankle", "right_shoulder", "right_elbow", "right_wrist", "left_hip",
    "left_knee", "left_ankle", "left_shoulder", "left_elbow", "left_wrist",
)

# DeepMimic PD gains (kp, kd), legacy of the tracking controller
# (mocap_util.py:22-25); used by the physics env's PD actuation mode.
PARAMS_KP_KD = {
    "chest": (1000, 100), "neck": (100, 10), "right_shoulder": (400, 40),
    "right_elbow": (300, 30), "left_shoulder": (400, 40), "left_elbow": (300, 30),
    "right_hip": (500, 50), "right_knee": (500, 50), "right_ankle": (400, 40),
    "left_hip": (500, 50), "left_knee": (500, 50), "left_ankle": (400, 40),
}

# DeepMimic per-joint reward weights (mocap_util.py:26-29); used by the
# physics env's pose-tracking reward.
JOINT_WEIGHT = {
    "root": 1, "chest": 0.5, "neck": 0.3, "right_hip": 0.5,
    "right_knee": 0.3, "right_ankle": 0.2, "right_shoulder": 0.3,
    "right_elbow": 0.2, "right_wrist": 0.0, "left_hip": 0.5, "left_knee": 0.3,
    "left_ankle": 0.2, "left_shoulder": 0.3, "left_elbow": 0.2,
    "left_wrist": 0.0,
}

# qpos layout: 3 root pos + 4 root quat + per-joint Euler/scalar dims.
QPOS_ROOT_POS = slice(0, 3)
QPOS_ROOT_QUAT = slice(3, 7)


def _build_qpos_index():
    idx = {}
    off = 7
    for j in BODY_JOINTS:
        d = DOF_DEF[j]
        idx[j] = slice(off, off + d)
        off += d
    return idx, off


QPOS_JOINT_SLICES, QPOS_DIM = _build_qpos_index()  # QPOS_DIM == 35


def _build_qvel_index():
    idx = {"root_lin": slice(0, 3), "root_ang": slice(3, 6)}
    off = 6
    for j in BODY_JOINTS:
        d = DOF_DEF[j]
        idx[j] = slice(off, off + d)
        off += d
    return idx, off


QVEL_JOINT_SLICES, QVEL_DIM = _build_qvel_index()  # QVEL_DIM == 34

TRANSITION_DIM = QPOS_DIM + QVEL_DIM  # 69, the v2 (config || vel) layout

# Load-bearing conditioning indices (reference README.md:95,
# sampling_config.py:23-32): shoulders are Euler triples, elbows scalars.
RIGHT_SHOULDER_DIMS = QPOS_JOINT_SLICES["right_shoulder"]  # 13:16 in qpos order
RIGHT_ELBOW_DIM = QPOS_JOINT_SLICES["right_elbow"].start   # 16
LEFT_SHOULDER_DIMS = QPOS_JOINT_SLICES["left_shoulder"]    # 17:20
LEFT_ELBOW_DIM = QPOS_JOINT_SLICES["left_elbow"].start     # 20

# Class labels for the 9 clips (motion_dataset_v2.py:11-21).
MOTION_CLASSES = {
    "humanoid3d_walk": 0,
    "humanoid3d_run": 1,
    "humanoid3d_spinkick": 2,
    "humanoid3d_roll": 3,
    "humanoid3d_dance_a": 4,
    "humanoid3d_dance_b": 5,
    "humanoid3d_jump": 6,
    "humanoid3d_cartwheel": 7,
    "humanoid3d_backflip": 8,
}
NUM_MOTION_CLASSES = 9


@dataclass(frozen=True)
class FeatureLayout:
    """Describes which features a trajectory tensor carries."""

    include_velocity: bool = False

    @property
    def dim(self) -> int:
        return TRANSITION_DIM if self.include_velocity else QPOS_DIM

    @property
    def qpos(self) -> slice:
        return slice(0, QPOS_DIM)

    @property
    def qvel(self) -> slice:
        if not self.include_velocity:
            raise ValueError("layout has no velocity features")
        return slice(QPOS_DIM, TRANSITION_DIM)
