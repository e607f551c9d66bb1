"""The port's mocap parsing and datasets against the JAX package's.

Both are numpy; the port keeps its own copies, so every comparison here is
array-equal (no tolerance).
"""
import os

import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.data import datasets as JD
from deepmimic_diffusion_mujoco_tpu.data import mocap as JM
from deepmimic_diffusion_mujoco_tpu_torch.data import datasets as TD
from deepmimic_diffusion_mujoco_tpu_torch.data import mocap as TM

torch.set_num_threads(2)

MOTIONS = os.path.join(os.path.dirname(__file__), "..", "data", "motions")
CLIPS = sorted(f for f in os.listdir(MOTIONS) if f.endswith(".txt"))


def test_all_nine_clips_are_present():
    assert len(CLIPS) == 9


@pytest.mark.parametrize("name", CLIPS)
def test_load_clip_array_equal(name):
    path = os.path.join(MOTIONS, name)
    ours, ref = TM.load_clip(path), JM.load_clip(path)
    assert ours.name == ref.name and ours.motion_class == ref.motion_class
    np.testing.assert_array_equal(ours.qpos, ref.qpos)
    np.testing.assert_array_equal(ours.qvel, ref.qvel)
    np.testing.assert_array_equal(ours.durations, ref.durations)


def _pair(path, **kw):
    return TD.MotionDataset.from_path(path, **kw), JD.MotionDataset.from_path(path, **kw)


def _assert_same(ours, ref):
    np.testing.assert_array_equal(ours.trajectories, ref.trajectories)
    np.testing.assert_array_equal(ours.motion_class, ref.motion_class)
    np.testing.assert_array_equal(ours.lengths, ref.lengths)
    assert (ours.horizon, ours.feature_dim) == (ref.horizon, ref.feature_dim)


@pytest.mark.parametrize("augment,include_velocity", [
    ("cyclic", False), ("cyclic_rooted", True), ("replicate", False), ("none", True)])
def test_motion_dataset_array_equal(augment, include_velocity):
    path = os.path.join(MOTIONS, "humanoid3d_cartwheel.txt")
    ours, ref = _pair(path, include_velocity=include_velocity, augment=augment,
                      replicas=7, horizon_multiple=8)
    _assert_same(ours, ref)
    if augment == "cyclic":
        assert ours.trajectories.shape == (160, 160, 35)  # the training slice's data


def test_multi_clip_padding_and_truncation_array_equal():
    ours, ref = _pair(MOTIONS, include_velocity=True, augment="cyclic_rooted",
                      horizon_multiple=8, max_files=3)
    _assert_same(ours, ref)
    _assert_same(ours.truncated(24), ref.truncated(24))
    b_ours, b_ref = ours.batch(np.array([0, 5, 270])), ref.batch(np.array([0, 5, 270]))
    for a, b in zip(b_ours, b_ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("class_balanced", [False, True])
def test_epochs_identical_batch_sequences(class_balanced):
    ours, ref = _pair(MOTIONS, include_velocity=False, augment="cyclic",
                      horizon_multiple=8, max_files=4)
    it_o = ours.epochs(16, seed=3, class_balanced=class_balanced)
    it_r = ref.epochs(16, seed=3, class_balanced=class_balanced)
    for _ in range(20):
        for a, b in zip(next(it_o), next(it_r)):
            np.testing.assert_array_equal(a, b)


def test_small_dataset_oversampling_matches():
    """A dataset smaller than the batch yields full batches with repeats."""
    path = os.path.join(MOTIONS, "humanoid3d_walk.txt")
    ours, ref = _pair(path, include_velocity=False, augment="none")
    assert len(ours) == 1
    it_o, it_r = ours.epochs(5, seed=1), ref.epochs(5, seed=1)
    for _ in range(3):
        b_o, b_r = next(it_o), next(it_r)
        assert b_o.trajectories.shape[0] == 5
        for a, b in zip(b_o, b_r):
            np.testing.assert_array_equal(a, b)
