"""Trajectory datasets: windowing, cyclic augmentation, batching.

Counterpart of ``deepmimic_diffusion_mujoco_tpu/data/datasets.py``, numpy
only: the same seed gives the same batch sequence as the JAX package.

- v1 (single clip, qpos only, (T, 35)): horizon truncated to a multiple of
  8 (the temporal U-Net downsamples 3x), augmented with all T cyclic
  rotations;
- v2 (qpos||qvel, (T, 69), per-clip class labels): ``cyclic_rooted``
  rotations with a root-xyz continuity fix-up, or the clip replicated
  ``replicas`` times. Clips of different lengths become zero-padded arrays
  with a validity mask.

Batches stay numpy on the host; the training loop copies each one to the
device (``train/loop.py``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from .mocap import MocapClip, load_clip


class Batch(NamedTuple):
    """One batch. ``mask`` is 1.0 on valid frames, 0.0 on padding."""

    trajectories: np.ndarray   # (B, H, D)
    motion_class: np.ndarray   # (B,) int32
    mask: np.ndarray           # (B, H) float32
    cond_frame: np.ndarray     # (B, D) frame-0 conditioning (v1 contract)


def truncate_to_multiple(x: np.ndarray, k: int = 8) -> np.ndarray:
    """Drop trailing frames so T % k == 0."""
    t = x.shape[0] - (x.shape[0] % k)
    return x[:t]


def cyclic_rotations(x: np.ndarray) -> np.ndarray:
    """All T rotations concat(x[i:], x[:i])."""
    T = x.shape[0]
    idx = (np.arange(T)[:, None] + np.arange(T)[None, :]) % T
    return x[idx]


def cyclic_rotations_rooted(x: np.ndarray) -> np.ndarray:
    """Cyclic rotations with root-xyz continuity fix-up: the wrapped suffix
    is shifted by the clip's net root displacement, then both halves are
    re-anchored so the rotated motion starts at the clip's original root
    position. Rotations i == 0 and i == T-1 are left untouched (a quirk of
    the original dataset, kept for parity)."""
    T = x.shape[0]
    diff3 = x[-1, :3] - x[0, :3]
    out = np.empty((T,) + x.shape, dtype=x.dtype)
    for i in range(T):
        prefix = x[i:].copy()
        suffix = x[:i].copy()
        if i != 0 and i != T - 1:
            suffix[:, :3] += diff3
            first_diff3 = prefix[0, :3] - x[0, :3]
            prefix[:, :3] -= first_diff3
            suffix[:, :3] -= first_diff3
        out[i] = np.concatenate([prefix, suffix], axis=0)
    return out


def flattened_normalized(qpos: np.ndarray, frames: int = 80):
    """Stack-C preprocessing: min-max normalize to [0, 1] and flatten
    (frames, 35) -> (1, frames*35, 1) for a 1-channel 1-D diffusion.
    Returns (flat, (min_val, max_val))."""
    x = np.asarray(qpos[:frames], np.float32)
    lo, hi = float(x.min()), float(x.max())
    norm = (x - lo) / (hi - lo)
    return norm.reshape(1, -1, 1), (lo, hi)


def unflatten_denormalized(flat: np.ndarray, bounds: tuple[float, float],
                           feature_dim: int = 35) -> np.ndarray:
    """Inverse of :func:`flattened_normalized`."""
    lo, hi = bounds
    x = np.asarray(flat).reshape(-1, feature_dim)
    return x * (hi - lo) + lo


@dataclass
class MotionDataset:
    """In-memory trajectory dataset over one or more mocap clips."""

    trajectories: np.ndarray     # (N, H, D) float32, zero-padded
    motion_class: np.ndarray     # (N,) int32
    lengths: np.ndarray          # (N,) int32 valid frame counts
    horizon: int
    feature_dim: int

    @classmethod
    def from_clips(
        cls,
        clips: list[MocapClip],
        include_velocity: bool = True,
        augment: str = "cyclic_rooted",  # "cyclic" | "cyclic_rooted" | "replicate" | "none"
        replicas: int = 1000,
        horizon_multiple: int = 1,
        pad_to: int | None = None,
        frames_limit: int | None = None,
    ) -> "MotionDataset":
        trajs, labels, lengths = [], [], []
        for clip in clips:
            x = clip.combined() if include_velocity else clip.qpos
            if frames_limit is not None:
                x = x[:frames_limit]
            x = truncate_to_multiple(x, horizon_multiple) if horizon_multiple > 1 else x
            if augment == "cyclic":
                variants = cyclic_rotations(x)
            elif augment == "cyclic_rooted":
                variants = cyclic_rotations_rooted(x)
            elif augment == "replicate":
                variants = np.broadcast_to(x, (replicas,) + x.shape)
            elif augment == "none":
                variants = x[None]
            else:
                raise ValueError(f"unknown augment mode {augment!r}")
            trajs.append(np.asarray(variants, dtype=np.float32))
            labels.extend([clip.motion_class] * len(variants))
            lengths.extend([x.shape[0]] * len(variants))

        H = pad_to if pad_to is not None else max(t.shape[1] for t in trajs)
        D = trajs[0].shape[2]
        N = sum(t.shape[0] for t in trajs)
        stacked = np.zeros((N, H, D), dtype=np.float32)
        off = 0
        for t in trajs:
            stacked[off : off + t.shape[0], : t.shape[1]] = t[:, :H]
            off += t.shape[0]
        return cls(
            trajectories=stacked,
            motion_class=np.asarray(labels, dtype=np.int32),
            lengths=np.asarray(lengths, dtype=np.int32),
            horizon=H,
            feature_dim=D,
        )

    @classmethod
    def from_path(cls, path: str, max_files: int | None = None, **kw) -> "MotionDataset":
        """Load a single .txt clip or every clip in a directory."""
        if os.path.isdir(path):
            files = sorted(
                os.path.join(path, f) for f in os.listdir(path) if f.endswith(".txt")
            )
            if max_files is not None:
                files = files[:max_files]
        else:
            files = [path]
        return cls.from_clips([load_clip(f) for f in files], **kw)

    def truncated(self, horizon: int) -> "MotionDataset":
        """Clamp every trajectory to ``horizon`` frames."""
        if horizon >= self.horizon:
            return self
        return MotionDataset(
            trajectories=self.trajectories[:, :horizon],
            motion_class=self.motion_class,
            lengths=np.minimum(self.lengths, horizon),
            horizon=horizon,
            feature_dim=self.feature_dim,
        )

    def __len__(self) -> int:
        return self.trajectories.shape[0]

    @property
    def max_sequence_length(self) -> int:
        return int(self.lengths.max())

    def mask(self) -> np.ndarray:
        """(N, H) float32: 1.0 on each trajectory's valid frames."""
        return (
            np.arange(self.horizon)[None, :] < self.lengths[:, None]
        ).astype(np.float32)

    def batch(self, indices: np.ndarray) -> Batch:
        traj = self.trajectories[indices]
        return Batch(
            trajectories=traj,
            motion_class=self.motion_class[indices],
            mask=(
                np.arange(self.horizon)[None, :] < self.lengths[indices][:, None]
            ).astype(np.float32),
            cond_frame=traj[:, 0],
        )

    def epochs(self, batch_size: int, seed: int = 0, shuffle: bool = True,
               class_balanced: bool = False):
        """Infinite batch iterator.

        A dataset smaller than the batch is oversampled to a full batch (an
        epoch's order is several concatenated permutations), so every batch
        has ``batch_size`` rows.

        ``class_balanced=True`` draws each row's class uniformly, then a
        random item of that class (cyclic augmentation otherwise weights
        classes by clip length).
        """
        rng = np.random.default_rng(seed)
        n = len(self)
        if class_balanced:
            classes = np.unique(self.motion_class)
            by_class = [np.where(self.motion_class == c)[0] for c in classes]
            while True:
                cls = rng.integers(0, len(classes), size=batch_size)
                idx = np.array([
                    by_class[c][rng.integers(len(by_class[c]))] for c in cls
                ])
                yield self.batch(idx)
        reps = max(1, -(-batch_size // n))  # ceil
        while True:
            order = np.concatenate([
                rng.permutation(n) if shuffle else np.arange(n)
                for _ in range(reps)
            ])
            for i in range(0, order.size - batch_size + 1, batch_size):
                yield self.batch(order[i : i + batch_size])
