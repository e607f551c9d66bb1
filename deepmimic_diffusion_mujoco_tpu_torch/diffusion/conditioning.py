"""Constraint injection ("apply_conditioning") as composable functions.

Counterpart of ``deepmimic_diffusion_mujoco_tpu/diffusion/conditioning.py``.
A conditioner maps trajectories (B, H, D) -> (B, H, D) and is applied after
initialization and after every denoise step. Every concrete conditioner is
one masked select,

    x <- x * (1 - mask) + values * mask,

with (mask, values) built once in numpy and held on the device as tensors
that broadcast against (B, H, D). ``chain(c1, c2)`` applies conditioners in
order, which matches sequential in-place overwrites.

Under sequence-sharded sampling a rank holds frames [lo, hi) of the
horizon: ``for_frames(cond, lo, hi, horizon)`` is the conditioner of those
frames alone (masks and values sliced to them; ``clamp_frame0`` only on the
rank holding frame 0), so every clamped frame stays exact under the split.
Each conditioner here carries its per-frame form; a callable that does not
is refused there.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..device import resolve_device

Conditioner = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    """The default: conditioning disabled."""
    return x


identity.frames = lambda lo, hi, horizon: identity


def for_frames(cond: Conditioner | None, lo: int, hi: int, horizon: int):
    """The conditioner of frames [lo, hi) of a ``horizon``-frame trajectory,
    acting on (B, hi - lo, D) tensors as ``cond`` acts on those frames of the
    whole. None stays None; a callable without a per-frame form raises."""
    if cond is None:
        return None
    frames = getattr(cond, "frames", None)
    if frames is None:
        raise ValueError(f"conditioner {cond!r} has no per-frame form, so it cannot run on a "
                         "horizon split over ranks: build it from conditioning's functions")
    return frames(lo, hi, horizon)


def _frame_slice(a: np.ndarray, lo: int, hi: int, horizon: int) -> np.ndarray:
    """Frames [lo, hi) of an array broadcasting against (B, horizon, D)."""
    if a.ndim < 2 or a.shape[-2] == 1:
        return a
    if a.shape[-2] != horizon:
        raise ValueError(f"a conditioner of {a.shape[-2]} frames on a {horizon}-frame horizon")
    return a[..., lo:hi, :]


def masked_overwrite(mask, values, device: str | torch.device = "cuda") -> Conditioner:
    """Generic conditioner: overwrite where mask == 1 (mask and values
    broadcast against (B, H, D))."""
    dev = resolve_device(device)
    mask_np = np.asarray(mask, np.float32)
    values_np = np.asarray(values, np.float32)
    mask = torch.as_tensor(mask_np, device=dev)
    values = torch.as_tensor(values_np, device=dev)

    def fn(x: torch.Tensor) -> torch.Tensor:
        return x * (1.0 - mask) + values * mask

    fn.frames = lambda lo, hi, horizon: masked_overwrite(
        _frame_slice(mask_np, lo, hi, horizon), _frame_slice(values_np, lo, hi, horizon), dev)
    return fn


def chain(*conditioners: Conditioner) -> Conditioner:
    """Apply conditioners left-to-right (sequential overwrite semantics)."""

    def fn(x: torch.Tensor) -> torch.Tensor:
        for c in conditioners:
            x = c(x)
        return x

    fn.frames = lambda lo, hi, horizon: chain(
        *(for_frames(c, lo, hi, horizon) for c in conditioners))
    return fn


def clamp_dims(dim_values: dict[int, float], feature_dim: int,
               device: str | torch.device = "cuda") -> Conditioner:
    """Motion editing: hold given feature dims at fixed values on every frame."""
    mask = np.zeros((feature_dim,), np.float32)
    vals = np.zeros((feature_dim,), np.float32)
    for d, v in dim_values.items():
        mask[d] = 1.0
        vals[d] = v
    return masked_overwrite(mask[None, None, :], vals[None, None, :], device)


def holding_box(feature_dim: int = 35, device: str | torch.device = "cuda") -> Conditioner:
    """The "holding a box" pose: shoulder triples (13-15, 17-19) zeroed,
    elbows (16, 20) at 1.57 rad (~90 degrees)."""
    pose = {d: 0.0 for d in (13, 14, 15, 17, 18, 19)}
    pose[16] = 1.57
    pose[20] = 1.57
    return clamp_dims(pose, feature_dim, device)


def clamp_frame0(frame0, device: str | torch.device = "cuda") -> Conditioner:
    """Pin frame 0 of each trajectory to ``frame0`` (B, D'), D' <= D."""
    frame0 = torch.as_tensor(np.asarray(frame0, np.float32), device=resolve_device(device))
    D = frame0.shape[1]

    def fn(x: torch.Tensor) -> torch.Tensor:
        x = x.clone()
        x[:, 0, :D] = frame0.to(x.dtype)
        return x

    fn.frames = lambda lo, hi, horizon: fn if lo == 0 else identity
    return fn


def clamp_frames(
    reference,
    frames: Sequence[int] | np.ndarray,
    dims: slice | Sequence[int] = slice(None),
    horizon: int | None = None,
    device: str | torch.device = "cuda",
) -> Conditioner:
    """Clamp the given frames (optionally only some feature dims) to a
    reference motion (H, D) or (B, H, D): keyframes, inbetweening windows,
    blending seams."""
    ref = np.asarray(reference, np.float32)
    if ref.ndim == 2:
        ref = ref[None]
    H, D = ref.shape[1], ref.shape[2]
    if horizon is None:
        horizon = H
    frame_mask = np.zeros((horizon,), np.float32)
    frame_mask[np.asarray(frames, np.int64)] = 1.0
    dim_mask = np.zeros((D,), np.float32)
    dim_mask[np.arange(D)[dims] if isinstance(dims, slice) else np.asarray(dims)] = 1.0
    mask = frame_mask[None, :, None] * dim_mask[None, None, :]
    values = np.zeros((ref.shape[0], horizon, D), np.float32)
    values[:, :H] = ref
    return masked_overwrite(mask, values, device)


def inbetween(start_clip, end_clip, horizon: int, edge: int,
              device: str | torch.device = "cuda") -> Conditioner:
    """Clamp the first ``edge`` frames to start_clip and the last ``edge``
    frames to end_clip, leaving the middle free for the model to fill."""
    start = np.asarray(start_clip, np.float32)
    end = np.asarray(end_clip, np.float32)
    D = start.shape[-1]
    ref = np.zeros((horizon, D), np.float32)
    ref[:edge] = start[:edge]
    ref[-edge:] = end[-edge:]
    frames = list(range(edge)) + list(range(horizon - edge, horizon))
    return clamp_frames(ref, frames, horizon=horizon, device=device)


def blend(
    first_clip: np.ndarray,
    second_clip: np.ndarray,
    seam_halfwidth: int = 5,
    root_continuity: bool = True,
    free_dims_second: slice = slice(3, 35),
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, Conditioner]:
    """Blend two clips. Returns (starting_motion, conditioner):

    - starting_motion = concat(first, second shifted for root continuity),
    - the conditioner clamps everything except +/- seam_halfwidth frames at
      the seam; the second half is clamped only on ``free_dims_second``.
    """
    a = np.asarray(first_clip, np.float32)
    b = np.asarray(second_clip, np.float32).copy()
    if root_continuity:
        b[:, :3] += a[-1, :3] - b[0, :3]
    start_motion = np.concatenate([a, b], axis=0)
    H, D = start_motion.shape
    seam = a.shape[0]
    lo, hi = seam - seam_halfwidth, seam + seam_halfwidth

    mask = np.zeros((1, H, D), np.float32)
    mask[:, :lo, :] = 1.0
    dim_mask = np.zeros((D,), np.float32)
    dim_mask[free_dims_second] = 1.0
    mask[:, hi:, :] = dim_mask[None, None, :]
    return start_motion, masked_overwrite(mask, start_motion[None], device)


def steer_root(
    path_xy: np.ndarray,
    horizon: int,
    feature_dim: int,
    frames: Sequence[int] | None = None,
    device: str | torch.device = "cuda",
) -> Conditioner:
    """Root-trajectory steering: overwrite root x, y of the given frames with
    a target path."""
    path_xy = np.asarray(path_xy, np.float32)
    if frames is None:
        frames = range(path_xy.shape[0])
    frames = np.asarray(list(frames), np.int64)
    values = np.zeros((1, horizon, feature_dim), np.float32)
    mask = np.zeros((1, horizon, feature_dim), np.float32)
    values[0, frames, 0] = path_xy[:, 0]
    values[0, frames, 1] = path_xy[:, 1]
    mask[0, frames, 0] = 1.0
    mask[0, frames, 1] = 1.0
    return masked_overwrite(mask, values, device)
