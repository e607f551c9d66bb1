"""Reverse-diffusion sampling.

Counterpart of ``deepmimic_diffusion_mujoco_tpu/diffusion/sampling.py``.
The JAX package compiles the chain into one ``lax.scan``; here it is a
Python loop over the timesteps, with the step's indices computed on the
host so the loop never waits on the device. Noise comes from an explicit
``torch.Generator`` in the order the JAX chain draws it: one initial draw
(unless ``starting_motion`` is given), then one per step.

``x_sharding`` (``parallel.mesh.seq_sharding(mesh)``, JAX's argument)
splits the trajectory over the mesh: rows over "data", the horizon over
"seq". Each rank then holds its share of the chain: every draw is made at
the global shape and cut to the rank's rows and frames
(``utils.rng.draw_frames``), the conditioner acts on the rank's frames
(``conditioning.for_frames``), and the model runs with the split active
(``utils.seq``), so each rank's frames equal the same frames of the
one-process chain drawn from the same generator (the local transformer's
padding frames under a key mask excepted, see ``models.local_attention``;
the chain passes none). ``x_sharding.gather`` assembles the whole
trajectory.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils import seq as seqlib
from ..utils.rng import draw_frames
from .conditioning import Conditioner, for_frames
from .process import (
    ddim_step,
    ddpm_step,
    posterior_step,
    predict_noise_from_start,
    predict_start_from_noise,
    predict_start_from_v,
)
from .schedules import Schedule

# Denoiser signature: (x, t, y) -> prediction (epsilon, x0 or v). `y` is an
# integer class-label tensor; the unconditional branch passes `uncond_y`.
ModelFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor | None], torch.Tensor]

MODES = ("posterior", "v4", "ddpm", "ddim")


class SampleResult(NamedTuple):
    trajectories: torch.Tensor          # (B, H, D)
    chain: torch.Tensor | None          # (steps, B, H, D) if return_chain


def _x0_and_eps(sched, x, t, pred, prediction: str):
    """Normalize any model output parameterization to (x0_hat, eps_hat)."""
    if prediction == "epsilon":
        return predict_start_from_noise(sched, x, t, pred), pred
    if prediction == "x0":
        return pred, predict_noise_from_start(sched, x, t, pred)
    if prediction == "v":
        x0 = predict_start_from_v(sched, x, t, pred)
        return x0, predict_noise_from_start(sched, x, t, x0)
    raise ValueError(f"unknown prediction {prediction!r}")


def _model_prediction(model_fn: ModelFn, x, t, y, cfg_scale, uncond_y,
                      cfg_batched: bool = True):
    """One (optionally classifier-free-guided) denoiser evaluation:
    pred = uncond + cfg_scale * (cond - uncond). With ``cfg_batched`` both
    branches run as one 2B-batch forward."""
    if cfg_scale is None or uncond_y is None:
        return model_fn(x, t, y)
    if cfg_batched and y is not None:
        x2 = torch.cat([x, x], dim=0)
        t2 = torch.cat([t, t], dim=0)
        y2 = torch.cat([torch.as_tensor(y, device=t.device).expand(t.shape),
                        torch.as_tensor(uncond_y, device=t.device).expand(t.shape)], dim=0)
        pred2 = model_fn(x2, t2, y2)
        cond, uncond = pred2[: x.shape[0]], pred2[x.shape[0]:]
    else:
        cond = model_fn(x, t, y)
        uncond = model_fn(x, t, uncond_y)
    return uncond + cfg_scale * (cond - uncond)


def _timesteps(mode: str, t_start: int, t_end: int, ddim_steps: int | None):
    """(t, t_prev) pairs of the chain, on the host."""
    if mode == "ddim":
        n = ddim_steps if ddim_steps is not None else t_start
        ts = np.linspace(0, t_start - 1, n).round().astype(np.int64)[::-1]
        ts_prev = np.concatenate([ts[1:], [-1]])
    else:
        ts = np.arange(t_start - 1, t_end - 1, -1)
        ts_prev = ts - 1
    return list(zip(ts.tolist(), ts_prev.tolist()))


def _rows(sharding, a):
    """This rank's rows of a per-sample label tensor of the global batch."""
    if sharding is None or not torch.is_tensor(a) or a.dim() == 0 or sharding.data_world == 1:
        return a
    return sharding.rows(a)


@torch.inference_mode()
def sample_loop(
    sched: Schedule,
    model_fn: ModelFn,
    shape: tuple[int, ...],
    generator: torch.Generator,
    *,
    mode: str = "posterior",
    predict_epsilon: bool = True,
    prediction: str | None = None,
    conditioning_fn: Conditioner | None = None,
    starting_motion=None,
    t_start: int | None = None,
    return_chain: bool = False,
    cfg_scale: float | None = None,
    y: torch.Tensor | None = None,
    uncond_y: torch.Tensor | None = None,
    clip_denoised: bool = False,
    x_sharding=None,
    ddim_steps: int | None = None,
    eta: float = 0.0,
    cfg_batched: bool = True,
) -> SampleResult:
    """Run the reverse chain on the schedule's device.

    mode="posterior": stack-A update x_{t-1} ~ q(x_{t-1} | x_t, x0_hat),
      noise zeroed at t == 0, loop t = t_start-1 .. 0.
    mode="v4": stack-B update, noise zeroed at t == 1, loop t = T-1 .. 1.
    mode="ddpm": the v4 update running down to t = 0, noise zeroed there.
    mode="ddim": strided sampling over ``ddim_steps`` timesteps
      (deterministic at eta=0).

    ``prediction`` ("epsilon" | "x0" | "v") names the model's output; the
    default derives from ``predict_epsilon``. ``t_start`` truncates the
    chain; with ``starting_motion`` that is motion-to-motion translation.
    ``shape`` may use any horizon the model accepts.

    ``x_sharding`` (``parallel.mesh.seq_sharding``): ``shape`` stays the
    global (B, H, D); the result (and the chain) hold this rank's rows and
    frames. ``y`` and ``uncond_y`` of the global batch are cut to its rows.
    """
    if mode not in MODES:
        raise ValueError(f"unknown sampling mode {mode!r}; expected one of {MODES}")
    shape = tuple(shape)
    device = sched.device
    T = sched.num_timesteps
    if t_start is None:
        t_start = T
    t_end = 1 if mode == "v4" else 0
    if prediction is None:
        prediction = "epsilon" if predict_epsilon else "x0"

    def draw(s):
        return torch.randn(s, generator=generator, device=device, dtype=torch.float32)

    if x_sharding is None:
        local = shape

        def randn():
            return draw(shape)
    else:
        local = x_sharding.local_shape(shape)
        lo, hi = x_sharding.frames(shape[1])
        conditioning_fn = for_frames(conditioning_fn, lo, hi, shape[1])
        y, uncond_y = _rows(x_sharding, y), _rows(x_sharding, uncond_y)

        def randn():  # the global draw's rows and frames of this rank
            frames = draw_frames(generator, (shape[0], local[1], *shape[2:]), draw,
                                 x_sharding.rank, x_sharding.world)
            return x_sharding.rows(frames)

    if starting_motion is not None:
        x = torch.as_tensor(starting_motion, dtype=torch.float32, device=device)
        x = x.expand(shape).clone()
        if x_sharding is not None:
            x = x_sharding.shard(x).contiguous()
    else:
        x = randn()
    if conditioning_fn is not None:
        x = conditioning_fn(x)

    chain = []
    B = local[0]
    with seqlib.sharded(x_sharding):  # the models see the split
        for t_scalar, t_prev_scalar in _timesteps(mode, t_start, t_end, ddim_steps):
            t = torch.full((B,), t_scalar, dtype=torch.long, device=device)
            pred = _model_prediction(model_fn, x, t, y, cfg_scale, uncond_y, cfg_batched)
            noise = randn()
            x0_hat, eps_hat = _x0_and_eps(sched, x, t, pred, prediction)
            if clip_denoised:
                x0_hat = x0_hat.clamp(-1.0, 1.0)
                eps_hat = predict_noise_from_start(sched, x, t, x0_hat)
            if mode in ("v4", "ddpm"):
                if t_scalar <= t_end:  # no noise on the final step
                    noise = torch.zeros_like(noise)
                x = ddpm_step(sched, x, t, eps_hat, noise)
            elif mode == "ddim":
                t_prev = torch.full((B,), t_prev_scalar, dtype=torch.long, device=device)
                if t_prev_scalar < 0:
                    noise = torch.zeros_like(noise)
                x = ddim_step(sched, x, t, t_prev, x0_hat, eps_hat, noise, eta)
            else:
                x = posterior_step(sched, x, t, x0_hat, noise)
            if conditioning_fn is not None:
                x = conditioning_fn(x)
            if return_chain:
                chain.append(x)
    return SampleResult(trajectories=x, chain=torch.stack(chain) if return_chain else None)


def make_sampler(sched: Schedule, model: torch.nn.Module, **kwargs):
    """Bind the denoiser into a closure over ``sample_loop``: the returned
    callable takes ``(shape, generator, **overrides)``, the overrides taking
    precedence over ``kwargs``. The JAX package binds flax params into its
    apply function here; a port model already holds its parameters."""

    def sampler(shape, generator: torch.Generator, **overrides):
        return sample_loop(sched, model, shape, generator, **{**kwargs, **overrides})

    return sampler
