"""Timestep samplers: uniform and loss-aware importance sampling.

Counterpart of ``deepmimic_diffusion_mujoco_tpu/diffusion/timestep_sampling.py``
(guided-diffusion's UniformSampler and LossSecondMomentResampler): the
loss-aware sampler keeps a (T, history) ring buffer of recent per-sample
losses on the device, draws t with probability proportional to
sqrt(E[loss²]) mixed with uniform once every row is full, and weights each
draw by 1 / (T · p[t]). Draws come from an explicit ``torch.Generator``.

Draws are batch-shaped: a data-parallel rank's generator
(``utils.rng.ShardGenerator``) draws the global batch's t and keeps its
rows. ``update_with_losses`` over a process group records every rank's
(t, loss) pairs in rank order, as JAX's ``axis_name`` all_gather does, so
every rank's state is the one process's that sees the whole batch.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..parallel.mesh import all_gather_rows
from ..utils.rng import draw_rows


def uniform_timesteps(generator: torch.Generator, batch: int, num_timesteps: int):
    """t ~ U{0..T-1} on the generator's device, weights 1."""
    t = draw_rows(generator, (batch,), lambda s: torch.randint(
        0, num_timesteps, s, generator=generator, device=generator.device))
    return t, torch.ones((batch,), dtype=torch.float32, device=generator.device)


@dataclass
class LossSecondMomentState:
    """Ring buffer of recent losses per timestep: ``losses`` (T, history)
    float32, ``counts`` (T,) int64 filled entries. Row t's first
    ``counts[t]`` entries hold its losses, oldest first."""

    losses: torch.Tensor
    counts: torch.Tensor

    @classmethod
    def create(cls, num_timesteps: int, history: int = 10,
               device: str | torch.device = "cuda") -> "LossSecondMomentState":
        device = resolve_device(device)
        return cls(losses=torch.zeros((num_timesteps, history), dtype=torch.float32,
                                      device=device),
                   counts=torch.zeros((num_timesteps,), dtype=torch.int64, device=device))


def loss_aware_weights(state: LossSecondMomentState, uniform_prob: float = 0.001) -> torch.Tensor:
    """(T,) sampling distribution: sqrt(E[loss²]) normalised, mixed with
    uniform; uniform until every row is full."""
    T, history = state.losses.shape
    w = torch.sqrt((state.losses ** 2).mean(dim=-1))
    w = w / w.sum().clamp(min=1e-20)
    w = w * (1 - uniform_prob) + uniform_prob / T
    warm = (state.counts >= history).all()
    return torch.where(warm, w, torch.full_like(w, 1.0 / T))


def importance_weights(state: LossSecondMomentState, t: torch.Tensor) -> torch.Tensor:
    """(B,) weights 1 / (T · p[t]) of timesteps drawn from the state's
    distribution."""
    p = loss_aware_weights(state)
    return 1.0 / (p.shape[0] * p[t])


def loss_aware_timesteps(state: LossSecondMomentState, generator: torch.Generator, batch: int):
    """Draw (B,) t from the loss-aware distribution -> (t, importance weights)."""
    p = loss_aware_weights(state)
    t = draw_rows(generator, (batch,), lambda s: torch.multinomial(
        p, s[0], replacement=True, generator=generator))
    return t, 1.0 / (p.shape[0] * p[t])


def update_with_losses(state: LossSecondMomentState, t: torch.Tensor, losses: torch.Tensor,
                       group=None) -> LossSecondMomentState:
    """Record per-sample ``losses`` at timesteps ``t``, in batch order, in
    place: as if each (t, loss) pair were appended one after another (the
    JAX sampler's ``lax.scan``), so a timestep drawn k times in one batch
    receives all k losses, the oldest dropping out of a full row. With
    ``group`` (a process group or a mesh's "data" dimension) every rank's
    pairs are recorded, in rank order (``parallel.mesh.all_gather_rows``,
    exact).

    Computed at once: row t's history followed by its new losses in batch
    order is one sequence, of which the row keeps the last ``history``."""
    t, losses = t.long(), losses.detach().to(state.losses.dtype)
    if group is not None:
        t, losses = all_gather_rows([t, losses], group)
    T, hist = state.losses.shape
    order = torch.argsort(t, stable=True)
    t_sorted = t[order]
    rank = torch.empty_like(t)                      # earlier samples of the same t
    rank[order] = (torch.arange(t.numel(), device=t.device)
                   - torch.searchsorted(t_sorted, t_sorted))
    cnt = state.counts
    # sequence length per row (index_add_: CUDA's bincount waits on the device)
    total = cnt + torch.zeros_like(cnt).index_add_(0, t, torch.ones_like(t))
    drop = (total - hist).clamp(min=0)              # oldest entries that fall out
    # every entry goes to its kept position, or to a spare column hist that
    # is cut off (no boolean indexing: nothing waits on the device)
    cols = torch.arange(hist, device=t.device)[None, :]
    old_pos = cols - drop[:, None]
    old_pos = torch.where((cols < cnt[:, None]) & (old_pos >= 0), old_pos, hist)
    new_pos = cnt[t] + rank - drop[t]
    new_pos = torch.where(new_pos >= 0, new_pos, hist)
    rows = torch.zeros((T, hist + 1), dtype=state.losses.dtype, device=t.device)
    rows[torch.arange(T, device=t.device)[:, None].expand(T, hist), old_pos] = state.losses
    rows[t, new_pos] = losses
    state.losses.copy_(rows[:, :hist])
    state.counts.copy_(total.clamp(max=hist))
    return state
