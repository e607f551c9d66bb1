"""Value-guided sampling.

Counterpart of ``deepmimic_diffusion_mujoco_tpu/diffusion/guidance.py``
(Diffuser's n_step_guided_p_sample): each reverse step nudges the
trajectory up the gradient of a value model, scaled by the posterior
variance, re-applies the conditioner after each nudge, and then takes the
stack-A posterior step. ``guided_sample_loop`` runs the whole chain (a
Python loop where the JAX package scans) and sorts the trajectories by
their final value.

Noise comes from an explicit ``torch.Generator``: one initial draw, then
one per step after the nudges, in the JAX chain's order. The value
gradients come from ``torch.autograd.grad``; freeze the value model's
parameters (``requires_grad_(False)``) so that its backward computes the
input's gradient only (on the card, the conv blocks' backward then takes
no weight gradient). Do not call the loop under ``torch.inference_mode``:
the nudges need autograd.
"""
from __future__ import annotations

from typing import Callable

import torch

from .process import posterior_step, predict_start_from_noise, q_sample
from .sampling import SampleResult
from .schedules import Schedule, extract

# value_fn(x, t) -> (B,) scalar values
ValueFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def value_gradients(value_fn: ValueFn, x, t):
    """(y, dy/dx) of the value model, both detached."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_()
        y = value_fn(xx, t)
        (grad,) = torch.autograd.grad(y.sum(), [xx])
    return y.detach(), grad


def guided_step(sched: Schedule, model_fn, value_fn: ValueFn, x, t, noise, *,
                scale: float = 0.001, t_stopgrad: int = 0, n_guide_steps: int = 1,
                scale_grad_by_std: bool = True, predict_epsilon: bool = True,
                conditioning_fn=None):
    """Nudge x up the value gradient ``n_guide_steps`` times (no nudge
    where t < t_stopgrad), then take the posterior step with ``noise``.
    -> (x_{t-1}, the values at the last nudge)."""
    shape = (-1,) + (1,) * (x.ndim - 1)
    var = torch.exp(extract(sched.posterior_log_variance_clipped, t, x.ndim))
    y = None
    for _ in range(n_guide_steps):
        y, grad = value_gradients(value_fn, x, t)
        if scale_grad_by_std:
            grad = var * grad
        grad = torch.where((t < t_stopgrad).reshape(shape), torch.zeros_like(grad), grad)
        x = x + scale * grad
        if conditioning_fn is not None:
            x = conditioning_fn(x)
    with torch.no_grad():
        pred = model_fn(x, t)
        x0_hat = predict_start_from_noise(sched, x, t, pred) if predict_epsilon else pred
        return posterior_step(sched, x, t, x0_hat, noise), y


@torch.no_grad()
def guided_sample_loop(sched: Schedule, model_fn, value_fn: ValueFn, shape, generator, *,
                       scale: float = 0.001, t_stopgrad: int = 0, n_guide_steps: int = 1,
                       scale_grad_by_std: bool = True, predict_epsilon: bool = True,
                       conditioning_fn=None, sort: bool = True):
    """The guided reverse chain, t = T-1 .. 0, on the schedule's device.
    -> (SampleResult, final values), both sorted by value, highest first,
    unless ``sort`` is False."""
    device = sched.device

    def randn():
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

    x = randn()
    if conditioning_fn is not None:
        x = conditioning_fn(x)
    values = None
    for t_scalar in range(sched.num_timesteps - 1, -1, -1):
        t = torch.full((shape[0],), t_scalar, dtype=torch.long, device=device)
        x, values = guided_step(sched, model_fn, value_fn, x, t, randn(), scale=scale,
                                t_stopgrad=t_stopgrad, n_guide_steps=n_guide_steps,
                                scale_grad_by_std=scale_grad_by_std,
                                predict_epsilon=predict_epsilon, conditioning_fn=conditioning_fn)
    if sort:
        order = torch.argsort(-values, stable=True)
        x, values = x[order], values[order]
    return SampleResult(trajectories=x, chain=None), values


def value_diffusion_loss(sched: Schedule, value_fn: ValueFn, x0, target_values, t, noise):
    """ValueDiffusion training: predict the target value from the trajectory
    noised with ``noise`` at ``t``; MSE. -> (loss, {})."""
    pred = value_fn(q_sample(sched, x0, t, noise), t)
    return ((pred - target_values) ** 2).mean(), {}
