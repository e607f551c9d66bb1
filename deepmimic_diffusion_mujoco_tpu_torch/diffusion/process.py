"""Forward/reverse diffusion formulas on tensors: the sampling half of
``deepmimic_diffusion_mujoco_tpu/diffusion/process.py`` and its stack-A
losses (the v4, kl, x0 and angle-velocity losses come with stack B).

Every function is shape-polymorphic over (B, ...) trajectories and takes
the Schedule as an argument; ``t`` is a (B,) integer tensor.
"""
from __future__ import annotations

import torch

from .schedules import Schedule, extract


def q_sample(sched: Schedule, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Forward noising q(x_t | x_0)."""
    nd = x0.ndim
    return (
        extract(sched.sqrt_alphas_cumprod, t, nd) * x0
        + extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * noise
    )


def predict_start_from_noise(sched: Schedule, x_t, t, eps):
    """x0_hat from predicted epsilon."""
    nd = x_t.ndim
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t
        - extract(sched.sqrt_recipm1_alphas_cumprod, t, nd) * eps
    )


def predict_noise_from_start(sched: Schedule, x_t, t, x0):
    """epsilon_hat from predicted x0."""
    nd = x_t.ndim
    acp = extract(sched.alphas_cumprod, t, nd)
    return (x_t - torch.sqrt(acp) * x0) / torch.sqrt(1.0 - acp)


def predict_v(sched: Schedule, x0, t, noise):
    """v-parameterization target: v = sqrt(acp)*eps - sqrt(1-acp)*x0."""
    nd = x0.ndim
    return (
        extract(sched.sqrt_alphas_cumprod, t, nd) * noise
        - extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * x0
    )


def predict_start_from_v(sched: Schedule, x_t, t, v):
    """x0_hat from a v-prediction."""
    nd = x_t.ndim
    return (
        extract(sched.sqrt_alphas_cumprod, t, nd) * x_t
        - extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * v
    )


def q_posterior(sched: Schedule, x0, x_t, t):
    """Mean / variance / clipped log-variance of q(x_{t-1} | x_t, x_0)."""
    nd = x_t.ndim
    mean = (
        extract(sched.posterior_mean_coef1, t, nd) * x0
        + extract(sched.posterior_mean_coef2, t, nd) * x_t
    )
    var = extract(sched.posterior_variance, t, nd)
    log_var = extract(sched.posterior_log_variance_clipped, t, nd)
    return mean, var, log_var


def ddpm_step(sched: Schedule, x_t, t, eps_hat, noise):
    """Stack-B reverse update:
    x_{t-1} = 1/sqrt(a) * (x - (1-a)/sqrt(1-abar) * eps_hat) + sqrt(b)*noise.
    """
    nd = x_t.ndim
    alpha = extract(sched.alphas, t, nd)
    acp = extract(sched.alphas_cumprod, t, nd)
    beta = extract(sched.betas, t, nd)
    mean = (x_t - (1.0 - alpha) / torch.sqrt(1.0 - acp) * eps_hat) / torch.sqrt(alpha)
    return mean + torch.sqrt(beta) * noise


def ddim_step(sched: Schedule, x_t, t, t_prev, x0_hat, eps_hat, noise, eta: float = 0.0):
    """DDIM update between arbitrary timesteps t -> t_prev (t_prev = -1 is
    the final step, where alpha_cumprod_prev is 1)."""
    nd = x_t.ndim
    acp = extract(sched.alphas_cumprod, t, nd)
    acp_prev = torch.where(
        (t_prev >= 0).reshape((-1,) + (1,) * (nd - 1)),
        extract(sched.alphas_cumprod, t_prev.clamp(min=0), nd),
        torch.ones_like(acp),
    )
    sigma = (
        eta
        * torch.sqrt((1.0 - acp_prev) / (1.0 - acp))
        * torch.sqrt(1.0 - acp / acp_prev)
    )
    dir_xt = torch.sqrt(torch.clamp(1.0 - acp_prev - sigma**2, min=0.0)) * eps_hat
    return torch.sqrt(acp_prev) * x0_hat + dir_xt + sigma * noise


def posterior_step(sched: Schedule, x_t, t, x0_hat, noise):
    """Stack-A reverse update: posterior mean + exp(0.5*logvar)*noise, with
    noise zeroed at t == 0."""
    mean, _, log_var = q_posterior(sched, x0_hat, x_t, t)
    nonzero = (t > 0).to(x_t.dtype).reshape((-1,) + (1,) * (x_t.ndim - 1))
    return mean + nonzero * torch.exp(0.5 * log_var) * noise


# ---------------------------------------------------------------------------
# Stack-A loss (Diffuser's weighted p_losses)
# ---------------------------------------------------------------------------


def diffuser_loss_weights(
    horizon: int,
    transition_dim: int,
    action_weight: float = 1.0,
    discount: float = 1.0,
    weights_dict: dict | None = None,
    device: str | torch.device = "cpu",
) -> torch.Tensor:
    """(H, D) per-element loss weights: discount**h per frame (normalised to
    mean 1), ``action_weight`` on frame 0, ``weights_dict`` {dim: factor}
    applied at the given dims."""
    dim_weights = torch.ones(transition_dim, dtype=torch.float32)
    for ind, w in (weights_dict or {}).items():
        dim_weights[ind] *= w
    discounts = discount ** torch.arange(horizon, dtype=torch.float32)
    discounts = discounts / discounts.mean()
    weights = discounts[:, None] * dim_weights[None, :]
    weights[0, :] = action_weight
    return weights.to(device)


def weighted_loss(pred, target, weights, kind: str = "l2"):
    """Weighted L1/L2 and the frame-0 diagnostic ``a0_loss``.
    -> (scalar loss, {"a0_loss": scalar})."""
    err = (pred - target).abs() if kind == "l1" else (pred - target) ** 2
    loss = (err * weights).mean()
    a0_loss = (err[:, 0, :] / weights[0, :]).mean()
    return loss, {"a0_loss": a0_loss}


def diffuser_p_losses(
    sched: Schedule,
    model_fn,
    x0: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    weights: torch.Tensor,
    predict_epsilon: bool = True,
    loss_kind: str = "l2",
    conditioning_fn=None,
):
    """Stack-A p_losses for timesteps ``t`` and Gaussian ``noise`` drawn by
    the caller: conditioning is applied to BOTH the noised input and the
    reconstruction (a training-time quirk of stack A)."""
    x_noisy = q_sample(sched, x0, t, noise)
    if conditioning_fn is not None:
        x_noisy = conditioning_fn(x_noisy)
    x_recon = model_fn(x_noisy, t)
    if conditioning_fn is not None:
        x_recon = conditioning_fn(x_recon)
    target = noise if predict_epsilon else x0
    return weighted_loss(x_recon, target, weights, loss_kind)
