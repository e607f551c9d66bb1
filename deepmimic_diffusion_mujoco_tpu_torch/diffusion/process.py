"""Forward/reverse diffusion formulas on tensors: the counterpart of
``deepmimic_diffusion_mujoco_tpu/diffusion/process.py``, its sampling
updates and every training loss (stack A's weighted p_losses, stack B's
v4 / x0 / KL / angle-velocity losses and stack C's v loss).

Every function is shape-polymorphic over (B, ...) trajectories and takes
the Schedule as an argument; ``t`` is a (B,) integer tensor. The training
losses take their Gaussian ``noise`` from the caller (the JAX losses draw
it from a key), so that tests can give both the same draw.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..parallel.mesh import all_reduce_mean
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
    device: str | torch.device = "cuda",
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
    return weights.to(resolve_device(device))


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


# ---------------------------------------------------------------------------
# Stack-B and stack-C losses
# ---------------------------------------------------------------------------


def _masked_mean(err, mask, group=None):
    """Mean of (B, H, D) ``err`` over the valid frames of a (B, H) mask.
    With a data-parallel ``group`` it is divided by the ranks' mean count of
    valid frames (one all_reduce), so that the mean of the ranks' losses,
    and of their gradients, is the masked mean over the global batch
    however the valid frames fall on the ranks."""
    m = mask[..., None]
    count = m.sum()
    if group is not None:
        all_reduce_mean([count], group)
    return (err * m).sum() / (count * err.shape[-1])


def mse_loss(pred, target, mask=None):
    """Plain MSE; with a (B, H) frame mask, the mean over valid frames."""
    err = (pred - target) ** 2
    return err.mean() if mask is None else _masked_mean(err, mask)


def kl_divergence_loss(sched: Schedule, x0, x_t, x0_hat, t):
    """KL(q(x_{t-1}|x_t, x0) || p(x_{t-1}|x_t, x0_hat)): both share the
    posterior variance, so it is the scaled squared mean difference."""
    mean_q, var, _ = q_posterior(sched, x0, x_t, t)
    mean_p, _, _ = q_posterior(sched, x0_hat, x_t, t)
    return (0.5 * (mean_q - mean_p) ** 2 / var.clamp(min=1e-20)).mean()


def kl_training_loss(sched: Schedule, model_fn, x0, t, noise, predict_x0: bool = True):
    """Loss kind "kl": noise x0, recover x0_hat from the model, and take
    the posterior KL. -> (loss, {})."""
    x_noisy = q_sample(sched, x0, t, noise)
    pred = model_fn(x_noisy, t)
    x0_hat = pred if predict_x0 else predict_start_from_noise(sched, x_noisy, t, pred)
    return kl_divergence_loss(sched, x0, x_noisy, x0_hat, t), {}


def angle_velocity_loss(sched: Schedule, model_fn, x0, t, noise,
                        smooth_loss_weight: float = 0.1):
    """The tuning model's loss: the model predicts noise; MSE of the
    recovered x0 plus ``smooth_loss_weight`` x the MSE of its frame
    differences."""
    x_noisy = q_sample(sched, x0, t, noise)
    x0_hat = predict_start_from_noise(sched, x_noisy, t, model_fn(x_noisy, t))
    angle_loss = ((x0_hat - x0) ** 2).mean()
    pred_vel = x0_hat[:, 1:] - x0_hat[:, :-1]
    true_vel = x0[:, 1:] - x0[:, :-1]
    velocity_loss = ((pred_vel - true_vel) ** 2).mean()
    loss = angle_loss + smooth_loss_weight * velocity_loss
    return loss, {"loss_angle": angle_loss, "loss_velocity": velocity_loss}


def v_training_loss(sched: Schedule, model_fn, x0, t, noise, mask=None):
    """Stack C's objective: MSE between the model output and the v target."""
    x_noisy = q_sample(sched, x0, t, noise)
    return mse_loss(model_fn(x_noisy, t), predict_v(sched, x0, t, noise), mask), {}


def v4_training_loss(sched: Schedule, model_fn, x0, t, noise, predict_x0: bool = True,
                     mask=None, t_weights=None, loss_space: str = "eps", group=None):
    """Stack B's loss. ``loss_space="eps"``: MSE in epsilon space (an
    x0-predicting model's output is converted first); ``"x0"``: MSE on the
    recovered x0 (MDM's "simple" objective, loss kind "x0").

    Unweighted (``t_weights`` None) it is the global mean, masked over valid
    frames with a (B, H) ``mask``; with (B,) importance weights from the
    loss-aware sampler, the mean of per-sample means times the weights.
    info["per_sample_loss"] (B,) is what that sampler records. ``group``:
    this batch is one data-parallel rank's share (``_masked_mean``)."""
    x_noisy = q_sample(sched, x0, t, noise)
    pred = model_fn(x_noisy, t)
    if loss_space == "x0":
        x0_hat = pred if predict_x0 else predict_start_from_noise(sched, x_noisy, t, pred)
        err = (x0_hat - x0) ** 2
    else:
        eps_hat = predict_noise_from_start(sched, x_noisy, t, pred) if predict_x0 else pred
        err = (eps_hat - noise) ** 2
    if mask is None:
        per_sample = err.mean(dim=tuple(range(1, err.ndim)))
    else:
        m = mask[..., None]
        per_sample = (err * m).sum(dim=(1, 2)) / (m.sum(dim=(1, 2)) * err.shape[-1])
    if t_weights is None:
        loss = err.mean() if mask is None else _masked_mean(err, mask, group)
    else:
        loss = (per_sample * t_weights).mean()
    return loss, {"per_sample_loss": per_sample}
