"""Noise schedules and derived coefficient tables.

Counterpart of ``deepmimic_diffusion_mujoco_tpu/diffusion/schedules.py``: the
betas and every derived table are computed in numpy float64, then held as
float32 tensors on the device. Both beta-clip conventions are kept:

- "diffuser" cosine: clip betas to [0, 0.999],
- "v4" cosine: clip betas to [beta_start, beta_end],
- "v4" linear: linspace(beta_start, beta_end).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device


def cosine_betas(
    timesteps: int,
    s: float = 0.008,
    clip: tuple[float, float] = (0.0, 0.999),
    convention: str = "diffuser",
) -> np.ndarray:
    """Nichol & Dhariwal cosine schedule.

    ``convention="diffuser"`` uses x = linspace(0, T+1, T+1);
    ``convention="v4"`` uses x = linspace(0, T, T+1).
    """
    steps = timesteps + 1
    if convention == "diffuser":
        x = np.linspace(0, steps, steps)
        denom = steps
    elif convention == "v4":
        x = np.linspace(0, timesteps, steps)
        denom = timesteps
    else:
        raise ValueError(f"unknown cosine convention {convention!r}")
    alphas_cumprod = np.cos(((x / denom) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, clip[0], clip[1]).astype(np.float64)


def linear_betas(timesteps: int, beta_start: float = 1e-4, beta_end: float = 0.02) -> np.ndarray:
    return np.linspace(beta_start, beta_end, timesteps, dtype=np.float64)


@dataclass(frozen=True)
class Schedule:
    """All q/posterior coefficients, derived once from betas (one (T,)
    float32 tensor per field, all on one device)."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    @property
    def device(self) -> torch.device:
        return self.betas.device

    @classmethod
    def from_betas(cls, betas: np.ndarray, device: str | torch.device = "cuda") -> "Schedule":
        dev = resolve_device(device)
        betas = np.asarray(betas, dtype=np.float64)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.concatenate([[1.0], acp[:-1]])
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        a = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        return cls(
            betas=a(betas),
            alphas=a(alphas),
            alphas_cumprod=a(acp),
            alphas_cumprod_prev=a(acp_prev),
            sqrt_alphas_cumprod=a(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=a(np.sqrt(1.0 - acp)),
            sqrt_recip_alphas_cumprod=a(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=a(np.sqrt(1.0 / acp - 1.0)),
            posterior_variance=a(post_var),
            posterior_log_variance_clipped=a(np.log(np.maximum(post_var, 1e-20))),
            posterior_mean_coef1=a(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=a((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
        )


def make_schedule(
    kind: str = "cosine",
    timesteps: int = 1000,
    beta_start: float = 1e-4,
    beta_end: float = 0.02,
    cosine_s: float = 0.008,
    convention: str = "diffuser",
    device: str | torch.device = "cuda",
) -> Schedule:
    if kind == "cosine":
        clip = (0.0, 0.999) if convention == "diffuser" else (beta_start, beta_end)
        betas = cosine_betas(timesteps, cosine_s, clip, convention)
    elif kind == "linear":
        betas = linear_betas(timesteps, beta_start, beta_end)
    else:
        raise ValueError(f"unknown schedule kind {kind!r}")
    return Schedule.from_betas(betas, device=device)


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep coefficients, broadcastable to an ndim tensor."""
    out = table[t.long()]
    return out.reshape(out.shape + (1,) * (ndim - 1))
