"""Hyper-connections: learned multi-stream residuals (arXiv 2409.19606).

Counterpart of ``deepmimic_diffusion_mujoco_tpu/models/hyper_connections.py``.
The residual is expanded into S streams; each wrapped branch takes its input
from a learned (S, S+1) width connection (a static matrix plus a tanh term of
the RMS-normalised streams) and folds its output back into every stream with
per-stream weights beta (the depth connection). ``reduce_streams`` sums the
streams. Parameters keep flax's names and shapes, so the dynamic weights are
used as ``normed @ W`` and the converter copies them unchanged.

At bf16 (``dtype``) the RMSNorm returns bf16 and the dynamic products run
in bf16, as flax's; the float32 0-d scales and the static matrices then
make alpha and beta float32 (JAX promotes a bf16 array with a float32
scalar parameter to float32), so the mixed streams are float32 from the
first width connection on.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from . import precision as P


def expand_streams(h: torch.Tensor, num_streams: int) -> torch.Tensor:
    """(B, N, D) -> (B, N, S, D): every stream starts as a copy."""
    return h[..., None, :].expand(*h.shape[:-1], num_streams, h.shape[-1])


def reduce_streams(h: torch.Tensor) -> torch.Tensor:
    """(B, N, S, D) -> (B, N, D)."""
    return h.sum(dim=-2)


def depth_connection(branch_out: torch.Tensor, residuals: torch.Tensor,
                     beta: torch.Tensor) -> torch.Tensor:
    """residuals (B, N, S, D) + branch_out (B, N, D) weighted by beta (B, N, S)."""
    return residuals + branch_out[..., None, :] * beta[..., None]


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``: x / sqrt(mean(x^2) + eps) * scale, eps 1e-6; at
    bf16 in float32 with a bf16 result."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return P.rms_norm(x, self.scale, self.eps, self.dtype)


class HyperConnection(nn.Module):
    """Width connection for one wrapped branch. ``forward(residuals)`` returns
    ``(branch_input, residuals, beta)``; fold the branch output back with
    :func:`depth_connection`."""

    def __init__(self, dim: int, num_streams: int, layer_index: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        S = num_streams
        self.dtype = dtype
        alpha = torch.zeros(S, S + 1)
        alpha[layer_index % S, 0] = 1.0
        alpha[:, 1:] = torch.eye(S)
        self.static_alpha = nn.Parameter(alpha)
        self.static_beta = nn.Parameter(torch.ones(S))
        self.dynamic_alpha_fn = nn.Parameter(torch.zeros(dim, S + 1))
        self.dynamic_alpha_scale = nn.Parameter(torch.tensor(1e-2))
        self.dynamic_beta_fn = nn.Parameter(torch.zeros(dim))
        self.dynamic_beta_scale = nn.Parameter(torch.tensor(1e-2))
        self.norm = RMSNorm(dim, dtype=dtype)

    def forward(self, residuals: torch.Tensor):
        normed = self.norm(residuals)
        if self.dtype == P.BF16:
            a = torch.tanh(normed @ P.cast(self.dynamic_alpha_fn, P.BF16)).float()
            b = torch.tanh(normed @ P.cast(self.dynamic_beta_fn, P.BF16)).float()
            alpha = a * self.dynamic_alpha_scale + self.static_alpha
            beta = b * self.dynamic_beta_scale + self.static_beta
            mixed = torch.einsum("...st,...sd->...td", alpha, residuals.float())
            return mixed[..., 0, :], mixed[..., 1:, :], beta
        alpha = torch.tanh(normed @ self.dynamic_alpha_fn) * self.dynamic_alpha_scale \
            + self.static_alpha                                  # (B, N, S, S+1)
        beta = torch.tanh(normed @ self.dynamic_beta_fn) * self.dynamic_beta_scale \
            + self.static_beta                                   # (B, N, S)
        mixed = torch.einsum("...st,...sd->...td", alpha, residuals)
        return mixed[..., 0, :], mixed[..., 1:, :], beta
