"""Timestep, rotary and xpos embeddings.

Counterpart of ``deepmimic_diffusion_mujoco_tpu/models/embeddings.py``:
the temporal U-Net's ``sinusoidal_pos_emb``, the local-attention
transformer's ``mdm_timestep_embedding``, and the rotary helpers of the
windowed attention.
"""
from __future__ import annotations

import math

import torch


def sinusoidal_pos_emb(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Diffuser-style [sin | cos] embedding: (B,) timesteps -> (B, dim)."""
    half = dim // 2
    freq = torch.exp(
        -(math.log(10000.0) / (half - 1))
        * torch.arange(half, dtype=torch.float32, device=x.device)
    )
    ang = x[:, None].to(torch.float32) * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def mdm_timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """MDM-style [cos | sin] embedding with /half frequency spacing:
    (B,) timesteps -> (B, dim), zero-padded when dim is odd."""
    half = dim // 2
    freq = torch.exp(-math.log(max_period)
                     * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t[:, None].to(torch.float32) * freq[None, :]
    emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def rotary_angles(seq_len: int, dim: int, base: float = 10000.0,
                  device: str | torch.device = "cpu") -> torch.Tensor:
    """(seq_len, dim/2) rotary angles: position x inverse frequency."""
    inv_freq = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    return torch.arange(seq_len, dtype=torch.float32, device=device)[:, None] * inv_freq[None, :]


def apply_rotary(x: torch.Tensor, angles: torch.Tensor, scale=1.0) -> torch.Tensor:
    """Rotate feature halves: x (..., seq, dim), angles (seq, dim/2); ``scale``
    is the xpos scale (1 for plain rotary)."""
    a = torch.cat([angles, angles], dim=-1)
    x1, x2 = x.chunk(2, dim=-1)
    rotated = torch.cat([-x2, x1], dim=-1)
    return x * torch.cos(a) * scale + rotated * torch.sin(a) * scale


def xpos_scale(seq_len: int, dim: int, scale_base: float,
               device: str | torch.device = "cpu") -> torch.Tensor:
    """xpos length-extrapolation scale: (seq, dim/2)."""
    scale = (torch.arange(0, dim, 2, dtype=torch.float32, device=device) + 0.4 * dim) / (1.4 * dim)
    power = (torch.arange(seq_len, dtype=torch.float32, device=device) - seq_len // 2) / scale_base
    return scale[None, :] ** power[:, None]
