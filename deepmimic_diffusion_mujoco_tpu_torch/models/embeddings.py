"""Timestep embeddings (the temporal U-Net's; the zoo's others come with
their models)."""
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
