"""Build models and schedules from an ExperimentConfig.

Counterpart of ``deepmimic_diffusion_mujoco_tpu/factory.py``: the MDM
transformer, the temporal U-Net, the local-attention transformer and the
decoder. bf16 compute raises ``NotImplementedError`` naming the ROADMAP.md
item that brings it.
"""
from __future__ import annotations

import torch

from .device import resolve_device
from .diffusion.schedules import Schedule, make_schedule
from .models.local_attention import LocalTransformer
from .models.temporal_unet import TemporalUnet
from .models.transformer import TransformerMotionModel
from .models.transformer_decoder import TransformerDecoderMotionModel
from .train.config import DiffusionConfig, ExperimentConfig, ModelConfig


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda") -> torch.nn.Module:
    """The denoiser for ``cfg``, on ``device``. ``use_pallas`` is not read:
    on the card the conv blocks always launch the CUDA kernel, and every
    local attention call the kernel's semantics cover launches B3."""
    dev = resolve_device(device)
    if cfg.bf16:
        raise NotImplementedError(
            "bf16 compute is not ported yet (ROADMAP.md Queue B, B1's bf16/wgmma variant); "
            "the port computes in float32 only")
    if cfg.architecture == "transformer":
        return TransformerMotionModel(
            input_dim=cfg.input_dim, latent_dim=cfg.latent_dim, n_heads=cfg.n_heads,
            num_layers=cfg.num_layers, dropout=cfg.dropout,
            dim_feedforward=cfg.dim_feedforward, max_sequence_length=cfg.max_seq_len,
            num_classes=cfg.num_classes, conditioning=cfg.conditioning,
        ).to(dev)
    if cfg.architecture == "temporal":
        return TemporalUnet(
            transition_dim=cfg.input_dim, dim=cfg.channel_dim,
            dim_mults=tuple(cfg.dim_mults), attention=cfg.attention,
        ).to(dev)
    if cfg.architecture == "local_attention":
        return LocalTransformer(
            input_dim=cfg.input_dim, max_seq_len=cfg.max_seq_len, dim=cfg.latent_dim,
            depth=cfg.depth, heads=cfg.n_heads, dim_head=cfg.dim_head,
            window_size=cfg.window_size, causal=cfg.causal, use_xpos=cfg.use_xpos,
            num_residual_streams=cfg.num_residual_streams, attn_dropout=cfg.attn_dropout,
            ff_dropout=cfg.ff_dropout, use_dynamic_pos_bias=cfg.use_dynamic_pos_bias,
            use_global_attn=cfg.use_global_attn,
            global_attn_layers=tuple(cfg.global_attn_layers), num_classes=cfg.num_classes,
        ).to(dev)
    if cfg.architecture == "decoder":
        return TransformerDecoderMotionModel(
            horizon=cfg.max_seq_len, transition_dim=cfg.input_dim, dim=cfg.latent_dim,
            n_heads=cfg.n_heads, num_layers=cfg.num_layers,
        ).to(dev)
    raise ValueError(f"unknown architecture {cfg.architecture!r}")


def build_schedule(cfg: DiffusionConfig, device: str | torch.device = "cuda") -> Schedule:
    return make_schedule(
        kind=cfg.schedule_type, timesteps=cfg.noise_steps,
        beta_start=cfg.beta_start, beta_end=cfg.beta_end,
        cosine_s=cfg.cosine_s, convention=cfg.convention, device=device,
    )


def build_experiment(cfg: ExperimentConfig, device: str | torch.device = "cuda"):
    """-> (model, schedule), both on ``device``."""
    return build_model(cfg.model, device), build_schedule(cfg.diffusion, device)
