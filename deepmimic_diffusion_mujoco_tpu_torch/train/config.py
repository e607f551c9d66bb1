"""One JSON-roundtrippable config system replacing the reference's four
coexisting mechanisms (SURVEY.md section 5 "Config / flag system"): pickled
Config factories (diffuser/utils/config.py), nested dicts with .get defaults
(train_transformer.py:469-530), argparse CLIs, and itertools.product sweep
grids (train_transformer.py:578-617).

An ExperimentConfig fully determines dataset + model + diffusion + training;
`expand_grid` turns {key: [v1, v2, ...]} JSON into the cartesian sweep the
reference's --sweep mode runs.
"""
from __future__ import annotations

import itertools
import json
from dataclasses import asdict, dataclass, field, replace
from typing import Any


@dataclass
class ModelConfig:
    architecture: str = "transformer"  # transformer|temporal|local_attention|decoder
    input_dim: int = 69
    latent_dim: int = 512
    n_heads: int = 8
    num_layers: int = 4
    dim_feedforward: int = 2048
    max_seq_len: int = 128
    num_classes: int = 0
    # transformer conditioning pathway: "add" (additive class/time tokens,
    # round-4 checkpoints) | "adaln" (per-layer FiLM of the norms by
    # class+time, adaLN-zero init — the DiT/MDM mechanism)
    conditioning: str = "add"
    # temporal U-Net
    channel_dim: int = 128
    dim_mults: tuple = (1, 2, 4, 8)
    attention: bool = False
    # dropout (active in training when the architecture supports it;
    # transformer_temporal.py:59 defaults 0.1, the live local-attention
    # config trains with attn/ff dropout 0.3, train_transformer.py:476-477)
    dropout: float = 0.1
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0
    # local attention
    depth: int = 6
    dim_head: int = 64
    window_size: int = 16
    causal: bool = False
    use_xpos: bool = False
    num_residual_streams: int = 4
    use_dynamic_pos_bias: bool = False
    # full-attention inserts before the local attention in the listed
    # 1-based layers (empty = all layers when enabled)
    use_global_attn: bool = False
    global_attn_layers: tuple = ()
    # compute
    bf16: bool = False
    # None = auto: enable the kernels that are measured end-to-end wins on
    # TPU (local-attention fused kernel yes, conv+GN+Mish no)
    use_pallas: bool | None = None


@dataclass
class DiffusionConfig:
    noise_steps: int = 1000
    schedule_type: str = "cosine"       # cosine|linear
    convention: str = "v4"              # v4|diffuser beta-clip convention
    beta_start: float = 1e-4
    beta_end: float = 0.02
    cosine_s: float = 0.008
    predict_x0: bool = True
    mode: str = "v4"                    # sampler loop: posterior|v4|ddpm
    cfg_scale: float = 3.0
    loss: str = "v4"                    # v4|x0|kl|diffuser|angle_velocity
    action_weight: float = 1.0
    loss_discount: float = 1.0
    loss_kind: str = "l2"
    clip_denoised: bool = False
    smooth_loss_weight: float = 0.1


@dataclass
class DataConfig:
    path: str = "data/motions"
    include_velocity: bool = True
    augment: str = "cyclic_rooted"      # cyclic|cyclic_rooted|replicate|none
    replicas: int = 1000
    horizon_multiple: int = 8
    max_files: int | None = None


@dataclass
class TrainConfig:
    batch_size: int = 64
    num_train_steps: int = 5000
    gradient_accumulate_every: int = 1
    log_every: int = 100
    save_every: int | None = None
    lr: float = 2e-4
    weight_decay: float = 0.0
    betas: tuple = (0.9, 0.98)
    optimizer_type: str = "adamw"
    scheduler_type: str | None = "exponential"
    ema_decay: float = 0.995
    ema_start: int = 2000
    ema_every: int = 10
    label_drop_prob: float = 0.1
    seed: int = 0
    scan_chunk: int = 1     # >1: updates per compiled call (lax.scan)
    # draw each batch row's class uniformly (cyclic augmentation otherwise
    # weights classes by clip length — see datasets.epochs)
    class_balanced: bool = False
    # uniform | loss_aware (LossSecondMomentResampler, resample.py:124-153);
    # loss_aware requires diffusion.loss == "v4"
    timestep_sampler: str = "uniform"


@dataclass
class ExperimentConfig:
    name: str = "experiment"
    model: ModelConfig = field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        return cls(
            name=d.get("name", "experiment"),
            model=ModelConfig(**d.get("model", {})),
            diffusion=DiffusionConfig(**d.get("diffusion", {})),
            data=DataConfig(**d.get("data", {})),
            train=TrainConfig(**d.get("train", {})),
        )

    @classmethod
    def load(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def override(self, dotted: dict[str, Any]) -> "ExperimentConfig":
        """Apply {"model.latent_dim": 256, ...} overrides."""
        cfg = self
        for key, value in dotted.items():
            section, _, leaf = key.partition(".")
            if not leaf:
                cfg = replace(cfg, **{section: value})
            else:
                sub = replace(getattr(cfg, section), **{leaf: value})
                cfg = replace(cfg, **{section: sub})
        return cfg


def expand_grid(base: ExperimentConfig, grid: dict[str, list]) -> list[ExperimentConfig]:
    """Cartesian sweep over dotted-key value lists
    (the reference's --sweep JSON grids, train_transformer.py:578-617)."""
    keys = list(grid)
    out = []
    for combo in itertools.product(*(grid[k] for k in keys)):
        cfg = base.override(dict(zip(keys, combo)))
        tag = "_".join(f"{k.split('.')[-1]}{v}" for k, v in zip(keys, combo))
        out.append(replace(cfg, name=f"{base.name}_{tag}" if tag else base.name))
    return out
