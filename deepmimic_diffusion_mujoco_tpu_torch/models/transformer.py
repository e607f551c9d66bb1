"""MDM-style transformer-encoder denoiser (stack B's main model).

Counterpart of ``deepmimic_diffusion_mujoco_tpu/models/transformer.py``:

- ``MultiHeadAttention``: flax's ``nn.MultiHeadDotProductAttention``
  semantics: query/key/value/out projections with biases, the query
  scaled by 1/sqrt(dh) before q·kᵀ, masked logits set to
  ``finfo(float32).min`` (so a query whose keys are all masked attends
  uniformly instead of giving NaN), softmax, then dropout on the attention
  WEIGHTS with one keep mask broadcast over batch and heads;
- ``EncoderLayer``: post-norm, ReLU feed-forward with dropout on its
  hidden activations;
- ``AdaLNEncoderLayer``: pre-norm with adaLN-zero modulation (6·D from
  the class+time vector, zero-initialised);
- ``TransformerMotionModel``: pose embedding, MDM timestep MLP, learned
  position table, class embedding with its 2-layer SiLU MLP (label
  ``num_classes`` is the null label), ``conditioning`` add / adaln / both,
  the adaLN-zero final modulation and a key mask.

The attention is written out in float32 (no SDPA backend choice can
change its result, and the TF32-off policy covers its matmuls). Norms use
flax's eps 1e-6; Dense layers are initialised lecun-normal with zero
biases, the position table N(0, 1), the class table N(0, 1/D) and the
adaLN modulations zero, as flax initialises them, so that training from
scratch starts where JAX's does. ``convert.transformer_from_flax`` maps a
flax parameter tree onto this module.

Dropout (training mode, ``dropout > 0``) draws its keep masks from the
``generator`` passed to ``forward``, in the order flax draws them: per
layer, the attention weights' mask, then the feed-forward's.

Compute dtype (``dtype``; ``factory.build_model`` passes bf16 for a
``bf16=True`` config): parameters stay float32; under bf16 every Dense,
LayerNorm and embedding rounds where flax's ``dtype=bf16`` module does
(``models.precision``), and the attention computes as flax's
``MultiHeadDotProductAttention(dtype=bf16)``: the query divided by the
bf16 sqrt(dh), bf16 logits filled with ``finfo(bf16).min`` where masked,
the softmax and P V in bf16. The output is cast to float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils import seq as seqlib
from ..utils.rng import draw_rows
from . import precision as P
from .embeddings import mdm_timestep_embedding

EPS = 1e-6  # flax LayerNorm
CONDITIONING = ("add", "adaln", "both")


def keep_mask(shape, keep_prob: float, generator: torch.Generator | None,
              device: torch.device, rows: bool = True) -> torch.Tensor:
    """Bernoulli(keep_prob) keep mask of ``shape`` from ``generator``. With
    ``rows`` the leading axis is the batch: a data-parallel rank's
    generator draws it at the global batch (``utils.rng.draw_rows``)."""
    if generator is None:
        raise ValueError("dropout in training mode needs a torch.Generator")

    def draw(s):
        return torch.rand(s, generator=generator, device=generator.device)

    u = draw_rows(generator, shape, draw) if rows else draw(tuple(shape))
    return (u < keep_prob).to(device)


def _lecun_normal_(weight: torch.Tensor):
    """flax's lecun_normal: truncated normal on [-2, 2] std, variance 1/fan_in."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std)


def dense(d_in: int, d_out: int, zero: bool = False) -> nn.Linear:
    """A Linear initialised as flax's Dense (lecun-normal kernel, zero bias),
    or all zeros (adaLN-zero)."""
    layer = nn.Linear(d_in, d_out)
    with torch.no_grad():
        if zero:
            layer.weight.zero_()
        else:
            _lecun_normal_(layer.weight)
        layer.bias.zero_()
    return layer


class MultiHeadAttention(nn.Module):
    """Attention of (B, N, D) queries over (B, M, D) keys and values (the
    queries themselves unless ``memory`` is given) with flax's MHA
    semantics, ``heads`` heads over ``inner`` (flax's ``qkv_features``,
    default D) projected features. ``key_mask`` (B, M) and ``attn_mask``
    (N, M), True where a query may attend a key, each fill masked logits
    with ``finfo.min``. The head count is read off the projections' width,
    so a column-parallel split of query/key/value (``parallel.tp``) runs on
    its share of whole heads."""

    def __init__(self, dim: int, heads: int, dropout: float = 0.0, inner: int | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = dim if inner is None else inner
        self.heads, self.dim_head, self.dropout = heads, inner // heads, dropout
        self.dtype = dtype
        self.query, self.key, self.value = (dense(dim, inner) for _ in range(3))
        self.out = dense(inner, dim)

    def forward(self, x, key_mask=None, generator=None, memory=None, attn_mask=None):
        B, N, _ = x.shape
        dh = self.dim_head
        kv = x if memory is None else memory
        M = kv.shape[1]

        def split(t):
            return t.view(B, t.shape[1], -1, dh).transpose(1, 2)  # (B, h, n, dh)

        dt = self.dtype
        # flax divides by sqrt(dh) in the compute dtype
        root = math.sqrt(dh) if dt != P.BF16 else torch.tensor(math.sqrt(dh)).to(dt).item()
        q = split(P.linear(x, self.query, dt)) / root
        logits = q @ split(P.linear(kv, self.key, dt)).transpose(-1, -2)  # (B, h, N, M)
        big_neg = torch.finfo(P.BF16 if dt == P.BF16 else torch.float32).min
        if key_mask is not None:
            logits = logits.masked_fill(~key_mask[:, None, None, :], big_neg)
        if attn_mask is not None:
            logits = logits.masked_fill(~attn_mask, big_neg)
        w = P.softmax(logits, dim=-1)
        if self.training and self.dropout > 0.0:
            keep_prob = 1.0 - self.dropout
            keep = keep_mask((1, 1, N, M), keep_prob, generator, x.device, rows=False)
            w = w * (keep.to(w.dtype) / keep_prob)
        ctx = (w @ split(P.linear(kv, self.value, dt))).transpose(1, 2).reshape(B, N, -1)
        return P.linear(ctx, self.out, dt)


class FeedForward(nn.Module):
    """Dense -> ReLU -> dropout -> Dense."""

    def __init__(self, dim: int, hidden: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout, self.dtype = dropout, dtype
        self.dense_0, self.dense_1 = dense(dim, hidden), dense(hidden, dim)

    def forward(self, x, generator=None):
        h = F.relu(P.linear(x, self.dense_0, self.dtype))
        if self.training and self.dropout > 0.0:
            keep_prob = 1.0 - self.dropout
            keep = keep_mask(h.shape, keep_prob, generator, h.device)
            h = torch.where(keep, h / keep_prob, torch.zeros_like(h))
        return P.linear(h, self.dense_1, self.dtype)


class EncoderLayer(nn.Module):
    """Post-norm torch-style encoder layer."""

    def __init__(self, dim: int, heads: int, dim_feedforward: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.attn = MultiHeadAttention(dim, heads, dropout, dtype=dtype)
        self.norm_0 = nn.LayerNorm(dim, eps=EPS)
        self.ff = FeedForward(dim, dim_feedforward, dropout, dtype)
        self.norm_1 = nn.LayerNorm(dim, eps=EPS)

    def forward(self, x, key_mask=None, generator=None):
        x = P.layer_norm(x + self.attn(x, key_mask, generator), self.norm_0, self.dtype)
        return P.layer_norm(x + self.ff(x, generator), self.norm_1, self.dtype)


def _modulate(x, shift, scale, dtype=torch.float32):
    return P.layer_norm(x, None, dtype, eps=EPS) * (1.0 + scale) + shift


class AdaLNEncoderLayer(nn.Module):
    """Pre-norm encoder layer whose norms' scale and shift and whose
    residual gates come from the conditioning vector (adaLN-zero: the
    modulation starts at zero, so every layer starts as identity)."""

    def __init__(self, dim: int, heads: int, dim_feedforward: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.adaln_mod = dense(dim, 6 * dim, zero=True)
        self.attn = MultiHeadAttention(dim, heads, dropout, dtype=dtype)
        self.ff = FeedForward(dim, dim_feedforward, dropout, dtype)

    def forward(self, x, c, key_mask=None, generator=None):
        dt = self.dtype
        (sa_shift, sa_scale, sa_gate, ff_shift, ff_scale,
         ff_gate) = P.linear(P.silu(c), self.adaln_mod, dt)[:, None, :].chunk(6, dim=-1)
        x = x + sa_gate * self.attn(_modulate(x, sa_shift, sa_scale, dt), key_mask, generator)
        return x + ff_gate * self.ff(_modulate(x, ff_shift, ff_scale, dt), generator)


class TransformerMotionModel(nn.Module):
    """(B, T, input_dim), (B,) time, optional (B,) labels and (B, T) mask ->
    (B, T, input_dim). ``y`` is clipped to [0, num_classes]; ``y=None`` or
    ``y == num_classes`` selects the null label (CFG's unconditional
    branch). ``mask`` is 1 on valid frames: keys at padded frames are
    masked for every query."""

    def __init__(self, input_dim: int, latent_dim: int = 256, n_heads: int = 4,
                 num_layers: int = 8, dropout: float = 0.1, dim_feedforward: int = 1024,
                 max_sequence_length: int = 128, num_classes: int = 0,
                 conditioning: str = "add", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        if conditioning not in CONDITIONING:
            raise ValueError(f"unknown conditioning {conditioning!r}; expected one of "
                             f"{CONDITIONING}")
        D = latent_dim
        self.latent_dim, self.max_sequence_length = D, max_sequence_length
        self.num_classes, self.conditioning = num_classes, conditioning
        self.adaln = conditioning in ("adaln", "both")
        self.add_tokens = conditioning in ("add", "both")
        self.pose_embed = dense(input_dim, D)
        self.time_embed_0, self.time_embed_1 = dense(D, D), dense(D, D)
        self.position_embed = nn.Parameter(torch.randn(max_sequence_length, D))
        if num_classes > 0:
            self.class_embed = nn.Embedding(num_classes + 1, D)
            nn.init.normal_(self.class_embed.weight, 0.0, math.sqrt(1.0 / D))
            self.class_embed_0, self.class_embed_1 = dense(D, D), dense(D, D)
        layer = AdaLNEncoderLayer if self.adaln else EncoderLayer
        self.layers = nn.ModuleList([layer(D, n_heads, dim_feedforward, dropout, dtype)
                                     for _ in range(num_layers)])
        if self.adaln:
            self.final_mod = dense(D, 2 * D, zero=True)
        self.final_layer = dense(D, input_dim)

    def forward(self, x, time, y=None, mask=None, generator=None):
        B, T, _ = x.shape
        seqlib.refuse_split("the MDM transformer")
        if T > self.max_sequence_length:
            raise ValueError(
                f"horizon {T} exceeds max_seq_len {self.max_sequence_length}: the learned "
                f"position table has {self.max_sequence_length} rows (the JAX model fails the "
                "same way), so frames cannot exceed the config's model.max_seq_len")
        dt = self.dtype
        # float32, float64 for a reference forward; bf16 computes from float32 inputs
        dtype = self.pose_embed.weight.dtype
        h = P.linear(x.to(dtype), self.pose_embed, dt)
        t_emb = P.linear(P.silu(P.linear(
            mdm_timestep_embedding(time, self.latent_dim).to(dtype), self.time_embed_0, dt)),
            self.time_embed_1, dt)
        if self.add_tokens:
            h = h + t_emb[:, None, :]
        h = h + (P.cast(self.position_embed, dt) if dt == P.BF16
                 else self.position_embed)[None, :T]
        cond = t_emb
        if self.num_classes > 0:
            if y is None:
                y = torch.full((B,), self.num_classes, dtype=torch.long, device=x.device)
            c = P.embed(y.long().clamp(0, self.num_classes), self.class_embed, dt)
            c = P.linear(P.silu(P.linear(c, self.class_embed_0, dt)), self.class_embed_1, dt)
            if self.add_tokens:
                h = h + c[:, None, :]
            if self.adaln:
                cond = cond + c
        key_mask = None if mask is None else mask != 0
        for layer in self.layers:
            if self.adaln:
                h = layer(h, cond, key_mask, generator)
            else:
                h = layer(h, key_mask, generator)
        if self.adaln:
            f_shift, f_scale = P.linear(P.silu(cond), self.final_mod, dt)[:, None, :].chunk(2,
                                                                                       dim=-1)
            h = _modulate(h, f_shift, f_scale, dt)
        out = P.linear(h, self.final_layer, dt)
        return out.to(torch.float32) if dt == P.BF16 else out
