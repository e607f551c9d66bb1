"""Decoder-style transformer denoiser with learned sequence queries.

Counterpart of ``deepmimic_diffusion_mujoco_tpu/models/transformer_decoder.py``
(the tuning model of ``experiments/decoder10k``: dim 256, 4 heads, 4
layers, trained with the angle + velocity loss):

- input Linear plus the fixed interleaved sin/cos positional encoding
  (``fixed_positional_encoding``, computed in float64 numpy);
- ``ConvBranch``: two k3 "same" Conv1d over time, ReLU between (and after,
  for the input branch), added to its input;
- the time embedding: sinusoidal MLP plus a learned per-timestep table
  (``learned_time_embed``, flax's ``nn.Embed``);
- learned per-frame queries ``seq_queries`` (horizon rows, sliced to the
  call's L) plus the time embedding as the decoder's target;
- ``DecoderLayer``: a post-norm torch-style decoder layer built from flax's
  MHA (``models.transformer.MultiHeadAttention``: biases, the query scaled
  by 1/sqrt(dh), masked logits filled with ``finfo.min``): causal
  self-attention over the target, cross-attention to the encoded sequence,
  a GELU (tanh) feed-forward of 2·dim, LayerNorm eps 1e-6 after each;
- a ConvBranch refinement and the output Linear.

Activations stay (B, L, D); the convolutions run channel-first inside
``ConvBranch``. ``convert.decoder_from_flax`` maps a flax parameter tree
onto this module. The model has no dropout.

Compute dtype (``dtype``; ``factory.build_model`` passes bf16 for a
``bf16=True`` config): parameters stay float32; under bf16 the Dense and
conv layers, the LayerNorms, the time table and the attention round where
flax's ``dtype=bf16`` modules do (``models.precision``,
``models.transformer.MultiHeadAttention``), the encoding and the queries
are cast to bf16 before they are added, and the output is cast to float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils import seq as seqlib
from . import precision as P
from .embeddings import sinusoidal_pos_emb
from .transformer import EPS, MultiHeadAttention, _lecun_normal_, dense


def fixed_positional_encoding(length: int, dim: int) -> np.ndarray:
    """(length, dim) float32 interleaved sin/cos encoding, computed in float64."""
    position = np.arange(length)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, dim, 2) * (-np.log(10000.0) / dim))
    pe = np.zeros((length, dim), np.float32)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


class DecoderLayer(nn.Module):
    """Post-norm decoder layer: self-attention (with ``tgt_mask``), then
    cross-attention to ``memory``, then the GELU feed-forward."""

    def __init__(self, dim: int, heads: int, dim_feedforward: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.self_attn = MultiHeadAttention(dim, heads, dtype=dtype)
        self.norm_0 = nn.LayerNorm(dim, eps=EPS)
        self.cross_attn = MultiHeadAttention(dim, heads, dtype=dtype)
        self.norm_1 = nn.LayerNorm(dim, eps=EPS)
        self.dense_0, self.dense_1 = dense(dim, dim_feedforward), dense(dim_feedforward, dim)
        self.norm_2 = nn.LayerNorm(dim, eps=EPS)

    def forward(self, tgt, memory, tgt_mask=None):
        dt = self.dtype
        x = P.layer_norm(tgt + self.self_attn(tgt, attn_mask=tgt_mask), self.norm_0, dt)
        x = P.layer_norm(x + self.cross_attn(x, memory=memory), self.norm_1, dt)
        h = P.linear(P.gelu_tanh(P.linear(x, self.dense_0, dt)), self.dense_1, dt)
        return P.layer_norm(x + h, self.norm_2, dt)


class ConvBranch(nn.Module):
    """k3 "same" Conv1d stack over time on (B, L, D): ReLU after every conv
    but the last, and after the last too with ``final_relu``."""

    def __init__(self, dim: int, layers: int = 2, final_relu: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.final_relu, self.dtype = final_relu, dtype
        self.convs = nn.ModuleList([nn.Conv1d(dim, dim, 3, padding=1) for _ in range(layers)])
        with torch.no_grad():  # flax's Conv init: lecun-normal over (k, Cin), zero bias
            for conv in self.convs:
                _lecun_normal_(conv.weight.view(dim, -1))
                conv.bias.zero_()

    def forward(self, x):
        x = x.transpose(1, 2)
        for i, conv in enumerate(self.convs):
            x = P.conv1d(x, conv, self.dtype)
            if self.final_relu or i < len(self.convs) - 1:
                x = F.relu(x)
        return x.transpose(1, 2)


class TransformerDecoderMotionModel(nn.Module):
    """(B, L, transition_dim), (B,) time -> (B, L, transition_dim); L at
    most ``horizon`` (the rows of ``seq_queries``). ``y`` is accepted and
    ignored, like the JAX model."""

    def __init__(self, horizon: int, transition_dim: int, dim: int = 512, n_heads: int = 8,
                 num_layers: int = 8, n_timesteps: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.horizon, self.dim, self.dtype = horizon, dim, dtype
        # the encoding's rows for every L the query table allows, made once
        self.register_buffer("pe", torch.from_numpy(fixed_positional_encoding(horizon, dim)),
                             persistent=False)
        self.input_process = dense(transition_dim, dim)
        self.conv_local = ConvBranch(dim, 2, final_relu=True, dtype=dtype)
        self.embed_timestep_0, self.embed_timestep_1 = dense(dim, dim), dense(dim, dim)
        self.learned_time_embed = nn.Embedding(n_timesteps, dim)
        nn.init.normal_(self.learned_time_embed.weight, 0.0, math.sqrt(1.0 / dim))
        self.seq_queries = nn.Parameter(torch.randn(horizon, dim))
        self.layers = nn.ModuleList([DecoderLayer(dim, n_heads, 2 * dim, dtype)
                                     for _ in range(num_layers)])
        self.spatial_attn = ConvBranch(dim, 2, final_relu=False, dtype=dtype)
        self.output_process = dense(dim, transition_dim)

    def forward(self, x, time, y=None):
        del y
        B, L, _ = x.shape
        seqlib.refuse_split("the decoder")
        if L > self.horizon:
            raise ValueError(
                f"horizon {L} exceeds max_seq_len {self.horizon}: seq_queries has "
                f"{self.horizon} rows (the JAX model fails the same way), so frames cannot "
                "exceed the config's model.max_seq_len")
        dt = self.dtype
        # float32, float64 for a reference forward; bf16 computes from float32 inputs
        dtype = self.input_process.weight.dtype
        h = P.linear(x.to(dtype), self.input_process, dt)
        h = h + self.pe[None, :L].to(dt if dt == P.BF16 else dtype)
        h = h + self.conv_local(h)

        t_emb = sinusoidal_pos_emb(time, self.dim).to(dtype)
        t_emb = P.linear(P.silu(P.linear(t_emb, self.embed_timestep_0, dt)),
                         self.embed_timestep_1, dt)
        t_emb = t_emb + P.embed(time.long(), self.learned_time_embed, dt)

        queries = P.cast(self.seq_queries, dt) if dt == P.BF16 else self.seq_queries
        tgt = queries[None, :L] + t_emb[:, None, :]
        causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        for layer in self.layers:
            tgt = layer(tgt, h, causal)
        tgt = tgt + self.spatial_attn(tgt)
        out = P.linear(tgt, self.output_process, dt)
        return out.to(torch.float32) if dt == P.BF16 else out
