"""Windowed (block-local) attention transformer denoiser (PyTorch).

Counterpart of ``deepmimic_diffusion_mujoco_tpu/models/local_attention.py``:

- ``local_attention``: the plain bucketed windowed attention over
  (B, h, N, dh) tensors: look-around neighbourhoods, exact-window and causal
  masks, rotary at neighbourhood-relative positions with optional xpos,
  autopad, key masks, a DynamicPositionBias table, the trained-window mask
  override and attention dropout from an explicit ``torch.Generator``;
- ``LocalMHA``: pre-norm local multi-head attention. Its attention core is
  ``ops.fused_local_attention.fused_qkv_local_attention`` (the CUDA kernel on
  the card, its plain version on the CPU) whenever the kernel's semantics
  cover the call: no window override, no bias table, rotary on, xpos off and
  a chunk plan for N. Every other call takes ``local_attention``;
- ``GEGLUFeedForward``, ``DynamicPositionBias`` and ``LocalTransformer``
  with hyper-connection residual streams;
- ``GlobalMHA``: pre-norm full attention over the whole horizon (flax's
  ``MultiHeadDotProductAttention`` with a key mask, written out in f32 as
  ``models.transformer.MultiHeadAttention``), inserted before the local
  attention of the layers ``global_attn_layers`` names (1-based; empty
  means every layer) when ``use_global_attn`` is set. With
  hyper-connections each insert has its own width connection, slot
  ``2·depth + i``, so the other parameters keep their names;
- the KV-cache decode (causal models): ``init_decode_cache(batch)`` gives
  each layer a ring buffer of the last ``window_size`` PRE-rotary keys and
  values; ``forward(x, time, y, cache=..., decode_pos=p)`` on the newest
  frame returns ``(out, cache)``, with rotary at the buffer's fixed
  relative positions and slots older than the sequence start masked. It
  is plain tensor code: B3 has no single-query form.

Sequence-sharded sampling: under a horizon split (``utils.seq``; the
chain of ``sample_loop(..., x_sharding=...)``) ``LocalTransformer.forward``
takes this rank's frames (and ``mask``'s) and returns them. It adds the
``pos_emb`` rows at the rank's global offset and checks ``max_seq_len``
against the whole horizon. ``LocalMHA`` takes one window of each
neighbour's QKV rows (none past the trajectory's ends) and, on every call
its unsharded twin sends to B3, runs B3's halo entry
(``ops.fused_local_attention.local_attention_halo``, K3) with rotary at the
global positions and prefix lengths summed over the ranks; the bias-table,
xpos and window-override calls run ``local_attention`` on the same slab.
A ``GlobalMHA`` insert attends over the keys and values of the whole
horizon, gathered. The KV-cache decode refuses a split. Each rank's frames
equal the one-process forward's, with one exception under a ``mask``: a
padding frame whose window holds no valid key gets K3's mean of V over the
rank's slab, where unsharded B3 averages over its 128-row chunk and halo.
Sampling passes no mask.

Dropout (training mode, ``attn_dropout`` / ``ff_dropout`` > 0) draws its
keep masks from the ``generator`` passed to ``forward``, on the
generator's device, in the order flax draws them: per layer, the
attention's mask, then the feed-forward's. On the kernel route the
attention's mask is the kernel-layout keep mask
(``ops.fused_local_attention.dropout_keep_mask``) that B3 applies to its
probabilities; the bucketed path drops its probabilities in its own
layout, as the JAX package's jnp path does; a global insert's attention
weights get one mask broadcast over batch and heads, as flax's MHA does.
Norms use flax's eps 1e-6 and GELU is flax's tanh
approximation, so ``convert.local_transformer_from_flax`` weights
reproduce the JAX model.

Compute dtype (``dtype``; ``factory.build_model`` passes bf16 for a
``bf16=True`` config): parameters stay float32; under bf16 every Dense,
LayerNorm, RMSNorm and embedding rounds where flax's ``dtype=bf16`` module
does (``models.precision``), the attention core takes the bf16 QKV and
returns a bf16 context (B3's bf16 form: float32 inside, as the Pallas
kernel upcasts), the bucketed path computes in bf16 as JAX's jnp path does,
and the output is cast to float32. It trains at bf16 too: B3's bf16 entry
takes the attention's keep mask, its backward returns a bf16 gradient, and
the feed-forward's dropout divides in bf16 as flax's ``Dropout`` does. Under
a horizon split at bf16 the QKV slab goes to K3's bf16 form and a
``GlobalMHA`` insert attends over the gathered bf16 rows (the gather is
exact), so each rank rounds where the one-process forward rounds. The bf16
KV-cache decode keeps its ring buffers in bf16 and computes as JAX's
decode does: the rotary angles rounded to bf16, the rotation, the
scale, the scores and flax's softmax each rounded to bf16, and a bf16
out-projection.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import fused_local_attention as FK
from ..utils import seq as seqlib
from . import hyper_connections as hc_lib
from . import precision as P
from .embeddings import apply_rotary, mdm_timestep_embedding, rotary_angles, xpos_scale
from .transformer import MultiHeadAttention, keep_mask

NEG_INF = -1e9
EPS = 1e-6  # flax LayerNorm / RMSNorm


def _look_around(bx: torch.Tensor, backward: int, forward: int, pad_value: float = 0.0):
    """(..., nw, w, d) -> (..., nw, (backward+forward+1)*w, d): window i's
    neighbourhood is windows [i-backward, i+forward], out-of-range windows
    filled with ``pad_value``."""
    nw = bx.shape[-3]
    padded = F.pad(bx, (0, 0, 0, 0, backward, forward), value=pad_value)
    return torch.cat([padded[..., i:i + nw, :, :] for i in range(backward + forward + 1)],
                     dim=-2)


def local_attention(q, k, v, window_size: int, *, causal: bool = False,
                    look_backward: int = 1, look_forward: int | None = None,
                    exact_windowsize: bool = True, use_rotary: bool = True,
                    use_xpos: bool = False, xpos_scale_base: float | None = None,
                    key_mask=None, scale: float | None = None,
                    mask_window_size: int | None = None, bias_table=None,
                    attn_dropout: float = 0.0, generator: torch.Generator | None = None):
    """Windowed attention over (B, h, N, dh) tensors, bucketed. Dropout on the
    attention probabilities needs ``generator``. ``mask_window_size`` is the
    trained window when ``window_size`` overrides it."""
    if look_forward is None:
        look_forward = 0 if causal else 1
    B, h, N, dh = q.shape
    w = window_size
    dev = q.device
    pad = (-N) % w
    if pad:  # autopad: pad keys are valid zero keys
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        if key_mask is not None:
            key_mask = F.pad(key_mask.to(torch.float32), (0, pad))
    n = N + pad
    nw = n // w
    scale = dh ** -0.5 if scale is None else scale

    bq = q.reshape(B, h, nw, w, dh) * scale
    bk = _look_around(k.reshape(B, h, nw, w, dh), look_backward, look_forward)
    bv = _look_around(v.reshape(B, h, nw, w, dh), look_backward, look_forward)
    jw = (look_backward + look_forward + 1) * w

    if use_rotary:
        # neighbourhood positions [0, jw); queries sit at the last w of them
        ang = rotary_angles(jw, dh, device=dev).to(q.dtype)
        if use_xpos:
            sb = xpos_scale_base if xpos_scale_base is not None else w // 2
            sc = xpos_scale(jw, dh, sb, device=dev).to(q.dtype)
            sc2 = torch.cat([sc, sc], dim=-1)
            bq = apply_rotary(bq, ang[-w:]) * sc2[-w:]
            bk = apply_rotary(bk, ang) * sc2 ** -1
        else:
            bq = apply_rotary(bq, ang[-w:])
            bk = apply_rotary(bk, ang)

    # positions for masking, sentinel -1 for out-of-range windows (numpy)
    t_pos = np.arange(n).reshape(nw, w)
    padded = np.concatenate([np.full((look_backward, w), -1, np.int64), t_pos,
                             np.full((look_forward, w), -1, np.int64)], axis=0)
    j_pos = np.concatenate([padded[i:i + nw] for i in range(look_backward + look_forward + 1)],
                           axis=-1)  # (nw, jw)
    ti, tj = t_pos[:, :, None], j_pos[:, None, :]
    neg = tj < 0
    mw = mask_window_size if mask_window_size is not None else w
    if causal:
        bad = ti < tj
        if exact_windowsize:
            bad |= ti > tj + mw * look_backward
    elif exact_windowsize:
        bad = (tj - mw * look_forward > ti) | (ti > tj + mw * look_backward)
    else:
        bad = np.zeros_like(neg)
    mask = torch.from_numpy(bad | neg).to(dev)[None, None]  # (1, 1, nw, w, jw)

    sim = torch.einsum("bhnie,bhnje->bhnij", bq, bk)
    if bias_table is not None:
        # bias_table (n_dist, h) indexed by |i - j|
        dist = np.minimum(np.abs(ti - tj), bias_table.shape[0] - 1)
        bias = bias_table[torch.from_numpy(dist).to(dev)]           # (nw, w, jw, h)
        sim = sim + bias.movedim(-1, 0)[None]
    sim = sim.masked_fill(mask, NEG_INF)
    if key_mask is not None:
        km = _look_around(key_mask.to(torch.float32).reshape(B, nw, w, 1), look_backward,
                          look_forward, pad_value=0.0)[..., 0]       # (B, nw, jw)
        sim = sim.masked_fill(km[:, None, :, None, :] <= 0, NEG_INF)
    attn = P.softmax(sim, dim=-1)
    if attn_dropout > 0.0:
        keep = keep_mask(attn.shape, 1.0 - attn_dropout, generator, dev)
        attn = attn * keep / (1.0 - attn_dropout)
    out = torch.einsum("bhnij,bhnje->bhnie", attn, bv)
    return out.reshape(B, h, n, dh)[:, :, :N]


class LocalMHA(nn.Module):
    """Pre-norm local multi-head attention."""

    def __init__(self, dim: int, window_size: int, heads: int = 8, dim_head: int = 64,
                 causal: bool = False, exact_windowsize: bool = True, use_xpos: bool = False,
                 xpos_scale_base: float | None = None, use_rotary: bool = True,
                 attn_dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.window_size, self.heads, self.dim_head = window_size, heads, dim_head
        self.causal, self.exact_windowsize = causal, exact_windowsize
        self.use_xpos, self.xpos_scale_base, self.use_rotary = use_xpos, xpos_scale_base, use_rotary
        self.attn_dropout = attn_dropout
        self.norm = nn.LayerNorm(dim, eps=EPS)
        self.to_qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_out = nn.Linear(heads * dim_head, dim, bias=False)

    def uses_kernel(self, N: int, window_size: int | None = None, bias_table=None) -> bool:
        """Whether a call at length N goes through the fused attention entry."""
        return (window_size is None and bias_table is None and self.use_rotary
                and not self.use_xpos
                and FK.supports(N, self.window_size, self.use_xpos, self.causal))

    def forward(self, x, key_mask=None, window_size=None, bias_table=None, generator=None,
                cache=None, decode_pos=None, seq=None, lengths=None):
        """``cache`` (k, v), each (B, h, w, dh): decode the single frame
        ``x`` (B, 1, D) at sequence position ``decode_pos`` -> (out, cache).
        ``seq`` (a ``utils.seq`` shard): ``x`` and ``key_mask`` are this
        rank's frames of a horizon split, ``lengths`` the whole key mask's
        (B,) valid frames."""
        B, N, _ = x.shape
        h, dh = self.heads, self.dim_head
        dropout = self.attn_dropout if self.training else 0.0
        dt = self.dtype
        qkv = P.linear(P.layer_norm(x, self.norm, dt), self.to_qkv, dt)
        if cache is not None:
            return self._decode(qkv, cache, decode_pos)
        if seq is not None:
            return P.linear(self._sharded(qkv, key_mask, window_size, bias_table, seq, lengths),
                            self.to_out, dt)
        if self.uses_kernel(N, window_size, bias_table):
            keep = None
            if dropout > 0.0:
                if generator is None:
                    raise ValueError("attention dropout in training mode needs a torch.Generator")
                keep = FK.dropout_keep_mask(generator, 1.0 - dropout, B, N, h, self.window_size,
                                            self.causal)
            out = FK.fused_qkv_local_attention(qkv, h, dh, self.window_size, self.causal,
                                               self.exact_windowsize, True, key_mask, keep,
                                               1.0 - dropout)
        else:
            q, k, v = qkv.reshape(B, N, 3, h, dh).permute(2, 0, 3, 1, 4)  # (B, h, N, dh) each
            out = local_attention(
                q, k, v, window_size if window_size is not None else self.window_size,
                causal=self.causal, exact_windowsize=self.exact_windowsize,
                use_rotary=self.use_rotary, use_xpos=self.use_xpos,
                # the xpos scale base is anchored to the trained window
                xpos_scale_base=(self.xpos_scale_base if self.xpos_scale_base is not None
                                 else self.window_size // 2),
                key_mask=key_mask, mask_window_size=self.window_size, bias_table=bias_table,
                attn_dropout=dropout, generator=generator,
            ).transpose(1, 2).reshape(B, N, h * dh)
        return P.linear(out, self.to_out, dt)

    def _sharded(self, qkv, key_mask, window_size, bias_table, seq, lengths):
        """This rank's context rows: its QKV rows with one window of each
        neighbour's (``exchange_halo``; none past the trajectory's ends,
        none after when causal), through K3 where the whole horizon's call
        would take B3, else through ``local_attention`` on the slab."""
        B, n, _ = qkv.shape
        h, dh = self.heads, self.dim_head
        w = window_size if window_size is not None else self.window_size
        if n % w:
            raise ValueError(f"a horizon split of {n} frames a rank needs whole windows of {w}")
        rows, q0, pos0 = FK.halo_slab(qkv, w, self.causal, seq)
        if self.uses_kernel(n * seq.world, window_size, bias_table):
            lens = None if lengths is None else FK.halo_lengths(lengths, pos0, rows.shape[1])
            return FK.local_attention_halo(rows, h, dh, w, q0, n, pos0, self.causal,
                                           self.exact_windowsize, True, lens)
        km = (None if key_mask is None
              else FK.halo_slab(key_mask.to(torch.float32), w, self.causal, seq)[0])
        q, k, v = rows.reshape(B, rows.shape[1], 3, h, dh).permute(2, 0, 3, 1, 4)
        out = local_attention(
            q, k, v, w, causal=self.causal, exact_windowsize=self.exact_windowsize,
            use_rotary=self.use_rotary, use_xpos=self.use_xpos,
            xpos_scale_base=(self.xpos_scale_base if self.xpos_scale_base is not None
                             else self.window_size // 2),
            key_mask=km, mask_window_size=self.window_size, bias_table=bias_table)
        return out[:, :, q0:q0 + n].transpose(1, 2).reshape(B, n, h * dh)

    def _decode(self, qkv, cache, decode_pos):
        """One causal step over the ring buffer: the L = w + 1 keys are the
        cached w and the new one, the new query sits at relative position
        L - 1, and slots before the sequence start are masked."""
        if not (self.causal and self.exact_windowsize and self.use_rotary
                and not self.use_xpos) or qkv.shape[1] != 1:
            raise ValueError("the KV-cache decode takes one frame of a causal model with "
                             "exact windows and rotary (no xpos)")
        B, h, dh = qkv.shape[0], self.heads, self.dim_head
        q, k, v = qkv.reshape(B, 3, h, 1, dh).unbind(1)           # (B, h, 1, dh) each
        k_buf = torch.cat([cache[0], k], dim=2)                   # (B, h, L, dh)
        v_buf = torch.cat([cache[1], v], dim=2)
        L = k_buf.shape[2]
        ang = rotary_angles(L, dh, device=qkv.device).to(qkv.dtype)
        qr = apply_rotary(q, ang[L - 1:L]) * P.scalar(dh ** -0.5, qkv.dtype)
        sim = qr @ apply_rotary(k_buf, ang).transpose(-1, -2)      # (B, h, 1, L)
        valid = torch.arange(L, device=qkv.device) >= L - 1 - decode_pos
        attn = P.softmax(sim.masked_fill(~valid, NEG_INF), dim=-1)
        out = (attn @ v_buf).transpose(1, 2).reshape(B, 1, h * dh)
        return P.linear(out, self.to_out, self.dtype), (k_buf[:, :, 1:], v_buf[:, :, 1:])


class GlobalMHA(nn.Module):
    """Pre-norm full attention over the whole horizon: LayerNorm, then
    flax's ``MultiHeadDotProductAttention`` (``heads`` x ``dim_head``
    features, biases) with padded keys masked for every query."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(dim, eps=EPS)
        self.attn = MultiHeadAttention(dim, heads, dropout, inner=heads * dim_head, dtype=dtype)

    def forward(self, x, key_mask=None, generator=None, seq=None):
        """``seq``: x and key_mask are this rank's frames of a horizon split;
        its queries attend over every rank's keys and values."""
        normed = P.layer_norm(x, self.norm, self.dtype)
        if seq is None:
            return self.attn(normed, None if key_mask is None else key_mask > 0, generator)
        mask = None if key_mask is None else seq.gather_horizon(key_mask.to(torch.float32)) > 0
        return self.attn(normed, mask, generator, memory=seq.gather_horizon(normed))


class GEGLUFeedForward(nn.Module):
    """Pre-norm GEGLU MLP: inner = int(dim * mult * 2/3), gated by GELU
    (tanh), with dropout between the gate and the down-projection."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = int(dim * mult * 2 / 3)
        self.dropout, self.dtype = dropout, dtype
        self.norm = nn.LayerNorm(dim, eps=EPS)
        self.proj_in = nn.Linear(dim, 2 * inner, bias=False)
        self.proj_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x, generator=None):
        dt = self.dtype
        a, g = P.linear(P.layer_norm(x, self.norm, dt), self.proj_in, dt).chunk(2, dim=-1)
        h = a * P.gelu_tanh(g)
        if self.training and self.dropout > 0.0:
            keep_prob = 1.0 - self.dropout
            keep = keep_mask(h.shape, keep_prob, generator, h.device)
            h = torch.where(keep, h / keep_prob, torch.zeros_like(h))
        return P.linear(h, self.proj_out, dt)


class DynamicPositionBias(nn.Module):
    """Relative-distance MLP bias: Linear(1->dim) SiLU Linear(dim->dim) SiLU
    Linear(dim->heads) on integer distances -> (n_dist, heads)."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dense = nn.ModuleList([nn.Linear(1, dim), nn.Linear(dim, dim), nn.Linear(dim, heads)])

    def forward(self, n_dist: int):
        d = torch.arange(n_dist, dtype=torch.float32, device=self.dense[0].weight.device)[:, None]
        h = P.silu(P.linear(d, self.dense[0], self.dtype))
        h = P.silu(P.linear(h, self.dense[1], self.dtype))
        return P.linear(h, self.dense[2], self.dtype)


class LocalTransformer(nn.Module):
    """Stack-B local-attention denoiser: (B, N, input_dim), (B,) time,
    optional (B,) class labels -> (B, N, input_dim). Submodule names follow
    flax's, see ``convert.local_transformer_from_flax``."""

    def __init__(self, input_dim: int, max_seq_len: int = 128, dim: int = 512, depth: int = 6,
                 heads: int = 8, dim_head: int = 64, window_size: int = 16,
                 causal: bool = False, ff_mult: int = 4, use_xpos: bool = False,
                 num_classes: int = 0, num_residual_streams: int = 4,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 use_dynamic_pos_bias: bool = False, use_global_attn: bool = False,
                 global_attn_layers: tuple = (), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.causal, self.dtype = causal, dtype
        self.input_dim, self.max_seq_len, self.dim = input_dim, max_seq_len, dim
        self.depth, self.window_size = depth, window_size
        self.num_classes = num_classes
        self.num_residual_streams = num_residual_streams
        self.use_dynamic_pos_bias = use_dynamic_pos_bias
        self.pose_embed = nn.Linear(input_dim, dim)
        self.time_embed_0 = nn.Linear(dim, dim)
        self.time_embed_1 = nn.Linear(dim, dim)
        self.pos_emb = nn.Parameter(torch.randn(max_seq_len, dim))
        self.class_embed = nn.Embedding(num_classes + 1, dim) if num_classes > 0 else None
        self.dynamic_pos_bias = (DynamicPositionBias(dim // 2, heads, dtype)
                                 if use_dynamic_pos_bias else None)
        self.attn = nn.ModuleList([
            LocalMHA(dim, window_size, heads, dim_head, causal=causal, use_xpos=use_xpos,
                     use_rotary=not use_dynamic_pos_bias, attn_dropout=attn_dropout,
                     dtype=dtype)
            for _ in range(depth)])
        self.ff = nn.ModuleList([GEGLUFeedForward(dim, ff_mult, ff_dropout, dtype)
                                 for _ in range(depth)])
        # global inserts before the local attention of these 0-based layers
        self.global_layers = (sorted(i - 1 for i in (global_attn_layers or range(1, depth + 1)))
                              if use_global_attn else [])
        self.global_attn = nn.ModuleDict({str(i): GlobalMHA(dim, heads, dim_head, attn_dropout,
                                                            dtype)
                                          for i in self.global_layers})
        S = num_residual_streams
        if S > 1:
            # width connections of the attention / FF branches: layer indices 2i, 2i+1;
            # the global inserts' after them, 2 depth + i
            self.hc_attn = nn.ModuleList([hc_lib.HyperConnection(dim, S, 2 * i, dtype)
                                          for i in range(depth)])
            self.hc_ff = nn.ModuleList([hc_lib.HyperConnection(dim, S, 2 * i + 1, dtype)
                                        for i in range(depth)])
            self.hc_global = nn.ModuleDict({str(i): hc_lib.HyperConnection(dim, S, 2 * depth + i,
                                                                           dtype)
                                            for i in self.global_layers})
        self.norm = nn.LayerNorm(dim, eps=EPS)
        self.final_layer = nn.Linear(dim, input_dim)

    def init_decode_cache(self, batch: int) -> tuple:
        """Empty per-layer (k, v) ring buffers, each (batch, h, w, dh) in the
        compute dtype, for the KV-cache decode (look-back one window)."""
        mha = self.attn[0]
        shape = (batch, mha.heads, self.window_size, mha.dim_head)
        return tuple((self.pos_emb.new_zeros(shape, dtype=self.dtype),
                      self.pos_emb.new_zeros(shape, dtype=self.dtype))
                     for _ in range(self.depth))

    def forward(self, x, time=None, y=None, mask=None, window_size=None, cache=None,
                decode_pos=None, generator=None):
        """``generator`` feeds the dropout keep masks in training mode. With
        ``cache`` (``init_decode_cache``; a causal model without global
        inserts) ``x`` is the newest frame (B, 1, D) at sequence position
        ``decode_pos``, and the result is ``(out, cache)``."""
        B, N, _ = x.shape
        decoding = cache is not None
        seq = seqlib.active()
        if decoding and (N != 1 or not self.causal or self.global_layers):
            raise ValueError("the KV-cache decode takes one frame at a time, of a causal "
                             "model without global-attention inserts")
        if seq is not None:
            self._check_sharded(decoding)
        total = N * (seq.world if seq is not None else 1)  # the whole horizon
        if total > self.max_seq_len:
            raise ValueError(
                f"horizon {total} exceeds max_seq_len {self.max_seq_len}: the learned position "
                f"table has {self.max_seq_len} rows (the JAX model fails the same way), so "
                "frames cannot exceed the config's model.max_seq_len")
        dt = self.dtype
        h = P.linear(x.to(torch.float32), self.pose_embed, dt)
        if time is not None:
            t = mdm_timestep_embedding(time, self.dim)
            t = P.linear(P.silu(P.linear(t, self.time_embed_0, dt)), self.time_embed_1, dt)
            h = h + t[:, None, :]
        first = seq.rank * N if seq is not None else 0  # this rank's first frame
        pos = P.cast(self.pos_emb, dt) if dt == P.BF16 else self.pos_emb
        h = h + (pos[decode_pos][None, None] if decoding else pos[None, first:first + N])
        lengths = None
        if seq is not None and mask is not None:  # valid frames over the whole horizon
            lengths = seq.all_reduce((mask > 0).sum(dim=1))
        if self.class_embed is not None:
            if y is None:
                y = torch.full((B,), self.num_classes, dtype=torch.long, device=x.device)
            h = h + P.embed(y.long().clamp(0, self.num_classes), self.class_embed, dt)[:, None, :]

        bias_table = None
        if self.dynamic_pos_bias is not None:
            # every distance a look-around neighbourhood of the runtime window can give
            bias_table = self.dynamic_pos_bias(2 * (window_size or self.window_size))

        use_hc = self.num_residual_streams > 1
        if use_hc:
            h = hc_lib.expand_streams(h, self.num_residual_streams)
        new_cache = []

        def attend(i, z):
            if not decoding:
                return self.attn[i](z, key_mask=mask, window_size=window_size,
                                    bias_table=bias_table, generator=generator, seq=seq,
                                    lengths=lengths)
            out, kv = self.attn[i](z, cache=cache[i], decode_pos=decode_pos)
            new_cache.append(kv)
            return out

        for i in range(self.depth):
            g = str(i)
            if g in self.global_attn:
                h = self._branch(h, self.hc_global[g] if use_hc else None,
                                 lambda z: self.global_attn[g](z, mask, generator, seq))
            h = self._branch(h, self.hc_attn[i] if use_hc else None, lambda z: attend(i, z))
            h = self._branch(h, self.hc_ff[i] if use_hc else None,
                             lambda z: self.ff[i](z, generator))
        if use_hc:
            h = hc_lib.reduce_streams(h)
        out = P.linear(P.layer_norm(h, self.norm, dt), self.final_layer, dt).to(torch.float32)
        return (out, tuple(new_cache)) if decoding else out

    def _check_sharded(self, decoding: bool):
        """Refuse what the horizon-sharded forward does not take."""
        if decoding:
            raise ValueError("the KV-cache decode does not run under a horizon split: it "
                             "decodes one frame at a time on one rank")
        if self.training or (torch.is_grad_enabled()
                             and any(p.requires_grad for p in self.parameters())):
            raise RuntimeError("the horizon-sharded LocalTransformer serves sampling only: run "
                               "it in eval mode under torch.no_grad or torch.inference_mode "
                               "(JAX shards no training over the horizon)")

    @staticmethod
    def _branch(h, hc, fn):
        """A residual branch: plain, or wrapped by the hyper-connection ``hc``."""
        if hc is None:
            return h + fn(h)
        hin, res, beta = hc(h)
        return hc_lib.depth_connection(fn(hin), res, beta)
