"""Temporal 1-D U-Net denoiser (PyTorch).

Counterpart of ``deepmimic_diffusion_mujoco_tpu/models/temporal_unet.py``:

- activations stay (B, H, C) channel-last, the model boundary and the conv
  block kernel's layout; 1x1 convolutions are ``nn.Linear`` over channels,
- Conv1dBlock = Conv(k=5) -> GroupNorm(8) -> Mish, one fused call
  (``ops.conv_block_kernel.conv_gn_mish``: the CUDA kernel on the card, the
  plain version on the CPU),
- ResidualTemporalBlock adds a time-MLP bias between its two conv blocks,
- optional per-resolution LinearAttention behind a channel LayerNorm,
- Downsample: stride-2 conv k3; Upsample: transposed conv k4 s2,
- fully convolutional over the horizon: any H divisible by
  2**(len(dim_mults)-1).

Sequence-sharded sampling: under a horizon split (``utils.seq``: the chain
of ``sample_loop(..., x_sharding=...)``) ``TemporalUnet.forward`` takes this
rank's frames and returns them, equal to the same frames of the whole
horizon's forward. Each conv block takes a k // 2-row halo from its
neighbours and goes through B1's sharded form
(``ops.conv_block_kernel.conv_gn_mish_sharded``: conv + local statistics,
then the statistics merged over the ranks, normalise + Mish and the
residual block's time-term or residual add in one K2); the stride-2
downsample takes one row from the left, the transposed-conv upsample one
row from each side and crops; LinearAttention's key softmax takes its max
and sum over the whole horizon and its (d x d) context is summed over the
ranks. The 1x1 convs and the time MLP stay local. At bf16 the split rounds
where the one-process forward does: the conv blocks take B1's sharded form
at bf16, the strided and transposed convs round as ``models.precision``'s,
and LinearAttention reduces float32 partial sums over the ranks and rounds
the softmax's sum and the context once each.

Submodules are created in the order flax numbers its auto-named children,
so ``convert.temporal_unet_from_flax`` maps parameters by a fixed table:
``res_blocks.i`` is ``ResidualTemporalBlock_i``, ``attentions.i`` is
``PreNormResidualAttention_i``, ``downsamples.i`` is ``Conv_i``,
``upsamples.i`` is ``ConvTranspose_i``, ``time_mlp.i`` is ``Dense_i``.

Compute dtype (``dtype``, ``factory.build_model`` passes bf16 for a
``bf16=True`` config): parameters stay float32; under bf16 the input is cast
to bf16 and every Dense, conv and conv block computes in bf16 as flax's
``dtype=bf16`` modules do (``models.precision``), each conv block through
B1's bf16 form (bf16 x and w, float32 bias, GroupNorm and Mish inside, a
bf16 output: the Pallas form, ``use_pallas=True``), and the output is cast
back to float32. The strided downsample and the transposed-conv upsample
stay library convolutions at bf16, as XLA computes them outside any kernel
in the JAX package. The model trains at bf16 too: each conv block's backward
is B1's bf16 backward (its dW through B2's bf16 form), and each parameter's
gradient arrives float32 through the backward of its bf16 cast.

``ValueFunction`` is the U-Net's down path and mid blocks with stride-2
downsamples, flattened into a Dense head over ``concat([x, t])``: one
value per trajectory, which ``diffusion/guidance.py`` climbs. Its 20 conv
blocks are the same fused call, so on the card each is the B1 kernel.
Since the head's width depends on the horizon, the port builds it for one
``horizon`` (flax infers it at init); ``convert.value_function_from_flax``
maps its parameters.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..ops.conv_block_kernel import conv_gn_mish, conv_gn_mish_sharded
from ..utils import seq as seqlib
from . import precision as P
from .embeddings import sinusoidal_pos_emb


mish = P.mish


class Conv1dBlock(nn.Module):
    """Conv1d("same") -> GroupNorm -> Mish. ``weight`` is held in the
    kernel's (k, Cin, Cout) layout, the flax kernel's own."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 5,
                 n_groups: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_groups, self.dtype = n_groups, dtype
        self.weight = nn.Parameter(
            torch.randn(kernel_size, in_channels, out_channels)
            * (kernel_size * in_channels) ** -0.5
        )
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.gn_weight = nn.Parameter(torch.ones(out_channels))
        self.gn_bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x, seq=None, add=None):  # (B, H, Cin) -> (B, H, Cout)
        """Under a horizon split ``add`` (None, a (B, Cout) row over every row
        or a (B, H, Cout) tensor, in the block's dtype) is added to the
        output in the same K2 launch."""
        if self.dtype == P.BF16:  # bf16 x and w, float32 bias, scale and shift
            x, w = x.to(P.BF16), P.cast(self.weight, P.BF16)
        else:
            w = self.weight
        if seq is None:
            if add is not None:
                raise ValueError("Conv1dBlock takes an addend under a horizon split only")
            return conv_gn_mish(x, w, self.bias, self.gn_weight, self.gn_bias, self.n_groups)
        pad = self.weight.shape[0] // 2
        before, after, _ = seq.exchange_halo(x, pad, pad)
        return conv_gn_mish_sharded(torch.cat([before, x, after], dim=1), w, self.bias,
                                    self.gn_weight, self.gn_bias, self.n_groups, 1e-5, seq,
                                    add=add)


class LinearAttention(nn.Module):
    """Softmax-kernel linear attention: keys softmaxed over the horizon, a
    (d x d) context per head, then queried."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        hidden = heads * dim_head
        self.to_qkv = nn.Linear(dim, hidden * 3, bias=False)
        self.to_out = nn.Linear(hidden, dim)

    def forward(self, x, seq=None):  # (B, H, C)
        B, H, _ = x.shape
        qkv = P.linear(x, self.to_qkv, self.dtype).reshape(B, H, 3, self.heads, self.dim_head)
        q, k, v = qkv.unbind(2)  # (B, H, h, d)
        q = q * self.dim_head ** -0.5
        if seq is None:
            k = P.softmax(k, dim=1)  # over the horizon
            context = torch.einsum("bnhd,bnhe->bhde", k, v)
        else:  # the softmax's max and sum, and the context, over every rank's frames:
            # float32 partial sums, reduced, then rounded once (as the one-process sum and
            # product round at bf16)
            e = (k - seq.all_reduce(k.amax(dim=1, keepdim=True), "max")).exp()
            k = e / seq.all_reduce(e.sum(dim=1, keepdim=True, dtype=torch.float32)).to(e.dtype)
            context = seq.all_reduce(torch.einsum("bnhd,bnhe->bhde", k.float(),
                                                  v.float())).to(k.dtype)
        out = torch.einsum("bhde,bnhd->bnhe", context, q)
        return P.linear(out.reshape(B, H, self.heads * self.dim_head), self.to_out, self.dtype)


class PreNormResidualAttention(nn.Module):
    """x + LinearAttention(LayerNorm_channels(x)), biased variance, eps 1e-5."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, 1, dim))
        self.b = nn.Parameter(torch.zeros(1, 1, dim))
        self.attn = LinearAttention(dim, heads, dim_head, dtype)

    def forward(self, x, seq=None):
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        normed = (x - mean) / torch.sqrt(var + 1e-5) * self.g + self.b
        return x + self.attn(normed, seq)


class ResidualTemporalBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, embed_dim: int,
                 kernel_size: int = 5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.blocks = nn.ModuleList([
            Conv1dBlock(in_channels, out_channels, kernel_size, dtype=dtype),
            Conv1dBlock(out_channels, out_channels, kernel_size, dtype=dtype),
        ])
        self.time_dense = nn.Linear(embed_dim, out_channels)
        self.residual = (nn.Linear(in_channels, out_channels)
                         if in_channels != out_channels else nn.Identity())

    def forward(self, x, t_emb, seq=None):  # x: (B, H, C), t_emb: (B, E)
        t = P.linear(mish(t_emb), self.time_dense, self.dtype)
        res = x if isinstance(self.residual, nn.Identity) else P.linear(x, self.residual,
                                                                        self.dtype)
        if seq is not None:  # under a horizon split each add runs inside its block's K2
            return self.blocks[1](self.blocks[0](x, seq, add=t), seq, add=res)
        return self.blocks[1](self.blocks[0](x) + t[:, None, :]) + res


def downsample(conv: nn.Conv1d, x, seq=None, dtype: torch.dtype = torch.float32):
    """The k3, stride-2, padding-1 conv on channel-last x; under a horizon
    split (even frames a rank) it needs one row from the left neighbour."""
    if seq is None:
        return P.conv1d(x.transpose(1, 2), conv, dtype).transpose(1, 2)
    before, _, _ = seq.exchange_halo(x, 1, 0)
    xh = torch.cat([before, x], dim=1).transpose(1, 2)
    return P.conv1d(xh, conv, dtype, padding=0).transpose(1, 2)


def upsample(conv: nn.ConvTranspose1d, x, seq=None, dtype: torch.dtype = torch.float32):
    """The k4, stride-2, padding-1 transposed conv on channel-last x; under a
    horizon split it takes one row from each neighbour and crops the two
    output rows each of them adds on its side."""
    if seq is None:
        return P.conv_transpose1d(x.transpose(1, 2), conv, dtype).transpose(1, 2)
    before, after, _ = seq.exchange_halo(x, 1, 1)
    xh = torch.cat([before, x, after], dim=1).transpose(1, 2)
    y = P.conv_transpose1d(xh, conv, dtype)
    return y[:, :, 2:2 + 2 * x.shape[1]].transpose(1, 2)


class TemporalUnet(nn.Module):
    def __init__(self, transition_dim: int, dim: int = 128,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), attention: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = [dim * m for m in dim_mults]
        self.down_factor = 2 ** (len(dims) - 1)
        self.dim, self.dtype = dim, dtype
        self.attention = attention
        self.time_mlp = nn.ModuleList([nn.Linear(dim, dim * 4), nn.Linear(dim * 4, dim)])

        res, attn = [], []
        c = transition_dim
        for d in dims:                                   # down path
            res += [ResidualTemporalBlock(c, d, dim, dtype=dtype),
                    ResidualTemporalBlock(d, d, dim, dtype=dtype)]
            attn.append(d)
            c = d
        res += [ResidualTemporalBlock(c, c, dim, dtype=dtype),
                ResidualTemporalBlock(c, c, dim, dtype=dtype)]
        attn.append(c)                                   # mid
        for d in reversed(dims[:-1]):                    # up path
            res += [ResidualTemporalBlock(2 * c, d, dim, dtype=dtype),
                    ResidualTemporalBlock(d, d, dim, dtype=dtype)]
            attn.append(d)
            c = d
        self.res_blocks = nn.ModuleList(res)
        self.attentions = nn.ModuleList(
            [PreNormResidualAttention(a, dtype=dtype) for a in attn] if attention else [])
        self.downsamples = nn.ModuleList(
            [nn.Conv1d(d, d, 3, stride=2, padding=1) for d in dims[:-1]])
        self.upsamples = nn.ModuleList(
            [nn.ConvTranspose1d(d, d, 4, stride=2, padding=1) for d in reversed(dims[:-1])])
        self.final_block = Conv1dBlock(dim, dim, kernel_size=5, dtype=dtype)
        self.final_conv = nn.Linear(dim, transition_dim)

    def forward(self, x, time, y=None):
        """x: (B, H, transition_dim), time: (B,) -> (B, H, transition_dim).
        ``y`` (class label) is accepted and ignored, like the JAX model.
        Under a horizon split (``utils.seq.active()``) x holds this rank's
        frames and so does the result."""
        del y
        seq = seqlib.active()
        if seq is not None:
            self._check_sharded(x.shape[1], seq.world)
        elif x.shape[1] % self.down_factor:
            raise ValueError(f"horizon {x.shape[1]} must be divisible by {self.down_factor}")
        dt = self.dtype
        t = sinusoidal_pos_emb(time, self.dim)
        t = P.linear(mish(P.linear(t, self.time_mlp[0], dt)), self.time_mlp[1], dt)

        res = iter(self.res_blocks)
        attn = iter(self.attentions)
        x = x.to(dt)
        skips = []
        n_down = len(self.downsamples)
        for i in range(n_down + 1):
            x = next(res)(x, t, seq)
            x = next(res)(x, t, seq)
            if self.attention:
                x = next(attn)(x, seq)
            skips.append(x)
            if i < n_down:
                x = downsample(self.downsamples[i], x, seq, dt)

        x = next(res)(x, t, seq)
        if self.attention:
            x = next(attn)(x, seq)
        x = next(res)(x, t, seq)

        # one iteration per down-sampled resolution, each ending in an
        # upsample; the full-resolution skip stays unused (as in the reference)
        for up in self.upsamples:
            x = torch.cat([x, skips.pop()], dim=-1)
            x = next(res)(x, t, seq)
            x = next(res)(x, t, seq)
            if self.attention:
                x = next(attn)(x, seq)
            x = upsample(up, x, seq, dt)

        x = self.final_block(x, seq)
        return P.linear(x, self.final_conv, dt).to(torch.float32)

    def _check_sharded(self, frames: int, ranks: int):
        """Refuse a horizon split the sharded forward does not take."""
        if torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters()):
            raise RuntimeError("the horizon-sharded TemporalUnet serves sampling only: run it "
                               "under torch.no_grad or torch.inference_mode (JAX shards no "
                               "training over the horizon)")
        if frames % self.down_factor:
            raise ValueError(f"horizon {frames * ranks} over {ranks} ranks: it must be "
                             f"divisible by ranks x {self.down_factor} = "
                             f"{ranks * self.down_factor}")
        halo = max(b.weight.shape[0] // 2 for b in self.modules() if isinstance(b, Conv1dBlock))
        if frames // self.down_factor < halo:
            raise ValueError(f"horizon {frames * ranks} over {ranks} ranks leaves "
                             f"{frames // self.down_factor} frames a rank at the deepest level, "
                             f"fewer than the conv blocks' {halo}-row halo (multi-hop halos "
                             "are not taken)")


def _halved(h: int) -> int:
    """Rows after a k3, stride-2, padding-1 conv."""
    return (h + 1) // 2


class ValueFunction(nn.Module):
    """(B, horizon, transition_dim), (B,) time -> (B,) values (or (B,
    out_dim)). Submodules in flax's numbering: ``time_mlp.i`` is
    ``Dense_i``, ``res_blocks.i`` ``ResidualTemporalBlock_i``,
    ``downsamples.i`` ``Conv_i`` and ``head.i`` ``Dense_{i+2}``."""

    def __init__(self, transition_dim: int, horizon: int, dim: int = 32,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), out_dim: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = [dim * m for m in dim_mults]
        self.dim, self.horizon, self.out_dim, self.dtype = dim, horizon, out_dim, dtype
        self.time_mlp = nn.ModuleList([nn.Linear(dim, dim * 4), nn.Linear(dim * 4, dim)])
        res, down = [], []
        c, h = transition_dim, horizon
        for i, d in enumerate(dims):
            res += [ResidualTemporalBlock(c, d, dim, dtype=dtype),
                    ResidualTemporalBlock(d, d, dim, dtype=dtype)]
            c = d
            if i != len(dims) - 1:
                down.append(nn.Conv1d(d, d, 3, stride=2, padding=1))
                h = _halved(h)
        for width in (dims[-1] // 2, dims[-1] // 4):  # the mid blocks, each halving H
            res.append(ResidualTemporalBlock(c, width, dim, dtype=dtype))
            down.append(nn.Conv1d(width, width, 3, stride=2, padding=1))
            c, h = width, _halved(h)
        self.res_blocks = nn.ModuleList(res)
        self.downsamples = nn.ModuleList(down)
        self.head = nn.ModuleList([nn.Linear(c * h + dim, dim * 2), nn.Linear(dim * 2, out_dim)])

    def forward(self, x, time, y=None):
        del y
        if x.shape[1] != self.horizon:
            raise ValueError(f"horizon {x.shape[1]}: this ValueFunction's head is built for "
                             f"horizon {self.horizon}")
        dt = self.dtype
        t = sinusoidal_pos_emb(time, self.dim)
        t = P.linear(mish(P.linear(t, self.time_mlp[0], dt)), self.time_mlp[1], dt)
        x = x.to(dt)
        res, down = iter(self.res_blocks), iter(self.downsamples)
        n_levels = len(self.res_blocks) - 2
        for i in range(0, n_levels, 2):
            x = next(res)(x, t)
            x = next(res)(x, t)
            if i != n_levels - 2:
                x = downsample(next(down), x, dtype=dt)
        for _ in range(2):  # mid
            x = next(res)(x, t)
            x = downsample(next(down), x, dtype=dt)
        h = mish(P.linear(torch.cat([x.reshape(x.shape[0], -1), t], dim=-1), self.head[0], dt))
        out = P.linear(h, self.head[1], dt).to(torch.float32)
        return out[..., 0] if self.out_dim == 1 else out
