"""Compute dtype: where a model built with ``bf16=True`` rounds.

The JAX package builds each denoiser with ``dtype=jnp.bfloat16`` and keeps
its parameters float32 (``factory.py``). flax then rounds in fixed places,
and these helpers put the port's rounding in the same places, with explicit
casts (``torch.autocast`` rounds elsewhere: it runs ``layer_norm`` and
``softmax`` in float32 and returns float32):

- ``nn.Dense`` / ``nn.Conv`` / ``nn.ConvTranspose`` with ``dtype=bf16`` cast
  the input, the kernel and the bias to bf16, multiply (float32 sums of the
  exact products, one rounding) and add the bias in bf16: ``linear``,
  ``conv1d``, ``conv_transpose1d``;
- ``nn.LayerNorm`` / ``nn.RMSNorm`` take their statistics and apply the
  float32 scale and bias in float32 and return bf16: ``layer_norm``,
  ``rms_norm``;
- ``nn.Embed(dtype=bf16)`` looks rows up in the table cast to bf16:
  ``embed``;
- the activations (``jax.nn.softmax``, ``silu``, ``gelu`` and ``x *
  tanh(softplus(x))``) are compositions of primitives, and XLA rounds each
  primitive's bf16 result; PyTorch's fused activations round once. At bf16
  ``softmax``, ``silu``, ``gelu_tanh`` and ``mish`` take the primitives in
  the order the JAX source writes them, each result rounded to bf16 (sums
  taken in float32, as ``jnp.sum`` takes them), with bf16 constants. (A
  compiled JAX program may keep a fused intermediate unrounded where its
  fusion recomputes it; the order as written is the one fixed reference.)

Everything else follows PyTorch's type promotion, which matches JAX's for
the tensors the models combine (a bf16 tensor with a float32 tensor of any
rank but zero gives float32; with a Python scalar, bf16). Where a float32
0-d parameter meets a bf16 tensor (JAX promotes to float32, PyTorch would
not), the model casts it itself.

With ``dtype`` float32 (or float64, the reference forwards) each helper is
the module's own call, so those paths are unchanged.

``cast`` gives a parameter's bf16 copy. Where no gradient is recorded
(serving: ``sample_loop`` runs under ``torch.inference_mode``) the copy is
kept on the parameter and made again only when the parameter changes (its
version counter or storage), so a chain casts each weight once, not once
a step: the same values with one copy kernel fewer per layer and step.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

BF16 = torch.bfloat16


def cast(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``p.to(dtype)``, kept on ``p`` between calls where no gradient is
    recorded."""
    if torch.is_grad_enabled():
        return p.to(dtype)
    key = (dtype, p._version, p.data_ptr(), p.device)
    kept = getattr(p, "_cast", None)
    if kept is None or kept[0] != key:
        kept = p._cast = (key, p.detach().to(dtype))
    return kept[1]


def _bf16_const(v: float) -> float:
    """v rounded to bf16, as JAX rounds a Python scalar against a bf16 array."""
    return torch.tensor(v, dtype=BF16).item()


def scalar(v: float, dtype: torch.dtype) -> float:
    """The Python scalar v as JAX takes it against an array of ``dtype``:
    rounded to bf16 at bf16, else as it is."""
    return _bf16_const(v) if dtype == BF16 else v


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    if x.dtype != BF16:
        return x.softmax(dim=dim)
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


def silu(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != BF16:
        return F.silu(x)
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != BF16:
        return F.gelu(x, approximate="tanh")
    inner = _bf16_const(0.7978845608028654) * (x + _bf16_const(0.044715) * (x * (x * x)))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def mish(x: torch.Tensor) -> torch.Tensor:
    """x tanh(softplus(x)); softplus as ``jnp.logaddexp(x, 0)`` at bf16."""
    if x.dtype != BF16:
        return x * torch.tanh(F.softplus(x))
    return x * torch.tanh(torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs())))


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    if dtype != BF16:
        return layer(x)
    y = F.linear(x.to(dtype), cast(layer.weight, dtype))
    return y if layer.bias is None else y + cast(layer.bias, dtype)


def conv1d(x: torch.Tensor, conv: nn.Conv1d, dtype: torch.dtype,
           padding: int | None = None) -> torch.Tensor:
    """``conv`` on channel-first x, with ``padding`` in place of the
    module's where given."""
    padding = conv.padding if padding is None else padding
    if dtype != BF16:
        return F.conv1d(x, conv.weight, conv.bias, conv.stride, padding)
    y = F.conv1d(x.to(dtype), cast(conv.weight, dtype), None, conv.stride, padding)
    return y if conv.bias is None else y + cast(conv.bias, dtype)[:, None]


def conv_transpose1d(x: torch.Tensor, conv: nn.ConvTranspose1d,
                     dtype: torch.dtype) -> torch.Tensor:
    """``conv`` on channel-first x."""
    if dtype != BF16:
        return conv(x)
    y = F.conv_transpose1d(x.to(dtype), cast(conv.weight, dtype), None, conv.stride,
                           conv.padding)
    return y if conv.bias is None else y + cast(conv.bias, dtype)[:, None]


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm | None, dtype: torch.dtype,
               eps: float | None = None) -> torch.Tensor:
    """``norm`` (or, with ``norm`` None, a LayerNorm without scale and bias
    of epsilon ``eps``) over the last axis."""
    if norm is None:
        if dtype != BF16:
            return F.layer_norm(x, x.shape[-1:], eps=eps)
        return F.layer_norm(x.float(), x.shape[-1:], eps=eps).to(dtype)
    if dtype != BF16:
        return norm(x)
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, dtype: torch.dtype):
    """x / sqrt(mean(x^2) + eps) * scale: in x's own dtype, or, at bf16, in
    float32 with one rounding."""
    if dtype != BF16:
        return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * scale
    xf = x.float()
    return (xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps) * scale).to(dtype)


def embed(ids: torch.Tensor, table: nn.Embedding, dtype: torch.dtype) -> torch.Tensor:
    if dtype != BF16:
        return table(ids)
    return F.embedding(ids, cast(table.weight, dtype))
