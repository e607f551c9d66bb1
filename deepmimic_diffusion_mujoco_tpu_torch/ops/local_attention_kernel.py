"""Per-head windowed attention over three whole neighbour blocks.

Replaces the TPU kernel ``deepmimic_diffusion_mujoco_tpu/ops/pallas/
local_attention_kernel.py:local_attention_tpu`` and its front door
``ops/pallas/__init__.py:local_attention_pallas``. Layout is the JAX
package's: q, k, v, out (B, h, N, dh), taken by the kernel as (B*h, N, dh).
Queries run in 128-row chunks against the chunk and its two neighbour chunks
(3C keys, the clamped edge duplicates masked), with rotary at absolute
positions and window / exact / causal masks. It takes N % 128 == 0,
N % w == 0, w <= 128 and no xpos; no key mask, dropout or autopad.

- ``local_attention_heads_plain``: the plain version, the chunk semantics
  of ``fused_local_attention.chunked_attention`` with these blocks. It
  equals the bucketed ``models.local_attention.local_attention`` up to f32
  rounding of the rotary angles. The CPU path and the CUDA kernel's oracle.
- ``local_attention_heads_cuda``: the kernel, the second entry point of
  ``csrc/local_attention.cu`` (the same core as B3). CUDA tensors only;
  ``.launches`` counts its launches.
- ``local_attention_heads``: the autograd entry: the kernel for CUDA tensors,
  the plain version for CPU tensors, the backward through the plain version.
- ``windowed_attention``: the front door: the entry for the shapes it takes,
  the bucketed ``local_attention`` for the others (xpos, unaligned N).

Nothing on the serving path calls it: the transformer's attention is B3.
"""
from __future__ import annotations

import torch

from ..models.local_attention import local_attention
from . import fused_local_attention as FK

CHUNK = 128


def supports(N: int, window_size: int, causal: bool = False, use_xpos: bool = False) -> bool:
    lb, lf = 1, (0 if causal else 1)
    return not (use_xpos or N % window_size or N % CHUNK or max(lb, lf) * window_size > CHUNK)


def plan(N: int) -> dict:
    """The TPU kernel's blocks in ``fused_local_attention``'s plan terms:
    128-row chunks whose keys are the three whole blocks around them."""
    return {"Np": N, "C": CHUNK, "nc": N // CHUNK, "P": CHUNK, "K": 3 * CHUNK}


def local_attention_heads_plain(q, k, v, window_size: int, causal: bool = False,
                                exact_windowsize: bool = True, use_rotary: bool = True):
    """The kernel's semantics in plain PyTorch, rotary at absolute positions
    as in the kernel. Equal to the bucketed ``local_attention`` up to f32
    rounding of the rotary angles (about 1e-4 at N 1024)."""
    x = [t.transpose(1, 2).to(torch.float32) for t in (q, k, v)]  # (B, N, h, dh)
    out = FK.chunked_attention(*x, plan(q.shape[2]), window_size, causal, exact_windowsize,
                               use_rotary)
    return out.transpose(1, 2).to(q.dtype)


def local_attention_heads_cuda(q, k, v, window_size: int, causal: bool = False,
                               exact_windowsize: bool = True, use_rotary: bool = True,
                               launch_plan: FK.AttnPlan | None = None):
    """Launch the kernel on PyTorch's current stream (built on first use),
    with ``launch_plan`` or ``FK.attention_plan``'s default for these blocks.
    Raises on a tensor or shape the kernel does not take, and if the launch
    is refused."""
    fn = "local_attention_heads_cuda"
    for name, t in (("q", q), ("k", k), ("v", v)):
        FK.check_cuda_f32(name, fn, t, q.device)
        if t.dim() != 4 or t.shape != q.shape:
            raise ValueError(f"{fn}: q, k, v must share one (B, h, N, dh) shape, "
                             f"{name} is {tuple(t.shape)}")
    B, h, N, dh = q.shape
    if dh not in FK.HEAD_DIMS:
        raise ValueError(f"{fn}: head width {dh} not in {FK.HEAD_DIMS}")
    if not supports(N, window_size, causal):
        raise ValueError(f"{fn}: N {N} with window {window_size} needs N % {CHUNK} == 0, "
                         f"N % w == 0 and w <= {CHUNK}")
    lp = launch_plan or FK.attention_plan(N, CHUNK, CHUNK, window_size, causal, dh, B * h,
                                          use_rotary)
    lib = FK._library()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lf = 0 if causal else 1
    with torch.cuda.device(q.device):
        table = FK.device_rotary_table(N + lf * window_size, dh, q.device) if use_rotary else None
        err = lib.local_attention_heads_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if table is None else table.data_ptr(),
            out.data_ptr(), B * h, N, dh, window_size, int(causal), int(exact_windowsize),
            int(use_rotary), lp.slab, lp.cap, int(lp.mma),
            torch.cuda.current_stream(q.device).cuda_stream)
    FK.raise_on_error(lib, err, fn)
    local_attention_heads_cuda.launches += 1
    return out


local_attention_heads_cuda.launches = 0


class _LocalAttentionHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window_size, causal, exact_windowsize, use_rotary):
        ctx.args = (window_size, causal, exact_windowsize, use_rotary)
        ctx.save_for_backward(q, k, v)
        impl = local_attention_heads_cuda if q.is_cuda else local_attention_heads_plain
        return impl(q, k, v, *ctx.args)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = local_attention_heads_plain(*leaves, *ctx.args)
            grads = torch.autograd.grad(out, leaves, grad)
        return (*grads, None, None, None, None)


def local_attention_heads(q, k, v, window_size: int, causal: bool = False,
                          exact_windowsize: bool = True, use_rotary: bool = True):
    """(B, h, N, dh) q, k, v -> (B, h, N, dh) with gradients: the kernel on
    the card, the plain version on the CPU. Gate callers with ``supports``."""
    if not supports(q.shape[2], window_size, causal):
        raise ValueError(f"local_attention_heads: N {q.shape[2]} with window {window_size} "
                         "is not supported; gate callers with supports()")
    return _LocalAttentionHeads.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                      window_size, causal, exact_windowsize, use_rotary)


def windowed_attention(q, k, v, window_size: int, *, causal: bool = False,
                       exact_windowsize: bool = True, use_rotary: bool = True,
                       use_xpos: bool = False, xpos_scale_base: float | None = None):
    """The per-head kernel where it applies, else the bucketed
    ``local_attention`` (xpos, N not a multiple of 128 or of the window)."""
    if supports(q.shape[2], window_size, causal, use_xpos):
        return local_attention_heads(q, k, v, window_size, causal, exact_windowsize, use_rotary)
    return local_attention(q, k, v, window_size, causal=causal,
                           exact_windowsize=exact_windowsize, use_rotary=use_rotary,
                           use_xpos=use_xpos, xpos_scale_base=xpos_scale_base)
