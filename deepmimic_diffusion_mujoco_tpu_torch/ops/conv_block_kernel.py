"""Fused Conv1d(k, "same") + GroupNorm + Mish: the temporal U-Net's
Conv1dBlock.

Replaces the TPU kernel ``deepmimic_diffusion_mujoco_tpu/ops/pallas/
conv_block_kernel.py:conv_gn_mish``. Layout is the JAX package's:
x (B, H, Cin), w (k, Cin, Cout), b / gamma / beta (Cout,), out (B, H, Cout).

- ``conv_gn_mish_plain``: the plain PyTorch version (conv, two-pass
  GroupNorm, affine, Mish). It is the CPU path and the oracle the CUDA kernel
  is held against.
- ``conv_gn_mish_cuda``: the hand-written CUDA kernel
  (``csrc/conv_gn_mish.cu``; its header states the design and what bounds
  it). It takes CUDA tensors only and raises on anything it does not take.
  ``conv_gn_mish_cuda.launches`` counts its launches.
- ``conv_gn_mish``: the autograd entry the model calls. Its forward launches
  the kernel for CUDA tensors and runs the plain version for CPU tensors.
  Its backward recomputes the pre-norm conv output (as the JAX kernel's
  custom VJP recomputes), backpropagates through GroupNorm, the affine and
  Mish in plain PyTorch, and takes the conv's dW from
  ``ops/conv_weight_grad.py`` (the B2 kernel for CUDA tensors); dx is the
  transposed conv of the pre-norm gradient (a library call, as XLA's conv
  computes it in the JAX package).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .conv_weight_grad import conv1d_weight_grad

KERNEL_SIZES = (1, 3, 5, 7, 9)
MAX_GROUP_CHANNELS = 256  # kMaxGroupChannels in csrc/conv_gn_mish.cu


def conv_gn_mish_plain(x, w, b, gamma, beta, groups: int = 8, eps: float = 1e-5):
    """Channel-last conv + bias -> GroupNorm (two-pass statistics) ->
    affine -> Mish, in plain PyTorch."""
    return _gn_affine_mish(_conv(x, w, b), gamma, beta, groups, eps)


def _conv(x, w, b):
    """Channel-last "same" conv + bias: (B, H, Cin) -> (B, H, Cout)."""
    k = w.shape[0]
    return F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), b, padding=k // 2).transpose(1, 2)


def _gn_affine_mish(out, gamma, beta, groups: int, eps: float):
    B, H, C = out.shape
    g = out.reshape(B, H, groups, C // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = ((g - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    normed = ((g - mean) / torch.sqrt(var + eps)).reshape(B, H, C)
    out = normed * gamma + beta
    return out * torch.tanh(F.softplus(out))


def _library() -> ctypes.CDLL:
    lib = _build.load("conv_gn_mish")
    if lib.conv_gn_mish_f32.argtypes is None:
        lib.conv_gn_mish_f32.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p]
        lib.conv_gn_mish_f32.restype = ctypes.c_int
        lib.conv_gn_mish_error_string.argtypes = [ctypes.c_int]
        lib.conv_gn_mish_error_string.restype = ctypes.c_char_p
    return lib


def _check_args(x, w, b, gamma, beta, groups: int):
    tensors = {"x": x, "w": w, "b": b, "gamma": gamma, "beta": beta}
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"conv_gn_mish_cuda: {name} is on {t.device}, needs a CUDA tensor")
        if t.dtype != torch.float32:
            raise ValueError(f"conv_gn_mish_cuda: {name} is {t.dtype}, the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"conv_gn_mish_cuda: {name} is not contiguous")
        if t.device != x.device:
            raise ValueError(f"conv_gn_mish_cuda: {name} is on {t.device}, x on {x.device}")
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"conv_gn_mish_cuda: x {tuple(x.shape)} must be (B, H, Cin) and "
                         f"w {tuple(w.shape)} (k, Cin, Cout)")
    k, cin, cout = w.shape
    if x.shape[2] != cin:
        raise ValueError(f"conv_gn_mish_cuda: x has {x.shape[2]} channels, w expects {cin}")
    if k not in KERNEL_SIZES:
        raise ValueError(f"conv_gn_mish_cuda: kernel size {k} not in {KERNEL_SIZES}")
    if groups <= 0 or cout % groups:
        raise ValueError(f"conv_gn_mish_cuda: Cout {cout} is not a multiple of groups {groups}")
    if cout // groups > MAX_GROUP_CHANNELS:
        raise ValueError(f"conv_gn_mish_cuda: {cout // groups} channels per group, the "
                         f"kernel takes at most {MAX_GROUP_CHANNELS}")
    for name in ("b", "gamma", "beta"):
        if tuple(tensors[name].shape) != (cout,):
            raise ValueError(f"conv_gn_mish_cuda: {name} must be ({cout},)")


def conv_gn_mish_cuda(x, w, b, gamma, beta, groups: int = 8, eps: float = 1e-5):
    """Launch the CUDA kernel on PyTorch's current stream (builds it on
    first use). Raises on a tensor or shape the kernel does not take, and
    if the launch is refused."""
    _check_args(x, w, b, gamma, beta, groups)
    lib = _library()
    B, H, cin = x.shape
    k, _, cout = w.shape
    out = torch.empty((B, H, cout), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = lib.conv_gn_mish_f32(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            out.data_ptr(), B, H, cin, cout, k, groups, eps,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError("conv_gn_mish kernel launch failed: "
                           + lib.conv_gn_mish_error_string(err).decode())
    conv_gn_mish_cuda.launches += 1
    return out


conv_gn_mish_cuda.launches = 0


class _ConvGnMish(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, gamma, beta, groups, eps):
        ctx.groups, ctx.eps = groups, eps
        ctx.save_for_backward(x, w, b, gamma, beta)
        if x.is_cuda:
            return conv_gn_mish_cuda(x, w, b, gamma, beta, groups, eps)
        return conv_gn_mish_plain(x, w, b, gamma, beta, groups, eps)

    @staticmethod
    def backward(ctx, grad):
        x, w, b, gamma, beta = ctx.saved_tensors
        need_x, need_w, need_b, need_gamma, need_beta = ctx.needs_input_grad[:5]
        k = w.shape[0]
        pre = _conv(x, w, b).detach().requires_grad_()
        with torch.enable_grad():
            affine = [t.detach().requires_grad_() for t in (gamma, beta)]
            out = _gn_affine_mish(pre, *affine, ctx.groups, ctx.eps)
            g, dgamma, dbeta = torch.autograd.grad(out, [pre, *affine], grad)
        g = g.contiguous()
        dx = (torch.nn.grad.conv1d_input(x.transpose(1, 2).shape, w.permute(2, 1, 0),
                                         g.transpose(1, 2), padding=k // 2).transpose(1, 2)
              if need_x else None)
        dw = conv1d_weight_grad(x, g, k) if need_w else None
        db = g.sum((0, 1)) if need_b else None
        return (dx, dw, db, dgamma if need_gamma else None,
                dbeta if need_beta else None, None, None)


def conv_gn_mish(x, w, b, gamma, beta, groups: int = 8, eps: float = 1e-5):
    """Fused Conv1d + GroupNorm + Mish with gradients (dW from the B2
    kernel on the card)."""
    return _ConvGnMish.apply(x.contiguous(), w.contiguous(), b, gamma, beta, groups, eps)
