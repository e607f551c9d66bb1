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
  the kernel for CUDA tensors and runs the plain version for CPU tensors;
  its backward recomputes through the plain version.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

KERNEL_SIZES = (1, 3, 5, 7, 9)
MAX_GROUP_CHANNELS = 256  # kMaxGroupChannels in csrc/conv_gn_mish.cu


def conv_gn_mish_plain(x, w, b, gamma, beta, groups: int = 8, eps: float = 1e-5):
    """Channel-last conv + bias -> GroupNorm (two-pass statistics) ->
    affine -> Mish, in plain PyTorch."""
    k = w.shape[0]
    out = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), b, padding=k // 2).transpose(1, 2)
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
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = conv_gn_mish_plain(*inputs, ctx.groups, ctx.eps)
            grads = iter(torch.autograd.grad(out, wanted, grad))
        return tuple(next(grads) if t.requires_grad else None for t in inputs) + (None, None)


def conv_gn_mish(x, w, b, gamma, beta, groups: int = 8, eps: float = 1e-5):
    """Fused Conv1d + GroupNorm + Mish with gradients (recomputed through the
    plain version, as the JAX kernel's custom VJP does)."""
    return _ConvGnMish.apply(x.contiguous(), w.contiguous(), b, gamma, beta, groups, eps)
