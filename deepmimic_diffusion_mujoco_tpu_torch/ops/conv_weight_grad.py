"""Weight gradient of a "same"-padded 1-D convolution: the dW of every
Conv1dBlock in the temporal U-Net's backward.

Replaces the TPU kernel ``deepmimic_diffusion_mujoco_tpu/ops/pallas/
conv_weight_grad.py:conv1d_weight_grad``; its oracle there is
``conv1d_weight_grad_xla``, the vjp of the conv with respect to its kernel.
Layout is the JAX package's: x (B, H, Cin), dy (B, H, Cout) ->
dW (k, Cin, Cout) float32, with ``pad_l = (k - 1) // 2``:

    dW[t, ci, co] = sum_{b, h} x_pad[b, h + t, ci] * dy[b, h, co]

- ``conv1d_weight_grad_plain``: k tap products over the padded input in
  plain PyTorch. It is the CPU path and the oracle the CUDA kernel is held
  against.
- ``conv1d_weight_grad_cuda``: the hand-written CUDA kernel
  (``csrc/conv1d_weight_grad.cu``; its header states the design and what
  bounds it). It takes CUDA tensors only and raises on anything it does not
  take. ``conv1d_weight_grad_cuda.launches`` counts its launches.
- ``conv1d_weight_grad``: the kernel for CUDA tensors, the plain version
  for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

KERNEL_SIZES = (1, 3, 5, 7, 9)
TILE = 64                    # kTileCi = kTileCo in csrc/conv1d_weight_grad.cu
ROWS_PER_CHUNK = 20          # kRows there
MIN_CHUNKS_PER_SPLIT = 4     # a split reads at least this many chunks
BLOCKS_PER_SM = 2            # resident 256-thread blocks per SM the split count aims for

_SMS: dict[int, int] = {}


def conv1d_weight_grad_plain(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """dL/dW of the SAME-padded conv, as k (Cin, B*H) x (B*H, Cout) products."""
    B, H, cin = x.shape
    pad_l = (k - 1) // 2
    xp = F.pad(x, (0, 0, pad_l, k - 1 - pad_l))
    dy2 = dy.reshape(B * H, dy.shape[-1])
    return torch.stack([xp[:, t:t + H].reshape(B * H, cin).T @ dy2 for t in range(k)])


def _library() -> ctypes.CDLL:
    lib = _build.load("conv1d_weight_grad")
    if lib.conv1d_weight_grad_f32.argtypes is None:
        lib.conv1d_weight_grad_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        lib.conv1d_weight_grad_f32.restype = ctypes.c_int
        lib.conv1d_weight_grad_error_string.argtypes = [ctypes.c_int]
        lib.conv1d_weight_grad_error_string.restype = ctypes.c_char_p
    return lib


def _check_args(x, dy, k: int):
    for name, t in (("x", x), ("dy", dy)):
        if not t.is_cuda:
            raise ValueError(f"conv1d_weight_grad_cuda: {name} is on {t.device}, "
                             "needs a CUDA tensor")
        if t.dtype != torch.float32:
            raise ValueError(f"conv1d_weight_grad_cuda: {name} is {t.dtype}, "
                             "the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"conv1d_weight_grad_cuda: {name} is not contiguous")
        if t.dim() != 3:
            raise ValueError(f"conv1d_weight_grad_cuda: {name} {tuple(t.shape)} must be 3-D")
    if dy.device != x.device:
        raise ValueError(f"conv1d_weight_grad_cuda: dy is on {dy.device}, x on {x.device}")
    if dy.shape[:2] != x.shape[:2]:
        raise ValueError(f"conv1d_weight_grad_cuda: x {tuple(x.shape)} and dy "
                         f"{tuple(dy.shape)} differ in (B, H)")
    if k not in KERNEL_SIZES:
        raise ValueError(f"conv1d_weight_grad_cuda: kernel size {k} not in {KERNEL_SIZES}")


def split_count(B: int, H: int, cin: int, cout: int, sms: int) -> int:
    """Ways the B*H reduction is split across blocks: enough blocks to fill
    the SMs when the (Cin, Cout) tiles are few, each split reading at least
    MIN_CHUNKS_PER_SPLIT chunks."""
    tiles = -(-cin // TILE) * -(-cout // TILE)
    chunks = B * -(-H // ROWS_PER_CHUNK)
    return max(1, min(BLOCKS_PER_SM * sms // tiles, chunks // MIN_CHUNKS_PER_SPLIT))


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def conv1d_weight_grad_cuda(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (builds it on first
    use). Raises on a tensor or shape the kernel does not take, and if the
    launch is refused."""
    _check_args(x, dy, k)
    lib = _library()
    B, H, cin = x.shape
    cout = dy.shape[-1]
    out = torch.empty((k, cin, cout), dtype=torch.float32, device=x.device)
    if B * H == 0:
        return out.zero_()
    splits = split_count(B, H, cin, cout, _sm_count(x.device))
    ws = (torch.empty((splits, k, cin, cout), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    with torch.cuda.device(x.device):
        err = lib.conv1d_weight_grad_f32(
            x.data_ptr(), dy.data_ptr(), out.data_ptr(), ws.data_ptr() if ws is not None else None,
            B, H, cin, cout, k, splits, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError("conv1d_weight_grad kernel launch failed: "
                           + lib.conv1d_weight_grad_error_string(err).decode())
    conv1d_weight_grad_cuda.launches += 1
    return out


conv1d_weight_grad_cuda.launches = 0


def conv1d_weight_grad(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """dW (k, Cin, Cout): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.is_cuda:
        return conv1d_weight_grad_cuda(x, dy, k)
    return conv1d_weight_grad_plain(x, dy, k)
