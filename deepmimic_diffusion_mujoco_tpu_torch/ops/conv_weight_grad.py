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
- ``wgrad_plan``: the kernel's launch plan for one shape (channel tile,
  rows per chunk, ring stages, cluster size), cached;
  ``make_wgrad_plan`` builds any other plan, which
  ``conv1d_weight_grad_cuda(..., plan=...)`` runs (the card tests and
  ``ops/conv_weight_grad_sweep.py`` do).
- ``conv1d_weight_grad``: the kernel for CUDA tensors, the plain version
  for CPU tensors.

bf16 (the backward of a conv block in a model built with ``bf16=True``):
bf16 x and dy, float32 dW, as the Pallas kernel takes and writes them.
``conv1d_weight_grad_plain`` sums the products of their float32 widenings;
``conv1d_weight_grad_bf16_cuda`` is the kernel's bf16 form (the same source,
bf16 ``mma.sync`` m16n8k16 with float32 sums; ``.launches`` counts it; its
plans come from ``wgrad_plan(..., bf16=True)``), and ``conv1d_weight_grad``
sends bf16 CUDA tensors to it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from . import _build

KERNEL_SIZES = (1, 3, 5, 7, 9)
# Constants of csrc/conv1d_weight_grad.cu
WARP_CI, WARP_CO = 16, 32  # kWarpCi x kWarpCo: a warp's piece of the channel tile
MAX_THREADS = 256          # kMaxThreads
MAX_STAGES = 4             # kMaxStages
PORTABLE_CLUSTER = 8       # kPortableCluster
MAX_CLUSTER = 16           # kMaxCluster, with the non-portable cluster size
MAX_SMEM = 227 * 1024      # kMaxSmem: a CTA's shared memory, dynamic and static
STATIC_SMEM = 2 * MAX_STAGES * 8  # the ring's full and empty mbarriers
PAD_COLS = 8               # kPadCols
MAX_ROWS = 64              # kMaxRows: dy rows per chunk
PATH = "3xtf32"            # the float32 path: 3xTF32 mma.sync on the tensor cores
BF16_PATH = "bf16"         # the bf16 path: bf16 mma.sync m16n8k16, float32 sums
STEP, BF16_STEP = 8, 16    # kStepF32, kStepBf16: rows of a k-step (the mma's k)
# The plan's defaults (make_wgrad_plan), fitted to ops/conv_weight_grad_sweep.py's
# timings of every plan at the 26 main-path shapes on an H100 (PERF.md)
SMALL_WORK = 1 << 26       # B H Cin Cout up to this: SMALL_TILE, clusters up to MAX_CLUSTER
SMALL_TILE = (16, 64)
TILES = ((64, 64), (32, 64), (32, 32), (16, 32))  # other shapes' tiles, widest first
CLUSTER_CAP = 4            # their CTAs per tile, at most, ...
LONG_ROWS = 5120           # ... unless B H reaches this
WARPS = 4                  # warps a CTA's slices add up to, at most

_SMS: dict[int, int] = {}


def conv1d_weight_grad_plain(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """dL/dW of the SAME-padded conv, as k (Cin, B*H) x (B*H, Cout) products;
    bf16 x and dy are summed as their float32 widenings."""
    if x.dtype == torch.bfloat16:
        x, dy = x.float(), dy.float()
    B, H, cin = x.shape
    pad_l = (k - 1) // 2
    xp = F.pad(x, (0, 0, pad_l, k - 1 - pad_l))
    dy2 = dy.reshape(B * H, dy.shape[-1])
    return torch.stack([xp[:, t:t + H].reshape(B * H, cin).T @ dy2 for t in range(k)])


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class WgradPlan:
    """One launch plan (struct Plan in csrc/conv1d_weight_grad.cu) and what
    follows from it for the shape it was made for. Every split of the
    reduction is a rank of one thread block cluster, added through
    distributed shared memory: no plan has a workspace in device memory."""
    tci: int       # input channels per tile, a multiple of WARP_CI
    tco: int       # output channels per tile, a multiple of WARP_CO
    rows: int      # dy rows per chunk (flattened (b, h) rows), a multiple of the k-step
    stages: int    # ring depth
    cluster: int   # CTAs per tile, each taking a contiguous range of chunks
    slices: int    # warps per piece of the tile, taking every slices-th k-step of a chunk
    R: int         # rows of the reduction: B * H
    threads: int   # slices * (tci / WARP_CI) * (tco / WARP_CO) warps
    tiles: int     # channel tiles: ceil(Cin / tci) * ceil(Cout / tco)
    chunks: int    # ceil(R / rows)
    smem_bytes: int  # dynamic shared memory per CTA
    path: str      # PATH (float32 x and dy) or BF16_PATH
    ints: object = dataclasses.field(compare=False, repr=False)  # ctypes int[6]

    @property
    def esize(self) -> int:
        """Bytes of a staged element."""
        return 2 if self.path == BF16_PATH else 4

    @property
    def grid(self) -> int:
        return self.tiles * self.cluster

    def rank_chunks(self, rank: int) -> range:
        """The chunks cluster rank ``rank`` reduces, as the kernel splits them."""
        return range(self.chunks * rank // self.cluster,
                     self.chunks * (rank + 1) // self.cluster)

    def chunk_rows(self, c: int) -> range:
        """The flattened (b, h) rows chunk ``c`` stages (rows past R are zeros)."""
        return range(c * self.rows, min((c + 1) * self.rows, self.R))


def smem_bytes(tci: int, tco: int, rows: int, stages: int, cluster: int, slices: int,
               k: int, esize: int = 4) -> int:
    """Dynamic shared memory of one plan: layout() in the kernel's source
    (the ring in elements of ``esize`` bytes, the partial tile float32)."""
    stage = (rows + k - 1) * (tci + PAD_COLS) + rows * (tco + PAD_COLS)
    part = k * tci * (tco + PAD_COLS) if cluster > 1 or slices > 1 else 0
    return max(esize * stages * stage, 4 * part)


def make_wgrad_plan(B: int, H: int, Cin: int, Cout: int, k: int, sms: int,
                    tci: int | None = None, tco: int | None = None, rows: int | None = None,
                    stages: int | None = None, cluster: int | None = None,
                    slices: int | None = None, bf16: bool = False) -> WgradPlan:
    """The plan for one shape; a keyword given fixes that choice; ``bf16``
    plans the bf16 form (k-steps of BF16_STEP rows, a ring of 2-byte
    elements). The defaults follow the best plans
    ``ops/conv_weight_grad_sweep.py`` timed at the main-path shapes on an
    H100 (``PERF.md``; the bf16 form keeps the float32 form's rules, with
    its own k-step):

    - Tile and cluster cap. Up to SMALL_WORK (B H Cin Cout) the narrow
      SMALL_TILE and clusters of up to MAX_CLUSTER CTAs: the work is a few
      microseconds, spread as wide as it goes. Above it the widest of TILES
      whose tiles x cap reach one CTA per SM (else the narrowest), with a
      cap of CLUSTER_CAP CTAs per tile, or MAX_CLUSTER from LONG_ROWS rows
      on: each rank's partial tile costs a write and a read of shared
      memory, so a cluster pays off only where the rows are many.
    - Cluster: a power of two up to the cap, doubled while the grid stays
      within one CTA per SM and each rank keeps two k-steps or more.
    - Rows per chunk: a rank's share of the rows rounded up to the k-step,
      at most MAX_ROWS (the tensor cores' round-toward-zero chain).
    - Slices: doubled while the CTA stays within WARPS warps and each slice
      keeps two k-steps of a chunk.
    - Stages: a rank's chunks, at most MAX_STAGES (all loads in flight at
      once where they fit), fewer where shared memory runs out.
    """
    R = B * H
    step, esize = (BF16_STEP, 2) if bf16 else (STEP, 4)
    cap = MAX_CLUSTER
    if tci is None or tco is None:
        if R * Cin * Cout <= SMALL_WORK:
            options = (SMALL_TILE,)
        else:
            options = TILES
            cap = MAX_CLUSTER if R >= LONG_ROWS else CLUSTER_CAP
        for i, (ti, to) in enumerate(options):
            ti = min(tci or ti, _ceil(Cin, WARP_CI) * WARP_CI)
            to = min(tco or to, _ceil(Cout, WARP_CO) * WARP_CO)
            if _ceil(Cin, ti) * _ceil(Cout, to) * cap >= sms or i == len(options) - 1:
                break
        tci, tco = tci or ti, tco or to
    if tci <= 0 or tci % WARP_CI or tco <= 0 or tco % WARP_CO:
        raise ValueError(f"conv1d_weight_grad_cuda: tile {tci} x {tco} is not a multiple of "
                         f"{WARP_CI} x {WARP_CO}")
    pieces = (tci // WARP_CI) * (tco // WARP_CO)  # warps of one slice
    tiles = _ceil(Cin, tci) * _ceil(Cout, tco)
    if cluster is None:
        cluster = 1
        while cluster < cap and 2 * tiles * cluster <= sms and 2 * step * cluster <= R:
            cluster *= 2
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"conv1d_weight_grad_cuda: cluster size {cluster} not in "
                         f"1..{MAX_CLUSTER}")
    if rows is None:
        rows = min(MAX_ROWS, _ceil(_ceil(R, cluster), step) * step)
    if rows <= 0 or rows % step or rows > MAX_ROWS:
        raise ValueError(f"conv1d_weight_grad_cuda: {rows} rows per chunk is not a multiple "
                         f"of {step} up to {MAX_ROWS}")
    if slices is None:
        slices = 1
        while 2 * pieces * slices <= WARPS and 2 * step * slices <= rows:
            slices *= 2
    threads = slices * pieces * 32
    if slices < 1 or threads > MAX_THREADS:
        raise ValueError(f"conv1d_weight_grad_cuda: {slices} slices of a {tci} x {tco} tile "
                         f"take {threads} threads, more than {MAX_THREADS}")
    chunks = _ceil(R, rows)
    size = functools.partial(smem_bytes, tci, tco, rows, cluster=cluster, slices=slices, k=k,
                             esize=esize)
    if stages is None:
        stages = min(MAX_STAGES, max(1, _ceil(chunks, cluster)))
        while stages > 1 and size(stages) + STATIC_SMEM > MAX_SMEM:
            stages -= 1
    if not 1 <= stages <= MAX_STAGES or size(stages) + STATIC_SMEM > MAX_SMEM:
        raise ValueError(f"conv1d_weight_grad_cuda: {stages} stages of {tci} x {tco} x "
                         f"{rows} rows do not fit {MAX_SMEM} bytes of shared memory")
    fields = (tci, tco, rows, stages, cluster, slices)
    return WgradPlan(*fields, R=R, threads=threads, tiles=tiles, chunks=chunks,
                     smem_bytes=size(stages), path=BF16_PATH if bf16 else PATH,
                     ints=(ctypes.c_int * 6)(*fields))


@functools.lru_cache(maxsize=None)
def wgrad_plan(B: int, H: int, Cin: int, Cout: int, k: int, sms: int,
               bf16: bool = False) -> WgradPlan:
    """The cached plan for one shape on a card of ``sms`` SMs."""
    return make_wgrad_plan(B, H, Cin, Cout, k, sms, bf16=bf16)


def _library() -> ctypes.CDLL:
    lib = _build.load("conv1d_weight_grad")
    if lib.conv1d_weight_grad_f32.argtypes is None:
        for entry in (lib.conv1d_weight_grad_f32, lib.conv1d_weight_grad_bf16):
            entry.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p, ctypes.c_void_p]
            entry.restype = ctypes.c_int
        lib.conv1d_weight_grad_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                                      ctypes.c_int]
        lib.conv1d_weight_grad_smem_bytes.restype = ctypes.c_int
        lib.conv1d_weight_grad_error_string.argtypes = [ctypes.c_int]
        lib.conv1d_weight_grad_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _check_layout(plan: WgradPlan, k: int) -> None:
    """Raises once per plan if the kernel refuses it or lays out another
    amount of shared memory than ``plan.smem_bytes``."""
    n = _library().conv1d_weight_grad_smem_bytes(k, plan.ints, plan.esize)
    if n != plan.smem_bytes:
        raise RuntimeError(f"conv1d_weight_grad plan {plan} at k {k}: the kernel lays out "
                           f"{n} bytes of shared memory (-1: refused), the plan "
                           f"{plan.smem_bytes}")


def _check_args(x, dy, k: int, dtype: torch.dtype, fn: str):
    for name, t in (("x", x), ("dy", dy)):
        if not t.is_cuda:
            raise ValueError(f"{fn}: {name} is on {t.device}, needs a CUDA tensor")
        if t.dtype != dtype:
            raise ValueError(f"{fn}: {name} is {t.dtype}, the kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
        if t.dim() != 3:
            raise ValueError(f"{fn}: {name} {tuple(t.shape)} must be 3-D")
    if dy.device != x.device:
        raise ValueError(f"{fn}: dy is on {dy.device}, x on {x.device}")
    if dy.shape[:2] != x.shape[:2]:
        raise ValueError(f"{fn}: x {tuple(x.shape)} and dy {tuple(dy.shape)} differ in (B, H)")
    if k not in KERNEL_SIZES:
        raise ValueError(f"{fn}: kernel size {k} not in {KERNEL_SIZES}")


def sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def _launch(wrapper, bf16: bool, x: torch.Tensor, dy: torch.Tensor, k: int,
            plan: WgradPlan | None) -> torch.Tensor:
    """B2's launch for the entry of ``bf16``, counted in ``wrapper.launches``."""
    fn = wrapper.__name__
    _check_args(x, dy, k, torch.bfloat16 if bf16 else torch.float32, fn)
    lib = _library()
    B, H, cin = x.shape
    cout = dy.shape[-1]
    out = torch.empty((k, cin, cout), dtype=torch.float32, device=x.device)
    if B * H == 0:
        return out.zero_()
    if plan is None:
        plan = wgrad_plan(B, H, cin, cout, k, sm_count(x.device), bf16)
    elif plan.R != B * H or plan.path != (BF16_PATH if bf16 else PATH):
        raise ValueError(f"{fn}: plan made for {plan.R} rows on the {plan.path} path, x has "
                         f"{B * H} rows of {x.dtype}")
    _check_layout(plan, k)
    entry = lib.conv1d_weight_grad_bf16 if bf16 else lib.conv1d_weight_grad_f32
    with torch.cuda.device(x.device):
        err = entry(x.data_ptr(), dy.data_ptr(), out.data_ptr(), B, H, cin, cout, k, plan.ints,
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: "
                           + lib.conv1d_weight_grad_error_string(err).decode())
    wrapper.launches += 1
    return out


def conv1d_weight_grad_cuda(x: torch.Tensor, dy: torch.Tensor, k: int,
                            plan: WgradPlan | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (builds it on first
    use), under ``plan`` or the shape's ``wgrad_plan``. Raises on a tensor,
    shape or plan the kernel does not take, and if the launch is refused."""
    return _launch(conv1d_weight_grad_cuda, False, x, dy, k, plan)


conv1d_weight_grad_cuda.launches = 0


def conv1d_weight_grad_bf16_cuda(x: torch.Tensor, dy: torch.Tensor, k: int,
                                 plan: WgradPlan | None = None) -> torch.Tensor:
    """The kernel's bf16 form, as ``conv1d_weight_grad_cuda``: bf16 x and
    dy, float32 dW, under ``plan`` or ``wgrad_plan(..., bf16=True)``'s."""
    return _launch(conv1d_weight_grad_bf16_cuda, True, x, dy, k, plan)


conv1d_weight_grad_bf16_cuda.launches = 0


def conv1d_weight_grad(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """dW (k, Cin, Cout) float32: the CUDA kernel for CUDA tensors (its bf16
    form for bf16 ones), the plain version for CPU tensors."""
    if not x.is_cuda:
        return conv1d_weight_grad_plain(x, dy, k)
    if x.dtype == torch.bfloat16:
        return conv1d_weight_grad_bf16_cuda(x, dy, k)
    return conv1d_weight_grad_cuda(x, dy, k)
