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
``conv1d_weight_grad_bf16_cuda`` is B2's bf16 form, a kernel of its own
(``csrc/conv1d_weight_grad_bf16.cu``: warpgroup ``wgmma`` with dy staged by
TMA; ``.launches`` counts it) under ``wgrad_bf16_plan`` (a
``WgradBf16Plan``; ``make_wgrad_bf16_plan`` fixes any field), and
``conv1d_weight_grad`` sends bf16 CUDA tensors to it.
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
STEP = 8                   # kStep: rows of a k-step (the mma's k)
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
    path: str      # PATH
    ints: object = dataclasses.field(compare=False, repr=False)  # ctypes int[6]

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
               k: int) -> int:
    """Dynamic shared memory of one plan: layout() in the kernel's source."""
    stage = (rows + k - 1) * (tci + PAD_COLS) + rows * (tco + PAD_COLS)
    part = k * tci * (tco + PAD_COLS) if cluster > 1 or slices > 1 else 0
    return 4 * max(stages * stage, part)


def make_wgrad_plan(B: int, H: int, Cin: int, Cout: int, k: int, sms: int,
                    tci: int | None = None, tco: int | None = None, rows: int | None = None,
                    stages: int | None = None, cluster: int | None = None,
                    slices: int | None = None) -> WgradPlan:
    """The plan for one shape; a keyword given fixes that choice. The
    defaults follow the best plans ``ops/conv_weight_grad_sweep.py`` timed
    at the main-path shapes on an H100 (``PERF.md``):

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
    step = STEP
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
    size = functools.partial(smem_bytes, tci, tco, rows, cluster=cluster, slices=slices, k=k)
    if stages is None:
        stages = min(MAX_STAGES, max(1, _ceil(chunks, cluster)))
        while stages > 1 and size(stages) + STATIC_SMEM > MAX_SMEM:
            stages -= 1
    if not 1 <= stages <= MAX_STAGES or size(stages) + STATIC_SMEM > MAX_SMEM:
        raise ValueError(f"conv1d_weight_grad_cuda: {stages} stages of {tci} x {tco} x "
                         f"{rows} rows do not fit {MAX_SMEM} bytes of shared memory")
    fields = (tci, tco, rows, stages, cluster, slices)
    return WgradPlan(*fields, R=R, threads=threads, tiles=tiles, chunks=chunks,
                     smem_bytes=size(stages), path=PATH, ints=(ctypes.c_int * 6)(*fields))


@functools.lru_cache(maxsize=None)
def wgrad_plan(B: int, H: int, Cin: int, Cout: int, k: int, sms: int) -> WgradPlan:
    """The cached plan for one shape on a card of ``sms`` SMs."""
    return make_wgrad_plan(B, H, Cin, Cout, k, sms)


def _library() -> ctypes.CDLL:
    lib = _build.load("conv1d_weight_grad")
    if lib.conv1d_weight_grad_f32.argtypes is None:
        lib.conv1d_weight_grad_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p, ctypes.c_void_p]
        lib.conv1d_weight_grad_f32.restype = ctypes.c_int
        lib.conv1d_weight_grad_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.conv1d_weight_grad_smem_bytes.restype = ctypes.c_int
        lib.conv1d_weight_grad_error_string.argtypes = [ctypes.c_int]
        lib.conv1d_weight_grad_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _check_layout(plan: WgradPlan, k: int) -> None:
    """Raises once per plan if the kernel refuses it or lays out another
    amount of shared memory than ``plan.smem_bytes``."""
    n = _library().conv1d_weight_grad_smem_bytes(k, plan.ints)
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


def conv1d_weight_grad_cuda(x: torch.Tensor, dy: torch.Tensor, k: int,
                            plan: WgradPlan | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (builds it on first
    use), under ``plan`` or the shape's ``wgrad_plan``. Raises on a tensor,
    shape or plan the kernel does not take, and if the launch is refused."""
    fn = "conv1d_weight_grad_cuda"
    _check_args(x, dy, k, torch.float32, fn)
    lib = _library()
    B, H, cin = x.shape
    cout = dy.shape[-1]
    out = torch.empty((k, cin, cout), dtype=torch.float32, device=x.device)
    if B * H == 0:
        return out.zero_()
    if plan is None:
        plan = wgrad_plan(B, H, cin, cout, k, sm_count(x.device))
    elif not isinstance(plan, WgradPlan) or plan.R != B * H:
        raise ValueError(f"{fn}: plan made for {getattr(plan, 'R', None)} rows on the "
                         f"{getattr(plan, 'path', 'bf16')} path, x has {B * H} rows of "
                         f"{x.dtype}")
    _check_layout(plan, k)
    with torch.cuda.device(x.device):
        err = lib.conv1d_weight_grad_f32(x.data_ptr(), dy.data_ptr(), out.data_ptr(), B, H, cin,
                                         cout, k, plan.ints,
                                         torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: "
                           + lib.conv1d_weight_grad_error_string(err).decode())
    conv1d_weight_grad_cuda.launches += 1
    return out


conv1d_weight_grad_cuda.launches = 0


# ---------------------------------------------------------------------------
# B2's bf16 form (csrc/conv1d_weight_grad_bf16.cu): a tile of 64 input
# channels x tco output channels, all k taps, on 1-3 warpgroups
# (wgmma m64nNk16 with the x rows of a tap from registers, dy by TMA from a
# ring), a cluster of CTAs splitting the rows. Constants of that source:
BF16_M = 64                # kM: input channels a tile (the wgmma's M)
BF16_STEP = 16             # kStep: rows a k-step (the wgmma's K)
BF16_MAX_ROWS = 128        # kMaxRows: dy rows a chunk
BF16_MAX_STAGES = 4        # kMaxStages
BF16_MAX_WGS = 3           # kMaxWgs: warpgroups a CTA
BF16_MAX_CHAIN = 64        # kMaxChainSteps: k-steps a tensor-core chain sums, at most
BF16_PAD = 8               # kPad: floats past a partial-tile row
BF16_ALIGN = 1024          # kAlign: the ring's swizzle period
BF16_STATIC_SMEM = BF16_MAX_STAGES * (8 + 4)  # kStaticSmem: each stage's mbarrier and count
BF16_NW = (16, 32, 64)     # output channels a warpgroup
# (taps, columns, warpgroups) of each instance: WGRAD_BF16_INSTANCES
BF16_INSTANCES = ((1, 32, 1), (1, 64, 2), (2, 32, 3), (2, 64, 2), (2, 64, 3), (3, 32, 1),
                  (3, 32, 2), (3, 64, 2), (3, 64, 3), (4, 64, 2), (5, 16, 1), (5, 16, 2),
                  (5, 32, 1), (5, 32, 2), (5, 64, 1), (5, 64, 2), (7, 32, 1), (9, 32, 1))
# The accumulators (taps x columns / 2) an instance may hold a thread: a sub-partition's
# 16,384 registers over the warps it holds leave 255 a thread for one or two warpgroups,
# 168 for three
BF16_MAX_ACC = {1: 160, 2: 160, 3: 96}
# The plan rule's choices (wgrad_bf16_plan), fitted to ops/conv_weight_grad_sweep.py --bf16 on
# an H100 (PERF.md)
BF16_NARROW = (16, 1, 0)   # (nw, wgs, split) where Cout is at most BF16_NARROW_COUT
BF16_NARROW_COUT = 64
BF16_DEEP = (64, 2, 0)     # where the 64 x 128 tiles number BF16_DEEP_TILES or more
BF16_DEEP_TILES = 96
BF16_MID = (64, 3, 1)      # otherwise: three warpgroups splitting the taps of 64 columns
BF16_CTAS = 64             # a cluster doubles while the grid stays within this many CTAs ...
BF16_RANK_ROWS = 128       # ... and each rank keeps this many rows at least


def bf16_taps(k: int, wgs: int, split: int) -> int:
    """Taps a warpgroup computes (taps_per)."""
    return _ceil(k, wgs) if split else k


@dataclasses.dataclass(frozen=True)
class WgradBf16Plan:
    """One launch plan of B2's bf16 kernel (struct Plan in
    csrc/conv1d_weight_grad_bf16.cu, in this order) and what follows from it
    for the shape it was made for. Every split of the reduction is a rank of
    one thread block cluster, added through distributed shared memory: no
    plan has a workspace in device memory."""
    nw: int        # output channels a warpgroup (its wgmma N)
    wgs: int       # warpgroups (threads: 128 wgs)
    split: int     # 0: the warpgroups split the output channels; 1: the taps
    rows: int      # dy rows a chunk (flattened (b, h) rows), a multiple of BF16_STEP
    stages: int    # ring depth
    cluster: int   # CTAs a tile, each taking a contiguous range of chunks
    chain: int     # k-steps between joins of the accumulators into a float32 tile; 0: none
    tma_x: int     # 1: x by TMA where Cin allows (a multiple of 8); 0: the CTA's threads stage x
    R: int         # rows of the reduction: B * H
    k: int         # kernel size
    Cin: int
    Cout: int
    smem_bytes: int  # dynamic shared memory of a CTA
    ints: object = dataclasses.field(compare=False, repr=False)  # ctypes int[8]
    # device index -> clusters the card holds at once, once checked
    checked: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def fields(self) -> dict:
        return {f: getattr(self, f) for f in ("nw", "wgs", "split", "rows", "stages",
                                              "cluster", "chain", "tma_x")}

    @property
    def kt(self) -> int:
        return bf16_taps(self.k, self.wgs, self.split)

    @property
    def tco(self) -> int:
        """Output channels a tile."""
        return self.nw if self.split else self.nw * self.wgs

    @property
    def tiles(self) -> int:
        return _ceil(self.Cin, BF16_M) * _ceil(self.Cout, self.tco)

    @property
    def grid(self) -> int:
        return self.tiles * self.cluster

    @property
    def threads(self) -> int:
        return 128 * self.wgs

    @property
    def chunks(self) -> int:
        return _ceil(self.R, self.rows)

    @property
    def x_staging(self) -> str:
        """How x reaches shared memory (the kernel also needs a 16-byte aligned base)."""
        return "tma" if self.tma_x and self.Cin % 8 == 0 else "threads"

    def rank_chunks(self, rank: int) -> range:
        """The chunks cluster rank ``rank`` reduces, as the kernel splits them."""
        return range(self.chunks * rank // self.cluster,
                     self.chunks * (rank + 1) // self.cluster)

    def chunk_rows(self, c: int) -> range:
        """The flattened (b, h) rows chunk ``c`` stages (rows past R are zeros)."""
        return range(c * self.rows, min((c + 1) * self.rows, self.R))

    def warpgroups(self) -> list[tuple[range, range]]:
        """Each warpgroup's (taps, output channels of the tile);
        taps past k read zeros and are dropped."""
        if self.split:
            return [(range(w * self.kt, (w + 1) * self.kt), range(self.nw))
                    for w in range(self.wgs)]
        return [(range(self.k), range(w * self.nw, (w + 1) * self.nw)) for w in range(self.wgs)]

    def longest_chain(self) -> int:
        """k-steps the longest tensor-core chain sums (longest_chain)."""
        steps = _ceil(self.chunks, self.cluster) * (self.rows // BF16_STEP)
        return self.chain if 0 < self.chain < steps else steps

    def accumulators(self) -> int:
        """float32 accumulators a thread holds."""
        return self.kt * self.nw // 2


def bf16_smem_bytes(nw: int, wgs: int, split: int, rows: int, stages: int, cluster: int,
                    chain: int, k: int) -> int:
    """Dynamic shared memory of one bf16 plan: layout() in
    csrc/conv1d_weight_grad_bf16.cu (the ring of x rows and dy atoms; the
    float32 partial tile over it, or past it with a chain join; the
    alignment slack)."""
    kt = bf16_taps(k, wgs, split)
    tco = nw if split else nw * wgs
    slots = kt * wgs if split else k
    x_rows = _ceil(rows + slots - 1, 8) * 8
    stage = _ceil(x_rows * 2 * BF16_M + rows * 2 * tco, BF16_ALIGN) * BF16_ALIGN
    ring = stages * stage
    part = 4 * slots * BF16_M * (tco + BF16_PAD) if cluster > 1 or chain > 0 else 0
    return BF16_ALIGN + (ring + part if chain > 0 else max(ring, part))


def make_wgrad_bf16_plan(B: int, H: int, Cin: int, Cout: int, k: int, nw: int = 64,
                         wgs: int = 1, split: int = 0, rows: int | None = None,
                         stages: int | None = None, cluster: int = 1, chain: int | None = None,
                         tma_x: int = 1) -> WgradBf16Plan:
    """The bf16 plan with these fields (plan_ok in the source): ``rows`` by
    default a rank's share of the rows rounded up to BF16_STEP, at most
    BF16_MAX_ROWS; ``stages`` the deepest ring that fits, no deeper than a
    rank's chunks; ``chain`` 0 where a rank's rows take at most BF16_MAX_CHAIN
    k-steps, else BF16_MAX_CHAIN. Raises ValueError for a plan the kernel
    does not take."""
    R = B * H
    if rows is None:
        rows = min(BF16_MAX_ROWS, _ceil(_ceil(R, cluster), BF16_STEP) * BF16_STEP)
    kt = bf16_taps(k, wgs, split)
    why = None
    if k not in KERNEL_SIZES or R <= 0 or Cin <= 0 or Cout <= 0:
        why = "a shape out of range"
    elif not (nw in BF16_NW and 1 <= wgs <= BF16_MAX_WGS and split in (0, 1)
              and 1 <= cluster <= MAX_CLUSTER and tma_x in (0, 1)):
        why = "a field out of range"
    elif split and wgs < 2:
        why = "the tap split takes two warpgroups or more"
    elif (kt, nw, wgs) not in BF16_INSTANCES:
        why = f"no instance holds {kt} taps of {nw} columns on {wgs} warpgroups"
    elif rows < BF16_STEP or rows % BF16_STEP or rows > BF16_MAX_ROWS:
        why = f"{rows} rows a chunk is not a multiple of {BF16_STEP} up to {BF16_MAX_ROWS}"
    if why is None:
        steps = _ceil(_ceil(R, rows), cluster) * (rows // BF16_STEP)
        if chain is None:
            chain = 0 if steps <= BF16_MAX_CHAIN else BF16_MAX_CHAIN
        if not 0 <= chain <= BF16_MAX_CHAIN or (chain == 0 and steps > BF16_MAX_CHAIN):
            why = (f"a tensor-core chain of {chain or steps} k-steps, more than "
                   f"{BF16_MAX_CHAIN}")
    if why is None:
        size = functools.partial(bf16_smem_bytes, nw, wgs, split, rows, cluster=cluster,
                                 chain=chain, k=k)
        deepest = min(BF16_MAX_STAGES, max(1, _ceil(_ceil(R, rows), cluster)))
        fits = [st for st in ((stages,) if stages else range(deepest, 0, -1))
                if 1 <= st <= BF16_MAX_STAGES and size(st) + BF16_STATIC_SMEM <= MAX_SMEM]
        if not fits:
            why = f"no ring fits {MAX_SMEM} bytes of shared memory"
    if why is not None:
        raise ValueError(f"conv1d_weight_grad_bf16_cuda: no plan at R {R}, {Cin}->{Cout}, k {k} "
                         f"with nw {nw}, wgs {wgs}, split {split}, rows {rows}, cluster "
                         f"{cluster}: {why}")
    fields = (nw, wgs, split, rows, fits[0], cluster, chain, tma_x)
    return WgradBf16Plan(*fields, R=R, k=k, Cin=Cin, Cout=Cout, smem_bytes=size(fits[0]),
                         ints=(ctypes.c_int * 8)(*fields))


@functools.lru_cache(maxsize=None)
def wgrad_bf16_plan(B: int, H: int, Cin: int, Cout: int, k: int, sms: int) -> WgradBf16Plan:
    """The cached bf16 plan for one shape: the rule fitted to
    ``ops/conv_weight_grad_sweep.py --bf16`` on an H100 (``PERF.md``: at the
    26 main-path shapes its plans sum to 0.760 ms over a training micro-step's
    33 launches and 0.222 over a value step's 20, against 0.739 and 0.193
    for the best plan at each shape).

    - Warpgroups: BF16_NARROW (one warpgroup of 16 columns) where Cout is at
      most BF16_NARROW_COUT; BF16_DEEP (two of 64 columns each, all taps)
      where the 64 x 128 tiles reach BF16_DEEP_TILES; else BF16_MID (three
      warpgroups splitting the taps of a 64-column tile, two taps each).
      Where k has no such instance, one warpgroup of 32 columns, or two
      splitting the taps.
    - Cluster: the fewest ranks that keep every tensor-core chain within
      BF16_MAX_CHAIN k-steps, doubled while the grid stays within BF16_CTAS
      (and ``sms``) and each rank keeps BF16_RANK_ROWS rows, at most
      MAX_CLUSTER. Few fat CTAs beat a full card: a launch is mostly fixed
      latency (the first TMA round trip, the epilogue's exchange).
    - Rows a chunk: a rank's share, at most BF16_MAX_ROWS; the deepest ring
      that fits; x by TMA where Cin allows.
    Where the rows outrun MAX_CLUSTER ranks' chains, the chain joins a
    float32 tile every BF16_MAX_CHAIN k-steps (the first layout whose ring
    and tile fit)."""
    R = B * H
    if Cout <= BF16_NARROW_COUT:
        first = BF16_NARROW
    elif _ceil(Cin, BF16_M) * _ceil(Cout, 128) >= BF16_DEEP_TILES:
        first = BF16_DEEP
    else:
        first = BF16_MID
    for nw, wgs, sp in (first, (32, 1, 0), (64, 2, 1)):
        if (bf16_taps(k, wgs, sp), nw, wgs) not in BF16_INSTANCES:
            continue
        tiles = _ceil(Cin, BF16_M) * _ceil(Cout, nw if sp else nw * wgs)
        cluster = 1
        while cluster < MAX_CLUSTER and _ceil(R, cluster * BF16_MAX_ROWS) * (
                BF16_MAX_ROWS // BF16_STEP) > BF16_MAX_CHAIN:
            cluster *= 2
        while (2 * cluster <= MAX_CLUSTER and 2 * cluster * tiles <= min(BF16_CTAS, sms)
               and R >= 2 * cluster * BF16_RANK_ROWS):
            cluster *= 2
        try:
            return make_wgrad_bf16_plan(B, H, Cin, Cout, k, nw, wgs, sp, cluster=cluster)
        except ValueError:
            continue
    raise ValueError(f"conv1d_weight_grad_bf16_cuda: no plan fits R {R}, {Cin}->{Cout}, k {k}")


def _library_bf16() -> ctypes.CDLL:
    lib = _build.load("conv1d_weight_grad_bf16")
    if lib.conv1d_weight_grad_bf16.argtypes is None:
        lib.conv1d_weight_grad_bf16.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p, ctypes.c_void_p]
        lib.conv1d_weight_grad_bf16.restype = ctypes.c_int
        lib.conv1d_weight_grad_bf16_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.conv1d_weight_grad_bf16_smem_bytes.restype = ctypes.c_int
        lib.conv1d_weight_grad_bf16_plan_check.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                                           ctypes.c_void_p, ctypes.c_void_p]
        lib.conv1d_weight_grad_bf16_plan_check.restype = ctypes.c_int
        lib.conv1d_weight_grad_bf16_error_string.argtypes = [ctypes.c_int]
        lib.conv1d_weight_grad_bf16_error_string.restype = ctypes.c_char_p
    return lib


def _check_bf16_plan(fn: str, lib, plan: WgradBf16Plan, device) -> None:
    """On a plan's first use on a card: the kernel's shared-memory layout
    against ``plan.smem_bytes`` and that the card holds one of its clusters
    (the kernel's opt-ins are made by that query). Raises with the reason
    otherwise."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index in plan.checked:
        return
    smem, clusters = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        err = lib.conv1d_weight_grad_bf16_plan_check(plan.k, plan.ints, ctypes.byref(smem),
                                                     ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError(f"{fn}: plan {plan} refused: "
                           + lib.conv1d_weight_grad_bf16_error_string(err).decode())
    if smem.value != plan.smem_bytes:
        raise RuntimeError(f"{fn}: the kernel lays out {smem.value} bytes of shared memory for "
                           f"plan {plan}, bf16_smem_bytes {plan.smem_bytes}")
    if clusters.value < 1:
        raise RuntimeError(f"{fn}: plan {plan} cannot be scheduled on this card "
                           f"(cudaOccupancyMaxActiveClusters is 0)")
    plan.checked[index] = clusters.value


def conv1d_weight_grad_bf16_cuda(x: torch.Tensor, dy: torch.Tensor, k: int,
                                 plan: WgradBf16Plan | None = None) -> torch.Tensor:
    """Launch B2's bf16 kernel on PyTorch's current stream (built on first
    use): bf16 x (B, H, Cin) and dy (B, H, Cout) -> float32 dW (k, Cin,
    Cout), under ``plan`` or ``wgrad_bf16_plan``'s. Raises on a tensor,
    shape or plan the kernel does not take, and if the launch is refused."""
    fn = "conv1d_weight_grad_bf16_cuda"
    _check_args(x, dy, k, torch.bfloat16, fn)
    B, H, cin = x.shape
    cout = dy.shape[-1]
    out = torch.empty((k, cin, cout), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if B * H == 0:
        return out.zero_()
    if plan is None:
        plan = wgrad_bf16_plan(B, H, cin, cout, k, sm_count(x.device))
    elif not isinstance(plan, WgradBf16Plan) or (plan.R, plan.k, plan.Cin, plan.Cout) != (
            B * H, k, cin, cout):
        raise ValueError(f"{fn}: plan {plan} is no bf16 plan for {B * H} rows, {cin}->{cout}, "
                         f"k {k}")
    lib = _library_bf16()
    _check_bf16_plan(fn, lib, plan, x.device)
    with torch.cuda.device(x.device):
        err = lib.conv1d_weight_grad_bf16(x.data_ptr(), dy.data_ptr(), out.data_ptr(), B, H, cin,
                                          cout, k, plan.ints,
                                          torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: "
                           + lib.conv1d_weight_grad_bf16_error_string(err).decode())
    conv1d_weight_grad_bf16_cuda.launches += 1
    return out


conv1d_weight_grad_bf16_cuda.launches = 0


def conv1d_weight_grad(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """dW (k, Cin, Cout) float32: the CUDA kernel for CUDA tensors (B2's bf16
    form for bf16 ones), the plain version for CPU tensors."""
    if not x.is_cuda:
        return conv1d_weight_grad_plain(x, dy, k)
    if x.dtype == torch.bfloat16:
        return conv1d_weight_grad_bf16_cuda(x, dy, k)
    return conv1d_weight_grad_cuda(x, dy, k)
