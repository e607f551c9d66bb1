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
  it). It takes CUDA tensors only and raises on anything it does not take,
  or on a plan the card cannot schedule. ``conv_gn_mish_cuda.launches``
  counts its launches.
- ``conv_plan``: the kernel's launch plan for one shape (cluster size,
  batch rows per cluster, threads, slices, row tile, chunk, ring stages),
  computed once per shape and cached; ``make_plan`` builds any other plan,
  which ``conv_gn_mish_cuda(..., plan=...)`` runs (the card tests and
  ``ops/conv_block_sweep.py`` do).
- ``conv_gn_mish``: the autograd entry the model calls. Its forward launches
  the kernel for CUDA tensors and runs the plain version for CPU tensors.
  Its backward recomputes the pre-norm conv output (as the JAX kernel's
  custom VJP recomputes), backpropagates through GroupNorm, the affine and
  Mish in plain PyTorch, and takes the conv's dW from
  ``ops/conv_weight_grad.py`` (the B2 kernel for CUDA tensors); dx is the
  transposed conv of the pre-norm gradient (a library call, as XLA's conv
  computes it in the JAX package).

The horizon-sharded form (sequence-sharded sampling; the header of
``csrc/conv_gn_mish.cu``): each rank holds H / R frames, and GroupNorm's
statistics span them all.

- ``conv_gn_stats_plain`` / ``conv_gn_stats_cuda`` (K1): the conv of the
  rank's rows with a k // 2-row halo on each side, plus the bias, and each
  (batch row, group)'s local mean and M2 (two-pass).
- ``chan_merge``: every rank's (mean, M2), gathered exactly, merged in
  float64 with Chan's formula, M2 = sum M2_i + sum n_i (mean_i - mean)^2,
  into the global (mean, rstd).
- ``gn_affine_mish_plain`` / ``gn_affine_mish_cuda`` (K2): normalise with
  the merged statistics, affine, Mish.
- ``conv_gn_mish_sharded``: K1, the merge, K2; sampling only (it raises
  where a gradient is asked of it: JAX shards no training over the horizon).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from . import _build
from .conv_weight_grad import conv1d_weight_grad

KERNEL_SIZES = (1, 3, 5, 7, 9)
# Constants of csrc/conv_gn_mish.cu
MAX_GROUP_CHANNELS = 256  # kMaxGroupChannels
TM, TN = 8, 4             # kTM x kTN: a thread's output tile, rows x channels
MAX_THREADS = 256         # kMaxThreads
MAX_STAGES = 4            # kMaxStages
MAX_ROWS = 4              # kMaxRows: batch rows per cluster
CLUSTER_SIZES = (1, 2, 4, 8)
MAX_SMEM = 227 * 1024     # kMaxSmem: a CTA's shared memory, dynamic and static
# the statistics' slots, the group's bias / gamma / beta, the mbarriers
STATIC_SMEM = 4 * (2 * MAX_ROWS + 3 * MAX_GROUP_CHANNELS) + 16 * MAX_STAGES
# The plan's defaults (make_plan)
STAGES = 3                # ring depth
CHANNELS_PER_SLICE = 8    # input channels a slice takes from each chunk, at most
DEEP_TILE_H = 40          # row tiles this short take two batch rows (and two ranks)
DEEP_MIN_CIN = 256        # ... where each of the two ranks keeps 128+ input channels
FILL_CTAS = 256           # K1 grows its cluster until its grid has this many CTAs (stats_plan)


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


def conv_gn_stats_plain(x_halo, w, b, groups: int = 8):
    """K1's plain version: (B, H + k - 1, Cin) -> pre-norm (B, H, Cout) and
    (B, groups, 2) per-(batch row, group) (mean, M2) over the H local rows."""
    pre = F.conv1d(x_halo.transpose(1, 2), w.permute(2, 1, 0), b).transpose(1, 2)
    B, H, C = pre.shape
    g = pre.reshape(B, H, groups, C // groups)
    mean = g.mean(dim=(1, 3))
    m2 = ((g - mean[:, None, :, None]) ** 2).sum(dim=(1, 3))
    return pre, torch.stack([mean, m2], dim=-1)


def gn_affine_mish_plain(pre, stats, gamma, beta, groups: int = 8):
    """K2's plain version: Mish((pre - mean) * rstd * gamma + beta) with
    ``stats`` (B, groups, 2) the merged (mean, rstd)."""
    B, H, C = pre.shape
    st = stats.repeat_interleave(C // groups, dim=1)  # (B, C, 2)
    out = (pre - st[:, None, :, 0]) * st[:, None, :, 1] * gamma + beta
    return out * torch.tanh(F.softplus(out))


def chan_merge(parts, count: int, eps: float):
    """Per-rank (R, B, groups, 2) (mean, M2), each over ``count`` values ->
    the (B, groups, 2) float32 (mean, rstd) of the union, in float64:
    mean = sum mean_i / R, M2 = sum M2_i + count sum (mean_i - mean)^2."""
    p = parts.to(torch.float64)
    means, m2 = p[..., 0], p[..., 1]
    mean = means.mean(dim=0)
    total = m2.sum(dim=0) + count * ((means - mean) ** 2).sum(dim=0)
    var = total / (count * p.shape[0])
    return torch.stack([mean, torch.rsqrt(var + eps)], dim=-1).to(torch.float32)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """One launch plan (struct Plan in csrc/conv_gn_mish.cu) and what
    follows from it for the shape it was made for."""
    cluster: int   # CTAs per (R batch rows, group): rank r takes Cin[r Cin/C, (r+1) Cin/C)
    rows: int      # R: batch rows per cluster, sharing every staged weight chunk
    threads: int   # n_out * slices: every thread owns an output tile
    slices: int    # ways each chunk's channels are split among the threads
    tile_h: int    # output rows per tile, a multiple of TM
    ck: int        # input channels per ring stage, a multiple of slices
    stages: int    # ring depth
    n_out: int     # threads of one slice: rows * (tile_h / TM) * (cgp / TN)
    n_tiles: int   # row tiles covering H
    smem_bytes: int  # dynamic shared memory per CTA
    grid: int      # CTAs: ceil(B / rows) * groups * cluster
    ints: object = dataclasses.field(compare=False, repr=False)  # ctypes int[7]
    # (H, Cin, Cout, k, groups, vec, stats, device index) -> clusters the card holds at once
    checked: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def rank_channels(self, cin: int) -> list[tuple[int, int]]:
        """[lo, hi) input channels of each cluster rank, as the kernel splits them."""
        return [(cin * r // self.cluster, cin * (r + 1) // self.cluster)
                for r in range(self.cluster)]


def smem_bytes(H: int, cg: int, k: int, rows: int, threads: int, tile_h: int, slices: int,
               ck: int, stages: int) -> int:
    """Dynamic shared memory of one plan: layout() in csrc/conv_gn_mish.cu."""
    cgp = _ceil(cg, TN) * TN
    xs_row = tile_h - TM + _ceil(TM + k - 1, 4) * 4
    stage = k * ck * cgp + ck * rows * xs_row
    tile = rows * tile_h * cgp
    ring = max(stages * stage, slices * tile if slices > 1 else 0, rows * threads)
    return 4 * (ring + (2 if _ceil(H, tile_h) > 1 else 1) * tile)


def make_plan(B: int, H: int, Cin: int, Cout: int, k: int, groups: int,
              cluster: int | None = None, rows: int | None = None, slices: int | None = None,
              channels_per_slice: int | None = None, stages: int | None = None) -> ConvPlan:
    """The plan for one shape; a keyword given fixes that choice. The
    defaults follow the best of the plans ``ops/conv_block_sweep.py`` timed
    at the U-Net's main-path shapes on an H100 (``PERF.md``).

    - Row tile: the whole of H where a batch row's (H / TM) x (cgp / TN)
      tiles fit MAX_THREADS, else equal tiles that do.
    - Rows R and cluster C: 2 and 2 at the deep levels (row tiles of at
      most DEEP_TILE_H rows, at least DEEP_MIN_CIN input channels, two
      rows' tiles within MAX_THREADS): every staged weight chunk then serves
      two batch rows, and two ranks split the channels, so the grid keeps
      B x groups CTAs. Elsewhere 1 and 1: a tall tile already reuses each
      weight enough, and few channels leave too little to split.
    - Slices: the most (up to Cin, at least one warp's worth) that keep
      threads = n_out * slices a whole number of warps, or simply the most.
    - Chunk: ck = slices * channels per slice. Of the powers of two up to
      CHANNELS_PER_SLICE that leave a rank two chunks or more (where it has
      the channels) and fit a ring of STAGES stages in MAX_SMEM, the one
      with the fewest chunks x (channels per slice + 1): zero-padded
      channels cost FMAs, and each chunk costs about one channel's work in
      waits. Fewer stages where none fits.
    """
    cg = Cout // groups
    ntc = _ceil(cg, TN)
    rg_all = _ceil(H, TM)
    n_tiles = _ceil(rg_all, max(1, MAX_THREADS // ntc))
    rg = _ceil(rg_all, n_tiles)
    tile_h = rg * TM
    deep = (B >= 2 and tile_h <= DEEP_TILE_H and Cin >= DEEP_MIN_CIN
            and 2 * rg * ntc <= MAX_THREADS)
    if rows is None:
        rows = 2 if deep else 1
    n_out = rows * rg * ntc
    if not 1 <= rows <= MAX_ROWS or n_out > MAX_THREADS:
        raise ValueError(f"conv_gn_mish_cuda: {rows} rows of {rg * ntc} output tiles each "
                         f"exceed {MAX_THREADS} threads")
    if cluster is None:
        cluster = 2 if deep else 1
    if cluster not in CLUSTER_SIZES or cluster > Cin:
        raise ValueError(f"conv_gn_mish_cuda: cluster size {cluster} not in {CLUSTER_SIZES} "
                         f"or above Cin {Cin}")
    if slices is None:  # no more slices than channels, but at least one warp
        most = min(MAX_THREADS // n_out, max(Cin, _ceil(32, n_out)))
        slices = next((s for s in range(most, 0, -1) if n_out * s % 32 == 0), most)
    threads = n_out * slices
    if not 32 <= threads <= MAX_THREADS:
        raise ValueError(f"conv_gn_mish_cuda: {threads} threads is no plan")
    need = _ceil(_ceil(Cin, cluster), slices)  # channels per slice a rank needs
    size = functools.partial(smem_bytes, H, cg, k, rows, threads, tile_h, slices)
    best = None
    for st in ((stages,) if stages else (STAGES, 2)):
        choices = ((channels_per_slice,) if channels_per_slice else
                   [c for c in (1, 2, 4, 8) if c <= min(CHANNELS_PER_SLICE, max(1, need // 2))])
        fits = [c for c in choices if size(slices * c, st) <= MAX_SMEM - STATIC_SMEM]
        if fits:  # the fewest channel-steps, a chunk's waits counted as one more
            cps = min(fits, key=lambda c: _ceil(need, c) * (c + 1))
            best = (slices * cps, st)
            break
    if best is None:
        raise ValueError(f"conv_gn_mish_cuda: no plan fits {MAX_SMEM} bytes of shared memory "
                         f"at H {H}, Cin {Cin}, {cg} channels per group, k {k}")
    ck, st = best
    fields = (cluster, rows, threads, slices, tile_h, ck, st)
    return ConvPlan(*fields, n_out=n_out, n_tiles=n_tiles, smem_bytes=size(ck, st),
                    grid=_ceil(B, rows) * groups * cluster, ints=(ctypes.c_int * 7)(*fields))


@functools.lru_cache(maxsize=None)
def conv_plan(B: int, H: int, Cin: int, Cout: int, k: int, groups: int) -> ConvPlan:
    """The cached plan for one shape."""
    return make_plan(B, H, Cin, Cout, k, groups)


@functools.lru_cache(maxsize=None)
def stats_plan(B: int, H: int, Cin: int, Cout: int, k: int, groups: int) -> ConvPlan:
    """K1's cached plan: B1's, its cluster doubled (up to 8, one channel a
    rank at least) while the grid has fewer than FILL_CTAS CTAs. Sampling's
    small batches leave B1's plans few CTAs (B 4 x 8 groups: 32 for 132 SMs);
    on an H100 clusters of 8 took a rank's 33 K1 launches of the sharded
    dim-128 forward (B 4, 512 of H 1024) from 5.65 to 2.50 ms (``PERF.md``)."""
    plan = conv_plan(B, H, Cin, Cout, k, groups)
    cluster = plan.cluster
    while cluster < max(CLUSTER_SIZES) and plan.grid // plan.cluster * cluster < FILL_CTAS \
            and 2 * cluster <= Cin:
        cluster *= 2
    if cluster == plan.cluster:
        return plan
    return make_plan(B, H, Cin, Cout, k, groups, cluster=cluster, rows=plan.rows)


def _library() -> ctypes.CDLL:
    lib = _build.load("conv_gn_mish")
    if lib.conv_gn_mish_f32.argtypes is None:
        lib.conv_gn_mish_f32.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        lib.conv_gn_mish_f32.restype = ctypes.c_int
        lib.conv_gn_mish_f32_plan_check.argtypes = [ctypes.c_int] * 5 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.conv_gn_mish_f32_plan_check.restype = ctypes.c_int
        lib.conv_gn_stats_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p, ctypes.c_void_p]
        lib.conv_gn_stats_f32.restype = ctypes.c_int
        lib.gn_affine_mish_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.gn_affine_mish_f32.restype = ctypes.c_int
        lib.conv_gn_mish_error_string.argtypes = [ctypes.c_int]
        lib.conv_gn_mish_error_string.restype = ctypes.c_char_p
    return lib


def max_active_clusters(plan: ConvPlan, H: int, Cin: int, Cout: int, k: int, groups: int,
                        vec: bool, device: torch.device, stats: bool = False) -> int:
    """How many of the plan's clusters the card holds at once
    (cudaOccupancyMaxActiveClusters; with a cluster of 1, the CTAs it
    holds), asked on the plan's first launch; ``stats`` asks it of K1.
    Raises, with the reason, if that is none, or if the kernel's shared
    memory layout disagrees with smem_bytes()."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (H, Cin, Cout, k, groups, vec, stats, index)
    n = plan.checked.get(key)
    if n is None:
        lib = _library()
        smem, clusters = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(index):
            err = lib.conv_gn_mish_f32_plan_check(H, Cin, Cout, k, groups, plan.ints, int(vec),
                                                  int(stats), ctypes.byref(smem),
                                                  ctypes.byref(clusters))
        if err != 0:
            raise RuntimeError(f"conv_gn_mish plan {plan} refused: "
                               + lib.conv_gn_mish_error_string(err).decode())
        if smem.value != plan.smem_bytes:
            raise RuntimeError(f"conv_gn_mish plan {plan}: the kernel lays out {smem.value} "
                               f"bytes of shared memory, the plan {plan.smem_bytes}")
        if clusters.value < 1:
            raise RuntimeError(
                f"conv_gn_mish plan {plan} cannot be scheduled on this card: no cluster of "
                f"{plan.cluster} CTAs x {plan.threads} threads x {plan.smem_bytes} bytes of "
                f"shared memory fits (cudaOccupancyMaxActiveClusters is 0)")
        n = plan.checked[key] = clusters.value
    return n


def _check_tensors(fn: str, device, **tensors):
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{fn}: {name} is on {t.device}, needs a CUDA tensor")
        if t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} is {t.dtype}, the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
        if t.device != device:
            raise ValueError(f"{fn}: {name} is on {t.device}, x on {device}")


def _check_args(x, w, b, gamma, beta, groups: int, fn: str = "conv_gn_mish_cuda"):
    tensors = {"x": x, "w": w, "b": b, "gamma": gamma, "beta": beta}
    _check_tensors(fn, x.device, **{k: v for k, v in tensors.items() if v is not None})
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"{fn}: x {tuple(x.shape)} must be (B, H, Cin) and "
                         f"w {tuple(w.shape)} (k, Cin, Cout)")
    k, cin, cout = w.shape
    if x.shape[2] != cin:
        raise ValueError(f"{fn}: x has {x.shape[2]} channels, w expects {cin}")
    if k not in KERNEL_SIZES:
        raise ValueError(f"{fn}: kernel size {k} not in {KERNEL_SIZES}")
    if groups <= 0 or cout % groups:
        raise ValueError(f"{fn}: Cout {cout} is not a multiple of groups {groups}")
    if cout // groups > MAX_GROUP_CHANNELS:
        raise ValueError(f"{fn}: {cout // groups} channels per group, the "
                         f"kernel takes at most {MAX_GROUP_CHANNELS}")
    for name in ("b", "gamma", "beta"):
        if tensors[name] is not None and tuple(tensors[name].shape) != (cout,):
            raise ValueError(f"{fn}: {name} must be ({cout},)")


def _raise_on_error(lib, err: int, fn: str):
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: "
                           + lib.conv_gn_mish_error_string(err).decode())


def conv_gn_mish_cuda(x, w, b, gamma, beta, groups: int = 8, eps: float = 1e-5,
                      plan: ConvPlan | None = None):
    """Launch the CUDA kernel on PyTorch's current stream (builds it on
    first use) with ``plan``, by default the shape's cached ``conv_plan``.
    Raises on a tensor or shape the kernel does not take, on a plan the card
    cannot schedule, and if the launch is refused."""
    _check_args(x, w, b, gamma, beta, groups)
    lib = _library()
    B, H, cin = x.shape
    k, _, cout = w.shape
    out = torch.empty((B, H, cout), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if plan is None:
        plan = conv_plan(B, H, cin, cout, k, groups)
    vec = (cout // groups) % 4 == 0 and w.data_ptr() % 16 == 0
    max_active_clusters(plan, H, cin, cout, k, groups, vec, x.device)
    with torch.cuda.device(x.device):
        err = lib.conv_gn_mish_f32(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            out.data_ptr(), B, H, cin, cout, k, groups, eps, ctypes.addressof(plan.ints),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on_error(lib, err, "conv_gn_mish")
    conv_gn_mish_cuda.launches += 1
    return out


conv_gn_mish_cuda.launches = 0


def conv_gn_stats_cuda(x_halo, w, b, groups: int = 8, plan: ConvPlan | None = None):
    """Launch K1 on PyTorch's current stream: ``x_halo`` (B, H + k - 1, Cin)
    -> pre-norm (B, H, Cout) and (B, groups, 2) (mean, M2), with ``plan`` or
    ``stats_plan``'s for the H output rows. Raises on what the kernel does not
    take."""
    fn = "conv_gn_stats_cuda"
    _check_args(x_halo, w, b, None, None, groups, fn)
    k, cin, cout = w.shape
    B, H = x_halo.shape[0], x_halo.shape[1] - (k - 1)
    if H <= 0:
        raise ValueError(f"{fn}: {x_halo.shape[1]} rows hold no output row of a k {k} conv")
    pre = torch.empty((B, H, cout), dtype=torch.float32, device=x_halo.device)
    stats = torch.empty((B, groups, 2), dtype=torch.float32, device=x_halo.device)
    if pre.numel() == 0:
        return pre, stats
    vec = (cout // groups) % 4 == 0 and w.data_ptr() % 16 == 0
    plan = plan or stats_plan(B, H, cin, cout, k, groups)
    max_active_clusters(plan, H, cin, cout, k, groups, vec, x_halo.device, stats=True)
    lib = _library()
    with torch.cuda.device(x_halo.device):
        err = lib.conv_gn_stats_f32(
            x_halo.data_ptr(), w.data_ptr(), b.data_ptr(), pre.data_ptr(), stats.data_ptr(),
            B, H, cin, cout, k, groups, ctypes.addressof(plan.ints),
            torch.cuda.current_stream(x_halo.device).cuda_stream)
    _raise_on_error(lib, err, fn)
    conv_gn_stats_cuda.launches += 1
    return pre, stats


conv_gn_stats_cuda.launches = 0


def gn_affine_mish_cuda(pre, stats, gamma, beta, groups: int = 8):
    """Launch K2 on PyTorch's current stream: (B, H, C) pre-norm values and
    (B, groups, 2) merged (mean, rstd) -> (B, H, C)."""
    fn = "gn_affine_mish_cuda"
    _check_tensors(fn, pre.device, pre=pre, stats=stats, gamma=gamma, beta=beta)
    if pre.dim() != 3:
        raise ValueError(f"{fn}: pre {tuple(pre.shape)} must be (B, H, C)")
    B, H, C = pre.shape
    if groups <= 0 or C % groups:
        raise ValueError(f"{fn}: C {C} is not a multiple of groups {groups}")
    if tuple(stats.shape) != (B, groups, 2):
        raise ValueError(f"{fn}: stats {tuple(stats.shape)} must be ({B}, {groups}, 2)")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if tuple(t.shape) != (C,):
            raise ValueError(f"{fn}: {name} must be ({C},)")
    out = torch.empty_like(pre)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(pre.device):
        err = lib.gn_affine_mish_f32(pre.data_ptr(), stats.data_ptr(), gamma.data_ptr(),
                                     beta.data_ptr(), out.data_ptr(), B, H, C, groups,
                                     torch.cuda.current_stream(pre.device).cuda_stream)
    _raise_on_error(lib, err, fn)
    gn_affine_mish_cuda.launches += 1
    return out


gn_affine_mish_cuda.launches = 0


def conv_gn_mish_sharded(x_halo, w, b, gamma, beta, groups: int, eps: float, group):
    """Conv1d + GroupNorm + Mish of this rank's frames of a horizon split
    over the ranks of ``group`` (a ``utils.seq`` shard): ``x_halo`` is the
    rank's (B, H, Cin) rows with k // 2 rows of each neighbour (zeros at the
    trajectory's ends) on each side. K1, the statistics merged over the
    ranks, K2: the kernels for CUDA tensors, their plain versions for CPU
    tensors. Sampling only: raises where a gradient is asked of it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_halo, w, b, gamma, beta)):
        raise RuntimeError("conv_gn_mish_sharded serves sampling only: no gradient flows "
                           "through the horizon-sharded conv block (run under "
                           "torch.no_grad or torch.inference_mode)")
    x_halo = x_halo.contiguous()
    if x_halo.is_cuda:
        pre, stats = conv_gn_stats_cuda(x_halo, w, b, groups)
    else:
        pre, stats = conv_gn_stats_plain(x_halo, w, b, groups)
    # every rank's statistics, gathered exactly: the same merged bits on every rank
    merged = chan_merge(group.all_gather(stats), pre.shape[1] * (pre.shape[2] // groups), eps)
    if pre.is_cuda:
        return gn_affine_mish_cuda(pre, merged, gamma, beta, groups)
    return gn_affine_mish_plain(pre, merged, gamma, beta, groups)


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
