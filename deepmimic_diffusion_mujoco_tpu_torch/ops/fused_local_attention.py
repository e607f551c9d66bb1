"""Windowed look-around attention over all heads, straight from the QKV
projection: the local-attention transformer's attention core.

Replaces the TPU kernel ``deepmimic_diffusion_mujoco_tpu/ops/pallas/
fused_local_attention.py:fused_qkv_local_attention``. Layout is the JAX
package's: qkv (B, N, 3*h*dh) as the QKV Dense emits it, context
(B, N, h*dh) as the out-projection takes it.

The semantics are the TPU kernel's chunk plan (``plan``): N is padded to a
multiple of the window (pad keys are valid zero keys); a padded length up to
256 is one chunk attending to itself, a longer one (a multiple of 128) runs
in 128-row chunks whose keys are the chunk plus P rows on each side, the
edge slices clamped and masked. Rotary runs at absolute positions (queries
shifted by look_forward * w). Masked scores are a finite -1e9 and the
softmax spans the chunk's K keys, so a query whose keys are all masked
(possible only with ``key_mask``) gets the mean of V over those K rows.

- ``fused_qkv_local_attention_plain``: the plain PyTorch version, a
  transcription of the chunk semantics. The CPU path, the backward, and the
  oracle the CUDA kernel is held against.
- ``fused_qkv_local_attention_cuda``: the hand-written kernel
  (``csrc/local_attention.cu``; its header states the design and what
  bounds it). CUDA tensors only; ``.launches`` counts its launches.
- ``attention_plan``: the kernel's launch plan for one shape (query rows
  per block, key rows staged at once, tensor or CUDA cores), cached per
  shape; ``launch_plan=`` runs any other (the card
  tests and ``ops/local_attention_sweep.py`` do).
- ``fused_qkv_local_attention``: the autograd entry the model calls. Its
  forward launches the kernel for CUDA tensors and runs the plain version
  for CPU tensors; its backward differentiates the plain version with the
  same masks and keep bits.

bf16 (a model built with ``bf16=True``): a bf16 qkv gives a bf16 context,
computed in float32 between (the TPU kernel upcasts its bf16 qkv and writes
``qkv.dtype``). The plain version converts to float32, runs the same chunk
semantics and rounds once; ``fused_qkv_local_attention_bf16_cuda`` launches
the kernel's bf16 entry (the same core as its own kernel: bf16 rows staged
as bf16, widened where they are read, the store rounding once; its plan is
``attention_plan(..., elem=2)``) and counts it in its own ``.launches``;
the float32 keep mask goes with it. The backward at bf16 differentiates the
plain version on the float32 widening of qkv and returns the gradient in
qkv's dtype, as JAX's vjp of its chunk transcription does.

``key_mask`` (B, N), > 0 marking valid frames, must be PREFIX-valid (valid
frames first, padding at the end, as jagged batches are): the kernel takes
per-sequence lengths. ``DMDM_CHECK_MASKS=1`` checks that on every call.

B3's halo entry (K3, sequence-sharded sampling): a rank holding frames
[g0, g0 + Nq) of a horizon split over ranks attends from its own rows over
a slab of them with w rows of each neighbour (none at the trajectory's ends;
none after when causal): ``local_attention_halo_plain`` /
``local_attention_halo_cuda`` / ``local_attention_halo``. It is B3's chunk
semantics with one chunk of the Nq own rows and P = w, rotary at the global
positions, prefix lengths given in slab rows (``halo_lengths``); every
query whose window holds a valid key gets what the unsharded call gives
it. A query whose keys are all masked gets the mean of V over the slab's
key slots, not over B3's 128-row chunk and its halo. Sampling only. At
bf16 (a bf16 model's horizon split) a bf16 slab gives a bf16 context: the
plain version widens, computes and rounds once, and
``local_attention_halo_bf16_cuda`` is B3's bf16 core started from slab row
q0 (its own ``.launches``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import os

import numpy as np
import torch

from ..utils.rng import draw_rows
from . import _build

NEG_INF = -1e9
CHUNK = 128
MAX_SINGLE = 256  # largest padded length run as one chunk
HEAD_DIMS = (16, 32, 64, 128)  # head widths csrc/local_attention.cu is built for

CHECK_MASKS = os.environ.get("DMDM_CHECK_MASKS", "0") == "1"


def plan(N: int, w: int, causal: bool) -> dict | None:
    """The chunk plan for sequence length N and window w, or None where the
    kernel's semantics do not cover the shape."""
    if w > CHUNK:
        return None
    lb, lf = 1, (0 if causal else 1)
    Np = -(-N // w) * w  # autopad to a window multiple
    if Np % 8:
        return None
    nc = Np // CHUNK
    if Np % CHUNK == 0 and nc > 1:
        if max(lb, lf) * w > CHUNK:
            return None
        P = w if CHUNK % w == 0 else CHUNK
        return {"Np": Np, "C": CHUNK, "nc": nc, "P": P, "K": CHUNK + 2 * P}
    if Np <= MAX_SINGLE:
        return {"Np": Np, "C": Np, "nc": 1, "P": 0, "K": Np}
    return None


def supports(N: int, window_size: int, use_xpos: bool, causal: bool = False) -> bool:
    return not use_xpos and plan(N, window_size, causal) is not None


def dropout_keep_mask(generator: torch.Generator, keep_prob: float, batch: int, N: int,
                      heads: int, window_size: int, causal: bool = False,
                      dtype=torch.float32):
    """Kernel-layout attention-dropout keep mask (B, Np, h*K): one
    Bernoulli(keep_prob) draw per (query, head, chunk key), on the
    generator's device."""
    p = plan(N, window_size, causal)
    if p is None:
        return None
    shape = (batch, p["Np"], heads * p["K"])
    u = draw_rows(generator, shape,
                  lambda s: torch.rand(s, generator=generator, device=generator.device))
    return (u < keep_prob).to(dtype)


def window_mask(ti, tj, w, lb, lf, causal, exact, invalid):
    """True where query position ti may not see key position tj (numpy)."""
    wi, wj = ti // w, tj // w
    bad = (wj < wi - lb) | (wj > wi + lf) | invalid
    if causal:
        bad = bad | (ti < tj)
        if exact:
            bad = bad | (ti > tj + w * lb)
    elif exact:
        bad = bad | (tj - w * lf > ti) | (ti > tj + w * lb)
    return bad


def chunk_index_sets(p: dict):
    """(nc, K) key-row indices of each chunk and (nc, 1, K) flags of the
    clamped edge slices, which are masked."""
    Np, C, nc, P, K = (p[k] for k in ("Np", "C", "nc", "P", "K"))
    if P == 0:  # the single plan: the chunk attends to itself
        return np.arange(Np)[None, :], np.zeros((1, 1, K), bool)
    seg = (np.arange(K) >= P).astype(int) + (np.arange(K) >= P + C).astype(int)
    rows, invs = [], []
    for c in range(nc):
        ps = max(c * C - P, 0)
        ns = min((c + 1) * C, Np - P)
        rows.append(np.concatenate([np.arange(ps, ps + P), np.arange(c * C, (c + 1) * C),
                                    np.arange(ns, ns + P)]))
        invs.append(((seg == 0) & (c == 0)) | ((seg == 2) & (c == nc - 1)))
    return np.stack(rows), np.stack(invs)[:, None, :]


def rotary_freqs(dh: int) -> np.ndarray:
    """(dh,) float32 inverse frequencies, each half repeated: the plain
    version's, and those of the kernel's cos/sin table (``device_rotary_table``)."""
    inv = 1.0 / (10000.0 ** (np.arange(0, dh, 2, dtype=np.float32) / dh))
    return np.concatenate([inv, inv]).astype(np.float32)


def rot_abs(x: torch.Tensor, pos: np.ndarray, dh: int) -> torch.Tensor:
    """Rotary at absolute positions. x (B, Np, h, dh), pos (Np,) numpy."""
    ang = torch.from_numpy(pos.astype(np.float32)[:, None] * rotary_freqs(dh)[None, :]).to(x.device)
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def chunked_attention(q, k, v, p: dict, window_size: int, causal: bool, exact_windowsize: bool,
                      use_rotary: bool, key_mask=None, dropout_keep=None, keep_prob: float = 1.0,
                      scale: float | None = None):
    """The chunk semantics over padded (B, Np, h, dh) float32 q, k, v ->
    (B, Np, h, dh). ``key_mask`` (B, Np) float, ``dropout_keep`` (B, Np, h*K);
    q is multiplied by ``scale`` (default dh ** -0.5) before the rotary."""
    B, Np, h, dh = q.shape
    w, lb, lf = window_size, 1, (0 if causal else 1)
    C, nc, K = p["C"], p["nc"], p["K"]
    dev = q.device
    q = q * (dh ** -0.5 if scale is None else scale)
    if use_rotary:
        q = rot_abs(q, np.arange(Np) + lf * w, dh)
        k = rot_abs(k, np.arange(Np), dh)
    idx, invalid = chunk_index_sets(p)
    i_pos = np.arange(Np).reshape(nc, C)[:, :, None]
    bad = window_mask(i_pos, idx[:, None, :], w, lb, lf, causal, exact_windowsize, invalid)
    flat = torch.from_numpy(idx.reshape(-1)).to(dev)
    qb = q.reshape(B, nc, C, h, dh)
    ksel = k[:, flat].reshape(B, nc, K, h, dh)
    vsel = v[:, flat].reshape(B, nc, K, h, dh)
    sim = torch.einsum("bnqhd,bnkhd->bnhqk", qb, ksel)
    sim = sim.masked_fill(torch.from_numpy(bad).to(dev)[None, :, None], NEG_INF)
    if key_mask is not None:
        kmsel = key_mask[:, flat].reshape(B, nc, K)
        sim = sim.masked_fill(kmsel[:, :, None, None, :] <= 0, NEG_INF)
    attn = sim.softmax(dim=-1)
    if dropout_keep is not None:
        kp = dropout_keep.reshape(B, nc, C, h, K).to(torch.float32)
        attn = attn * kp.movedim(3, 2) * (1.0 / keep_prob)
    return torch.einsum("bnhqk,bnkhd->bnqhd", attn, vsel).reshape(B, Np, h, dh)


def halo_key_slots(Nh: int, q0: int, Nq: int, w: int):
    """(K,) slab rows of K3's Nq + 2w key slots and (K,) flags of the
    clamped ones (no neighbour on that side), as ``chunk_index_sets`` gives
    them for one chunk of rows [q0, q0 + Nq) with P = w."""
    kk = np.arange(Nq + 2 * w)
    seg = (kk >= w).astype(int) + (kk >= w + Nq).astype(int)
    rows = np.where(seg == 0, max(q0 - w, 0) + kk,
                    np.where(seg == 1, q0 + kk - w, min(q0 + Nq, Nh - w) + kk - w - Nq))
    invalid = ((seg == 0) & (q0 == 0)) | ((seg == 2) & (q0 + Nq == Nh))
    return rows, invalid


def halo_lengths(lengths: torch.Tensor, pos0: int, Nh: int) -> torch.Tensor:
    """Global prefix lengths (B,) -> K3's (B,) int32 lengths in slab rows,
    for a slab whose row 0 sits at global position ``pos0``."""
    return (lengths.to(torch.int64) - pos0).clamp(0, Nh).to(torch.int32)


def halo_slab(rows: torch.Tensor, window_size: int, causal: bool, shard):
    """This rank's (B, n, ...) rows with ``window_size`` rows of each
    neighbour along dim 1 (none past the trajectory's ends; none after when
    causal), brought by ``shard.exchange_halo`` (a ``utils.seq`` shard) ->
    (slab, q0: the slab row of the rank's first row, pos0: the slab's first
    row's global position)."""
    w, n = window_size, rows.shape[1]
    before, after, (real_before, real_after) = shard.exchange_halo(rows, w, 0 if causal else w)
    parts = ([before] if real_before else []) + [rows] + ([after] if real_after else [])
    q0 = w if real_before else 0
    return torch.cat(parts, dim=1), q0, shard.rank * n - q0


def _check_halo(Nh: int, q0: int, Nq: int, w: int, causal: bool, pos0: int):
    lf = 0 if causal else 1
    if q0 not in (0, w) or Nh - q0 - Nq not in (0, lf * w) or Nq % w or pos0 % w:
        raise ValueError(f"halo slab of {Nh} rows with own rows [{q0}, {q0 + Nq}) at position "
                         f"{pos0}: K3 takes 0 or w = {w} rows before, 0 or {lf * w} after, "
                         f"and own rows and position that are multiples of w")


def local_attention_halo_plain(qkv, heads: int, dim_head: int, window_size: int, q0: int,
                               Nq: int, pos0: int, causal: bool = False,
                               exact_windowsize: bool = True, use_rotary: bool = True,
                               lengths=None):
    """K3's plain version: the slab (B, Nh, 3*h*dh) -> (B, Nq, h*dh) for its
    rows [q0, q0 + Nq), which sit at global positions pos0 + q0 on.
    ``lengths`` (B,) int: valid keys, in slab rows."""
    B, Nh, _ = qkv.shape
    h, dh, w = heads, dim_head, window_size
    _check_halo(Nh, q0, Nq, w, causal, pos0)
    lf = 0 if causal else 1
    x = qkv.reshape(B, Nh, 3, h, dh).to(torch.float32)
    q = x[:, q0:q0 + Nq, 0] * (dh ** -0.5)
    k, v = x[:, :, 1], x[:, :, 2]
    if use_rotary:
        q = rot_abs(q, pos0 + np.arange(q0, q0 + Nq) + lf * w, dh)
        k = rot_abs(k, pos0 + np.arange(Nh), dh)
    rows, invalid = halo_key_slots(Nh, q0, Nq, w)
    ti = np.arange(q0, q0 + Nq)[:, None]
    bad = window_mask(ti, rows[None, :], w, 1, lf, causal, exact_windowsize, invalid[None, :])
    idx = torch.from_numpy(rows).to(qkv.device)
    sim = torch.einsum("bqhd,bkhd->bhqk", q, k[:, idx])
    sim = sim.masked_fill(torch.from_numpy(bad).to(qkv.device), NEG_INF)
    if lengths is not None:
        beyond = idx[None, :] >= lengths.to(idx.device)[:, None]  # (B, K)
        sim = sim.masked_fill(beyond[:, None, None, :], NEG_INF)
    out = torch.einsum("bhqk,bkhd->bqhd", sim.softmax(dim=-1), v[:, idx])
    return out.reshape(B, Nq, h * dh).to(qkv.dtype)


def fused_qkv_local_attention_plain(qkv, heads: int, dim_head: int, window_size: int,
                                    causal: bool = False, exact_windowsize: bool = True,
                                    use_rotary: bool = True, key_mask=None, dropout_keep=None,
                                    keep_prob: float = 1.0):
    """The chunk semantics in plain PyTorch: (B, N, 3*h*dh) -> (B, N, h*dh)."""
    B, N, _ = qkv.shape
    h, dh = heads, dim_head
    p = plan(N, window_size, causal)
    if p is None:
        raise ValueError(f"no chunk plan for N {N}, window {window_size}; "
                         "gate callers with supports()")
    pad = p["Np"] - N
    x = torch.nn.functional.pad(qkv, (0, 0, 0, pad)).reshape(B, p["Np"], 3, h, dh)
    x = x.to(torch.float32)
    if key_mask is not None:
        key_mask = torch.nn.functional.pad((key_mask > 0).to(torch.float32), (0, pad))
    out = chunked_attention(x[:, :, 0], x[:, :, 1], x[:, :, 2], p, window_size, causal,
                            exact_windowsize, use_rotary, key_mask, dropout_keep, keep_prob)
    return out.reshape(B, p["Np"], h * dh)[:, :N].to(qkv.dtype)


def key_lengths(key_mask: torch.Tensor) -> torch.Tensor:
    """(B,) int32 count of valid frames per sequence; with CHECK_MASKS, raise
    unless the mask is prefix-valid."""
    valid = key_mask > 0
    lengths = valid.sum(dim=1, dtype=torch.int32)
    if CHECK_MASKS:
        expected = torch.arange(key_mask.shape[1], device=key_mask.device)[None, :] < lengths[:, None]
        if not torch.equal(valid, expected):
            raise ValueError(
                "fused_qkv_local_attention: key_mask is not prefix-valid (valid frames must "
                "form a contiguous prefix per sequence); such masks need the bucketed "
                "local_attention")
    return lengths


# ---------------------------------------------------------------------------
# The CUDA kernel (csrc/local_attention.cu)


def _library() -> ctypes.CDLL:
    return bind(_build.load("local_attention"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument types on a loaded library."""
    if lib.fused_qkv_local_attention_f32.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_qkv_local_attention_f32.argtypes = [
            vp, vp, vp, vp, vp,        # qkv, lengths, keep, rotary table, out
            i, i, i, i, i,             # B, N, Np, heads, dim_head
            i, i, i, i,                # window, causal, exact, use_rotary
            i, i, i,                   # C, P, K
            ctypes.c_float,            # 1 / keep_prob
            i, i, i, vp]               # slab, cap, tensor cores, stream
        lib.fused_qkv_local_attention_f32.restype = i
        lib.fused_qkv_local_attention_bf16.argtypes = lib.fused_qkv_local_attention_f32.argtypes
        lib.fused_qkv_local_attention_bf16.restype = i
        lib.local_attention_heads_f32.argtypes = [
            vp, vp, vp, vp, vp,        # q, k, v, rotary table, out
            i, i, i, i, i, i, i,       # BH, N, dim_head, window, causal, exact, use_rotary
            i, i, i, vp]               # slab, cap, tensor cores, stream
        lib.local_attention_heads_f32.restype = i
        lib.local_attention_halo_f32.argtypes = [
            vp, vp, vp, vp,            # qkv, lengths, rotary table, out
            i, i, i, i, i, i,          # B, Nh, q0, Nq, heads, dim_head
            i, i, i, i,                # window, causal, exact, use_rotary
            i, i, i, vp]               # slab, cap, tensor cores, stream
        lib.local_attention_halo_f32.restype = i
        lib.local_attention_heads_bf16.argtypes = lib.local_attention_heads_f32.argtypes
        lib.local_attention_heads_bf16.restype = i
        lib.local_attention_halo_bf16.argtypes = lib.local_attention_halo_f32.argtypes
        lib.local_attention_halo_bf16.restype = i
        if hasattr(lib, "local_attention_smem_bytes"):  # (a build of an earlier source lacks it)
            lib.local_attention_smem_bytes.argtypes = [i] * 5  # bf16 form, dh, slab, cap, rotary
            lib.local_attention_smem_bytes.restype = i
        lib.local_attention_error_string.argtypes = [i]
        lib.local_attention_error_string.restype = ctypes.c_char_p
    return lib


# Constants of csrc/local_attention.cu
MAX_WARPS = 8               # kMaxWarps: warps per block
SMEM_LIMIT = 232448 - 16    # kMaxSmem less the two mbarriers
# The plan's defaults (attention_plan)
MIN_BLOCKS = 128            # blocks a launch should have: about one per SM of an H100
BF16_MIN_BLOCKS = 256       # the bf16 form's: about two per SM


def rows_per_warp(mma: bool) -> int:
    """Query rows a warp owns: rows_per_warp() in csrc/local_attention.cu."""
    return 16 if mma else 8


@dataclasses.dataclass(frozen=True)
class AttnPlan:
    """One launch plan (struct Plan and the MMA template argument in
    csrc/local_attention.cu) and what follows from it for its shape."""
    slab: int        # S: query rows per block, within one chunk
    cap: int         # K and V rows staged at once
    mma: bool        # products on the tensor cores (3xTF32), else the CUDA cores
    band: int        # most key rows one slab's windows reach
    segments: int    # most staging rounds a block takes: ceil(band / cap)
    blocks: int      # blocks per (head, batch row)
    smem_bytes: int  # dynamic shared memory per block
    elem: int = 4    # bytes of an element: 4 for the float32 form, 2 for the bf16 form


def key_band(q0: int, q1: int, w: int, causal: bool, C: int, P: int, Np: int, base: int = 0):
    """[lo, hi) key rows that query rows [q0, q1) of one chunk can see, the
    chunks starting at row ``base``: key_band() in csrc/local_attention.cu."""
    lf = 0 if causal else 1
    first = base + (q0 - base) // C * C
    lo = max(first - P, (q0 // w - 1) * w, 0)
    wh = ((q1 - 1) // w + lf + 1) * w
    if causal:
        wh = min(wh, q1)
    return lo, min(first + C + P, wh, Np)


def slab_rows(Np: int, C: int, slab: int, base: int = 0, Nq: int | None = None):
    """[s0, s1) query rows of each block, in grid order: the slabs of each
    chunk of the Nq (default Np) query rows from ``base`` on, the last one of
    a chunk cut at the chunk's end."""
    Nq = Np if Nq is None else Nq
    return [(s0, min(s0 + slab, base + c * C + C, base + Nq))
            for c in range(Nq // C) for s0 in range(base + c * C, base + (c + 1) * C, slab)]


def smem_bytes(dh: int, slab: int, cap: int, rotary: bool, elem: int = 4) -> int:
    """Q, K and V rows, and with rotary the (cos, sin) rows of Q's and K's
    positions: smem_bytes() in csrc/local_attention.cu. The bf16 form (elem
    2, smem_bytes_bf16()): bf16 Q, K and V rows of dh + 8 values, then
    float32 rotated Q and K rows of dh + 4 (cos/sin come from the table in
    L2)."""
    if elem == 4:
        return 4 * (slab + 2 * cap + (slab + cap if rotary else 0)) * (dh + 4)
    return 2 * (slab + 2 * cap) * (dh + 8) + 4 * (slab + cap) * (dh + 4)


def _fits(dh: int, slab: int, rotary: bool, elem: int) -> int:
    """The most key rows (cap) that fit in shared memory beside ``slab``."""
    if elem == 4:
        return (SMEM_LIMIT // (4 * (dh + 4)) - slab * (2 if rotary else 1)) // (3 if rotary else 2)
    per_row = 4 * (dh + 8) + 4 * (dh + 4)  # a key row's bf16 K and V and float32 K
    return (SMEM_LIMIT - smem_bytes(dh, slab, 0, rotary, elem)) // per_row


@functools.lru_cache(maxsize=None)
def attention_plan(Np: int, C: int, P: int, w: int, causal: bool, dh: int,
                   batch_heads: int | None = None, rotary: bool = True, slab: int | None = None,
                   cap: int | None = None, mma: bool | None = None, base: int = 0,
                   Nq: int | None = None, elem: int = 4, keep: bool = False) -> AttnPlan:
    """The plan for one shape; ``batch_heads`` is the launch's (batch row,
    head) pairs, ``elem`` the element's bytes (4: the float32 form, 2: the
    bf16 form), ``keep`` whether a dropout keep mask goes with the launch,
    and a keyword given fixes that choice (``base`` and ``Nq``: K3's query
    rows, [base, base + Nq) of the Np). The defaults follow the best of the
    plans ``ops/local_attention_sweep.py`` (``--bf16`` for the bf16 form)
    timed on an H100 at the served shapes (``PERF.md``).

    - Units and slab S, float32: the tensor cores with slabs of 128 or 64
      rows where that still gives MIN_BLOCKS blocks, else the CUDA cores
      with the largest slab of 64, 32, 16 or 8 rows that does (the smallest
      where none does). bf16: the tensor cores with slabs of 64 or 32 rows
      (32 where a keep mask goes with the launch) where that gives
      BF16_MIN_BLOCKS blocks (two an SM), else the CUDA cores with the
      largest slab of 32 or 16 rows that gives MIN_BLOCKS (8 where none
      does). S is at most the chunk rounded up to whole warps and at most
      MAX_WARPS warps, halved while the slab and its whole key band do not
      fit in shared memory.
    - cap: the most key rows any slab's windows reach, so that each block
      stages its band in one round; where that does not fit even at the
      smallest slab, the most that does (the band then comes in segments)."""
    if elem not in (2, 4):
        raise ValueError(f"elem {elem}: 4 (float32) or 2 (bf16)")
    rows = functools.partial(slab_rows, Np, C, base=base, Nq=Nq)
    default_slab = slab is None
    if default_slab:
        slab, default_mma = (_default_units(rows, batch_heads) if elem == 4
                             else _default_units_bf16(rows, batch_heads, keep))
        mma = default_mma if mma is None else mma
    mma = bool(mma)
    rpw = rows_per_warp(mma)
    if default_slab:
        slab = min(slab, MAX_WARPS * rpw, -(-min(C, Np) // rpw) * rpw)
        while slab > rpw and smem_bytes(dh, slab, _band(rows, Np, C, P, w, causal, slab, base),
                                        rotary, elem) > SMEM_LIMIT:
            slab //= 2
    if slab % rpw or not rpw <= slab <= MAX_WARPS * rpw:
        raise ValueError(f"slab {slab} must be a multiple of {rpw} up to {MAX_WARPS * rpw}")
    band = _band(rows, Np, C, P, w, causal, slab, base)
    fits = _fits(dh, slab, rotary, elem)
    if cap is None:
        cap = min(band, fits)
    if not 0 < cap <= fits:
        raise ValueError(f"cap {cap} rows: between 1 and {fits} fit beside slab {slab} "
                         f"at dh {dh}")
    return AttnPlan(slab=slab, cap=cap, mma=mma, band=band, segments=-(-band // cap),
                    blocks=len(rows(slab)), smem_bytes=smem_bytes(dh, slab, cap, rotary, elem),
                    elem=elem)


def _default_units(rows, batch_heads):
    """(slab, tensor cores?) of the default plan: see ``attention_plan``."""
    def blocks(slab):
        return len(rows(slab)) * (batch_heads or MIN_BLOCKS)

    for slab in (128, 64):
        if blocks(slab) >= MIN_BLOCKS:
            return slab, True
    for slab in (64, 32, 16):
        if blocks(slab) >= MIN_BLOCKS:
            return slab, False
    return 8, False


def _default_units_bf16(rows, batch_heads, keep):
    """(slab, tensor cores?) of the bf16 form's default plan: see
    ``attention_plan``."""
    def blocks(slab):
        return len(rows(slab)) * (batch_heads or BF16_MIN_BLOCKS)

    for slab in (32,) if keep else (64, 32):
        if blocks(slab) >= BF16_MIN_BLOCKS:
            return slab, True
    for slab in (32, 16):
        if blocks(slab) >= MIN_BLOCKS:
            return slab, False
    return 8, False


def _band(rows, Np, C, P, w, causal, slab, base):
    return max(hi - lo for lo, hi in (key_band(s0, s1, w, causal, C, P, Np, base)
                                      for s0, s1 in rows(slab)))


_TABLES: dict = {}


def device_rotary_table(positions: int, dh: int, device: torch.device) -> torch.Tensor:
    """(positions, dh / 2, 2) cos and sin of the f32 angles pos * freq, as
    ``rot_abs`` takes them, on ``device``; made once per (positions, dh,
    device)."""
    key = (positions, dh, str(device))
    if key not in _TABLES:
        ang = torch.from_numpy(np.arange(positions, dtype=np.float32)[:, None]
                               * rotary_freqs(dh)[None, : dh // 2]).to(device)
        _TABLES[key] = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1).contiguous()
    return _TABLES[key]


def check_cuda_f32(name: str, fn: str, t: torch.Tensor, device: torch.device,
                   dtypes: tuple = (torch.float32,)):
    if not t.is_cuda:
        raise ValueError(f"{fn}: {name} is on {t.device}, needs a CUDA tensor")
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, the other operands on {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{fn}: {name} is {t.dtype}, the kernel takes "
                         + " or ".join(str(d) for d in dtypes))
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} is not contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} is not 16-byte aligned (the kernel reads float4)")


def raise_on_error(lib, err: int, fn: str):
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: "
                           + lib.local_attention_error_string(err).decode())


def plan_args(fn: str, dtype, lp: AttnPlan) -> tuple:
    """The plan's arguments of the entry of ``dtype``: (slab, cap, mma);
    raises on a plan made for the other form."""
    elem = 2 if dtype == torch.bfloat16 else 4
    if lp.elem != elem:
        raise ValueError(f"{fn}: a plan for {lp.elem}-byte elements; this entry takes "
                         f"attention_plan(..., elem={elem})")
    return lp.slab, lp.cap, int(lp.mma)


def _launch_fused_qkv(wrapper, dtype, qkv, heads, dim_head, window_size, causal,
                      exact_windowsize, use_rotary, key_mask, dropout_keep, keep_prob,
                      launch_plan):
    """B3's launch for the entry of ``dtype`` (its output dtype too), counted
    in ``wrapper.launches``."""
    fn = wrapper.__name__
    check_cuda_f32("qkv", fn, qkv, qkv.device, (dtype,))
    if qkv.dim() != 3 or qkv.shape[2] != 3 * heads * dim_head:
        raise ValueError(f"{fn}: qkv {tuple(qkv.shape)} must be (B, N, 3*{heads}*{dim_head})")
    if dim_head not in HEAD_DIMS:
        raise ValueError(f"{fn}: head width {dim_head} not in {HEAD_DIMS}")
    B, N, _ = qkv.shape
    p = plan(N, window_size, causal)
    if p is None:
        raise ValueError(f"{fn}: no chunk plan for N {N}, window {window_size}")
    lengths = None
    if key_mask is not None:
        if tuple(key_mask.shape) != (B, N) or key_mask.device != qkv.device:
            raise ValueError(f"{fn}: key_mask {tuple(key_mask.shape)} on {key_mask.device} "
                             f"must be ({B}, {N}) on {qkv.device}")
        lengths = key_lengths(key_mask)
    if dropout_keep is not None:
        check_cuda_f32("dropout_keep", fn, dropout_keep, qkv.device)
        if tuple(dropout_keep.shape) != (B, p["Np"], heads * p["K"]):
            raise ValueError(f"{fn}: dropout_keep {tuple(dropout_keep.shape)} must be "
                             f"{(B, p['Np'], heads * p['K'])}; use dropout_keep_mask()")
    lp = launch_plan or attention_plan(p["Np"], p["C"], p["P"], window_size, causal, dim_head,
                                       B * heads, use_rotary, elem=qkv.element_size(),
                                       keep=dropout_keep is not None)
    lib = _library()
    out = torch.empty((B, N, heads * dim_head), dtype=dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    lf = 0 if causal else 1
    entry = (lib.fused_qkv_local_attention_bf16 if dtype == torch.bfloat16
             else lib.fused_qkv_local_attention_f32)
    with torch.cuda.device(qkv.device):
        table = (device_rotary_table(p["Np"] + lf * window_size, dim_head, qkv.device)
                 if use_rotary else None)
        err = entry(
            qkv.data_ptr(), None if lengths is None else lengths.data_ptr(),
            None if dropout_keep is None else dropout_keep.data_ptr(),
            None if table is None else table.data_ptr(), out.data_ptr(), B, N, p["Np"], heads,
            dim_head, window_size, int(causal), int(exact_windowsize), int(use_rotary), p["C"],
            p["P"], p["K"], 1.0 / keep_prob, *plan_args(fn, dtype, lp),
            torch.cuda.current_stream(qkv.device).cuda_stream)
    raise_on_error(lib, err, fn)
    wrapper.launches += 1
    return out


def fused_qkv_local_attention_cuda(qkv, heads: int, dim_head: int, window_size: int,
                                   causal: bool = False, exact_windowsize: bool = True,
                                   use_rotary: bool = True, key_mask=None, dropout_keep=None,
                                   keep_prob: float = 1.0,
                                   launch_plan: AttnPlan | None = None):
    """Launch the kernel on PyTorch's current stream (built on first use),
    with ``launch_plan`` or ``attention_plan``'s default for the shape.
    Raises on a tensor or shape the kernel does not take, and if the launch
    is refused."""
    return _launch_fused_qkv(fused_qkv_local_attention_cuda, torch.float32, qkv, heads,
                             dim_head, window_size, causal, exact_windowsize, use_rotary,
                             key_mask, dropout_keep, keep_prob, launch_plan)


fused_qkv_local_attention_cuda.launches = 0


def fused_qkv_local_attention_bf16_cuda(qkv, heads: int, dim_head: int, window_size: int,
                                        causal: bool = False, exact_windowsize: bool = True,
                                        use_rotary: bool = True, key_mask=None,
                                        dropout_keep=None, keep_prob: float = 1.0,
                                        launch_plan: AttnPlan | None = None):
    """The kernel's bf16 entry, as ``fused_qkv_local_attention_cuda``: a bf16
    qkv, float32 inside (the float32 keep mask too), a bf16 context."""
    return _launch_fused_qkv(fused_qkv_local_attention_bf16_cuda, torch.bfloat16, qkv, heads,
                             dim_head, window_size, causal, exact_windowsize, use_rotary,
                             key_mask, dropout_keep, keep_prob, launch_plan)


fused_qkv_local_attention_bf16_cuda.launches = 0


def halo_plan(B: int, heads: int, dim_head: int, window_size: int, q0: int, Nq: int, Nh: int,
              causal: bool, use_rotary: bool, elem: int = 4) -> AttnPlan:
    """K3's default launch plan: ``attention_plan`` for one chunk of the Nq
    own rows from slab row q0, P = w (``elem`` 2: the bf16 form's)."""
    return attention_plan(Nh, Nq, window_size, window_size, causal, dim_head, B * heads,
                          use_rotary, base=q0, Nq=Nq, elem=elem)


def _launch_halo(wrapper, dtype, qkv, heads, dim_head, window_size, q0, Nq, pos0, causal,
                 exact_windowsize, use_rotary, lengths, launch_plan):
    """K3's launch for the entry of ``dtype`` (its output dtype too), counted
    in ``wrapper.launches``."""
    fn = wrapper.__name__
    check_cuda_f32("qkv", fn, qkv, qkv.device, (dtype,))
    if qkv.dim() != 3 or qkv.shape[2] != 3 * heads * dim_head:
        raise ValueError(f"{fn}: qkv {tuple(qkv.shape)} must be (B, Nh, 3*{heads}*{dim_head})")
    if dim_head not in HEAD_DIMS:
        raise ValueError(f"{fn}: head width {dim_head} not in {HEAD_DIMS}")
    if window_size > CHUNK:
        raise ValueError(f"{fn}: window {window_size} above {CHUNK}")
    B, Nh, _ = qkv.shape
    _check_halo(Nh, q0, Nq, window_size, causal, pos0)
    if lengths is not None:
        if tuple(lengths.shape) != (B,) or lengths.device != qkv.device:
            raise ValueError(f"{fn}: lengths {tuple(lengths.shape)} on {lengths.device} must "
                             f"be ({B},) on {qkv.device}")
        lengths = lengths.to(torch.int32).contiguous()
    lp = launch_plan or halo_plan(B, heads, dim_head, window_size, q0, Nq, Nh, causal,
                                  use_rotary, qkv.element_size())
    lib = _library()
    out = torch.empty((B, Nq, heads * dim_head), dtype=dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    lf = 0 if causal else 1
    entry = (lib.local_attention_halo_bf16 if dtype == torch.bfloat16
             else lib.local_attention_halo_f32)
    with torch.cuda.device(qkv.device):
        # row r of the table: slab row r's global position, pos0 + r
        table = (device_rotary_table(pos0 + Nh + lf * window_size, dim_head, qkv.device)[pos0:]
                 if use_rotary else None)
        err = entry(
            qkv.data_ptr(), None if lengths is None else lengths.data_ptr(),
            None if table is None else table.data_ptr(), out.data_ptr(), B, Nh, q0, Nq, heads,
            dim_head, window_size, int(causal), int(exact_windowsize), int(use_rotary),
            *plan_args(fn, dtype, lp), torch.cuda.current_stream(qkv.device).cuda_stream)
    raise_on_error(lib, err, fn)
    wrapper.launches += 1
    return out


def local_attention_halo_cuda(qkv, heads: int, dim_head: int, window_size: int, q0: int,
                              Nq: int, pos0: int, causal: bool = False,
                              exact_windowsize: bool = True, use_rotary: bool = True,
                              lengths=None, launch_plan: AttnPlan | None = None):
    """Launch K3 on PyTorch's current stream (built on first use): the slab
    (B, Nh, 3*h*dh) -> (B, Nq, h*dh), as ``local_attention_halo_plain``.
    Raises on what the kernel does not take."""
    return _launch_halo(local_attention_halo_cuda, torch.float32, qkv, heads, dim_head,
                        window_size, q0, Nq, pos0, causal, exact_windowsize, use_rotary, lengths,
                        launch_plan)


local_attention_halo_cuda.launches = 0


def local_attention_halo_bf16_cuda(qkv, heads: int, dim_head: int, window_size: int, q0: int,
                                   Nq: int, pos0: int, causal: bool = False,
                                   exact_windowsize: bool = True, use_rotary: bool = True,
                                   lengths=None, launch_plan: AttnPlan | None = None):
    """K3's bf16 form, as ``local_attention_halo_cuda``: a bf16 slab, float32
    inside, a bf16 context."""
    return _launch_halo(local_attention_halo_bf16_cuda, torch.bfloat16, qkv, heads, dim_head,
                        window_size, q0, Nq, pos0, causal, exact_windowsize, use_rotary, lengths,
                        launch_plan)


local_attention_halo_bf16_cuda.launches = 0


def local_attention_halo(qkv, heads: int, dim_head: int, window_size: int, q0: int, Nq: int,
                         pos0: int, causal: bool = False, exact_windowsize: bool = True,
                         use_rotary: bool = True, lengths=None):
    """K3 for CUDA tensors (its bf16 form for a bf16 slab), its plain version
    for CPU tensors. Sampling only: raises where a gradient is asked of it."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise RuntimeError("local_attention_halo serves sampling only: run it under "
                           "torch.no_grad or torch.inference_mode")
    if not qkv.is_cuda:
        impl = local_attention_halo_plain
    elif qkv.dtype == torch.bfloat16:
        impl = local_attention_halo_bf16_cuda
    else:
        impl = local_attention_halo_cuda
    return impl(qkv.contiguous(), heads, dim_head, window_size, q0, Nq, pos0, causal,
                exact_windowsize, use_rotary, lengths)


class _FusedQkvLocalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, key_mask, dropout_keep, heads, dim_head, window_size, causal,
                exact_windowsize, use_rotary, keep_prob):
        ctx.args = (heads, dim_head, window_size, causal, exact_windowsize, use_rotary)
        ctx.keep_prob = keep_prob
        ctx.save_for_backward(qkv, key_mask, dropout_keep)
        if not qkv.is_cuda:
            impl = fused_qkv_local_attention_plain
        elif qkv.dtype == torch.bfloat16:
            impl = fused_qkv_local_attention_bf16_cuda
        else:
            impl = fused_qkv_local_attention_cuda
        return impl(qkv, *ctx.args, key_mask, dropout_keep, keep_prob)

    @staticmethod
    def backward(ctx, grad):
        qkv, key_mask, dropout_keep = ctx.saved_tensors
        with torch.enable_grad():
            x = qkv.detach().requires_grad_()
            out = fused_qkv_local_attention_plain(x, *ctx.args, key_mask, dropout_keep,
                                                  ctx.keep_prob)
            (g,) = torch.autograd.grad(out, [x], grad)
        return (g,) + (None,) * 9


def fused_qkv_local_attention(qkv, heads: int, dim_head: int, window_size: int,
                              causal: bool = False, exact_windowsize: bool = True,
                              use_rotary: bool = True, key_mask=None, dropout_keep=None,
                              keep_prob: float = 1.0):
    """(B, N, 3*h*dh) -> (B, N, h*dh) with gradients: the kernel on the card,
    the plain version on the CPU. Gate callers with ``supports``. A bf16 qkv
    gives a bf16 context and a bf16 gradient."""
    if plan(qkv.shape[1], window_size, causal) is None:
        raise ValueError(f"no chunk plan for N {qkv.shape[1]}, window {window_size}; "
                         "gate callers with supports()")
    return _FusedQkvLocalAttention.apply(qkv.contiguous(), key_mask, dropout_keep, heads,
                                         dim_head, window_size, causal, exact_windowsize,
                                         use_rotary, keep_prob)
