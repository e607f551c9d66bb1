"""Time the windowed-attention kernel (B3 and B4) under its launch plans at
the local-attention transformer's serving shapes, on one CUDA card:

    python -m deepmimic_diffusion_mujoco_tpu_torch.ops.local_attention_sweep \\
        [--bf16] [--baseline OLD/local_attention.cu] [--out sweep.json]

B3 runs at the three request shapes of the served config (B 16 x N 128, B 4
x N 1024 in 128-row chunks, B 4 x N 120 padded to 128; 8 heads of 64, window
16), each without masks, with prefix key lengths, and with those and a
dropout keep mask; B4 at (16, 8, 128, 64) and (4, 8, 1024, 64). At each
shape every plan (query rows per block, tensor or CUDA cores) is checked
against the plain version (1e-4) and then timed, as is the composition of
library calls that computes the same function (the rotary from tables made
once, then one ``scaled_dot_product_attention`` with the band mask).

``--baseline`` names another copy of ``csrc/local_attention.cu`` with the
earlier C interface (no plan arguments, 32-row query tiles): it is built and
timed beside the current kernel at every shape.

Then what a launch waits on, at B 1, 4 and 16 of the first shape: both
kernels timed after the L2 flush, after the flush and 50 us of idle card,
and warm; without rotary; and probe builds of both sources that stamp each
block's phases with the SM clock (``clock64``, thread 0). The earlier
kernel's probe can also skip its P V pass. The probes exist only here; the
one that skips P V computes another function.

``--bf16`` sweeps the kernel's bf16 form instead (``attention_plan(...,
elem=2)``: every slab on either units): B3 at la_serve's three shapes
without masks and with prefix lengths and at la_train's B 64 x N 96 with
the keep mask, K3 at both ranks' slabs of B 4 x H 1024 over two ranks (512
own rows each), B4 at (16, 8, 128, 64) and (4, 8, 1024, 64). Each plan is
checked against the plain version first (within one bf16 ulp of the value
plus 1e-4), and each shape times the float32 form on the widened values
under its own default plan. There ``--baseline`` names an earlier source
with the same C interface (the bf16 form before its redesign, which ran
the float32 plan): its bf16 entries are timed beside the new ones. The
clock64 probe stamps the bf16 instance at B 4 and 16 x N 128 (and the
baseline's).

Times: CUDA events, median of 15 launches with L2 flushed before each and
the card held busy while they queue, after 2 s of matrix products; each
plan is timed in two rounds and keeps the lesser median. Prints one JSON
line per shape and the card's name and power limit; ``--out`` keeps every
row.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from . import fused_local_attention as FA
from . import local_attention_kernel as LH
from .conv_block_sweep import time_ms, warm

TOL = 1e-4
HEADS, DH, W, KEEP_PROB = 8, 64, 16, 0.7
B3_SHAPES = [(16, 128), (4, 1024), (4, 120)]  # (B, N)
B4_SHAPES = [(16, 128), (4, 1024)]
MASKS = ("none", "lengths", "lengths+keep")
# plans whose blocks' phases are stamped: the default and two others
PROBED = {"default": {}, "cuda_cores_s64": dict(slab=64, mma=False),
          "tensor_cores_s64": dict(slab=64, mma=True)}
N_STAMPS = 7  # phase boundaries stamped per block


def plans(Np, C, P, batch_heads, dh=DH, w=W, causal=False):
    """Every plan: slabs of 8-128 rows (within the chunk) on the CUDA cores
    and 16-128 rows on the tensor cores."""
    base = FA.attention_plan(Np, C, P, w, causal, dh, batch_heads)
    seen = {base: None}
    for mma in (False, True):
        for slab in (8, 16, 32, 64, 128):
            if slab > -(-C // 16) * 16:
                continue
            try:
                seen.setdefault(FA.attention_plan(Np, C, P, w, causal, dh, slab=slab, mma=mma),
                                None)
            except ValueError:  # more warps than a block takes
                pass
    return base, list(seen)


def rotary_tables(n, dh, w, causal, dev):
    """cos and sin (n, dh) of the queries' and the keys' absolute positions."""
    tables = []
    for pos in (np.arange(n) + (0 if causal else w), np.arange(n)):
        ang = torch.from_numpy(pos.astype(np.float32)[:, None] * FA.rotary_freqs(dh)[None, :])
        tables.append((torch.cos(ang).to(dev), torch.sin(ang).to(dev)))
    return tables


def rotate(x, table):
    cos, sin = table
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def band_mask(n, w, causal, dev):
    i = np.arange(n)
    bad = FA.window_mask(i[:, None], i[None, :], w, 1, 0 if causal else 1, causal, True, False)
    return torch.from_numpy(~bad).to(dev)


def composition(q, k, v, tables, mask):
    """(B, h, n, dh) q, k, v: the rotary, then one SDPA with the band mask."""
    return F.scaled_dot_product_attention(rotate(q, tables[0]), rotate(k, tables[1]), v,
                                          attn_mask=mask)


def b3_composition(qkv, Np, tables, mask):
    B, N, _ = qkv.shape
    x = F.pad(qkv, (0, 0, 0, Np - N)).view(B, Np, 3, HEADS, DH).permute(2, 0, 3, 1, 4)
    out = composition(x[0], x[1], x[2], tables, mask)
    return out.transpose(1, 2).reshape(B, Np, HEADS * DH)[:, :N]


@functools.lru_cache(maxsize=None)
def freqs(dh, device):
    """The earlier kernel's rotary input: (dh,) inverse frequencies on the
    card, made once (a copy inside a timed launch would time the copy)."""
    return torch.from_numpy(FA.rotary_freqs(dh)).to(device)


class Baseline:
    """The earlier kernel's library, built from ``source`` under ``name``."""

    def __init__(self, source: Path, name: str):
        """``source`` is built under ``name``; with no name it is a built library."""
        self.lib = ctypes.CDLL(str(_build.build(name, source) if name else source))
        vp, i = ctypes.c_void_p, ctypes.c_int
        self.lib.fused_qkv_local_attention_f32.argtypes = [
            vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, i, i, i, ctypes.c_float, vp]
        self.lib.local_attention_heads_f32.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, i,
                                                       vp]

    def b3(self, qkv, key_mask=None, keep=None, rotary=True):
        B, N, _ = qkv.shape
        p = FA.plan(N, W, False)
        lengths = None if key_mask is None else FA.key_lengths(key_mask)
        out = torch.empty(B, N, HEADS * DH, device=qkv.device)
        err = self.lib.fused_qkv_local_attention_f32(
            qkv.data_ptr(), None if lengths is None else lengths.data_ptr(),
            None if keep is None else keep.data_ptr(), freqs(DH, qkv.device).data_ptr(),
            out.data_ptr(), B, N, p["Np"], HEADS, DH, W, 0, 1, int(rotary), p["C"], p["P"],
            p["K"], 1.0 / (KEEP_PROB if keep is not None else 1.0),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline B3 launch failed: {err}")
        return out

    def b4(self, q, k, v):
        B, h, N, dh = q.shape
        out = torch.empty_like(q)
        err = self.lib.local_attention_heads_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), freqs(dh, q.device).data_ptr(),
            out.data_ptr(), B * h, N, dh, W, 0, 1, 1, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline B4 launch failed: {err}")
        return out


# Phase boundaries (anchor, stamp index, stamp after the anchor) of each kernel's source
BASELINE_ANCHORS = [
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n", 0, True),
    ("  // 1. queries,", 1, False), ("  // 2. scores over the band", 2, False),
    ("  // 3. row softmax", 3, False), ("  // 4. P V over the band", 4, False),
    ("  // 5. rows whose keys", 5, False), ("  if (i < a.N) {\n    float* out_row", 6, False)]
BASELINE_PHASES = ("init", "queries", "scores", "softmax", "pv", "masked_rows")
CURRENT_ANCHORS = [
    ("  const int tid = threadIdx.x, nthreads = blockDim.x, lane = tid & 31, warp = tid >> 5;\n",
     0, True),
    ("    // 1. one round trip", 1, False), ("    // 2. scale Q, rotate Q and K", 2, False),
    ("    // 3. this warp's keys", 3, False), ("  // 4. rows whose keys", 4, False),
    ("  // 5. the context rows", 5, False), ("}\n\n// Q, K and V rows, and with rotary", 6,
                                             False)]
CURRENT_PHASES = ("init", "loads", "rotate", "compute", "masked_rows", "store")
BASELINE_PV = ("  for (int t0 = lo; t0 < hi; t0 += kTK) {\n    __syncthreads();\n"
               "    stage_rows<DH, kTK>(kvs, vb")


def probe_source(source: Path, anchors, skip_pv: str | None = None) -> str:
    """A kernel source with a clock64 stamp by thread 0 of every block at
    each anchor and, where ``skip_pv`` names the P V loop's head, a switch
    that skips that loop."""
    text = source.read_text()
    decl = ("__device__ long long la_probe_stamps[1 << 20];\n"
            "__device__ int la_probe_skip_pv;\n"
            "#define STAMP(k) do { if (threadIdx.x == 0) la_probe_stamps[(blockIdx.x + "
            "gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) * " + str(N_STAMPS) +
            " + (k)] = clock64(); } while (0)\n")
    for anchor, k, after in anchors:
        if text.count(anchor) != 1:
            raise RuntimeError(f"probe anchor {anchor!r} not found once in {source}")
        stamp = f"  STAMP({k});\n"
        text = text.replace(anchor, anchor + stamp if after else stamp + anchor)
    if skip_pv is not None:
        if text.count(skip_pv) != 1:
            raise RuntimeError("probe: the P V loop is not where it was")
        text = text.replace(skip_pv,
                            skip_pv.replace("t0 < hi;", "t0 < (la_probe_skip_pv ? lo : hi);"))
    text = text.replace("namespace {\n", decl + "namespace {\n", 1)
    text += ('\nextern "C" int la_probe_read(long long* dst, int n) {\n'
             "  return (int)cudaMemcpyFromSymbol(dst, la_probe_stamps, sizeof(long long) * n);\n}\n"
             'extern "C" int la_probe_set_skip_pv(int v) {\n'
             "  return (int)cudaMemcpyToSymbol(la_probe_skip_pv, &v, sizeof(int));\n}\n")
    return text


def build_probe(source: Path, name: str, anchors, skip_pv=None) -> Path:
    path = _build.BUILD_DIR / f"{name}.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(probe_source(source, anchors, skip_pv))
    return _build.build(name, path)


def read_phases(lib, blocks, phases):
    """Median and 90th-percentile SM cycles of each phase over the blocks of
    the last launch, and the median block's total."""
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (blocks * N_STAMPS))()
    if lib.la_probe_read(buf, blocks * N_STAMPS):
        raise RuntimeError("la_probe_read failed")
    st = np.frombuffer(buf, dtype=np.int64).reshape(blocks, N_STAMPS).astype(np.float64)
    d = np.diff(st, axis=1)
    return {"blocks": blocks, "cycles_median": dict(zip(phases, np.median(d, axis=0).tolist())),
            "cycles_p90": dict(zip(phases, np.percentile(d, 90, axis=0).tolist())),
            "block_cycles_median": float(np.median(st[:, -1] - st[:, 0]))}


def time_with(fn, before, reps=15, warmup=3):
    """Median device ms of fn, ``before()`` enqueued ahead of each timed
    launch (outside its events); the card is held busy while they queue."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(5e-3 * 2e9))
    events = []
    for _ in range(reps):
        before()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def b3_inputs(g, dev, batch, n):
    qkv = torch.randn(batch, n, 3 * HEADS * DH, generator=g, device=dev)
    lengths = np.linspace(n, 3, batch).round().astype(int).tolist()
    km = (torch.arange(n, device=dev)[None, :]
          < torch.tensor(lengths, device=dev)[:, None]).to(torch.float32)
    keep = FA.dropout_keep_mask(g, KEEP_PROB, batch, n, HEADS, W)
    return qkv, {"none": (None, None), "lengths": (km, None), "lengths+keep": (km, keep)}


def check(out, ref, what):
    err = (out - ref).abs().max().item()
    if not (err <= TOL and torch.isfinite(out).all()):
        raise RuntimeError(f"{what} disagrees with the plain version: {err}")
    return err


def sweep_rows(fn, ref, plan_list, base, flush, what):
    """Check every plan, then time each that agrees twice (two rounds). A
    plan other than the default that disagrees is kept with its error and
    not timed; the default must agree."""
    rows = []
    for p in plan_list:
        row = {"plan": dataclasses.asdict(p), "default": p == base}
        try:
            row["max_abs_err"] = check(fn(p), ref, f"{what} plan {p}")
            row["_p"] = p
        except RuntimeError as e:
            if p == base:
                raise
            row["error"] = str(e)[:300]
        rows.append(row)
    timed = [r for r in rows if "_p" in r]
    for rnd in ("ms_first", "ms_second"):
        for r in timed:
            r[rnd] = time_ms(functools.partial(fn, r["_p"]), flush)
    for r in timed:
        r.pop("_p")
        r["ms"] = min(r["ms_first"], r["ms_second"])
    return rows


def summary(rows, extra):
    timed = [r for r in rows if "ms" in r]
    best = min(timed, key=lambda r: r["ms"])
    default = next(r for r in timed if r["default"])
    return {**extra, "default_ms": default["ms"], "default_plan": default["plan"],
            "best_ms": best["ms"], "best_plan": best["plan"], "plans": len(rows),
            "disagree": len(rows) - len(timed)}


# --bf16: the bf16 form's shapes. B3: (B, N, masks); K3: (q0, Nh) of each
# rank's slab of B 4 x H 1024 over two ranks (512 own rows); B4: (B, N)
BF16_B3 = [(16, 128, ("none", "lengths")), (4, 1024, ("none", "lengths")),
           (4, 120, ("none", "lengths")), (64, 96, ("keep",))]
BF16_K3 = (4, 512, [(0, 528), (16, 528)])
BF16_ULP = 2.0 ** -7  # one bf16 ulp of a value v is at most 2^-7 |v|
BF16_PROBED = {"default": {}, "tensor_cores_s128": dict(slab=128, mma=True),
               "cuda_cores_s32": dict(slab=32, mma=False)}


def bf16_check(out, ref, what):
    """A bf16 output against its plain version: within one bf16 ulp of the
    value plus TOL (the float32 form's sums in another order)."""
    d = (out.float() - ref.float()).abs()
    beyond = int((d > BF16_ULP * ref.float().abs() + TOL).sum())
    if beyond or not torch.isfinite(out.float()).all():
        raise RuntimeError(f"{what} disagrees with the plain version: {beyond} values beyond "
                           f"one ulp, max |d| {d.max().item()}")
    return d.max().item()


def bf16_plans(Np, C, P, batch_heads, base=0, Nq=None, keep=False):
    """The bf16 rule's plan and every other: slabs of 8-128 rows on either
    units."""
    kw = dict(base=base, Nq=Nq, elem=2)
    default = FA.attention_plan(Np, C, P, W, False, DH, batch_heads, keep=keep, **kw)
    seen = {default: None}
    for mma in (False, True):
        for slab in (8, 16, 32, 64, 128):
            if slab > -(-C // 16) * 16:
                continue
            try:
                seen.setdefault(FA.attention_plan(Np, C, P, W, False, DH, slab=slab, mma=mma,
                                                  **kw), None)
            except ValueError:  # more warps than a block takes
                pass
    return default, list(seen)


def as_bf16_plan(plan):
    """A float32-rule plan handed to the bf16 entries of an earlier source
    (which staged float32 rows under the float32 plan)."""
    return dataclasses.replace(plan, elem=2)


@contextlib.contextmanager
def library(lib):
    """The wrappers launch through ``lib`` while inside."""
    real = FA._library
    FA._library = lambda: lib
    try:
        yield
    finally:
        FA._library = real


def bf16_cases(g, dev):
    """(name, args, bf16 entry, float32 entry, plain, default plan, plan list,
    the float32 default plan) of every --bf16 shape."""
    BF = torch.bfloat16
    for batch, n, masks in BF16_B3:
        p = FA.plan(n, W, False)
        qkv, mk = b3_inputs(g, dev, batch, n)
        qkv = qkv.to(BF)
        if "keep" in masks:
            mk = {"keep": (None, FA.dropout_keep_mask(g, KEEP_PROB, batch, n, HEADS, W))}
        base, plan_list = bf16_plans(p["Np"], p["C"], p["P"], batch * HEADS, keep="keep" in masks)
        f32_plan = FA.attention_plan(p["Np"], p["C"], p["P"], W, False, DH, batch * HEADS)
        for name in masks:
            km, keep = mk[name]
            a = (qkv, HEADS, DH, W, False, True, True, km, keep,
                 KEEP_PROB if keep is not None else 1.0)
            yield ({"kernel": "B3", "B": batch, "N": n, "masks": name}, a,
                   FA.fused_qkv_local_attention_bf16_cuda, FA.fused_qkv_local_attention_cuda,
                   FA.fused_qkv_local_attention_plain, base, plan_list, f32_plan)
    batch, nq, slabs = BF16_K3
    for rank, (q0, nh) in enumerate(slabs):
        qkv = torch.randn(batch, nh, 3 * HEADS * DH, generator=g, device=dev).to(BF)
        pos0 = rank * nq - q0
        a = (qkv, HEADS, DH, W, q0, nq, pos0, False, True, True, None)
        base, plan_list = bf16_plans(nh, nq, W, batch * HEADS, base=q0, Nq=nq)
        yield ({"kernel": "K3", "B": batch, "rank": rank, "q0": q0, "Nh": nh}, a,
               FA.local_attention_halo_bf16_cuda, FA.local_attention_halo_cuda,
               FA.local_attention_halo_plain, base, plan_list,
               FA.halo_plan(batch, HEADS, DH, W, q0, nq, nh, False, True))
    for batch, n in B4_SHAPES:
        q, k, v = (torch.randn(batch, HEADS, n, DH, generator=g, device=dev).to(BF)
                   for _ in range(3))
        a = (q, k, v, W)
        base, plan_list = bf16_plans(n, LH.CHUNK, LH.CHUNK, batch * HEADS)
        yield ({"kernel": "B4", "B": batch, "N": n}, a, LH.local_attention_heads_bf16_cuda,
               LH.local_attention_heads_cuda, LH.local_attention_heads_plain, base, plan_list,
               FA.attention_plan(n, LH.CHUNK, LH.CHUNK, W, False, DH, batch * HEADS))


def bf16_main(args, dev, smi, flush) -> int:
    """The --bf16 sweep (the module's docstring)."""
    old = old_probe = None
    if args.baseline:
        source = Path(args.baseline).resolve()
        old = FA.bind(ctypes.CDLL(str(_build.build("local_attention_baseline", source))))
        old_probe = FA.bind(ctypes.CDLL(str(build_probe(
            source, "local_attention_probe_baseline", CURRENT_ANCHORS))))
    probe = FA.bind(ctypes.CDLL(str(build_probe(
        _build.CSRC / "local_attention.cu", "local_attention_probe", CURRENT_ANCHORS))))
    g = torch.Generator(device=dev).manual_seed(0)
    results = {"device": smi, "bf16": [], "latency": []}
    warm(dev)
    for line, a, bf16_fn, f32_fn, plain, base, plan_list, f32_plan in bf16_cases(g, dev):
        what = " ".join(f"{k} {v}" for k, v in line.items())
        ref = plain(*a)
        rows = []
        for p in plan_list:
            row = {"plan": dataclasses.asdict(p), "default": p == base}
            try:
                row["max_abs_err"] = bf16_check(bf16_fn(*a, launch_plan=p), ref, f"{what} {p}")
                row["_p"] = p
            except RuntimeError as e:
                if p == base:
                    raise
                row["error"] = str(e)[:300]
            rows.append(row)
        timed = [r for r in rows if "_p" in r]
        for rnd in ("ms_first", "ms_second"):
            for r in timed:
                r[rnd] = time_ms(functools.partial(bf16_fn, *a, launch_plan=r["_p"]), flush)
        for r in timed:
            r.pop("_p")
            r["ms"] = min(r["ms_first"], r["ms_second"])
        line = summary(rows, line)
        a32 = tuple(t.float() if torch.is_tensor(t) and t.dtype == torch.bfloat16 else t
                    for t in a)
        line["f32_plan"] = dataclasses.asdict(f32_plan)
        line["f32_ms"] = time_ms(functools.partial(f32_fn, *a32, launch_plan=f32_plan), flush)
        line["default_over_f32"] = line["default_ms"] / line["f32_ms"]
        if old is not None:
            with library(old):
                bf16_check(bf16_fn(*a, launch_plan=as_bf16_plan(f32_plan)), ref, "the baseline")
                line["baseline_ms"] = time_ms(functools.partial(
                    bf16_fn, *a, launch_plan=as_bf16_plan(f32_plan)), flush)
            line["default_over_baseline"] = line["default_ms"] / line["baseline_ms"]
        print(json.dumps(line), flush=True)
        results["bf16"].append({**line, "rows": rows})
        if args.out:  # kept as it grows
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    # where a B 16 x N 128 block's cycles go: the bf16 instance's phases under
    # three plans, and the baseline's bf16 form under the float32 plan
    n = B3_SHAPES[0][1]
    for batch in (4, 16):
        qkv = torch.randn(batch, n, 3 * HEADS * DH, generator=g, device=dev).to(torch.bfloat16)
        ref = FA.fused_qkv_local_attention_plain(qkv, HEADS, DH, W)
        row = {"B": batch, "N": n}
        for name, kw in BF16_PROBED.items():
            plan = FA.attention_plan(n, n, 0, W, False, DH, batch * HEADS, elem=2, **kw)
            fn = functools.partial(FA.fused_qkv_local_attention_bf16_cuda, qkv, HEADS, DH, W,
                                   launch_plan=plan)
            row[f"{name}_plan"] = dataclasses.asdict(plan)
            row[f"{name}_ms"] = time_ms(fn, flush)
            row[f"{name}_no_rotary_ms"] = time_ms(functools.partial(fn, use_rotary=False), flush)
            with library(probe):
                bf16_check(fn(), ref, "the probe build")
                row[f"{name}_phases"] = read_phases(probe, plan.blocks * HEADS * batch,
                                                    CURRENT_PHASES)
        if old is not None:
            plan = as_bf16_plan(FA.attention_plan(n, n, 0, W, False, DH, batch * HEADS))
            fn = functools.partial(FA.fused_qkv_local_attention_bf16_cuda, qkv, HEADS, DH, W,
                                   launch_plan=plan)
            with library(old):
                row["baseline_ms"] = time_ms(fn, flush)
            with library(old_probe):
                bf16_check(fn(), ref, "the baseline probe build")
                row["baseline_phases"] = read_phases(old_probe, plan.blocks * HEADS * batch,
                                                     CURRENT_PHASES)
        print(json.dumps({"latency": {k: v for k, v in row.items() if not k.endswith("_plan")}}),
              flush=True)
        results["latency"].append(row)
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--baseline", default=None, help="an earlier csrc/local_attention.cu")
    ap.add_argument("--bf16", action="store_true", help="sweep the bf16 form")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("local_attention_sweep: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush.zero_()  # the flush and spin kernels load here, not inside a timed window
    torch.cuda._sleep(1000)
    if args.bf16:
        return bf16_main(args, dev, smi, flush)
    base_lib = base_probe = None
    if args.baseline:
        source = Path(args.baseline).resolve()
        base_lib = Baseline(source, "local_attention_baseline")
        base_probe = Baseline(build_probe(source, "local_attention_probe_baseline",
                                          BASELINE_ANCHORS, BASELINE_PV), "")
    current_probe = FA.bind(ctypes.CDLL(str(build_probe(
        _build.CSRC / "local_attention.cu", "local_attention_probe", CURRENT_ANCHORS))))
    g = torch.Generator(device=dev).manual_seed(0)
    results = {"device": smi, "b3": [], "b4": [], "latency": []}
    warm(dev)

    for batch, n in B3_SHAPES:
        p = FA.plan(n, W, False)
        qkv, masks = b3_inputs(g, dev, batch, n)
        base, plan_list = plans(p["Np"], p["C"], p["P"], batch * HEADS)
        for name in MASKS:
            km, keep = masks[name]
            kp = KEEP_PROB if keep is not None else 1.0
            a = (qkv, HEADS, DH, W, False, True, True, km, keep, kp)
            ref = FA.fused_qkv_local_attention_plain(*a)
            rows = sweep_rows(
                lambda pl, a=a: FA.fused_qkv_local_attention_cuda(*a, launch_plan=pl), ref,
                plan_list, base, flush, f"B3 {batch}x{n} {name}")
            line = summary(rows, {"kernel": "B3", "B": batch, "N": n, "masks": name})
            if base_lib is not None:
                check(base_lib.b3(qkv, km, keep), ref, "the baseline B3")
                line["baseline_ms"] = time_ms(lambda: base_lib.b3(qkv, km, keep), flush)
                line["default_over_baseline"] = line["default_ms"] / line["baseline_ms"]
            if name == "none":
                mask = band_mask(p["Np"], W, False, dev)
                tables = rotary_tables(p["Np"], DH, W, False, dev)
                check(b3_composition(qkv, p["Np"], tables, mask), ref, "the composition")
                line["composition_ms"] = time_ms(
                    lambda: b3_composition(qkv, p["Np"], tables, mask), flush)
                line["composition_ratio"] = line["default_ms"] / line["composition_ms"]
            print(json.dumps(line), flush=True)
            results["b3"].append({**line, "rows": rows})

    for batch, n in B4_SHAPES:
        q, k, v = (torch.randn(batch, HEADS, n, DH, generator=g, device=dev) for _ in range(3))
        ref = LH.local_attention_heads_plain(q, k, v, W)
        base, plan_list = plans(n, LH.CHUNK, LH.CHUNK, batch * HEADS)
        rows = sweep_rows(lambda pl: LH.local_attention_heads_cuda(q, k, v, W, launch_plan=pl),
                          ref, plan_list, base, flush, f"B4 {batch}x{n}")
        line = summary(rows, {"kernel": "B4", "B": batch, "N": n})
        mask = band_mask(n, W, False, dev)
        tables = rotary_tables(n, DH, W, False, dev)
        check(composition(q, k, v, tables, mask), ref, "the B4 composition")
        line["composition_ms"] = time_ms(lambda: composition(q, k, v, tables, mask), flush)
        line["composition_ratio"] = line["default_ms"] / line["composition_ms"]
        if base_lib is not None:
            check(base_lib.b4(q, k, v), ref, "the baseline B4")
            line["baseline_ms"] = time_ms(lambda: base_lib.b4(q, k, v), flush)
            line["default_over_baseline"] = line["default_ms"] / line["baseline_ms"]
        print(json.dumps(line), flush=True)
        results["b4"].append({**line, "rows": rows})

    # What a launch waits on: B 1, 4 and 16 of the first shape. The earlier
    # kernel and the default plan timed after the L2 flush (as above), after
    # the flush and 50 us of idle card, and warm (no flush); each probed plan
    # and the earlier kernel without rotary and with each block's phases in
    # SM cycles; the earlier kernel without its P V pass.
    n = B3_SHAPES[0][1]
    timers = {"flushed": flush.zero_,
              "flushed_idle": lambda: (flush.zero_(), torch.cuda._sleep(100_000)),
              "warm": lambda: None}
    timers_flushed = ("flushed", flush.zero_)
    for batch in (1, 4, 16):
        probed = {name: FA.attention_plan(n, n, 0, W, False, DH, batch * HEADS, **kw)
                  for name, kw in PROBED.items()}
        qkv = torch.randn(batch, n, 3 * HEADS * DH, generator=g, device=dev)
        ref = FA.fused_qkv_local_attention_plain(qkv, HEADS, DH, W)
        row = {"B": batch, "N": n}
        for name, plan in probed.items():
            fn = functools.partial(FA.fused_qkv_local_attention_cuda, qkv, HEADS, DH, W,
                                   launch_plan=plan)
            row[f"{name}_plan"] = dataclasses.asdict(plan)
            for tname, before in timers.items() if name == "default" else [timers_flushed]:
                row[f"{name}_{tname}_ms"] = time_with(fn, before)
            row[f"{name}_no_rotary_ms"] = time_ms(functools.partial(fn, use_rotary=False), flush)
            real = FA._library
            FA._library = lambda: current_probe
            try:
                check(fn(), ref, "the probe build")
                row[f"{name}_phases"] = read_phases(current_probe, plan.blocks * HEADS * batch,
                                                    CURRENT_PHASES)
            finally:
                FA._library = real
        if base_lib is not None:
            for tname, before in timers.items():
                row[f"baseline_{tname}_ms"] = time_with(lambda: base_lib.b3(qkv), before)
            row["baseline_no_rotary_ms"] = time_ms(lambda: base_lib.b3(qkv, rotary=False), flush)
            check(base_probe.b3(qkv), ref, "the baseline probe build")
            row["baseline_phases"] = read_phases(base_probe.lib, n // 32 * HEADS * batch,
                                                 BASELINE_PHASES)
            row["baseline_probe_ms"] = time_ms(lambda: base_probe.b3(qkv), flush)
            base_probe.lib.la_probe_set_skip_pv(1)
            row["baseline_probe_without_pv_ms"] = time_ms(lambda: base_probe.b3(qkv), flush)
            base_probe.lib.la_probe_set_skip_pv(0)
        print(json.dumps({"latency": {k: v for k, v in row.items() if not k.endswith("_plan")}}),
              flush=True)
        results["latency"].append(row)
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
