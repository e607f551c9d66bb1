"""Time the conv block kernel under many launch plans at the U-Net's main
shapes, on one CUDA card:

    python -m deepmimic_diffusion_mujoco_tpu_torch.ops.conv_block_sweep [--bf16] [--out sweep.json]

For each shape: the default plan (``conv_plan``) and every plan that
``make_plan`` builds from a cluster size, a slice count, channels per slice
and a ring depth; each is checked against the plain version (1e-4) before it
is timed twice, in two rounds over the plans (CUDA events, median of 15
launches, L2 flushed before each; the lesser median counts), after 2 s of
matrix products to warm the card. Prints
one JSON line per shape with the default's time, the best plan and its time,
and the card's name and power limit; ``--out`` keeps every plan's time.

``--bf16``: B1's bf16 form instead (``bf16_sweep``), at the 14 shapes of the
dim-128 serve forward (B 16 x H 64), the 14 of a bf16 training micro-step
(B 32 x H 160), the 12 of the dim-32 ValueFunction's value step (B 16 x H 64)
and K1's bf16 entry at the 14 of a rank's sharded forward (B 4, 512 rows),
under ``bf16_plan``'s default and the plans ``bf16_candidates`` builds (rows,
cluster, channel or row split, ring depth, warpgroups, the wgmma or mma.sync
instance, TMA off for the default), each checked against the plain version
(one bf16 ulp of the value plus 1e-4; K1's pre-norm rows within 1e-4) and
timed the same way, beside the float32 kernel's default plan on the same
values in float32 and the bf16 composition (``F.conv1d`` + ``group_norm`` +
``mish``; K1: ``F.conv1d`` + ``var_mean``). ``--kinds`` picks among serve,
train, value and k1.
"""
from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from . import conv_block_kernel as CB

TOL = 1e-4
# (B, H, Cin, Cout): serving's deep (H 8, 16) and level-0/1 (H 64, 48, 32)
# shapes at B 16, training's deep (H 20, 40) and level-0/1 (H 160, 80) shapes
# at B 32
SHAPES = [(16, 8, 1024, 1024), (16, 8, 512, 512), (16, 16, 512, 512), (16, 48, 35, 128),
          (16, 64, 128, 128), (16, 32, 128, 256), (16, 32, 128, 128), (16, 32, 256, 256),
          (32, 20, 1024, 1024), (32, 40, 256, 256), (32, 80, 256, 256), (32, 80, 128, 128),
          (32, 160, 35, 128), (32, 160, 128, 128)]
K, GROUPS = 5, 8
# bf16 (B, H, Cin, Cout): the distinct shapes of the dim-128 serve forward (B 16 x H 64), a
# bf16 training micro-step (B 32 x H 160), the dim-32 ValueFunction's value step (B 16 x H
# 64) and a rank's sharded forward for K1 (B 4, 512 of H 1024 rows)
BF16_SHAPES = {
    "serve": [(16, 64, 35, 128), (16, 64, 128, 128), (16, 32, 128, 256), (16, 32, 256, 256),
              (16, 16, 256, 512), (16, 16, 512, 512), (16, 8, 512, 1024), (16, 8, 1024, 1024),
              (16, 8, 2048, 512), (16, 8, 512, 512), (16, 16, 1024, 256), (16, 16, 256, 256),
              (16, 32, 512, 128), (16, 32, 128, 128)],
    "train": [(32, 20, 512, 512), (32, 20, 512, 1024), (32, 20, 1024, 1024), (32, 20, 2048, 512),
              (32, 40, 256, 256), (32, 40, 256, 512), (32, 40, 512, 512), (32, 40, 1024, 256),
              (32, 80, 128, 128), (32, 80, 128, 256), (32, 80, 256, 256), (32, 80, 512, 128),
              (32, 160, 35, 128), (32, 160, 128, 128)],
    "value": [(16, 4, 64, 64), (16, 4, 128, 64), (16, 8, 128, 128), (16, 8, 128, 256),
              (16, 8, 256, 128), (16, 8, 256, 256), (16, 16, 64, 128), (16, 16, 128, 128),
              (16, 32, 32, 64), (16, 32, 64, 64), (16, 64, 32, 32), (16, 64, 35, 32)],
    "k1": [(4, 512, 35, 128), (4, 512, 128, 128), (4, 256, 128, 256), (4, 256, 256, 256),
           (4, 128, 256, 512), (4, 128, 512, 512), (4, 64, 512, 1024), (4, 64, 1024, 1024),
           (4, 64, 2048, 512), (4, 64, 512, 512), (4, 128, 1024, 256), (4, 128, 256, 256),
           (4, 256, 512, 128), (4, 256, 128, 128)],
}


def bf16_shapes(kinds=tuple(BF16_SHAPES)):
    """Every (B, H, Cin, Cout) of ``BF16_SHAPES`` for ``kinds``."""
    return [shape for kind in kinds for shape in BF16_SHAPES[kind]]

def time_ms(fn, flush, reps=15, warmup=3):
    """Median device ms of fn over reps, L2 flushed before each; the card is
    held busy (a device-side spin) while every call is queued, so the events
    time the device and not the host's launch gaps."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda._sleep(int((1e-3 + 2 * reps * enqueue_s) * 2e9))  # cycles at ~2 GHz
    events = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def candidates(B, H, cin, cout):
    base = CB.conv_plan(B, H, cin, cout, K, GROUPS)
    seen = {base: None}
    for rows in range(1, CB.MAX_ROWS + 1):
        for c in CB.CLUSTER_SIZES:
            if cin // c < 32:
                continue
            try:
                first = CB.make_plan(B, H, cin, cout, K, GROUPS, cluster=c, rows=rows)
            except ValueError:
                continue
            for s in sorted({first.slices, max(1, first.slices // 2)}):
                for cps in (2, 4, 8):
                    for st in (3, 4):
                        try:
                            p = CB.make_plan(B, H, cin, cout, K, GROUPS, cluster=c,
                                             rows=rows, slices=s, channels_per_slice=cps,
                                             stages=st)
                        except ValueError:
                            continue
                        seen.setdefault(p, None)
    return base, list(seen)


def bf16_candidates(B, H, cin, cout):
    """The bf16 plans timed at one shape: the rule's default first, then for
    rows R in the powers of two up to B (and the default's R), each cluster
    size of the channel split and (R 1) of the row split whose grid stays
    within 16..2 x 132 CTAs, each instance, at the deepest ring and one
    shallower, with one and two warpgroups where both hold the rows; and the
    default with TMA off."""
    default = CB.bf16_plan(B, H, cin, cout, K, GROUPS)
    seen = {default: None}
    rows = {r for r in (1, 2, 4, 8, 16) if r <= B} | {default.rows}
    for r in sorted(rows):
        for split in ((0, 1) if r == 1 else (0,)):
            for c in CB.CLUSTER_SIZES:
                if split and (c == 1 or H < 16 * c):
                    continue
                if not 16 <= GROUPS * -(-B // r) * c <= 2 * CB.H100_SMS:
                    continue
                for mma in (0, 1):
                    try:
                        first = CB.make_bf16_plan(B, H, cin, cout, K, GROUPS, r, c, split,
                                                  mma=mma)
                    except ValueError:
                        continue
                    for st in sorted({first.stages, max(1, first.stages - 1)}):
                        for wgs in sorted({first.wgs, 2}):
                            try:
                                seen.setdefault(CB.make_bf16_plan(
                                    B, H, cin, cout, K, GROUPS, r, c, split, stages=st,
                                    mma=mma, wgs=wgs), None)
                            except ValueError:
                                pass
    seen.setdefault(CB.make_bf16_plan(B, H, cin, cout, K, GROUPS, **{**default.fields(),
                                                                    "tma": 0}), None)
    return default, list(seen)


def bf16_sweep(dev, g, flush, kinds=tuple(BF16_SHAPES)):
    """-> one result per shape of ``kinds`` (see the module docstring)."""
    results = []
    for kind in kinds:
        for B, H, cin, cout in BF16_SHAPES[kind]:
            k1 = kind == "k1"
            rows_in = H + K - 1 if k1 else H
            x = torch.randn(B, rows_in, cin, generator=g, device=dev).to(torch.bfloat16)
            w = (torch.randn(K, cin, cout, generator=g, device=dev)
                 * (K * cin) ** -0.5).to(torch.bfloat16)
            b, gamma, beta = (0.1 * torch.randn(cout, generator=g, device=dev) for _ in range(3))
            gamma += 1
            xc, wc = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
            b16, g16, be16 = b.to(torch.bfloat16), gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
            if k1:
                ref = CB.conv_gn_stats_plain(x, w, b, GROUPS)[0]
                entry = functools.partial(CB.conv_gn_stats_bf16_cuda, x, w, b, GROUPS)
                f32 = functools.partial(CB.conv_gn_stats_cuda, x.float(), w.float(), b, GROUPS)

                def composition():
                    o = F.conv1d(xc, wc, b16)
                    return torch.var_mean(o.view(B, GROUPS, -1), dim=-1, correction=0)
            else:
                ref = CB.conv_gn_mish_plain(x, w, b, gamma, beta, GROUPS).float()
                entry = functools.partial(CB.conv_gn_mish_bf16_cuda, x, w, b, gamma, beta,
                                          GROUPS)
                f32 = functools.partial(CB.conv_gn_mish_cuda, x.float(), w.float(), b, gamma,
                                        beta, GROUPS)

                def composition():
                    return F.mish(F.group_norm(F.conv1d(xc, wc, b16, padding=K // 2), GROUPS,
                                               g16, be16))
            default, plans = bf16_candidates(B, H, cin, cout)
            rows = []
            for plan in plans:
                fn = functools.partial(entry, plan=plan)
                out = fn()
                d = ((out[0] if k1 else out.float()) - ref).abs()
                bound = TOL if k1 else 2.0 ** -7 * ref.abs() + TOL
                if not bool((d <= bound).all()):
                    raise RuntimeError(f"bf16 plan {plan} disagrees at {kind} "
                                       f"{(B, H, cin, cout)}: {d.max().item()}")
                rows.append({"plan": plan.fields(), "default": plan == default, "_fn": fn})
            for r in rows + rows:  # two rounds: a plan's time is the lesser median
                r["ms"] = min(r.get("ms", float("inf")), time_ms(r["_fn"], flush))
            for r in rows:
                del r["_fn"]
            best = min(rows, key=lambda r: r["ms"])
            line = {"kind": kind, "shape": [B, H, cin, cout], "default_plan": default.fields(),
                    "default_ms": rows[0]["ms"], "best_plan": best["plan"],
                    "best_ms": best["ms"], "f32_kernel_ms": time_ms(f32, flush),
                    "composition_ms": time_ms(composition, flush), "plans": len(rows)}
            print(json.dumps(line), flush=True)
            results.append({**line, "rows": rows})
    return results

def warm(dev, seconds=2.0):
    a = torch.randn(4096, 4096, device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(4):
            a @ a
        torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None)
    ap.add_argument("--shapes", type=int, default=len(SHAPES), help="first N shapes only")
    ap.add_argument("--bf16", action="store_true", help="B1's bf16 form (bf16_sweep)")
    ap.add_argument("--kinds", default=",".join(BF16_SHAPES),
                    help="with --bf16: comma-separated of " + ", ".join(BF16_SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("conv_block_sweep: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush.zero_()  # the flush and spin kernels load here, not inside a timed window
    torch.cuda._sleep(1000)
    g = torch.Generator(device=dev).manual_seed(0)
    results = []
    warm(dev)
    if args.bf16:
        results = bf16_sweep(dev, g, flush, args.kinds.split(","))
    for B, H, cin, cout in ([] if args.bf16 else SHAPES[:args.shapes]):
        x = torch.randn(B, H, cin, generator=g, device=dev)
        w = torch.randn(K, cin, cout, generator=g, device=dev) * (K * cin) ** -0.5
        b, gamma, beta = (0.1 * torch.randn(cout, generator=g, device=dev) for _ in range(3))
        gamma += 1
        ref = CB.conv_gn_mish_plain(x, w, b, gamma, beta, GROUPS)
        base, plans = candidates(B, H, cin, cout)
        rows = []
        for p in plans:
            try:
                out = CB.conv_gn_mish_cuda(x, w, b, gamma, beta, GROUPS, plan=p)
            except RuntimeError as e:  # a plan the card cannot schedule
                rows.append({"plan": repr(p), "error": str(e)[:200]})
                continue
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            if not err <= TOL:
                raise RuntimeError(f"plan {p} disagrees at {(B, H, cin, cout)}: {err}")
            rows.append({"plan": repr(p), "err": err, "default": p == base, "_plan": p})
        for r in rows:  # two rounds, each plan once per round: its time is the lesser median
            if "_plan" in r:
                fn = functools.partial(CB.conv_gn_mish_cuda, x, w, b, gamma, beta, GROUPS,
                                       plan=r["_plan"])
                r["ms_first"] = time_ms(fn, flush)
        for r in rows:
            if "_plan" in r:
                fn = functools.partial(CB.conv_gn_mish_cuda, x, w, b, gamma, beta, GROUPS,
                                       plan=r.pop("_plan"))
                r["ms_second"] = time_ms(fn, flush)
                r["ms"] = min(r["ms_first"], r["ms_second"])
        timed = [r for r in rows if "ms" in r]
        best = min(timed, key=lambda r: r["ms"])
        default = next(r for r in timed if r["default"])
        flops = 2.0 * B * H * cout * K * cin
        line = {"shape": [B, H, cin, cout], "default_ms": default["ms"],
                "default_plan": default["plan"], "best_ms": best["ms"], "best_plan": best["plan"],
                "default_tflops": flops / default["ms"] / 1e9, "plans": len(rows),
                "refused": len(rows) - len(timed)}
        print(json.dumps(line), flush=True)
        results.append({**line, "rows": rows})
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "shapes": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
