"""Time the conv weight-gradient kernel (B2) under its launch plans at the
main-path shapes, on one CUDA card:

    python -m deepmimic_diffusion_mujoco_tpu_torch.ops.conv_weight_grad_sweep \\
        [--out sweep.json] [--shapes N] [--bf16]

The 26 shapes are every (H, Cin, Cout) that B2 takes on a main path: the
dim-128 U-Net's 14 in a training micro-step (B 32, H 160) and the dim-32
ValueFunction's 12 in a value-training step (B 16, H 64), all at k 5. At
each shape every plan ``make_wgrad_plan`` builds from a channel tile, a
cluster size, rows per chunk and warp slices is checked against the plain
version (within TOL of max |dW|) and timed. Beside them, in the same
turns: the earlier split-K kernel (``csrc/conv1d_weight_grad_splitk.cu``:
CUDA cores, a workspace and a second kernel that adds the splits), and
cuDNN's weight gradient
(``torch.nn.grad.conv1d_weight`` on channel-first copies made outside the
timed call), each held against the plain version too.

``--bf16`` sweeps B2's bf16 form instead (``csrc/conv1d_weight_grad_bf16.cu``:
bf16 x and dy, float32 dW) at the same shapes: every plan
``make_wgrad_bf16_plan`` builds from a warpgroup layout (columns a
warpgroup, warpgroups, the split of channels or taps), a cluster size,
rows per chunk and x's staging (TMA or the CTA's threads), beside cuDNN's bf16
weight gradient (which rounds dW to bf16, so it is held to BF16_LIB_TOL)
and the float32 kernel's default plan on the float32 widenings, in the
same turns; its bounds are the bf16 operations at the tensor cores' rate
and the bytes of bf16 inputs and a float32 output. Each line also gives
the rule's plan (``wgrad_bf16_plan``) against the best plan at the shape.

Times: CUDA events, median of 15 launches with L2 flushed before each and
the card held busy while they queue, after 2 s of matrix products; two
rounds over every plan and yardstick, each keeping the lesser median.
Prints one JSON line per shape (the default plan, the best plan, the
yardsticks, both bounds) and the card's name and power limit;
``--out`` keeps every plan's time.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys

import torch

from . import _build
from . import conv_weight_grad as CW
from .conv_block_sweep import time_ms, warm

TOL = 1e-5   # of max |dW|: float32 sums over up to B*H = 5,120 rows in another order
BF16_LIB_TOL = 2.0 ** -8  # cuDNN's bf16 dW, rounded to bf16: half an ulp of max |dW| and sums
K = 5
TRAIN_B, VALUE_B = 32, 16
# (H, Cin, Cout) of a dim-128 U-Net training micro-step at H 160 (14) and of
# the dim-32 ValueFunction over H 64 (12)
TRAIN_SHAPES = [(160, 35, 128), (160, 128, 128), (80, 128, 256), (80, 256, 256),
                (40, 256, 512), (40, 512, 512), (20, 512, 1024), (20, 1024, 1024),
                (20, 2048, 512), (20, 512, 512), (40, 1024, 256), (40, 256, 256),
                (80, 512, 128), (80, 128, 128)]
VALUE_SHAPES = [(64, 35, 32), (64, 32, 32), (32, 32, 64), (32, 64, 64), (16, 64, 128),
                (16, 128, 128), (8, 128, 256), (8, 256, 256), (8, 256, 128), (8, 128, 128),
                (4, 128, 64), (4, 64, 64)]
SHAPES = [(TRAIN_B, *s) for s in TRAIN_SHAPES] + [(VALUE_B, *s) for s in VALUE_SHAPES]
BF16_ROWS = (32, 64, 128)
TILES_CI = (16, 32, 48, 64, 128)
TILES_CO = (32, 64, 128, 256)
CLUSTERS = (1, 2, 4, 8, 16)
ROWS = (8, 16, 32, 64)  # up to CW.MAX_ROWS
SLICES = (1, 2, 4, 8)
# Published dense peaks of an H100 SXM: float32 outside the tensor cores,
# TF32 and bf16 on them, HBM bandwidth
F32_FLOPS, TF32_FLOPS, BF16_FLOPS, HBM_BYTES = 67.0e12, 495.0e12, 989.0e12, 3.35e12


def splitk_splits(B: int, H: int, cin: int, cout: int, sms: int) -> int:
    """The split-K kernel's split count: enough 64 x 64 tiles' splits for two
    blocks per SM, each reading at least 4 chunks of 20 rows."""
    tiles = -(-cin // 64) * -(-cout // 64)
    return max(1, min(2 * sms // tiles, B * -(-H // 20) // 4))


class SplitK:
    """The earlier split-K kernel, with its workspace allocated once."""

    def __init__(self):
        self.lib = ctypes.CDLL(str(_build.build("conv1d_weight_grad_splitk")))
        self.lib.conv1d_weight_grad_splitk_f32.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        self.lib.conv1d_weight_grad_splitk_f32.restype = ctypes.c_int

    def __call__(self, x, dy, splits, ws):
        B, H, cin = x.shape
        cout = dy.shape[-1]
        out = torch.empty(K, cin, cout, device=x.device)
        err = self.lib.conv1d_weight_grad_splitk_f32(
            x.data_ptr(), dy.data_ptr(), out.data_ptr(), ws.data_ptr() if splits > 1 else None,
            B, H, cin, cout, K, splits, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"split-K kernel launch failed: {err}")
        return out


def plans(B, H, cin, cout, sms):
    """The default plan and every plan of the tiles, clusters, chunk rows and
    slices above that the kernel takes (duplicates once)."""
    base = CW.wgrad_plan(B, H, cin, cout, K, sms)
    seen = {base: None}
    R = B * H
    step = CW.STEP
    for tci in TILES_CI:
        if tci > -(-cin // 16) * 16:
            continue
        for tco in TILES_CO:
            if tco > -(-cout // 32) * 32:
                continue
            for c in CLUSTERS:
                if c > -(-R // step):
                    continue
                for rows in ROWS:
                    if rows % step or rows > -(-R // (step * c)) * step:  # a rank's share
                        continue
                    for sl in SLICES:
                        if step * sl > rows:  # a slice without k-steps
                            continue
                        try:
                            p = CW.make_wgrad_plan(B, H, cin, cout, K, sms, tci=tci, tco=tco,
                                                   rows=rows, cluster=c, slices=sl)
                        except ValueError:
                            continue
                        seen.setdefault(p, None)
    return base, list(seen)


def bf16_plans(B, H, cin, cout, sms):
    """The rule's bf16 plan and every plan of a warpgroup layout at k (each
    instance, either split), a cluster size, chunk rows and x's staging
    (the threads only where TMA could take x) that the kernel takes,
    duplicates once."""
    base = CW.wgrad_bf16_plan(B, H, cin, cout, K, sms)
    seen = {base: None}
    R = B * H
    for kt, nw, wgs in CW.BF16_INSTANCES:
        for split in (0, 1):
            if CW.bf16_taps(K, wgs, split) != kt or (split and wgs < 2):
                continue
            tco = nw if split else nw * wgs
            if tco > max(16, -(-cout // 16) * 16) * 2:  # tiles mostly past Cout
                continue
            for c in CLUSTERS:
                for rows in BF16_ROWS:
                    if rows > -(-R // (CW.BF16_STEP * c)) * CW.BF16_STEP:  # a rank's share
                        continue
                    for tma_x in ((1, 0) if cin % 8 == 0 else (1,)):
                        try:
                            p = CW.make_wgrad_bf16_plan(B, H, cin, cout, K, nw, wgs, split,
                                                        rows, cluster=c, tma_x=tma_x)
                        except ValueError:
                            continue
                        seen.setdefault(p, None)
    return base, list(seen)


def bounds(B, H, cin, cout, bf16=False):
    flops = 2.0 * K * cin * cout * B * H
    if bf16:
        t_bytes = (2.0 * B * H * (cin + cout) + 4.0 * K * cin * cout) / HBM_BYTES * 1e3
        return {"flops": flops, "bound_ms": max(flops / BF16_FLOPS * 1e3, t_bytes)}
    t_bytes = 4.0 * (B * H * (cin + cout) + K * cin * cout) / HBM_BYTES * 1e3
    return {"flops": flops, "bound_ms": max(flops / F32_FLOPS * 1e3, t_bytes),
            "bound_3xtf32_ms": max(flops / (TF32_FLOPS / 3) * 1e3, t_bytes)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None)
    ap.add_argument("--shapes", type=int, default=len(SHAPES), help="first N shapes only")
    ap.add_argument("--bf16", action="store_true", help="sweep the kernel's bf16 form")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("conv_weight_grad_sweep: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    sms = CW.sm_count(dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush.zero_()  # the flush and spin kernels load here, not inside a timed window
    torch.cuda._sleep(1000)
    splitk = None if args.bf16 else SplitK()
    kernel = CW.conv1d_weight_grad_bf16_cuda if args.bf16 else CW.conv1d_weight_grad_cuda
    plan_rows = bf16_plans if args.bf16 else plans
    g = torch.Generator(device=dev).manual_seed(0)
    results = []
    warm(dev)
    for B, H, cin, cout in SHAPES[:args.shapes]:
        x = torch.randn(B, H, cin, generator=g, device=dev)
        dy = torch.randn(B, H, cout, generator=g, device=dev)
        if args.bf16:
            x, dy = x.to(torch.bfloat16), dy.to(torch.bfloat16)
        ref = CW.conv1d_weight_grad_plain(x, dy, K)
        scale = ref.abs().max().item()
        xc, dyc = x.transpose(1, 2).contiguous(), dy.transpose(1, 2).contiguous()

        def check(out, what, tol=TOL):
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            if not (err <= tol * scale and torch.isfinite(out).all()):
                raise RuntimeError(f"{what} disagrees at {(B, H, cin, cout)}: max abs err "
                                   f"{err}, max |dW| {scale}")
            return err / scale

        yardsticks = {"cudnn": lambda: torch.nn.grad.conv1d_weight(xc, (cout, cin, K), dyc,
                                                                   padding=K // 2)}
        errs = {"cudnn": check(yardsticks["cudnn"]().permute(2, 1, 0), "cuDNN",
                               BF16_LIB_TOL if args.bf16 else TOL)}
        if args.bf16:
            x32, dy32 = x.float(), dy.float()
            yardsticks["f32_kernel"] = functools.partial(CW.conv1d_weight_grad_cuda, x32, dy32, K)
            errs["f32_kernel"] = check(yardsticks["f32_kernel"](), "the float32 kernel")
        else:
            splits = splitk_splits(B, H, cin, cout, sms)
            ws = torch.empty(splits, K, cin, cout, device=dev)
            yardsticks["splitk"] = functools.partial(splitk, x, dy, splits, ws)
            errs["splitk"] = check(yardsticks["splitk"](), "the split-K kernel")
        base, cands = plan_rows(B, H, cin, cout, sms)
        rows = []
        for p in cands:
            try:
                out = kernel(x, dy, K, plan=p)
            except RuntimeError as e:  # a cluster the card cannot schedule
                rows.append({"plan": repr(p), "error": str(e)[:200]})
                continue
            rows.append({"plan": repr(p), "cluster": p.cluster,
                         "rel_err": check(out, f"plan {p}"), "default": p == base, "_plan": p,
                         **({"fields": p.fields()} if args.bf16 else {})})
        timed = [r for r in rows if "_plan" in r]
        lib_ms = {}
        for rnd in ("first", "second"):  # plans and yardsticks in turns, twice
            for r in timed:
                r[f"ms_{rnd}"] = time_ms(functools.partial(kernel, x, dy, K, plan=r["_plan"]),
                                         flush)
            for name, fn in yardsticks.items():
                lib_ms.setdefault(name, []).append(time_ms(fn, flush))
        for r in timed:
            del r["_plan"]
            r["ms"] = min(r["ms_first"], r["ms_second"])
        best = min(timed, key=lambda r: r["ms"])
        default = next(r for r in timed if r["default"])
        line = {"shape": [B, H, cin, cout, K],
                "path": "bf16" if args.bf16 else base.path, "default_ms": default["ms"],
                "default_plan": default["plan"], "default_rel_err": default["rel_err"],
                "best_ms": best["ms"], "best_plan": best["plan"],
                **{f"{name}_ms": min(ms) for name, ms in lib_ms.items()},
                **({} if args.bf16 else {"splitk_splits": splits}),
                **{f"{name}_rel_err": e for name, e in errs.items()},
                **bounds(B, H, cin, cout, args.bf16), "plans": len(rows),
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
