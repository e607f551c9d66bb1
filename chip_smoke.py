"""Drive the PyTorch port on one CUDA card and check what comes out.

    python3 chip_smoke.py [--seed 0] [--out results.json]

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi).
2. build: the CUDA kernels of the serving path, built from csrc/ with nvcc.
3. kernels: each kernel against its plain PyTorch version at every shape
   the dim-128 U-Net gives it at B 16 on the main path, H 64 and H 48 (plus
   level 0 at H 192): max error, and per-launch times of the kernel, the
   plain version and the nearest library composition, beside the card's
   bound for the same work.
4. main path: a dim-128 run directory (config.json + a checkpoint from a
   seeded random init) answered through ``cli.sample.main`` (posterior
   T=1000, B 16, H 64, holding_box; then H 48), with every kernel's launch
   count set to 0 just before and read just after; DDIM-50 through
   ``sample_loop``; one U-Net forward with the kernel against the same
   forward with the plain version, at H 64 and H 48; chain throughput.
5. profile: device kernel time by name and the device's busy share over 50
   posterior steps (torch.profiler), beside the unprofiled wall time; the
   host time of one conv block call (the wrapper up to its launch) and its
   share of a step's wall time.

Then a line with the card's name and power limit, a ``{"kernels": [...]}``
line, and last ``{"ok": true, "device": {...}}``. ``--out`` also writes
every phase's results to one JSON file. Timings use CUDA events with the
50 MB L2 flushed before each timed launch; TF32 is off.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from deepmimic_diffusion_mujoco_tpu_torch.cli import sample as cli
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import conditioning
from deepmimic_diffusion_mujoco_tpu_torch.diffusion.sampling import sample_loop
from deepmimic_diffusion_mujoco_tpu_torch.models import temporal_unet
from deepmimic_diffusion_mujoco_tpu_torch.models.temporal_unet import TemporalUnet
from deepmimic_diffusion_mujoco_tpu_torch.ops import _build
from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_block_kernel as CB
from deepmimic_diffusion_mujoco_tpu_torch.train.checkpoint import Checkpointer
from deepmimic_diffusion_mujoco_tpu_torch.train.config import ExperimentConfig

B, H, D, DIM, T, K, GROUPS = 16, 64, 35, 128, 1000, 5, 8
KERNEL_TOL = 1e-4        # |kernel - plain| per element, f32 sums in another order
FORWARD_TOL = 1e-3       # |U-Net(kernel) - U-Net(plain)| after 33 blocks
BOX_ZERO, BOX_ELBOW = [13, 14, 15, 17, 18, 19], [16, 20]

# Published dense peaks: float32 outside the tensor cores, and HBM bandwidth.
PEAKS = {  # substring of the device name -> (flop/s, bytes/s)
    "H100 PCIe": (51.2e12, 2.0e12),
    "H100 NVL": (60.0e12, 3.9e12),
    "H100": (67.0e12, 3.35e12),  # SXM
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    raise RuntimeError(f"no published peaks recorded for {name!r}")


class Timer:
    """Per-call device time: median over calls, each bracketed by CUDA
    events, with L2 flushed before each one. The card is held busy (a
    device-side sleep) while every timed call is queued, so the events time
    the device and not the host's launch gaps."""

    def __init__(self, device):
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, reps=15, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        enqueue_s = time.perf_counter() - t0
        torch.cuda._sleep(int((1e-3 + 2 * reps * enqueue_s) * 2e9))  # cycles at ~2 GHz
        events = []
        for _ in range(reps):
            self.flush_buf.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return float(np.median([start.elapsed_time(end) for start, end in events]))


def record_block_shapes(model, x, t):
    """(H, Cin, Cout) of every conv block call in one forward."""
    seen = []
    real = temporal_unet.conv_gn_mish

    def recorder(xx, w, *args):
        seen.append((xx.shape[1], w.shape[1], w.shape[2]))
        return real(xx, w, *args)

    temporal_unet.conv_gn_mish = recorder
    try:
        with torch.inference_mode():
            model(x, t)
    finally:
        temporal_unet.conv_gn_mish = real
    return seen


def forward_with_plain_blocks(model, x, t):
    """The same forward with every conv block through the plain version."""
    real = temporal_unet.conv_gn_mish
    temporal_unet.conv_gn_mish = CB.conv_gn_mish_plain
    try:
        with torch.inference_mode():
            return model(x, t)
    finally:
        temporal_unet.conv_gn_mish = real


def kernel_phase(dev, timer, counts, peaks):
    """``counts``: horizon -> Counter of (H, Cin, Cout) per forward."""
    flops_peak, bw_peak = peaks
    shapes = list(dict.fromkeys(s for c in counts.values() for s in c))
    shapes += [(192, cin, DIM) for cin in (D, DIM)]  # level 0 at a long horizon
    rows = []
    g = torch.Generator(device=dev).manual_seed(1)
    for (h, cin, cout) in shapes:
        x = torch.randn(B, h, cin, generator=g, device=dev)
        w = torch.randn(K, cin, cout, generator=g, device=dev) * (K * cin) ** -0.5
        b = 0.1 * torch.randn(cout, generator=g, device=dev)
        gamma = 1 + 0.1 * torch.randn(cout, generator=g, device=dev)
        beta = 0.1 * torch.randn(cout, generator=g, device=dev)
        args = (x, w, b, gamma, beta, GROUPS)
        out = CB.conv_gn_mish_cuda(*args)
        ref = CB.conv_gn_mish_plain(*args)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        rel = err / max(ref.abs().max().item(), 1e-30)
        if not (err <= KERNEL_TOL and torch.isfinite(out).all()):
            raise RuntimeError(f"conv_gn_mish kernel disagrees at H {h}, {cin}->{cout}: "
                               f"max abs err {err}")
        xc, wc = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
        ms = timer(lambda: CB.conv_gn_mish_cuda(*args))
        plain_ms = timer(lambda: CB.conv_gn_mish_plain(*args))
        lib_ms = timer(lambda: F.mish(F.group_norm(F.conv1d(xc, wc, b, padding=K // 2),
                                                   GROUPS, gamma, beta)))
        flops = 2.0 * B * h * cout * K * cin
        nbytes = 4.0 * (B * h * cin + K * cin * cout + 3 * cout + B * h * cout)
        t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / bw_peak * 1e3
        rows.append({
            "H": h, "cin": cin, "cout": cout,
            **{f"per_forward_h{hz}": c.get((h, cin, cout), 0) for hz, c in counts.items()},
            "max_abs_err": err, "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
            "composition_ms": lib_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "tflops": flops / ms / 1e9,
        })
        emit({"phase": "kernel", "name": "conv_gn_mish", **rows[-1]})
    return rows


def host_per_call(dev, reps=200):
    """Host microseconds per conv block call at (64, 128->128), with the card
    held busy so that no call waits on it: the autograd entry the model
    calls, and the wrapper alone (argument checks + ctypes launch)."""
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(B, H, DIM, generator=g, device=dev)
    w = torch.randn(K, DIM, DIM, generator=g, device=dev) * (K * DIM) ** -0.5
    b, gamma, beta = (torch.randn(DIM, generator=g, device=dev) for _ in range(3))
    out = {}
    with torch.inference_mode():  # as in sample_loop
        for name, fn in (("entry_us", CB.conv_gn_mish), ("wrapper_us", CB.conv_gn_mish_cuda)):
            for _ in range(10):
                fn(x, w, b, gamma, beta, GROUPS)
            torch.cuda.synchronize()
            torch.cuda._sleep(int(0.1 * 2e9))  # ~0.1 s at ~2 GHz, longer than the loop
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(x, w, b, gamma, beta, GROUPS)
            out[name] = (time.perf_counter() - t0) / reps * 1e6
            torch.cuda.synchronize()
    return out


def write_run(run_dir, seed):
    cfg = ExperimentConfig.from_dict({
        "name": "chip_smoke",
        "model": {"architecture": "temporal", "input_dim": D, "channel_dim": DIM,
                  "dim_mults": [1, 2, 4, 8], "max_seq_len": H},
        "diffusion": {"noise_steps": T, "schedule_type": "cosine", "convention": "diffuser",
                      "predict_x0": False, "mode": "posterior"},
    })
    os.makedirs(run_dir, exist_ok=True)
    cfg.save(os.path.join(run_dir, "config.json"))
    torch.manual_seed(seed)
    sd = TemporalUnet(D, dim=DIM).state_dict()
    Checkpointer(os.path.join(run_dir, "checkpoints")).save_best(0, sd, sd, loss=0.0)


def check_motions(paths, frames, num):
    if len(paths) != num:
        raise RuntimeError(f"expected {num} motions, got {len(paths)}")
    for p in paths:
        m = np.load(p)
        if m.shape != (frames, 35) or not np.isfinite(m).all():
            raise RuntimeError(f"{p}: shape {m.shape}, finite {np.isfinite(m).all()}")
        if not ((m[:, BOX_ZERO] == 0).all() and (m[:, BOX_ELBOW] == np.float32(1.57)).all()):
            raise RuntimeError(f"{p}: holding_box dims not clamped")


def request(run_dir, out_dir, frames):
    """One CLI request; -> (paths, seconds, conv_gn_mish launches)."""
    CB.conv_gn_mish_cuda.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # the CLI prints every saved path
        paths = cli.main(["--run", run_dir, "--num", str(B), "--frames", str(frames),
                          "--conditioner", "holding_box", "--out", out_dir, "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = CB.conv_gn_mish_cuda.launches
    check_motions(paths, frames, B)
    return paths, seconds, launches


def timed_chain(model, sched, mode, seed, **kw):
    cond = conditioning.holding_box(D, device=sched.device)
    gen = torch.Generator(device=sched.device).manual_seed(seed)
    CB.conv_gn_mish_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sample_loop(sched, model, (B, H, D), gen, mode=mode, conditioning_fn=cond, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    x = out.trajectories
    if x.shape != (B, H, D) or not torch.isfinite(x).all():
        raise RuntimeError(f"{mode} chain: shape {tuple(x.shape)}, finite "
                           f"{bool(torch.isfinite(x).all())}")
    return seconds, CB.conv_gn_mish_cuda.launches


def profile_window(model, sched, seed, steps=50):
    """Device kernel time by name over ``steps`` posterior steps, from a
    torch.profiler trace, beside the same window's wall time without the
    profiler: -> (device ms per step, wall ms per step, top kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cond = conditioning.holding_box(D, device=sched.device)

    def window():
        gen = torch.Generator(device=sched.device).manual_seed(seed)
        sample_loop(sched, model, (B, H, D), gen, conditioning_fn=cond, t_start=steps)
        torch.cuda.synchronize()

    window()
    t0 = time.perf_counter()
    window()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window()
    by_name = Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
    top = [{"kernel": n[:80], "ms_per_step": ms / steps} for n, ms in by_name.most_common(8)]
    return sum(by_name.values()) / steps, wall_ms / steps, top


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="also write all results to this JSON file")
    args = p.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    peak_key, peaks = peaks_for(kind)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "peaks_for": peak_key, "fp32_flops": peaks[0], "hbm_bytes_per_s": peaks[1]})

    t0 = time.perf_counter()
    log = Path(str(_build.build("conv_gn_mish")) + ".log")  # nvcc's output, beside the library
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    timer = Timer(dev)
    torch.manual_seed(args.seed)
    probe = TemporalUnet(D, dim=DIM).to(dev).eval()
    gx = torch.Generator(device=dev).manual_seed(args.seed + 1)
    x = torch.randn(B, H, D, generator=gx, device=dev)
    t = torch.randint(0, T, (B,), generator=gx, device=dev)
    x48 = torch.randn(B, 48, D, generator=gx, device=dev)
    shapes = record_block_shapes(probe, x, t)
    counts = {H: Counter(shapes), 48: Counter(record_block_shapes(probe, x48, t))}
    rows = kernel_phase(dev, timer, counts, peaks)
    per_fwd = lambda key: sum(r[key] * r[f"per_forward_h{H}"] for r in rows)
    kernel_err = max(r["max_abs_err"] for r in rows)

    result = {"kernel_rows": rows}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        run = os.path.join(tmp, "run")
        write_run(run, args.seed)
        # -- the main path: two CLI requests, launch counts around each --
        _, s64, launches = request(run, os.path.join(tmp, "h64"), H)
        expected = len(shapes) * T
        if launches != expected:
            raise RuntimeError(f"conv_gn_mish launched {launches} times in the H {H} request, "
                               f"expected {expected}")
        _, s48, launches48 = request(run, os.path.join(tmp, "h48"), 48)
        if launches48 != sum(counts[48].values()) * T:
            raise RuntimeError(f"conv_gn_mish launched {launches48} times in the H 48 request")
        emit({"phase": "main_path", "requests": [
            {"frames": H, "num": B, "seconds": s64, "conv_gn_mish_launches": launches},
            {"frames": 48, "num": B, "seconds": s48, "conv_gn_mish_launches": launches48}]})

        _, model, sched, payload, _ = cli.load_run(run, device=dev)
        model.load_state_dict(payload["params"])
        model.eval()
        fwd_errs = {}
        for xx in (x, x48):
            with torch.inference_mode():
                out_k = model(xx, t)
            out_p = forward_with_plain_blocks(model, xx, t)
            err = (out_k - out_p).abs().max().item()
            if not (err <= FORWARD_TOL and torch.isfinite(out_k).all()):
                raise RuntimeError(f"U-Net forward at H {xx.shape[1]} with the kernel differs "
                                   f"from plain by {err}")
            fwd_errs[f"h{xx.shape[1]}"] = err
        with torch.inference_mode():
            fwd_ms = timer(lambda: model(x, t), reps=10)
            fwd_plain_ms = timer(lambda: forward_with_plain_blocks(model, x, t), reps=10)

        s_post, l_post = timed_chain(model, sched, "posterior", args.seed)
        s_ddim, l_ddim = timed_chain(model, sched, "ddim", args.seed, ddim_steps=50)
        if l_post != expected or l_ddim != len(shapes) * 50:
            raise RuntimeError(f"chain launches {l_post}, {l_ddim}")
        chains = {
            "forward_max_abs_err_kernel_vs_plain": fwd_errs,
            "forward_ms": fwd_ms, "forward_plain_blocks_ms": fwd_plain_ms,
            "posterior_T1000": {"seconds": s_post, "samples_per_s": B / s_post,
                                "conv_gn_mish_launches": l_post},
            "ddim50": {"seconds": s_ddim, "samples_per_s": B / s_ddim,
                       "conv_gn_mish_launches": l_ddim},
        }
        emit({"phase": "chains", **chains})
        result.update(chains, requests={"h64_seconds": s64, "h48_seconds": s48})

        device_ms, wall_ms, top = profile_window(model, sched, args.seed)
        host = host_per_call(dev)
        profile = {"device_ms_per_step": device_ms, "wall_ms_per_step": wall_ms,
                   # null when the trace holds no device events: not measured
                   "device_busy_share": device_ms / wall_ms if device_ms else None,
                   "top_kernels": top, "conv_block_host": host,
                   "conv_block_host_share_of_step": len(shapes) * host["entry_us"] / 1e3 / wall_ms}
        emit({"phase": "profile", **profile})
        result.update(profile=profile)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = [{
        "name": "conv_gn_mish", "route": "cuda", "status": "ported; matches its plain version",
        "source": "deepmimic_diffusion_mujoco_tpu_torch/csrc/conv_gn_mish.cu",
        "replaces": "deepmimic_diffusion_mujoco_tpu/ops/pallas/conv_block_kernel.py:104",
        "launches": launches, "max_abs_err": kernel_err,
        # times: sums over one dim-128 U-Net forward's 33 launches at B 16, H 64
        "ms": per_fwd("ms"), "plain_ms": per_fwd("plain_ms"), "bound_ms": per_fwd("bound_ms"),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in rows
                                        if r[f"per_forward_h{H}"]) else "bytes",
        "library_ms": None, "composition_ms": per_fwd("composition_ms"),
        "launches_per_forward": len(shapes),
    }]
    result.update(device={"kind": kind, "nvidia_smi": smi}, kernels=kernels)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)

    print(smi.splitlines()[0], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
