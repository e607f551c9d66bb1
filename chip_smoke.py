"""Drive the PyTorch port on one CUDA card and check what comes out.

    python3 chip_smoke.py [--seed 0] [--out results.json]

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi).
2. build: both CUDA sources (B1 csrc/conv_gn_mish.cu, B2
   csrc/conv1d_weight_grad.cu), compiled in parallel with nvcc, with
   ptxas's register and spill lines.
3. kernels: each kernel against its plain PyTorch version at every shape
   the dim-128 U-Net gives it on the main paths: B1 at B 16 for serving
   (H 64 and H 48, plus level 0 at H 192) and at B 32 for a training
   micro-step (H 160), B2 at B 32 (H 160). Max error, and per-launch times
   of the kernel, the plain version and the library yardstick, beside the
   card's bound for the same work.
4. serve: a dim-128 run directory (config.json + a checkpoint from a seeded
   random init) answered through ``cli.sample.main`` (posterior T=1000,
   B 16, H 64, holding_box; then H 48), with B1's launch count set to 0
   just before and read just after each request; DDIM-50 through
   ``sample_loop``; one U-Net forward with the kernel against the same
   forward with the plain version, at H 64 and H 48; chain throughput; the
   serving profile (device kernel time by name and busy share over 50
   posterior steps, and the host time of one conv block call).
5. train, the slice's main path: ``cli.train.main`` with the user config
   experiments/unet_walk10k/config.json read from disk, on the cartwheel
   clip (H 160, 160 cyclic variants), B 64 taken as 32 x
   gradient_accumulate_every 2, cut to 30 optimizer steps with the EMA,
   periodic saves, logs and the best-model window all firing. Both
   kernels' counts are set to 0 just before and read just after: each must
   be 33 per micro-step. Then one ``cli.sample.main`` request answered from
   the trained run, with its clamped dims exact.
6. grads: one full B 64 step at H 160 with both kernels against the same
   step with both plain versions: the loss and every parameter's gradient.
7. train profile: ms per optimizer step (host clock, 10 steps), device
   kernel time per step by name, the host operators with the most CPU time
   and the device's busy share (torch.profiler over 10 steps), and peak
   device memory.

Then a line with the card's name and power limit, a ``{"kernels": [...]}``
line, and last ``{"ok": true, "device": {...}}``. ``--out`` also writes
every phase's results to one JSON file. Timings use CUDA events with the
50 MB L2 flushed before each timed launch; TF32 is off.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from deepmimic_diffusion_mujoco_tpu_torch.cli import sample as cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import train as train_cli
from deepmimic_diffusion_mujoco_tpu_torch.data.datasets import MotionDataset
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import conditioning, process
from deepmimic_diffusion_mujoco_tpu_torch.diffusion.sampling import sample_loop
from deepmimic_diffusion_mujoco_tpu_torch.diffusion.schedules import make_schedule
from deepmimic_diffusion_mujoco_tpu_torch.models import temporal_unet
from deepmimic_diffusion_mujoco_tpu_torch.models.temporal_unet import TemporalUnet
from deepmimic_diffusion_mujoco_tpu_torch.ops import _build
from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_block_kernel as CB
from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_weight_grad as CW
from deepmimic_diffusion_mujoco_tpu_torch.train.checkpoint import Checkpointer
from deepmimic_diffusion_mujoco_tpu_torch.train.config import ExperimentConfig
from deepmimic_diffusion_mujoco_tpu_torch.train.loop import make_loss_fn

ROOT = Path(__file__).resolve().parent
USER_CONFIG = ROOT / "experiments" / "unet_walk10k" / "config.json"
CARTWHEEL = ROOT / "data" / "motions" / "humanoid3d_cartwheel.txt"
SOURCES = ("conv_gn_mish", "conv1d_weight_grad")

B, H, D, DIM, T, K, GROUPS = 16, 64, 35, 128, 1000, 5, 8
TRAIN_B, TRAIN_H, ACCUM, TRAIN_STEPS = 32, 160, 2, 30
KERNEL_TOL = 1e-4        # B1: |kernel - plain| per element, f32 sums in another order
WGRAD_TOL = 1e-5         # B2: |kernel - plain| / max|plain|, sums over up to 10,240 rows
FORWARD_TOL = 1e-3       # |U-Net(kernel) - U-Net(plain)| after 33 blocks
GRAD_TOL = 1e-3          # per parameter: |grad(kernels) - grad(plain)| / max|grad(plain)|
LOSS_TOL = 1e-5          # |loss(kernels) - loss(plain)| / loss(plain)
BOX_ZERO, BOX_ELBOW = [13, 14, 15, 17, 18, 19], [16, 20]
TRAIN_SET = [f"train.gradient_accumulate_every={ACCUM}", "train.log_every=10",
             "train.save_every=15", "train.ema_start=20", "train.ema_every=10"]

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


def bound(flops, nbytes, peaks):
    """(bound ms, what bounds it) for work of ``flops`` and ``nbytes``."""
    t_ops, t_bytes = flops / peaks[0] * 1e3, nbytes / peaks[1] * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


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


def build_all():
    """Both sources compiled at once, one nvcc each; -> {name: ptxas lines,
    or None where the library was already built and its log is gone}."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
    out = {}
    for name, so in libs.items():
        log = Path(str(so) + ".log")
        out[name] = ([ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln] if log.exists() else None)
    return out


def reset_counts():
    CB.conv_gn_mish_cuda.launches = 0
    CW.conv1d_weight_grad_cuda.launches = 0


def counts():
    return CB.conv_gn_mish_cuda.launches, CW.conv1d_weight_grad_cuda.launches


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


@contextlib.contextmanager
def plain_kernels():
    """Every conv block through the plain versions: B1's forward and B2's dW."""
    real = CB.conv_gn_mish_cuda, CB.conv1d_weight_grad
    CB.conv_gn_mish_cuda, CB.conv1d_weight_grad = CB.conv_gn_mish_plain, CW.conv1d_weight_grad_plain
    try:
        yield
    finally:
        CB.conv_gn_mish_cuda, CB.conv1d_weight_grad = real


def forward_with_plain_blocks(model, x, t):
    with plain_kernels(), torch.inference_mode():
        return model(x, t)


def b1_rows(dev, timer, counts_by_h, peaks, batch, extra=()):
    """B1 against its plain version at every shape of ``counts_by_h``
    (horizon -> Counter of (H, Cin, Cout) per forward) at ``batch``."""
    shapes = list(dict.fromkeys(s for c in counts_by_h.values() for s in c)) + list(extra)
    rows = []
    g = torch.Generator(device=dev).manual_seed(1)
    for (h, cin, cout) in shapes:
        x = torch.randn(batch, h, cin, generator=g, device=dev)
        w = torch.randn(K, cin, cout, generator=g, device=dev) * (K * cin) ** -0.5
        b = 0.1 * torch.randn(cout, generator=g, device=dev)
        gamma = 1 + 0.1 * torch.randn(cout, generator=g, device=dev)
        beta = 0.1 * torch.randn(cout, generator=g, device=dev)
        args = (x, w, b, gamma, beta, GROUPS)
        out = CB.conv_gn_mish_cuda(*args)
        ref = CB.conv_gn_mish_plain(*args)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not (err <= KERNEL_TOL and torch.isfinite(out).all()):
            raise RuntimeError(f"conv_gn_mish kernel disagrees at B {batch}, H {h}, "
                               f"{cin}->{cout}: max abs err {err}")
        xc, wc = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
        ms = timer(lambda: CB.conv_gn_mish_cuda(*args))
        plain_ms = timer(lambda: CB.conv_gn_mish_plain(*args))
        comp_ms = timer(lambda: F.mish(F.group_norm(F.conv1d(xc, wc, b, padding=K // 2),
                                                    GROUPS, gamma, beta)))
        flops = 2.0 * batch * h * cout * K * cin
        bound_ms, bound_by = bound(flops, 4.0 * (batch * h * (cin + cout) + K * cin * cout
                                                 + 3 * cout), peaks)
        rows.append({
            "B": batch, "H": h, "cin": cin, "cout": cout,
            **{f"per_forward_h{hz}": c.get((h, cin, cout), 0) for hz, c in counts_by_h.items()},
            "max_abs_err": err, "max_rel_err": err / max(ref.abs().max().item(), 1e-30),
            "ms": ms, "plain_ms": plain_ms, "composition_ms": comp_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "tflops": flops / ms / 1e9,
        })
        emit({"phase": "kernel", "name": "conv_gn_mish", **rows[-1]})
    return rows


def b2_rows(dev, timer, per_step, peaks, batch):
    """B2 against its plain version at every (H, Cin, Cout) of ``per_step``
    (Counter of launches per micro-step) at ``batch``; the library yardstick
    is cuDNN's weight gradient, ``torch.nn.grad.conv1d_weight``, on
    channel-first copies made outside the timed call."""
    rows = []
    g = torch.Generator(device=dev).manual_seed(3)
    for (h, cin, cout), n in per_step.items():
        x = torch.randn(batch, h, cin, generator=g, device=dev)
        dy = torch.randn(batch, h, cout, generator=g, device=dev)
        out = CW.conv1d_weight_grad_cuda(x, dy, K)
        ref = CW.conv1d_weight_grad_plain(x, dy, K)
        xc, dyc = x.transpose(1, 2).contiguous(), dy.transpose(1, 2).contiguous()

        def library():
            return torch.nn.grad.conv1d_weight(xc, (cout, cin, K), dyc, padding=K // 2)

        lib = library().permute(2, 1, 0)
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        err = (out - ref).abs().max().item()
        lib_err = (lib - ref).abs().max().item()
        if not (err <= WGRAD_TOL * scale and torch.isfinite(out).all()):
            raise RuntimeError(f"conv1d_weight_grad kernel disagrees at B {batch}, H {h}, "
                               f"{cin}->{cout}: max abs err {err}, max |dW| {scale}")
        if not lib_err <= WGRAD_TOL * scale:
            raise RuntimeError(f"the library yardstick computes another function: {lib_err}")
        ms = timer(lambda: CW.conv1d_weight_grad_cuda(x, dy, K))
        plain_ms = timer(lambda: CW.conv1d_weight_grad_plain(x, dy, K))
        lib_ms = timer(library)
        flops = 2.0 * K * cin * cout * batch * h
        bound_ms, bound_by = bound(flops, 4.0 * (batch * h * (cin + cout) + K * cin * cout), peaks)
        rows.append({
            "B": batch, "H": h, "cin": cin, "cout": cout, "per_micro_step": n,
            "splits": CW.split_count(batch, h, cin, cout, CW._sm_count(x.device)),
            "max_abs_err": err, "max_rel_err": err / scale, "library_rel_err": lib_err / scale,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "tflops": flops / ms / 1e9,
        })
        emit({"phase": "kernel", "name": "conv1d_weight_grad", **rows[-1]})
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


def request(run_dir, out_dir, frames, num=B):
    """One CLI request; -> (paths, seconds, conv_gn_mish launches)."""
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # the CLI prints every saved path
        paths = cli.main(["--run", run_dir, "--num", str(num), "--frames", str(frames),
                          "--conditioner", "holding_box", "--out", out_dir, "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = CB.conv_gn_mish_cuda.launches
    check_motions(paths, frames, num)
    return paths, seconds, launches


def timed_chain(model, sched, mode, seed, **kw):
    cond = conditioning.holding_box(D, device=sched.device)
    gen = torch.Generator(device=sched.device).manual_seed(seed)
    reset_counts()
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


def device_time_by_kernel(fn, n):
    """torch.profiler over ``fn()``: (device ms summed over every kernel / n,
    the 8 largest kernels' ms / n, the 12 host operators with the most self
    CPU time / n, profiler overhead included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    by_name = Counter()
    for e in prof.events():
        # user annotations (e.g. "Optimizer.step#AdamW.step") are ranges
        # over kernels that are counted themselves
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
    top = [{"kernel": name[:80], "ms_per_step": ms / n} for name, ms in by_name.most_common(8)]
    ops = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                 key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    host = [{"op": e.key[:60], "self_cpu_ms_per_step": e.self_cpu_time_total / 1e3 / n,
             "calls_per_step": e.count / n} for e in ops]
    return sum(by_name.values()) / n, top, host


def profile_window(model, sched, seed, steps=50):
    """Device kernel time by name over ``steps`` posterior steps beside the
    same window's wall time without the profiler:
    -> (device ms per step, wall ms per step, top kernels, top host ops)."""
    cond = conditioning.holding_box(D, device=sched.device)

    def window():
        gen = torch.Generator(device=sched.device).manual_seed(seed)
        sample_loop(sched, model, (B, H, D), gen, conditioning_fn=cond, t_start=steps)
        torch.cuda.synchronize()

    window()
    t0 = time.perf_counter()
    window()
    wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms, top, host = device_time_by_kernel(window, steps)
    return device_ms, wall_ms / steps, top, host


def serve_phase(dev, timer, args, tmp, counts_by_h, peaks):
    """The serving path: two CLI requests, the kernel-vs-plain forward, the
    chains and the serving profile."""
    run = os.path.join(tmp, "serve_run")
    write_run(run, args.seed)
    per_fwd = sum(counts_by_h[H].values())
    _, s64, launches = request(run, os.path.join(tmp, "h64"), H)
    if launches != per_fwd * T:
        raise RuntimeError(f"conv_gn_mish launched {launches} times in the H {H} request, "
                           f"expected {per_fwd * T}")
    _, s48, launches48 = request(run, os.path.join(tmp, "h48"), 48)
    if launches48 != sum(counts_by_h[48].values()) * T:
        raise RuntimeError(f"conv_gn_mish launched {launches48} times in the H 48 request")
    emit({"phase": "main_path", "path": "serve", "requests": [
        {"frames": H, "num": B, "seconds": s64, "conv_gn_mish_launches": launches},
        {"frames": 48, "num": B, "seconds": s48, "conv_gn_mish_launches": launches48}]})

    _, model, sched, payload, _ = cli.load_run(run, device=dev)
    model.load_state_dict(payload["params"])
    model.eval()
    gx = torch.Generator(device=dev).manual_seed(args.seed + 1)
    t = torch.randint(0, T, (B,), generator=gx, device=dev)
    fwd_errs = {}
    for h in (H, 48):
        xx = torch.randn(B, h, D, generator=gx, device=dev)
        with torch.inference_mode():
            out_k = model(xx, t)
        err = (out_k - forward_with_plain_blocks(model, xx, t)).abs().max().item()
        if not (err <= FORWARD_TOL and torch.isfinite(out_k).all()):
            raise RuntimeError(f"U-Net forward at H {h} with the kernel differs from plain "
                               f"by {err}")
        fwd_errs[f"h{h}"] = err
    x64 = torch.randn(B, H, D, generator=gx, device=dev)
    with torch.inference_mode():
        fwd_ms = timer(lambda: model(x64, t), reps=10)
    fwd_plain_ms = timer(lambda: forward_with_plain_blocks(model, x64, t), reps=10)

    s_post, l_post = timed_chain(model, sched, "posterior", args.seed)
    s_ddim, l_ddim = timed_chain(model, sched, "ddim", args.seed, ddim_steps=50)
    if l_post != per_fwd * T or l_ddim != per_fwd * 50:
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

    device_ms, wall_ms, top, host_ops = profile_window(model, sched, args.seed)
    host = host_per_call(dev)
    profile = {"device_ms_per_step": device_ms, "wall_ms_per_step": wall_ms,
               # null when the trace holds no device events: not measured
               "device_busy_share": device_ms / wall_ms if device_ms else None,
               "top_kernels": top, "top_host_ops": host_ops, "conv_block_host": host,
               "conv_block_host_share_of_step": per_fwd * host["entry_us"] / 1e3 / wall_ms}
    emit({"phase": "profile", "path": "serve", **profile})
    return {"requests": {"h64_seconds": s64, "h48_seconds": s48}, **chains,
            "profile": profile, "launches": launches}


def train_args(run_dir, seed):
    return ["--config", str(USER_CONFIG), "--data", str(CARTWHEEL),
            "--batch-size", str(TRAIN_B), "--steps", str(TRAIN_STEPS), "--out", run_dir,
            "--device", "cuda", "--set", *TRAIN_SET, f"train.seed={seed}"]


def train_phase(args, tmp, per_step):
    """The slice's main path: ``cli.train.main`` on a user config, then a
    sampling request answered from the trained run."""
    run = os.path.join(tmp, "train_run")
    micro = TRAIN_STEPS * ACCUM
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as log:
        trainer = train_cli.main(train_args(run, args.seed))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    b1, b2 = counts()
    if (b1, b2) != (per_step * micro, per_step * micro):
        raise RuntimeError(f"training launched conv_gn_mish {b1} and conv1d_weight_grad {b2} "
                           f"times, expected {per_step} x {micro} micro-steps each")
    ckpts = Path(run) / "checkpoints"
    saved = sorted(p.name for p in ckpts.glob("*.pt"))
    for name in ("best_model.pt", "best_model.json", "state_30.pt", f"state_{micro}.pt"):
        if not (ckpts / name).exists():
            raise RuntimeError(f"training wrote no {name}: {saved}")
    metrics = json.loads((Path(run) / "training_metrics.json").read_text())
    losses = [r["loss"] for r in metrics["metrics"]]
    if (len(losses) != micro // 10 or not np.isfinite(losses).all()
            or not np.isfinite(metrics["best_loss"]) or metrics["best_step"] < 25):
        raise RuntimeError(f"training metrics: {metrics}")
    cfg = ExperimentConfig.load(os.path.join(run, "config.json"))
    ema_moved = any((trainer.state.ema_params[k] != v).any().item()
                    for k, v in trainer.state.model.state_dict().items())
    result = {"seconds": seconds, "micro_steps": micro, "optimizer_steps": TRAIN_STEPS,
              "micro_batch": cfg.train.batch_size, "accum": cfg.train.gradient_accumulate_every,
              "horizon": trainer.dataset.horizon, "variants": len(trainer.dataset),
              "conv_gn_mish_launches": b1, "conv1d_weight_grad_launches": b2,
              "losses": losses, "best_loss": metrics["best_loss"],
              "best_step": metrics["best_step"], "checkpoints": saved,
              "ema_differs_from_params": ema_moved, "log_lines": len(log.getvalue().splitlines())}
    if trainer.dataset.horizon != TRAIN_H or len(trainer.dataset) != TRAIN_H:
        raise RuntimeError(f"cartwheel gave H {trainer.dataset.horizon}, {len(trainer.dataset)}")

    _, s_req, l_req = request(run, os.path.join(tmp, "trained"), TRAIN_H, num=4)
    if l_req != per_step * T:
        raise RuntimeError(f"sampling the trained run launched conv_gn_mish {l_req} times")
    result["sample_request"] = {"frames": TRAIN_H, "num": 4, "seconds": s_req,
                                "conv_gn_mish_launches": l_req}
    emit({"phase": "main_path", "path": "train", **result})
    return result


def grads_phase(dev, seed):
    """One B 64 step at H 160 (loss and every parameter's gradient) with both
    kernels against the same step with both plain versions."""
    ds = MotionDataset.from_path(str(CARTWHEEL), include_velocity=False, augment="cyclic",
                                 horizon_multiple=8)
    x0 = torch.from_numpy(next(ds.epochs(TRAIN_B * ACCUM, seed=seed)).trajectories).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = torch.randint(0, T, (x0.shape[0],), generator=gen, device=dev)
    noise = torch.randn(x0.shape, generator=gen, device=dev)
    torch.manual_seed(seed)
    model = TemporalUnet(D, dim=DIM).to(dev).train()
    loss_fn = make_loss_fn(make_schedule("cosine", T, convention="diffuser", device=dev), model,
                           weights=process.diffuser_loss_weights(ds.horizon, D, device=dev))

    def step():
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(x0, t, noise)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}

    reset_counts()
    loss_k, grads_k = step()
    launched = counts()
    with plain_kernels():
        loss_p, grads_p = step()
    if launched != (33, 33) or counts() != launched:
        raise RuntimeError(f"grads step launched {launched}, then {counts()}")
    rel = {k: ((grads_k[k] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
           for k, g in grads_p.items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_k - loss_p) / loss_p
    if not (loss_rel <= LOSS_TOL and rel[worst] <= GRAD_TOL
            and all(torch.isfinite(g).all() for g in grads_k.values())):
        raise RuntimeError(f"kernel step vs plain step: loss rel err {loss_rel}, "
                           f"{worst} grad rel err {rel[worst]}")
    result = {"batch": x0.shape[0], "H": x0.shape[1], "loss_kernels": loss_k,
              "loss_plain": loss_p, "loss_rel_err": loss_rel, "params": len(rel),
              "max_grad_rel_err": rel[worst], "worst_param": worst,
              "median_grad_rel_err": float(np.median(list(rel.values())))}
    emit({"phase": "grads", **result})
    return result


def train_profile_phase(dev, seed, steps=10):
    """Optimizer steps of the CLI's trainer without checkpoints: host-clock
    ms per step, and device kernel time by name under torch.profiler. The
    best-model window is kept shut so that no step waits for its loss."""
    cfg = ExperimentConfig.load(str(USER_CONFIG)).override({
        "data.path": str(CARTWHEEL), "train.batch_size": TRAIN_B,
        "train.gradient_accumulate_every": ACCUM, "train.seed": seed})
    trainer = train_cli.build_trainer(cfg, device=dev)
    trainer.config = dataclasses.replace(trainer.config, log_every=10 ** 9,
                                         best_window_frac=-1e6)

    def window():
        trainer.train(num_steps=steps)
        torch.cuda.synchronize()

    window()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    window()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    peak = torch.cuda.max_memory_allocated()
    device_ms, top, host = device_time_by_kernel(window, steps)
    result = {"ms_per_optimizer_step": wall_ms, "optimizer_steps_per_s": 1e3 / wall_ms,
              "device_ms_per_step": device_ms,
              "device_busy_share": device_ms / wall_ms if device_ms else None,
              "top_kernels": top, "top_host_ops": host, "peak_memory_bytes": peak}
    emit({"phase": "profile", "path": "train", **result})
    return result


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
    ptxas = build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    timer = Timer(dev)
    torch.manual_seed(args.seed)
    probe = TemporalUnet(D, dim=DIM).to(dev).eval()
    gx = torch.Generator(device=dev).manual_seed(args.seed + 1)
    shape_counts = {}
    for batch, h in ((B, H), (B, 48), (TRAIN_B, TRAIN_H)):
        x = torch.randn(batch, h, D, generator=gx, device=dev)
        t = torch.randint(0, T, (batch,), generator=gx, device=dev)
        shape_counts[h] = Counter(record_block_shapes(probe, x, t))
    del probe
    per_step = sum(shape_counts[TRAIN_H].values())  # 33: B1 forward launches = B2 launches
    serve_counts = {h: shape_counts[h] for h in (H, 48)}
    serve_rows = b1_rows(dev, timer, serve_counts, peaks, B,
                         extra=[(192, cin, DIM) for cin in (D, DIM)])
    train_rows = b1_rows(dev, timer, {TRAIN_H: shape_counts[TRAIN_H]}, peaks, TRAIN_B)
    wgrad_rows = b2_rows(dev, timer, shape_counts[TRAIN_H], peaks, TRAIN_B)

    result = {"kernel_rows": {"conv_gn_mish_serve": serve_rows,
                              "conv_gn_mish_train": train_rows,
                              "conv1d_weight_grad_train": wgrad_rows}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        result["serve"] = serve_phase(dev, timer, args, tmp, shape_counts, peaks)
        result["train"] = train_phase(args, tmp, per_step)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result["grads"] = grads_phase(dev, args.seed)
    result["train_profile"] = train_profile_phase(dev, args.seed)

    def per_launch_sum(rows, key, weight):
        return sum(r[key] * r[weight] for r in rows)

    w_fwd = f"per_forward_h{TRAIN_H}"
    kernels = [{
        "name": "conv_gn_mish", "route": "cuda", "status": "ported; matches its plain version",
        "source": "deepmimic_diffusion_mujoco_tpu_torch/csrc/conv_gn_mish.cu",
        "replaces": "deepmimic_diffusion_mujoco_tpu/ops/pallas/conv_block_kernel.py:104",
        "launches": result["train"]["conv_gn_mish_launches"],
        "launches_serve_request": result["serve"]["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in serve_rows + train_rows),
        # times: sums over one training micro-step's 33 forward launches (B 32, H 160)
        "ms": per_launch_sum(train_rows, "ms", w_fwd),
        "plain_ms": per_launch_sum(train_rows, "plain_ms", w_fwd),
        "bound_ms": per_launch_sum(train_rows, "bound_ms", w_fwd),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in train_rows)
        else "bytes",
        "library_ms": None, "composition_ms": per_launch_sum(train_rows, "composition_ms", w_fwd),
        # the serving forward (B 16, H 64), as in the first slice
        "serve_forward": {k: per_launch_sum(serve_rows, k, f"per_forward_h{H}")
                          for k in ("ms", "plain_ms", "bound_ms", "composition_ms")},
        "launches_per_forward": per_step,
    }, {
        "name": "conv1d_weight_grad", "route": "cuda",
        "status": "ported; matches its plain version",
        "source": "deepmimic_diffusion_mujoco_tpu_torch/csrc/conv1d_weight_grad.cu",
        "replaces": "deepmimic_diffusion_mujoco_tpu/ops/pallas/conv_weight_grad.py:63",
        "launches": result["train"]["conv1d_weight_grad_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in wgrad_rows),
        "max_rel_err": max(r["max_rel_err"] for r in wgrad_rows),
        # times: sums over one training micro-step's 33 launches (B 32, H 160)
        "ms": per_launch_sum(wgrad_rows, "ms", "per_micro_step"),
        "plain_ms": per_launch_sum(wgrad_rows, "plain_ms", "per_micro_step"),
        "bound_ms": per_launch_sum(wgrad_rows, "bound_ms", "per_micro_step"),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in wgrad_rows)
        else "bytes",
        "library_ms": per_launch_sum(wgrad_rows, "library_ms", "per_micro_step"),
        "launches_per_micro_step": per_step,
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
