"""Data-parallel scaling efficiency of the U-Net train step.

Counterpart of ``deepmimic_diffusion_mujoco_tpu/cli/scaling.py`` (BASELINE
target: efficiency >= 0.8 at N >= 2): optimizer steps/s of the dim-128
``TemporalUnet`` diffusion train step on the cartwheel clip (H 160) at
data-parallel widths 1, 2, 4, ..., with the GLOBAL batch growing with the
width (weak scaling: ``--batch-per-device`` rows a rank), and each width's
efficiency against the narrowest. Width w starts w rank processes on this
host (``parallel.launch.spawn_ranks``): NCCL when every rank has a card of
its own, gloo where ranks outnumber the cards and share them
(``parallel.mesh.default_backend``).

    python -m deepmimic_diffusion_mujoco_tpu_torch.cli.scaling --widths 1,2,4,8 \\
        --gate 0.8 --json scaling.json

The JSON record carries ``n_hosts``, ``n_devices``, ``measurement_valid``,
per width ``steps_per_s``, ``samples_per_s``, ``efficiency`` (and the
backend), and ``gate``, ``gate_evaluated``, ``gate_pass``. Where ranks
outnumber the cards, or on the CPU, the ranks share one device and the
record says ``measurement_valid: false`` with a WARNING: the gate is then
recorded but not evaluated. ``--gate`` exits 1 below the gate on a valid
measurement. JAX's multi-host flags (one command per host) are not ported:
every width runs on this host.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
CARTWHEEL = os.path.join(REPO, "data", "motions", "humanoid3d_cartwheel.txt")


def rank_steps_per_s(rank, world, batch_per_device, dim, steps, reps, device) -> float:
    """One rank of one width: the best of ``reps`` timings of ``steps``
    train steps over pre-staged batches, in steps/s (a device sync ends
    each step: ``utils.profiling.StepTimer``), and the group's backend."""
    import torch.distributed as dist

    from ..data.datasets import MotionDataset
    from ..diffusion import process, schedules
    from ..models.temporal_unet import TemporalUnet
    from ..parallel import mesh as meshlib
    from ..utils import rng
    from ..train.loop import make_loss_fn, train_step
    from ..train.state import TrainState, make_optimizer
    from ..utils.profiling import StepTimer

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    group = dist.group.WORLD
    ds = MotionDataset.from_path(CARTWHEEL, include_velocity=False, augment="cyclic",
                                 horizon_multiple=8)
    sched = schedules.make_schedule("cosine", 1000, convention="diffuser", device=dev)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = TemporalUnet(35, dim=dim).to(dev)
    loss_fn = make_loss_fn(sched, model, "diffuser",
                           weights=process.diffuser_loss_weights(ds.horizon, 35, device=dev))
    opt, lr_sched = make_optimizer(model.parameters(), "adam", lr=2e-5)
    state = TrainState(model, opt, lr_sched)
    batches = ds.epochs(batch_per_device * world, seed=0)
    staged = [torch.from_numpy(meshlib.shard_batch(group, next(batches)).trajectories).to(dev)
              for _ in range(steps)]
    g = rng.ShardGenerator(dev, rank, world).manual_seed(0)

    def run():
        timer = StepTimer(dev)
        timer.tick()
        for x0 in staged:
            t = rng.draw_rows(g, (x0.shape[0],), lambda s: torch.randint(
                0, sched.num_timesteps, s, generator=g, device=dev))
            noise = rng.draw_rows(g, x0.shape, lambda s: torch.randn(
                s, generator=g, device=dev))
            train_step(state, loss_fn, x0, t, noise, group=group)
            timer.tick()
        return timer.steps_per_s

    run()  # warm-up: allocator, cuDNN plans, the kernels' first launches
    return max(run() for _ in range(reps)), dist.get_backend()


def measure(widths, batch_per_device=32, dim=128, steps=10, reps=3, device="cuda"):
    """{width: (steps/s, backend)}: rank 0's rate, each width its own ranks."""
    from ..device import resolve_device
    from ..parallel.launch import spawn_ranks

    dev = resolve_device(device)
    results = {}
    with tempfile.TemporaryDirectory(prefix="scaling_") as store:
        for w in widths:
            results[w] = spawn_ranks(rank_steps_per_s, w, store, device=dev.type,
                                     args=(batch_per_device, dim, steps, reps, dev.type),
                                     threads=1 if dev.type == "cpu" else None)[0]
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--widths", default=None,
                    help="comma-separated rank counts (default: 1,2,4,.. up to the cards)")
    ap.add_argument("--batch-per-device", type=int, default=32)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--json", dest="json_out", default=None)
    ap.add_argument("--gate", type=float, default=None,
                    help="minimum efficiency at the widest width (BASELINE target: 0.8); "
                         "exit 1 below it on a valid measurement")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    dev = resolve_device(args.device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    widths = ([int(w) for w in args.widths.split(",")] if args.widths
              else [w for w in (1, 2, 4, 8, 16, 32, 64) if w <= n])
    res = measure(widths, args.batch_per_device, args.dim, args.steps, device=dev)
    report = {"n_hosts": 1, "n_devices": n, "device": (torch.cuda.get_device_name(dev)
                                                       if dev.type == "cuda" else "cpu"),
              "measurement_valid": dev.type == "cuda" and max(widths) <= n}
    if not report["measurement_valid"]:
        report["WARNING"] = (
            "METHODOLOGY SMOKE TEST ONLY: ranks share one device (the CPU, or fewer cards "
            "than ranks), so per-rank throughput drops with the width by construction and "
            "'efficiency' is not a scaling result. Run one rank a card for the measurement.")
    print(f"{'ranks':>8} {'steps/s':>10} {'samples/s':>12} {'efficiency':>11}")
    eff = 1.0
    for w in widths:
        rate, backend = res[w]
        # weak scaling: ideal keeps steps/s constant as ranks grow
        eff = rate / res[widths[0]][0]
        samples = rate * args.batch_per_device * w
        print(f"{w:>8} {rate:>10.2f} {samples:>12.0f} {eff:>11.2f}")
        report[str(w)] = {"steps_per_s": rate, "samples_per_s": samples,
                          "efficiency": eff, "backend": backend}
    report["gate"] = args.gate
    report["gate_evaluated"] = args.gate is not None and report["measurement_valid"]
    report["gate_pass"] = bool(eff >= args.gate) if report["gate_evaluated"] else None
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=2)
    if report["gate_evaluated"] and not report["gate_pass"]:
        print(f"FAIL: efficiency {eff:.3f} < gate {args.gate}", file=sys.stderr)
        sys.exit(1)
    if report["gate_evaluated"]:
        print(f"PASS: efficiency {eff:.3f} >= gate {args.gate}")
    return report


if __name__ == "__main__":
    main()
