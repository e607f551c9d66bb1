"""Evaluation CLI of the PyTorch port.

    python -m deepmimic_diffusion_mujoco_tpu_torch.cli.evaluate --run experiments/run1 \
        --gt data/motions/humanoid3d_walk.txt [--num 50 --reps 5] [--device cuda]

Counterpart of ``deepmimic_diffusion_mujoco_tpu/cli/evaluate.py`` with the
same flags plus ``--device`` (default ``cuda``; it raises if no card is
present). Reports sampling rate, intra/inter diversity, the ground truth's
intra-diversity diff and SiFID (mean +/- std over replications); ``--fid``
adds motion-FID against the clip's cyclic variants, ``--physics`` the
PD-tracking score of the samples and of the ground truth (the port's
``track_motions``: B5 on the card), ``--rmse`` the frame-0-clamped RMSE
against the clip, and ``--check`` regression assertions on the results.
"""
from __future__ import annotations

import argparse
import json
import operator
import re

import numpy as np
import torch

from ..data.mocap import load_clip
from ..device import resolve_device
from ..diffusion.conditioning import clamp_frame0
from ..diffusion.sampling import sample_loop
from ..eval import metrics as M
from .sample import load_run


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run", required=True)
    p.add_argument("--gt", required=True, help="ground-truth clip (.txt) or .npy")
    p.add_argument("--num", type=int, default=50)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--ema", action="store_true")
    p.add_argument("--json", dest="json_out", default=None)
    p.add_argument("--fid", action="store_true",
                   help="also compute motion-FID of generated samples against the "
                        "clip's cyclic variants, each conditioned on a real frame 0")
    p.add_argument("--physics", action="store_true",
                   help="also PD-track generated samples on the dynamics engine and report "
                        "tracking reward / survival, the ground truth's beside it")
    p.add_argument("--physics-horizon", type=int, default=15)
    p.add_argument("--rmse", action="store_true",
                   help="also generate samples clamped to the ground truth's frame 0 and "
                        "report per-dim RMSE against the clip (min over samples + mean)")
    p.add_argument("--check", action="append", default=[], metavar="EXPR",
                   help="regression assertion on the results dict, e.g. 'sifid.mean<=2.2'; "
                        "repeatable; any failing check prints FAIL and exits nonzero")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    # float32 throughout: no TF32 in cuDNN's convolutions or cuBLAS's matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, model, sched, payload, _ = load_run(args.run, device=dev)
    model.load_state_dict(payload["ema_params"] if args.ema else payload["params"])
    model.eval()
    d = cfg.diffusion
    D = cfg.model.input_dim

    if args.gt.endswith(".txt"):
        clip = load_clip(args.gt)
        gt = clip.combined() if D == 69 else clip.qpos
    else:
        gt = np.load(args.gt)
    H = args.frames or min(gt.shape[0], cfg.model.max_seq_len)
    gt = torch.as_tensor(np.asarray(gt[:H, :D], np.float32), device=dev)

    seed = [0]

    def chain(n, conditioning_fn=None):
        seed[0] += 1
        return sample_loop(
            sched, model, (n, H, D), torch.Generator(device=dev).manual_seed(seed[0]),
            mode=d.mode, predict_epsilon=not d.predict_x0, clip_denoised=d.clip_denoised,
            conditioning_fn=conditioning_fn,
        ).trajectories

    results = M.evaluate(chain, gt, num_samples=args.num, replications=args.reps)
    if args.fid:
        from ..data.datasets import MotionDataset

        ds = MotionDataset.from_path(args.gt, include_velocity=(D == 69),
                                     augment="cyclic_rooted")
        real = ds.trajectories[:, :H, :D]
        n = min(args.num, real.shape[0])
        # the generated side is conditioned on frame 0 of real samples drawn at random
        idx = np.random.default_rng(0).integers(0, real.shape[0], size=n)
        gen = chain(n, clamp_frame0(real[idx, 0], device=dev))
        results["motion_fid"] = {"mean": M.motion_fid(torch.as_tensor(real, device=dev), gen),
                                 "std": 0.0}
    if args.physics:
        from ..physics.plausibility import track_motions

        # physics tracks the 35-dim qpos (a 69-dim model's velocity tail is dropped)
        gen35 = chain(args.num)[..., :35]
        results["physics_tracking"] = {
            "generated": track_motions(gen35, horizon=args.physics_horizon,
                                       device=dev)["summary"],
            "ground_truth": track_motions(gt[None, :, :35], horizon=args.physics_horizon,
                                          device=dev)["summary"],
        }
    if args.rmse:
        frame0 = gt[0].cpu().numpy()
        gen = chain(args.num, clamp_frame0(np.repeat(frame0[None], args.num, axis=0),
                                           device=dev))
        err = torch.sqrt(((gen - gt[None]) ** 2).mean(dim=(1, 2)))
        results["rmse"] = {"min": float(err.min()), "mean": float(err.mean()),
                           "std": float(err.std(unbiased=False))}
    text = json.dumps(results, indent=2)
    print(text)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(text)
    if args.check and check_results(results, args.check):
        raise SystemExit(1)
    return results


def check_results(results: dict, exprs: list[str]) -> list[str]:
    """Evaluate 'dotted.path OP value' regression assertions against the
    results dict (OP in <=, >=, <, >). Prints one PASS/FAIL line per check
    and returns the failing expressions."""
    ops = {"<=": operator.le, ">=": operator.ge, "<": operator.lt, ">": operator.gt}
    failures = []
    for expr in exprs:
        m = re.match(r"^([\w.]+)\s*(<=|>=|<|>)\s*([-+0-9.eE]+)$", expr.strip())
        if not m:
            raise ValueError(f"bad --check expression: {expr!r}")
        path, op, bound = m.group(1), m.group(2), float(m.group(3))
        node = results
        for key in path.split("."):
            node = node[key]
        ok = ops[op](float(node), bound)
        print(f"{'PASS' if ok else 'FAIL'}: {path} = {float(node):.6g} {op} {bound:g}")
        if not ok:
            failures.append(expr)
    return failures


if __name__ == "__main__":
    main()
