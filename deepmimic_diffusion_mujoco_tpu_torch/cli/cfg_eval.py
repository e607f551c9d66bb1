"""Per-class, per-CFG-scale scores of a class-conditional run (PyTorch port).

    python -m deepmimic_diffusion_mujoco_tpu_torch.cli.cfg_eval \
        --run experiments/allclips12k_r5 --scales 0,1.5,3,5 --num 8 \
        --out cfg_eval.json [--device cuda]

Counterpart of ``deepmimic_diffusion_mujoco_tpu/cli/cfg_eval.py`` with the
same flags plus ``--device`` (default ``cuda``; it raises if no card is
present), and the same JSON. For every (class, scale) pair it samples
``num`` motions conditioned on the class (CFG lerp against the null label,
one 2B-batch forward per step; scale 0 is the unconditional branch), and a
second batch with frame 0 clamped to the class's clip, then scores

- sifid_own:  SiFID against the class's own ground-truth clip;
- sifid_best: the class whose clip gives the lowest SiFID;
- rmse_min:   the best frame-0-clamped per-dim RMSE against the own clip;
- intra_div:  intra-diversity of the batch.

Each scale's summary has ``class_accuracy``, the fraction of classes whose
sifid_best is the class itself. Ground-truth clips shorter than
max(frames, 120) are tiled (they all loop) so that every class has a
reference with the same windows, and the ground truth is windowed at
stride 1.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..data.mocap import load_clip
from ..data.skeleton import MOTION_CLASSES, NUM_MOTION_CLASSES
from ..device import resolve_device
from ..diffusion.conditioning import clamp_frame0
from ..diffusion.sampling import sample_loop
from ..eval import metrics as M
from .sample import load_run, save_motions


def _tile_looping(x: np.ndarray, min_frames: int) -> np.ndarray:
    """Cyclically extend a looping clip to at least ``min_frames``, carrying
    the root's net x-y displacement per cycle (z zeroed) so that tiling
    adds no root jump."""
    T = x.shape[0]
    if T >= min_frames:
        return x
    reps = -(-min_frames // T)
    delta = np.zeros((x.shape[1],), x.dtype)
    delta[:2] = x[-1, :2] - x[0, :2]
    return np.concatenate([x + k * delta for k in range(reps)])[:min_frames]


def _class_clips(data_dir: str, D: int, min_frames: int = 0):
    """class id -> (name, (T, D) ground-truth array); ``min_frames`` > 0
    tiles shorter clips up to it. A short clip's few windows give a
    ground-truth covariance of low rank, which mis-ranks even perfect
    samples."""
    out = {}
    for name, cid in MOTION_CLASSES.items():
        path = os.path.join(data_dir, f"{name}.txt")
        if not os.path.exists(path):
            continue
        clip = load_clip(path)
        arr = np.asarray(clip.combined() if D == 69 else clip.qpos)
        if min_frames:
            arr = _tile_looping(arr, min_frames)
        out[cid] = (name.replace("humanoid3d_", ""), arr)
    return out


def evaluate_cfg(run_dir, scales, num=8, frames=None, ema=True, data_dir="data/motions",
                 seed=0, save_motions_to=None, device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    cfg, model, sched, payload, _ = load_run(run_dir, device=dev)
    model.load_state_dict(payload["ema_params"] if ema else payload["params"])
    model.eval()
    d = cfg.diffusion
    D = cfg.model.input_dim
    n_classes = cfg.model.num_classes or NUM_MOTION_CLASSES

    report = {"run": run_dir, "num": num, "ema": ema, "scales": {}}
    rngs = np.random.default_rng(seed)
    H = frames or min(64, cfg.model.max_seq_len)
    report["frames"] = H
    gt_min = max(H, 120)
    report["gt_tiled_to"] = gt_min
    clips = _class_clips(data_dir, D, min_frames=gt_min)
    uy = torch.full((num,), n_classes, dtype=torch.long, device=dev)

    def chain(key, y, scale, conditioning_fn=None):
        return sample_loop(
            sched, model, (num, H, D), torch.Generator(device=dev).manual_seed(key),
            mode=d.mode, predict_epsilon=not d.predict_x0, clip_denoised=d.clip_denoised,
            y=y, cfg_scale=scale, uncond_y=uy, conditioning_fn=conditioning_fn,
        ).trajectories

    for s in scales:
        per_class = {}
        for cid, (cname, gt_full) in sorted(clips.items()):
            print(f"[cfg_eval] scale {s} class {cname} ({time.strftime('%H:%M:%S')})",
                  file=sys.stderr, flush=True)
            L = min(H, gt_full.shape[0])
            gt = torch.as_tensor(np.asarray(gt_full[:L, :D], np.float32), device=dev)
            key = int(rngs.integers(1 << 30))
            y = torch.full((num,), cid, dtype=torch.long, device=dev)
            # scale 0 is the unconditional branch: lerp(uncond, cond, 0)
            gen = chain(key, y, float(s))
            # the frame-0-clamped batch for the trajectory RMSE
            frame0 = np.repeat(gt_full[None, 0, :D], num, axis=0)
            gen0 = chain(key + (1 << 30), y, float(s), clamp_frame0(frame0, device=dev))
            sifid_by_class = {}
            for _, (cname2, gt2_full) in sorted(clips.items()):
                # windows need >= window_size frames of both
                if gt2_full.shape[0] < 10 or H < 10:
                    continue
                gt2 = torch.as_tensor(np.asarray(gt2_full[:, :D], np.float32), device=dev)
                sifid_by_class[cname2] = M.sifid(gen, gt2, gt_step_size=1)
            if not sifid_by_class:
                continue  # no clip (or the horizon) is as long as a SiFID window
            finite = {k: v for k, v in sifid_by_class.items() if np.isfinite(v)}
            best = min(finite or sifid_by_class, key=sifid_by_class.get)
            err = torch.sqrt(((gen0[:, :L] - gt[None]) ** 2).mean(dim=(1, 2)))
            per_class[cname] = {
                "sifid_own": sifid_by_class.get(cname),
                "sifid_best": best,
                "sifid_best_value": sifid_by_class[best],
                "rmse_min": float(err.min()),
                "rmse_mean": float(err.mean()),
                "intra_div": M.intra_diversity(gen, torch.Generator(device=dev).manual_seed(0)),
            }
            if save_motions_to:
                save_motions(gen, os.path.join(save_motions_to, f"cfg_{s}", cname))
        n_right = sum(1 for c, r in per_class.items() if r["sifid_best"] == c)
        own = [r["sifid_own"] for r in per_class.values() if r["sifid_own"] is not None]
        report["scales"][str(s)] = {
            "per_class": per_class,
            "class_accuracy": n_right / max(len(per_class), 1),
            "mean_sifid_own": float(np.nanmean(own)) if own else None,
            "mean_rmse_min": float(np.nanmean([r["rmse_min"] for r in per_class.values()])),
        }
    return report


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run", required=True)
    p.add_argument("--scales", default="0,1.5,3,5")
    p.add_argument("--num", type=int, default=8)
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--no-ema", action="store_true")
    p.add_argument("--data-dir", default="data/motions")
    p.add_argument("--out", default=None)
    p.add_argument("--save-motions", default=None,
                   help="also dump the sampled motions under this dir")
    p.add_argument("--check-accuracy", default=None,
                   help="gate 'SCALE:MIN' (e.g. '3.0:0.8'): exit 1 unless class_accuracy at "
                        "that scale >= MIN")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    # float32 throughout: no TF32 in cuDNN's convolutions or cuBLAS's matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    scales = [float(s) for s in args.scales.split(",")]
    report = evaluate_cfg(args.run, scales, num=args.num, frames=args.frames,
                          ema=not args.no_ema, data_dir=args.data_dir,
                          save_motions_to=args.save_motions, device=dev)
    print(f"{'scale':>6} {'class_acc':>10} {'mean_sifid':>11} {'mean_rmse':>10}")
    for s, r in report["scales"].items():
        own = r["mean_sifid_own"]
        own_s = "-" if own is None else f"{own:.3f}"
        print(f"{s:>6} {r['class_accuracy']:>10.2f} {own_s:>11} {r['mean_rmse_min']:>10.3f}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    if args.check_accuracy:
        scale_s, _, min_s = args.check_accuracy.partition(":")
        key = str(float(scale_s))
        if key not in report["scales"]:
            print(f"FAIL: scale {key} not evaluated", file=sys.stderr)
            sys.exit(1)
        acc = report["scales"][key]["class_accuracy"]
        if acc < float(min_s):
            print(f"FAIL: class_accuracy {acc:.2f} @ scale {key} < {min_s}", file=sys.stderr)
            sys.exit(1)
        print(f"PASS: class_accuracy {acc:.2f} @ scale {key} >= {min_s}")
    return report


if __name__ == "__main__":
    main()
