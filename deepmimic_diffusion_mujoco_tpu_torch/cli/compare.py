"""Multi-checkpoint comparison CLI of the PyTorch port.

    python -m deepmimic_diffusion_mujoco_tpu_torch.cli.compare \
        --runs experiments/walk40k,experiments/allclips12k --num 4 \
        --out comparison/ [--gt data/motions/humanoid3d_walk.txt] [--device cuda]

Counterpart of ``deepmimic_diffusion_mujoco_tpu/cli/compare.py`` with the
same flags plus ``--device`` (default ``cuda``; it raises if no card is
present). For every run directory: load the checkpoint (the architecture
from the run's config.json), generate ``num`` motions, save them under
<out>/motions/<run_name>/ with the 35-dim qpos contract, and record the
architecture, checkpoint step and best loss. With --gt the horizon is
clamped to min(clip length, max_seq_len) and each run's samples are scored
(SiFID, inter-diversity) so that the report ranks the checkpoints; with
--class-id a class-conditional run samples with CFG at its config's scale.
Writes <out>/compare_report.json.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..device import resolve_device
from ..diffusion.sampling import sample_loop
from .sample import load_run, save_motions


def _best_loss(meta, run_dir):
    """Best training loss for the report: the checkpoint sidecar first
    (best_model carries it), then the run's training_metrics.json."""
    if meta:
        v = meta.get("best_loss", meta.get("loss"))
        if v is not None:
            return v
    tm = os.path.join(run_dir, "training_metrics.json")
    if os.path.exists(tm):
        with open(tm) as f:
            return json.load(f).get("best_loss")
    return None


def compare(run_dirs, out_dir, num=4, frames=None, ema=False, gt=None,
            seed=0, class_id=None, device: str | torch.device = "cuda"):
    dev = resolve_device(device)
    os.makedirs(os.path.join(out_dir, "motions"), exist_ok=True)
    gt_clip = None
    if gt is not None:
        from ..data.mocap import load_clip

        gt_clip = load_clip(gt)

    report = {}
    for run in run_dirs:
        name = os.path.basename(os.path.normpath(run))
        cfg, model, sched, payload, meta = load_run(run, device=dev)
        model.load_state_dict(payload["ema_params"] if ema else payload["params"])
        model.eval()
        d = cfg.diffusion
        # default horizon: the ground-truth clip's length, at most max_seq_len
        # (learned position slots beyond the trained horizon are untrained)
        H = frames or (
            min(gt_clip.qpos.shape[0], cfg.model.max_seq_len)
            if gt_clip is not None else cfg.model.max_seq_len
        )
        D = cfg.model.input_dim
        y = uncond_y = cfg_scale = None
        if class_id is not None and cfg.model.num_classes:
            y = torch.full((num,), class_id, dtype=torch.long, device=dev)
            uncond_y = torch.full((num,), cfg.model.num_classes, dtype=torch.long, device=dev)
            cfg_scale = d.cfg_scale

        samples = sample_loop(
            sched, model, (num, H, D), torch.Generator(device=dev).manual_seed(seed),
            mode=d.mode, predict_epsilon=not d.predict_x0,
            clip_denoised=d.clip_denoised, cfg_scale=cfg_scale,
            y=y, uncond_y=uncond_y,
        ).trajectories
        paths = save_motions(samples, os.path.join(out_dir, "motions", name))
        entry = {
            "run": run,
            "architecture": cfg.model.architecture,
            "checkpoint_step": int(meta.get("step", -1)) if meta else -1,
            "best_loss": _best_loss(meta, run),
            "motion_paths": paths,
            "frames": H,
        }
        if gt_clip is not None:
            from ..eval import metrics as M

            ref = gt_clip.combined() if D == 69 else gt_clip.qpos
            ref = torch.as_tensor(np.asarray(ref[: samples.shape[1], :D], np.float32),
                                  device=dev)
            entry["sifid"] = M.sifid(samples, ref)
            entry["inter_diversity"] = M.inter_diversity(samples)
        report[name] = entry

    with open(os.path.join(out_dir, "compare_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--runs", required=True,
                   help="comma-separated run directories")
    p.add_argument("--out", required=True)
    p.add_argument("--num", type=int, default=4)
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--ema", action="store_true")
    p.add_argument("--gt", default=None,
                   help="optional ground-truth clip for SiFID/diversity")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--class-id", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    # float32 throughout: no TF32 in cuDNN's convolutions or cuBLAS's matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    report = compare(
        [r for r in args.runs.split(",") if r], args.out, num=args.num,
        frames=args.frames, ema=args.ema, gt=args.gt, seed=args.seed,
        class_id=args.class_id, device=dev,
    )
    for name, e in report.items():
        extra = f"  sifid={e['sifid']:.4f}" if "sifid" in e else ""
        print(f"{name}: step={e['checkpoint_step']} "
              f"arch={e['architecture']}{extra}")
    print(os.path.join(args.out, "compare_report.json"))
    return report


if __name__ == "__main__":
    main()
