"""Hyperparameter sweep CLI of the PyTorch port.

    python -m deepmimic_diffusion_mujoco_tpu_torch.cli.sweep --config base.json \
        --grid grid.json --out experiments/sweep1 [--device cuda]

Counterpart of ``deepmimic_diffusion_mujoco_tpu/cli/sweep.py`` with the
same flags plus ``--device`` (default ``cuda``; it raises if no card is
present). grid.json maps dotted config keys to value lists:

    {"model.latent_dim": [128, 256], "train.lr": [1e-3, 1e-4]}

Each combination trains through ``cli/train.py``'s ``build_trainer`` in its
own subdirectory with config.json, checkpoints and training_metrics.json;
``interim_summary.json`` (after each run), ``final_summary.json`` and
``best_configs.txt`` rank the runs by best loss.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from ..device import resolve_device
from ..train.config import ExperimentConfig, expand_grid
from .train import build_trainer


def run_sweep(base: ExperimentConfig, grid: dict, out_dir: str,
              device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    configs = expand_grid(base, grid)
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for i, cfg in enumerate(configs):
        exp_dir = os.path.join(out_dir, cfg.name)
        os.makedirs(exp_dir, exist_ok=True)
        cfg.save(os.path.join(exp_dir, "config.json"))
        print(f"[{i + 1}/{len(configs)}] {cfg.name}")
        trainer = build_trainer(cfg, exp_dir, device=dev)
        trainer.train()
        trainer.save_metrics(os.path.join(exp_dir, "training_metrics.json"))
        results.append({
            "name": cfg.name,
            "dir": exp_dir,
            "best_loss": trainer.best_loss,
            "best_step": trainer.best_step,
            "final_loss": trainer.metrics[-1]["loss"] if trainer.metrics else None,
        })
        interim = sorted(results, key=lambda r: r["best_loss"])
        with open(os.path.join(out_dir, "interim_summary.json"), "w") as f:
            json.dump(interim, f, indent=2)
    final = sorted(results, key=lambda r: r["best_loss"])
    summary = {"best": final[0] if final else None, "all": final}
    with open(os.path.join(out_dir, "final_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    with open(os.path.join(out_dir, "best_configs.txt"), "w") as f:
        for r in final[:5]:
            f.write(f"{r['name']}: best_loss={r['best_loss']:.6f} "
                    f"@ step {r['best_step']}\n")
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default=None, help="base ExperimentConfig JSON")
    p.add_argument("--grid", required=True, help="dotted-key grid JSON")
    p.add_argument("--out", default="experiments/sweep")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    # float32 throughout: no TF32 in cuDNN's convolutions or cuBLAS's matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    base = ExperimentConfig.load(args.config) if args.config else ExperimentConfig()
    with open(args.grid) as f:
        grid = json.load(f)
    summary = run_sweep(base, grid, args.out, device=dev)
    if summary["best"]:
        print(f"best: {summary['best']['name']} loss {summary['best']['best_loss']:.6f}")
    return summary


if __name__ == "__main__":
    main()
