"""Inference CLI of the PyTorch port.

    python -m deepmimic_diffusion_mujoco_tpu_torch.cli.sample \
        --run experiments/run1 --num 4 --out samples/ [--frames 120] \
        [--cfg-scale 3.0] [--class-id 7] [--conditioner holding_box] [--ema] \
        [--device cuda]

Counterpart of ``deepmimic_diffusion_mujoco_tpu/cli/sample.py`` with the
same flags plus ``--device`` (default ``cuda``; it raises if no card is
present). The run directory holds the JAX package's ``config.json`` and the
port's checkpoints (``checkpoints/best_model.pt`` or ``state_<step>.pt``,
see ``train/checkpoint.py``). Motions are saved with exactly 35 qpos dims,
one ``.npy`` per sample. The run's ``model.architecture`` may be
``temporal``, ``transformer``, ``local_attention`` or ``decoder``; for the
three transformers ``--frames`` may not exceed ``model.max_seq_len``, the
rows of their learned position and query tables. With ``--class-id`` on a class-conditional
run, every step runs the conditional and the null-label branch as one
2B-batch forward and lerps them by ``--cfg-scale`` (default: the config's
``diffusion.cfg_scale``).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .. import factory
from ..device import resolve_device
from ..diffusion import conditioning as C
from ..diffusion.sampling import sample_loop
from ..train.checkpoint import Checkpointer
from ..train.config import ExperimentConfig

CONDITIONERS = {
    "none": lambda dim, device: None,
    "holding_box": lambda dim, device: C.holding_box(dim, device),
}


def load_run(run_dir: str, best: bool = True, device: str | torch.device = "cuda"):
    """Rebuild config, model, schedule and checkpoint from a run directory:
    the best model, else the latest periodic save.
    -> (cfg, model, sched, payload, meta)."""
    dev = resolve_device(device)
    cfg = ExperimentConfig.load(os.path.join(run_dir, "config.json"))
    model, sched = factory.build_experiment(cfg, dev)
    ckpt = Checkpointer(os.path.join(run_dir, "checkpoints"))
    try:
        payload, meta = ckpt.restore(best=best, map_location=dev)
    except FileNotFoundError:
        payload, meta = ckpt.restore(best=False, map_location=dev)
    return cfg, model, sched, payload, meta


def save_motions(samples, out_dir: str, prefix: str = "motion"):
    """Slice/pad to exactly 35 qpos dims and save one .npy per sample."""
    os.makedirs(out_dir, exist_ok=True)
    if isinstance(samples, torch.Tensor):
        samples = samples.cpu().numpy()
    paths = []
    for i, s in enumerate(np.asarray(samples)):
        m = s[:, :35]
        if m.shape[1] < 35:
            m = np.pad(m, ((0, 0), (0, 35 - m.shape[1])))
        path = os.path.join(out_dir, f"{prefix}{i + 1}.npy")
        np.save(path, m)
        paths.append(path)
    return paths


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run", required=True)
    p.add_argument("--num", type=int, default=4)
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--cfg-scale", type=float, default=None)
    p.add_argument("--class-id", type=int, default=None)
    p.add_argument("--conditioner", default="none", choices=sorted(CONDITIONERS))
    p.add_argument("--ema", action="store_true", help="sample the EMA weights")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument(
        "--cfg-sweep", default=None,
        help="comma-separated CFG scales; per-scale subdir + metadata JSON",
    )
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
    H = args.frames or cfg.model.max_seq_len
    D = cfg.model.input_dim
    n_classes = cfg.model.num_classes

    y = uncond_y = None
    cfg_scale = None
    if args.class_id is not None and n_classes:
        y = torch.full((args.num,), args.class_id, dtype=torch.long, device=dev)
        uncond_y = torch.full((args.num,), n_classes, dtype=torch.long, device=dev)
        cfg_scale = args.cfg_scale if args.cfg_scale is not None else d.cfg_scale

    cond = CONDITIONERS[args.conditioner](D, dev)
    out_dir = args.out or os.path.join(args.run, "sampled_motions")

    def sample(scale):
        return sample_loop(
            sched, model, (args.num, H, D),
            torch.Generator(device=dev).manual_seed(args.seed),
            mode=d.mode, predict_epsilon=not d.predict_x0,
            conditioning_fn=cond, cfg_scale=scale, y=y, uncond_y=uncond_y,
            clip_denoised=d.clip_denoised,
        ).trajectories

    if args.cfg_sweep is not None:
        scales = [float(s) for s in args.cfg_sweep.split(",")]
        if y is None:
            y = torch.zeros((args.num,), dtype=torch.long, device=dev)
            uncond_y = torch.full((args.num,), max(n_classes, 1), dtype=torch.long, device=dev)
        meta = {"scales": scales, "num": args.num, "frames": H,
                "class_id": args.class_id, "run": args.run}
        all_paths = []
        for s in scales:
            out = sample(s if s > 0 else None)
            all_paths += save_motions(out, os.path.join(out_dir, f"cfg_{s:g}"))
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "cfg_sweep.json"), "w") as f:
            json.dump({**meta, "files": all_paths}, f, indent=2)
        print("\n".join(all_paths))
        return all_paths

    paths = save_motions(sample(cfg_scale), out_dir)
    print("\n".join(paths))
    return paths


if __name__ == "__main__":
    main()
