"""The reference's seven constrained-sampling workflows as one CLI
(PyTorch port).

Each subcommand reproduces an archive notebook's behavior through the
conditioners of ``diffusion/conditioning.py``:

    editing            hold-a-box pose
    start-with-motion  motion-to-motion: a real clip shallowly re-noised
    short-projection   0.75x the clip's horizon
    long-projection    3x the horizon, clamped around each clip seam
    inbetween          the first and last quarter clamped to the clip
    blend              walk -> backflip, free only around the seam
    steer              the root's x-y clamped to a straight path

    python -m deepmimic_diffusion_mujoco_tpu_torch.cli.workflows editing \
        --run experiments/run1 --clip data/motions/humanoid3d_walk.txt \
        --out out/ [--untrained] [--device cuda]

Counterpart of ``deepmimic_diffusion_mujoco_tpu/cli/workflows.py`` with the
same flags plus ``--device`` (default ``cuda``; it raises if no card is
present). ``--untrained`` builds a freshly initialized temporal U-Net
(``--dim``, ``--steps`` posterior steps; init from a fixed seed), which
exercises the conditioning mechanics without a checkpoint; otherwise
``--run`` is a port run directory (``--ema`` samples the EMA weights).
Every horizon is a multiple of 8, as the U-Net needs.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import factory
from ..data.mocap import load_clip
from ..device import resolve_device
from ..diffusion import conditioning as C
from ..diffusion.sampling import make_sampler
from ..train.config import ExperimentConfig
from .sample import load_run, save_motions

WORKFLOWS = ("editing", "start-with-motion", "short-projection", "long-projection",
             "inbetween", "blend", "steer")


def _setup(args, dev):
    """-> (config, sampler(shape, generator, **overrides) -> trajectories)."""
    if args.untrained:
        cfg = ExperimentConfig()
        cfg.model.architecture = "temporal"
        cfg.model.input_dim = 35
        cfg.model.channel_dim = args.dim
        cfg.diffusion.noise_steps = args.steps
        cfg.diffusion.predict_x0 = False
        cfg.diffusion.mode = "posterior"
        cfg.diffusion.loss = "diffuser"
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model, sched = factory.build_experiment(cfg, dev)
    else:
        cfg, model, sched, payload, _ = load_run(args.run, device=dev)
        model.load_state_dict(payload["ema_params"] if args.ema else payload["params"])
    model.eval()
    d = cfg.diffusion
    sampler = make_sampler(sched, model, mode=d.mode, predict_epsilon=not d.predict_x0,
                           clip_denoised=d.clip_denoised)

    def sample(shape, generator, **kw):
        return sampler(shape, generator, **kw).trajectories

    return cfg, sample


def _clip_qpos(path, multiple=8):
    q = load_clip(path).qpos.astype(np.float32)
    return q[: len(q) - len(q) % multiple]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("workflow", choices=WORKFLOWS)
    p.add_argument("--run", default=None)
    p.add_argument("--untrained", action="store_true")
    p.add_argument("--ema", action="store_true")
    p.add_argument("--clip", default="data/motions/humanoid3d_walk.txt")
    p.add_argument("--clip2", default="data/motions/humanoid3d_backflip.txt")
    p.add_argument("--num", type=int, default=2)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="out")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    # float32 throughout: no TF32 in cuDNN's convolutions or cuBLAS's matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, sample = _setup(args, dev)
    D = 35 if args.untrained else cfg.model.input_dim
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    motion = _clip_qpos(args.clip)
    H = motion.shape[0]
    wf = args.workflow

    def padded(m):
        return np.pad(m, ((0, 0), (0, D - 35)))

    if wf == "editing":
        out = sample((args.num, H, D), gen, conditioning_fn=C.holding_box(D, dev))
    elif wf == "start-with-motion":
        # shallow noising of a real motion, 2 denoise steps
        out = sample((args.num, H, D), gen, starting_motion=padded(motion)[None], t_start=2)
    elif wf == "short-projection":
        h = int(H * 0.75) // 8 * 8
        out = sample((args.num, h, D), gen)
    elif wf == "long-projection":
        h = H * 3
        tiled = padded(np.tile(motion, (3, 1)))
        # keyframes: +/-2 frames around each clip seam, dims 3: (root x-y free)
        keyframes = []
        for kf in (0, H, 2 * H):
            keyframes.extend(range(max(kf - 2, 0), min(kf + 3, h)))
        cond = C.clamp_frames(tiled, keyframes, dims=slice(3, 35), horizon=h, device=dev)
        out = sample((args.num, h, D), gen, conditioning_fn=cond)
    elif wf == "inbetween":
        ref = padded(motion)
        cond = C.inbetween(ref, ref, horizon=H, edge=H // 4, device=dev)
        out = sample((args.num, H, D), gen, conditioning_fn=cond)
    elif wf == "blend":
        a = padded(motion)
        b = padded(_clip_qpos(args.clip2))
        # trim the first clip's tail so that the combined horizon is a multiple of 8
        a = a[: a.shape[0] - (a.shape[0] + b.shape[0]) % 8]
        start_motion, cond = C.blend(a, b, seam_halfwidth=5, free_dims_second=slice(3, 35),
                                     device=dev)
        out = sample((args.num, start_motion.shape[0], D), gen,
                     starting_motion=start_motion[None], t_start=2, conditioning_fn=cond)
    else:  # steer
        path = np.stack([np.linspace(0, 2.0, 16), np.zeros(16)], axis=1)
        cond = C.steer_root(path, horizon=H, feature_dim=D, device=dev)
        out = sample((args.num, H, D), gen, conditioning_fn=cond)

    paths = save_motions(out, args.out, prefix=f"{wf}_")
    print("\n".join(paths))
    return paths


if __name__ == "__main__":
    main()
