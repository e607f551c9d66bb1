"""End-to-end demo of the PyTorch port: train on the walk clip, sample the
diffusion model, play the first sampled motion through the MuJoCo player
and write a video artifact, all through the port's own CLIs.

    python -m deepmimic_diffusion_mujoco_tpu_torch.examples.end_to_end_walk \
        --steps 300 --out runs/walk_demo [--device cuda]

The port's counterpart of the JAX package's ``examples/end_to_end_walk.py``,
with the same flags plus ``--device`` (default ``cuda``; it raises if no
card is present), passed on to ``cli.train``, ``cli.sample`` and
``cli.play``. Without a GL context the player draws the frames with the
software capsule renderer, so a video (.avi through cv2, else an .npy frame
stack) is always written.
"""
from __future__ import annotations

import argparse
import glob
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CLIP = os.path.join(REPO, "data", "motions", "humanoid3d_walk.txt")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--out", default="runs/walk_demo")
    p.add_argument("--num-samples", type=int, default=2)
    p.add_argument("--skip-train", action="store_true",
                   help="reuse an existing checkpoint in --out")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)

    from ..cli import play, sample, train

    if not args.skip_train:
        # 1) train: the default config cut to a demo budget
        train.main([
            "--data", CLIP,
            "--steps", str(args.steps),
            "--out", args.out,
            "--device", args.device,
            "--set", "train.log_every=50",
            f"train.save_every={max(args.steps // 2, 1)}",
            "train.scan_chunk=10",
        ])

    # 2) sample the trained model -> (T, 35) .npy motions
    sample_dir = os.path.join(args.out, "samples")
    sample.main([
        "--run", args.out,
        "--num", str(args.num_samples),
        "--out", sample_dir,
        "--device", args.device,
    ])
    motions = sorted(glob.glob(os.path.join(sample_dir, "*.npy")))
    if not motions:
        raise SystemExit(f"no sampled motions found in {sample_dir}")

    # 3) play the first sample and write the video
    video = os.path.join(args.out, "walk_demo.avi")
    play.main([motions[0], "--loops", "2", "--video", video, "--device", args.device])
    artifacts = [f for f in (video, video + ".npy") if os.path.exists(f)]
    print(f"demo complete: motion={motions[0]} video={artifacts}")
    return motions[0], artifacts


if __name__ == "__main__":
    main()
