"""Playback CLI of the PyTorch port (the reference's mocap_player).

    python -m deepmimic_diffusion_mujoco_tpu_torch.cli.play motion1.npy [--loops 3]
        [--video out.avi] [--no-render] [--physics] [--physics-horizon 15]
        [--device cuda]

Counterpart of ``deepmimic_diffusion_mujoco_tpu/cli/play.py`` with the same
flags plus ``--device`` (default ``cuda``; it raises if no card is
present). Plays a saved (T, 35) qpos motion, or a DeepMimic clip ``.txt``
(its parsed qpos track), through MuJoCo kinematics with the root-xy phase
carry; without a GL context the frames come from the software renderer,
whose forward kinematics run on the device. ``--physics`` PD-tracks the
motion on the port's dynamics engine (``physics/plausibility.py``
``track_motions``: one whole-control-step kernel launch a control step on
the card) and prints the DeepMimic tracking reward and survival.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("motion", help=".npy motion or DeepMimic .txt clip")
    p.add_argument("--loops", type=int, default=1)
    p.add_argument("--video", default=None)
    p.add_argument("--no-render", action="store_true")
    p.add_argument("--physics", action="store_true",
                   help="PD-track the motion on the dynamics engine and "
                        "report tracking reward / survival")
    p.add_argument("--physics-horizon", type=int, default=15,
                   help="control steps scored by --physics (open-loop PD "
                        "has no balance feedback; use a fixed horizon)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    from ..physics.player import MocapPlayer, play_mocap_np_file

    if args.motion.endswith(".txt"):
        from ..data.mocap import load_clip

        qpos = load_clip(args.motion).qpos
        frames = MocapPlayer().play(
            qpos, loops=args.loops, render=not args.no_render,
            video_path=args.video, device=dev,
        )
    else:
        qpos = np.load(args.motion)
        frames = play_mocap_np_file(
            args.motion, loops=args.loops, render=not args.no_render,
            video_path=args.video, device=dev,
        )
    print(f"played; {len(frames)} frames rendered")

    res = None
    if args.physics:
        from ..physics.plausibility import track_motions

        res = track_motions(qpos, horizon=args.physics_horizon, device=dev)
        s = res["summary"]
        curve = " ".join(f"{r:.2f}" for r in res["reward_curve"][:10])
        print(f"physics tracking: reward {s['physics_reward_mean']:.3f} "
              f"(auc {s['physics_reward_auc']:.3f}), survived "
              f"{s['physics_survived_frac']:.0%} of "
              f"{args.physics_horizon} steps; per-step reward: {curve} ...")
    return frames, res


if __name__ == "__main__":
    main()
