"""Host-side mocap playback through the installed MuJoCo bindings.

Counterpart of ``deepmimic_diffusion_mujoco_tpu/physics/player.py`` (the
reference's mocap_player): kinematic playback of a (T, 35) qpos motion with
the root-xy phase carry that keeps the character moving forward across
loops, on a MuJoCo model built from ``humanoid_model.to_xml``. Frames come
from MuJoCo's offscreen renderer when it opens a GL context, else from the
software capsule renderer (``softrender.render_motion``, whose forward
kinematics run on ``device``); a video goes through ``VideoSaver``.
"""
from __future__ import annotations

import numpy as np
import torch

from .humanoid_model import to_xml


# Set once MuJoCo has failed to open a GL context in this process: without
# one, a second ``mujoco.Renderer`` attempt aborts the process (MuJoCo 3.x).
_NO_GL = []


def _load_mujoco():
    try:
        import mujoco

        return mujoco
    except Exception as e:
        raise ImportError(f"mujoco bindings unavailable: {e}") from e


class MocapPlayer:
    def __init__(self):
        mujoco = _load_mujoco()
        self.mujoco = mujoco
        self.model = mujoco.MjModel.from_xml_string(to_xml())
        self.data = mujoco.MjData(self.model)

    def forward(self, qpos: np.ndarray):
        """Set qpos and run kinematics (the sim.forward() analog)."""
        self.data.qpos[:] = np.asarray(qpos, np.float64)
        self.mujoco.mj_forward(self.model, self.data)
        return self.data

    def body_positions(self, qpos: np.ndarray) -> dict[str, np.ndarray]:
        data = self.forward(qpos)
        return {
            self.model.body(i).name: data.xpos[i].copy()
            for i in range(self.model.nbody)
        }

    def play(
        self,
        motion: np.ndarray,
        loops: int = 1,
        fps: float = 30.0,
        render: bool = True,
        video_path: str | None = None,
        width: int = 640,
        height: int = 480,
        device: str | torch.device = "cuda",
    ):
        """Playback loop with the root-xy phase carry. Returns the list of
        rendered frames (empty with ``render=False`` and no video).
        ``device`` runs the software renderer's forward kinematics."""
        motion = np.asarray(motion, np.float64)
        renderer = None
        frames = []
        played = []
        if (render or video_path) and not _NO_GL:
            try:
                renderer = self.mujoco.Renderer(self.model, height=height, width=width)
            except Exception:
                _NO_GL.append(True)  # no GL context: the software renderer below
        phase_offset = np.zeros(3)
        for _ in range(loops):
            for config in motion:
                qpos = config.copy()
                qpos[0:3] += phase_offset
                self.forward(qpos)
                played.append(qpos.copy())
                if renderer is not None:
                    renderer.update_scene(self.data)
                    frames.append(renderer.render().copy())
            phase_offset = self.data.qpos[0:3].copy()
            phase_offset[2] = 0.0
        if renderer is None and (render or video_path) and played:
            from .softrender import render_motion

            frames = list(render_motion(np.stack(played), width=width, height=height,
                                        device=device))
        if video_path and frames:
            from .video import VideoSaver

            saver = VideoSaver(video_path, width=width, height=height, fps=int(fps))
            for f in frames:
                saver.write(f)
            saver.close()
        return frames


def play_mocap_np_file(path: str, loops: int = 1, **kw):
    """Play a saved .npy motion of shape (T, D); the feature dim is cut or
    zero-padded to 35 like the save path does."""
    motion = np.load(path)
    if motion.ndim != 2:
        raise ValueError(f"expected (T, D) motion, got {motion.shape}")
    if motion.shape[1] > 35:
        motion = motion[:, :35]
    elif motion.shape[1] < 35:
        motion = np.pad(motion, ((0, 0), (0, 35 - motion.shape[1])))
    return MocapPlayer().play(motion, loops=loops, **kw)
