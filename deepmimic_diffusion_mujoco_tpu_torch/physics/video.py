"""Video writer (the reference's VideoSaver).

Counterpart of ``deepmimic_diffusion_mujoco_tpu/physics/video.py``: MJPG
``.avi`` through OpenCV when cv2 imports and its writer opens, else the
frames go to ``<path>.npy`` as one (T, H, W, 3) uint8 stack, so a machine
without a codec still gets an artifact.
"""
from __future__ import annotations

import numpy as np


class VideoSaver:
    def __init__(self, path: str, width: int = 640, height: int = 480, fps: int = 30):
        self.path = path
        self.width = width
        self.height = height
        self.fps = fps
        self._frames = []
        self._writer = None
        try:
            import cv2

            writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps,
                                     (width, height))
            # the writer constructs even when the codec or container is
            # unusable and then writes nothing: keep it only if it opened
            self._writer = writer if writer.isOpened() else None
            self._cv2 = cv2
        except Exception:
            self._writer = None

    def write(self, frame: np.ndarray):
        """frame: (H, W, 3) RGB uint8."""
        if self._writer is not None:
            self._writer.write(self._cv2.cvtColor(frame, self._cv2.COLOR_RGB2BGR))
        else:
            self._frames.append(np.asarray(frame))

    def close(self):
        if self._writer is not None:
            self._writer.release()
        elif self._frames:
            np.save(self.path + ".npy", np.stack(self._frames))
