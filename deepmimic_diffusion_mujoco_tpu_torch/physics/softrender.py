"""Software renderer for the humanoid: capsule-skeleton frames without a GL
context.

Counterpart of ``deepmimic_diffusion_mujoco_tpu/physics/softrender.py``.
``MocapPlayer.play`` falls back here when MuJoCo cannot open a renderer:
every capsule geom of the model (humanoid_model.py) is projected through a
root-following pinhole camera and drawn as a thick 2D segment. The
rasterizer is numpy on the host (cv2 lines when cv2 imports); unlike the
JAX package's, it skips capsules at or behind the camera and caps a
segment's thickness at width + height, so that cv2 draws poses far from
any clip in milliseconds instead of minutes (identical frames otherwise);
``render_motion`` runs the forward kinematics on ``device`` and reads the
whole trajectory's body poses back once.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .humanoid_model import BODIES, BODY_INDEX


def _quat_rot_np(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate v by unit quaternion q (w,x,y,z); broadcasting on leading dims."""
    w, xyz = q[..., :1], q[..., 1:]
    t = 2.0 * np.cross(xyz, v)
    return v + w * t + np.cross(xyz, t)


def _geom_segments():
    """Static table: (body_index, p0_local, p1_local, radius) per geom.

    Capsules use their fromto endpoints; spheres and boxes collapse to a
    point segment at the geom position (drawn as a disc of their size).
    """
    segs = []
    for b in BODIES:
        bi = BODY_INDEX[b.name]
        for g in b.geoms:
            r = float(g.size[0])
            if g.fromto is not None:
                p0 = np.asarray(g.fromto[:3], np.float64)
                p1 = np.asarray(g.fromto[3:], np.float64)
            else:
                p = np.asarray(g.pos if g.pos is not None else g.com, np.float64)
                p0 = p1 = p
            segs.append((bi, p0, p1, r))
    body_idx = np.asarray([s[0] for s in segs], np.int32)
    p0 = np.stack([s[1] for s in segs])
    p1 = np.stack([s[2] for s in segs])
    rad = np.asarray([s[3] for s in segs], np.float64)
    return body_idx, p0, p1, rad


_SEG_BODY, _SEG_P0, _SEG_P1, _SEG_RAD = _geom_segments()


def _camera(target: np.ndarray, azimuth_deg: float = 35.0,
            elevation_deg: float = -15.0, distance: float = 3.0):
    """Orbit camera: returns (eye, R) with rows = (right, up, forward)."""
    az = np.deg2rad(azimuth_deg)
    el = np.deg2rad(elevation_deg)
    fwd = np.array([
        np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)
    ])
    eye = target - distance * fwd
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    right /= np.linalg.norm(right) + 1e-12
    up = np.cross(right, fwd)
    return eye, np.stack([right, up, fwd])


def _project(pts: np.ndarray, eye: np.ndarray, R: np.ndarray,
             width: int, height: int, fov_deg: float = 45.0):
    """World points (..., 3) -> pixel coords (..., 2), depth (...,) and the
    focal length in pixels."""
    cam = (pts - eye) @ R.T
    x, y, z = cam[..., 0], cam[..., 1], np.maximum(cam[..., 2], 1e-3)
    f = 0.5 * height / np.tan(np.deg2rad(fov_deg) / 2)
    u = width / 2 + f * x / z
    v = height / 2 - f * y / z
    return np.stack([u, v], axis=-1), z, f


def _draw_line(img: np.ndarray, a, b, thickness: int, color):
    """Thick 2D segment; cv2 when it imports, else numpy stamps."""
    try:
        import cv2

        cv2.line(img, (int(a[0]), int(a[1])), (int(b[0]), int(b[1])),
                 color, max(1, thickness), cv2.LINE_AA)
        return
    except Exception:
        pass
    h, w = img.shape[:2]
    n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]))) + 1
    us = np.linspace(a[0], b[0], n).astype(int)
    vs = np.linspace(a[1], b[1], n).astype(int)
    r = max(1, thickness // 2)
    for du in range(-r, r + 1):
        for dv in range(-r, r + 1):
            uu = np.clip(us + du, 0, w - 1)
            vv = np.clip(vs + dv, 0, h - 1)
            img[vv, uu] = color


def render_frame(body_pos: np.ndarray, body_quat: np.ndarray,
                 width: int = 640, height: int = 480,
                 target: np.ndarray | None = None) -> np.ndarray:
    """One (H, W, 3) uint8 RGB frame from world body poses (nb, 3)/(nb, 4)."""
    img = np.full((height, width, 3), 24, np.uint8)
    root = body_pos[0]
    if target is None:
        target = np.array([root[0], root[1], 0.8])
    eye, R = _camera(target)

    # ground grid around the character (1 m spacing, 8x8 m)
    gx = np.floor(target[0]) + np.arange(-4, 5)
    gy = np.floor(target[1]) + np.arange(-4, 5)
    grid_col = (55, 55, 60)
    for x in gx:
        pts = np.array([[x, gy[0], 0.0], [x, gy[-1], 0.0]])
        uv, z, _ = _project(pts, eye, R, width, height)
        if np.all(z > 0.05):
            _draw_line(img, uv[0], uv[1], 1, grid_col)
    for y in gy:
        pts = np.array([[gx[0], y, 0.0], [gx[-1], y, 0.0]])
        uv, z, _ = _project(pts, eye, R, width, height)
        if np.all(z > 0.05):
            _draw_line(img, uv[0], uv[1], 1, grid_col)

    # capsule geoms, painter's order back-to-front by midpoint depth
    q = body_quat[_SEG_BODY]
    p0 = body_pos[_SEG_BODY] + _quat_rot_np(q, _SEG_P0)
    p1 = body_pos[_SEG_BODY] + _quat_rot_np(q, _SEG_P1)
    uv0, z0, f = _project(p0, eye, R, width, height)
    uv1, z1, _ = _project(p1, eye, R, width, height)
    order = np.argsort(-(z0 + z1))
    col = (235, 190, 80)
    for i in order:
        if min(z0[i], z1[i]) <= 0.05:
            # at or behind the camera, as the grid's lines are skipped: a pose
            # far from the clip's (an untrained model's) would otherwise give
            # segments millions of pixels thick and stall the rasterizer
            continue
        zmid = 0.5 * (z0[i] + z1[i])
        thick = int(round(2 * _SEG_RAD[i] * f / zmid))
        _draw_line(img, uv0[i], uv1[i], min(max(2, thick), width + height), col)
    return img


def body_poses(qpos_traj, device: str | torch.device = "cuda"):
    """(T, 35) qpos -> float64 numpy (T, nb, 3) positions and (T, nb, 4)
    quaternions: the forward kinematics on ``device`` in float32, read back
    in one copy."""
    from .kinematics import forward_kinematics_batch

    dev = resolve_device(device)
    q = torch.as_tensor(np.asarray(qpos_traj, np.float32), device=dev)
    with torch.inference_mode():
        fk = forward_kinematics_batch(q)
        poses = torch.cat([fk.body_pos, fk.body_quat], dim=-1).cpu().numpy()
    poses = poses.astype(np.float64)
    return poses[..., :3], poses[..., 3:]


def render_motion(qpos_traj, width: int = 640, height: int = 480,
                  device: str | torch.device = "cuda") -> np.ndarray:
    """(T, 35) qpos trajectory -> (T, H, W, 3) uint8 frames; the forward
    kinematics on ``device``, the rasterizer on the host."""
    body_pos, body_quat = body_poses(qpos_traj, device)
    return np.stack([
        render_frame(body_pos[t], body_quat[t], width, height)
        for t in range(body_pos.shape[0])
    ])
