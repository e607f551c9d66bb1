"""Physical-plausibility scoring of motion tracks on the dynamics engine.

The port of ``deepmimic_diffusion_mujoco_tpu/physics/plausibility.py``:
PD-track each motion on the physics engine (DeepMimic's imitation setup)
and measure how well the simulated character keeps up. Physically
consistent motions track with high reward; motions with impossible
accelerations, interpenetrations or balance-free poses lose the character
quickly.

`track_motions` scores a BATCH of independent motions (each its own target
trajectory — unlike PhysicsTrackingEnv, which tracks one shared clip): one
`DynamicsEnv.step` per control step (the whole-control-step kernel B5
without the reward, on the card), then the tracking reward. Velocities for
the reward's joint-velocity term are finite-differenced from the track.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .dynamics import DynamicsEnv, pd_torques  # noqa: F401 (pd re-export)
from .env import tracking_reward


def _joint_velocities(motions: torch.Tensor, dt: float) -> torch.Tensor:
    """(B, T, 35) -> (B, T, 34) finite-difference velocities: root rows 0
    (unused by the reward's velocity term), hinge rows forward-difference
    with the last frame holding the previous value."""
    B, T, _ = motions.shape
    joints = motions[:, :, 7:]
    dj = (joints[:, 1:] - joints[:, :-1]) / dt
    dj = torch.cat([dj, dj[:, -1:]], dim=1)                    # (B, T, 28)
    root = motions.new_zeros((B, T, 6))
    return torch.cat([root, dj], dim=-1)


def _rollout(motions: torch.Tensor, substeps: int, dt: float, fall_height: float):
    """Track frame t at control step t -> (rewards, dones), each (T-1, B)."""
    engine = DynamicsEnv(dt=dt, substeps=substeps)
    vels = _joint_velocities(motions, dt)
    qp, qv = motions[:, 0].contiguous(), vels[:, 0].contiguous()
    done = torch.zeros((motions.shape[0],), dtype=torch.bool, device=motions.device)
    rewards, dones = [], []
    for t in range(1, motions.shape[1]):
        t_q, t_v = motions[:, t].contiguous(), vels[:, t].contiguous()
        qp2, qv2 = engine.step(qp, qv, t_q)
        qp = torch.where(done[:, None], qp, qp2)
        qv = torch.where(done[:, None], qv, qv2)
        r = tracking_reward(qp, qv, t_q, t_v)
        done = done | (qp[:, 2] < fall_height)
        rewards.append(torch.where(done, torch.zeros_like(r), r))
        dones.append(done)
    return torch.stack(rewards), torch.stack(dones)


def track_motions(motions, dt: float = 1.0 / 30.0, substeps: int = 17,
                  fall_height: float = 0.3, horizon: int | None = None,
                  device="cuda") -> dict:
    """Score motions (B, T, 35) [or (T, 35)] by physics PD-tracking.

    Returns per-motion arrays and scalar summaries:
      reward_mean    — mean tracking reward over surviving steps (B,)
      survival_steps — control steps before the character fell (B,)
      survived       — fraction of motions upright through the horizon
      reward_curve   — (T-1,) batch-mean reward per control step
    `horizon` truncates scoring to the first `horizon` control steps
    (open-loop PD has no balance feedback, so even ground-truth mocap
    topples after ~20 steps — comparisons should use a fixed horizon)."""
    dev = resolve_device(device)
    m = torch.as_tensor(np.asarray(motions, np.float32) if not torch.is_tensor(motions)
                        else motions, dtype=torch.float32).to(dev)
    if m.ndim == 2:
        m = m[None]
    if horizon is not None:
        m = m[:, : horizon + 1]
    with torch.inference_mode():
        rewards, dones = _rollout(m, substeps, dt, fall_height)
    rewards = rewards.cpu().numpy()                            # (T-1, B)
    alive = ~dones.cpu().numpy()
    steps_alive = alive.sum(0)                                 # (B,)
    denom = np.maximum(steps_alive, 1)
    reward_mean = (rewards * alive).sum(0) / denom
    # single-number score: reward integrated over the whole horizon with
    # fallen steps scored 0 — rewards early falls less than reward_mean does
    reward_auc = (rewards * alive).sum(0) / rewards.shape[0]
    return {
        "reward_mean": reward_mean,
        "reward_auc": reward_auc,
        "survival_steps": steps_alive,
        "survived": float(alive[-1].mean()),
        "reward_curve": rewards.mean(1),
        "summary": {
            "physics_reward_mean": float(reward_mean.mean()),
            "physics_reward_std": float(reward_mean.std()),
            "physics_reward_auc": float(reward_auc.mean()),
            "physics_survived_frac": float(alive[-1].mean()),
            "physics_survival_steps_mean": float(steps_alive.mean()),
        },
    }
