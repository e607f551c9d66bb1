"""Vectorized humanoid environments + DeepMimic tracking reward.

The port of ``deepmimic_diffusion_mujoco_tpu/physics/env.py``. The
reference's only environment is a host-side kinematic playback loop
(mocap_player.py:7-39) with a phase-offset wraparound carrying the root xy
across loops (mocap_player.py:35-37,76-79); here it steps thousands of
instances in lockstep on the card, plus the DeepMimic tracking-reward stack
(PARAMS_KP_KD / JOINT_WEIGHT, utils/mocap_util.py:22-29).

- KinematicEnv: `step` advances the mocap frame (wraparound + root-xy phase
  carry) and runs FK: the playback/eval path.
- PhysicsTrackingEnv: the DeepMimic imitation loop on the rigid-body
  engine: PD torques toward the next mocap frame, tracking reward, fall
  termination. On the "auto"/"pallas" layout `step` is one launch of the
  whole-control-step kernel (B5) with the reward fused in and `rollout` one
  launch of the whole-rollout kernel (B6); on CPU tensors both run the
  kernels' plain versions. On "vmap", "lanes" and "aba" `step` runs that
  engine (dynamics.DynamicsEnv) and then the reward, and `rollout` is `step`
  in a loop. `rollout_sharded` splits the envs over data-parallel ranks.

Constructors take ``device`` ("cuda" by default; it raises without a card).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..data.skeleton import BODY_JOINTS, DOF_DEF, JOINT_WEIGHT, QPOS_JOINT_SLICES, QVEL_DIM
from ..device import resolve_device
from ..parallel.mesh import all_gather_rows, shard_batch
from . import dynamics_kernel
from .kinematics import forward_kinematics, quat_from_euler_rxyz, quat_geodesic_angle

# ---------------------------------------------------------------------------
# DeepMimic tracking reward (Peng et al. 2018 weights)
# ---------------------------------------------------------------------------

_JOINT_W = np.asarray([JOINT_WEIGHT[j] for j in BODY_JOINTS], np.float32)
_JOINT_W = _JOINT_W / _JOINT_W.sum()


def _joint_quats(qpos: torch.Tensor) -> torch.Tensor:
    """Per-joint rotations as quaternions: (..., 12, 4)."""
    quats = []
    for j in BODY_JOINTS:
        sl = QPOS_JOINT_SLICES[j]
        if DOF_DEF[j] == 3:
            quats.append(quat_from_euler_rxyz(qpos[..., sl]))
        else:
            half = qpos[..., sl][..., 0] * 0.5
            z = torch.zeros_like(half)
            # hinge about -y (elbows/knees): sign only flips the geodesic
            # direction, not the angle magnitude used by the reward
            quats.append(torch.stack([torch.cos(half), z, -torch.sin(half), z], -1))
    return torch.stack(quats, dim=-2)


def tracking_reward(qpos, qvel, ref_qpos, ref_qvel, w_pose: float = 0.65, w_vel: float = 0.1,
                    w_ee: float = 0.15, w_com: float = 0.1) -> torch.Tensor:
    """DeepMimic reward: weighted product-of-exponentials over pose error,
    velocity error, end-effector error and COM error."""
    ang = quat_geodesic_angle(_joint_quats(qpos), _joint_quats(ref_qpos))   # (..., 12)
    w = torch.as_tensor(_JOINT_W, dtype=qpos.dtype, device=qpos.device)
    pose_err = (w * ang ** 2).sum(-1)

    vel_err = ((qvel[..., 6:] - ref_qvel[..., 6:]) ** 2).mean(-1)

    fk = forward_kinematics(qpos)
    fk_ref = forward_kinematics(ref_qpos)
    ee_err = ((fk.end_effectors - fk_ref.end_effectors) ** 2).sum(-1).mean(-1)
    com_err = ((fk.com - fk_ref.com) ** 2).sum(-1)

    return (w_pose * torch.exp(-2.0 * pose_err) + w_vel * torch.exp(-0.1 * vel_err)
            + w_ee * torch.exp(-40.0 * ee_err) + w_com * torch.exp(-10.0 * com_err))


def _clip_tensors(qpos_clip, qvel_clip, device):
    motion = torch.as_tensor(np.asarray(qpos_clip), dtype=torch.float32, device=device)
    if qvel_clip is None:
        vel = torch.zeros((motion.shape[0], QVEL_DIM), dtype=torch.float32, device=device)
    else:
        vel = torch.as_tensor(np.asarray(qvel_clip), dtype=torch.float32, device=device)
    return motion, vel


def _reset_frames(n: int, num_frames: int, stagger: bool, device) -> torch.Tensor:
    if stagger:
        return (torch.arange(n, device=device) * num_frames // max(n, 1)) % num_frames
    return torch.zeros((n,), dtype=torch.long, device=device)


# ---------------------------------------------------------------------------
# Kinematic playback env (vectorized mocap_player)
# ---------------------------------------------------------------------------


class EnvState(NamedTuple):
    frame: torch.Tensor         # (N,) int64 current frame index
    phase_offset: torch.Tensor  # (N, 3) root offset carried across loops
    qpos: torch.Tensor          # (N, 35)
    qvel: torch.Tensor          # (N, 34)


class KinematicEnv:
    """N instances playing a mocap clip in lockstep."""

    def __init__(self, qpos_clip, qvel_clip=None, device="cuda"):
        self.device = resolve_device(device)
        self.motion, self.vel = _clip_tensors(qpos_clip, qvel_clip, self.device)  # (T, 35), (T, 34)
        self.num_frames = self.motion.shape[0]

    def reset(self, n: int, stagger: bool = True) -> EnvState:
        """Instances optionally staggered across the clip's phase."""
        frame = _reset_frames(n, self.num_frames, stagger, self.device)
        return EnvState(frame=frame,
                        phase_offset=torch.zeros((n, 3), dtype=torch.float32, device=self.device),
                        qpos=self.motion[frame], qvel=self.vel[frame])

    def step(self, state: EnvState):
        """Advance one frame; on wraparound carry the root xy offset so the
        character keeps moving forward (mocap_player.py:76-79). Returns
        (state, fk, reward): FK runs every step (the sim.forward analog)
        and reward is tracking vs. the raw clip."""
        nxt = state.frame + 1
        wrapped = nxt >= self.num_frames
        nxt = torch.where(wrapped, torch.zeros_like(nxt), nxt)
        # offset += (last_frame_root - first_frame_root), z zeroed
        delta = self.motion[-1, 0:3] - self.motion[0, 0:3]
        delta = torch.cat([delta[:2], delta.new_zeros(1)])
        phase = state.phase_offset + torch.where(wrapped[:, None], delta[None],
                                                 delta.new_zeros(()))
        qpos = self.motion[nxt]
        qpos = torch.cat([qpos[:, 0:3] + phase, qpos[:, 3:]], dim=1)
        qvel = self.vel[nxt]
        fk = forward_kinematics(qpos)
        # the reference pose shares the phase carry: after wraparound the
        # clip's root xy is offset too
        reward = tracking_reward(qpos, qvel, qpos, self.vel[nxt])
        return EnvState(nxt, phase, qpos, qvel), fk, reward


# ---------------------------------------------------------------------------
# Physics tracking env (real forward dynamics + DeepMimic imitation loop)
# ---------------------------------------------------------------------------


class PhysicsState(NamedTuple):
    frame: torch.Tensor  # (N,) int64 target mocap frame
    qpos: torch.Tensor   # (N, 35)
    qvel: torch.Tensor   # (N, 34)
    done: torch.Tensor   # (N,) bool — fell (root below threshold)


class PhysicsTrackingEnv:
    """DeepMimic-style imitation env on the rigid-body engine: each 30 Hz
    control step applies stable PD torques toward the next mocap frame,
    integrates `substeps` implicitly-damped semi-implicit Euler substeps
    with ground contact, and scores the DeepMimic tracking reward vs the
    reference frame. Fall detection terminates an instance when the root
    drops below `fall_height` (done instances hold their state; rewards
    gate to 0)."""

    def __init__(self, qpos_clip, qvel_clip=None, dt: float = 1.0 / 30.0, substeps: int = 17,
                 kp_scale: float = 1.0, kd_scale: float = 1.0, fall_height: float = 0.3,
                 layout: str = "auto", device="cuda"):
        from .dynamics import DynamicsEnv

        self.device = resolve_device(device)
        self.motion, self.vel = _clip_tensors(qpos_clip, qvel_clip, self.device)
        self.num_frames = self.motion.shape[0]
        self.fall_height = fall_height
        self.engine = DynamicsEnv(dt=dt, substeps=substeps, kp_scale=kp_scale,
                                  kd_scale=kd_scale, layout=layout)

    def reset(self, n: int, stagger: bool = True) -> PhysicsState:
        frame = _reset_frames(n, self.num_frames, stagger, self.device)
        return PhysicsState(frame=frame, qpos=self.motion[frame], qvel=self.vel[frame],
                            done=torch.zeros((n,), dtype=torch.bool, device=self.device))

    def step(self, state: PhysicsState):
        """PD toward the NEXT mocap frame, integrate, reward vs that frame.
        On the whole-control-step layout, one launch of B5 with the reward
        fused in (on the post-step state, identical to the unfused order
        because done instances gate to 0 below anyway). Returns (state,
        reward)."""
        nxt = torch.where(state.frame + 1 >= self.num_frames, torch.zeros_like(state.frame),
                          state.frame + 1)
        target = self.motion[nxt]
        if self.engine.layout == "pallas":
            qpos, qvel, reward = dynamics_kernel.control_step(
                state.qpos, state.qvel, target, self.vel[nxt], **self.engine.kernel_args())
        else:
            qpos, qvel = self.engine.step(state.qpos, state.qvel, target)
        # frozen once fallen
        qpos = torch.where(state.done[:, None], state.qpos, qpos)
        qvel = torch.where(state.done[:, None], state.qvel, qvel)
        if self.engine.layout != "pallas":
            reward = tracking_reward(qpos, qvel, target, self.vel[nxt])
        done = state.done | (qpos[:, 2] < self.fall_height)
        reward = torch.where(done, torch.zeros_like(reward), reward)
        return PhysicsState(nxt, qpos, qvel, done), reward

    def rollout(self, state: PhysicsState, num_steps: int):
        """`num_steps` control steps. Returns (final_state, rewards
        (num_steps, N)). On the whole-control-step layout, ONE launch of the
        whole-rollout kernel (B6): dynamics, rewards and the done/fall
        bookkeeping; on the other layouts `step` in a loop."""
        if self.engine.layout != "pallas":
            rewards = []
            for _ in range(num_steps):
                state, r = self.step(state)
                rewards.append(r)
            return state, torch.stack(rewards)
        frames = (state.frame[None, :] + 1
                  + torch.arange(num_steps, device=state.frame.device)[:, None]) % self.num_frames
        qpos, qvel, rewards, done = dynamics_kernel.rollout(
            state.qpos, state.qvel, self.motion[frames], self.vel[frames], state.done,
            fall_height=self.fall_height, **self.engine.kernel_args())
        return PhysicsState(frames[-1], qpos, qvel, done), rewards

    def rollout_sharded(self, mesh, state: PhysicsState, num_steps: int):
        """`rollout` with the env axis split over the ranks of ``mesh`` (a
        ``DeviceMesh``'s "data" dimension or a process group): every rank
        runs `rollout` on its N/R envs of the global ``state`` (one B6
        launch at N/R on the whole-control-step layout), and the rewards
        (num_steps, N) and final state are gathered in rank order
        (``parallel.mesh.all_gather_rows``), so every rank returns what
        `rollout` of the whole state returns. Envs are independent: no
        other communication. N must split evenly over the ranks."""
        local = PhysicsState(*shard_batch(mesh, tuple(state)))
        final, rewards = self.rollout(local, num_steps)
        *parts, rewards = all_gather_rows([*final, rewards.T], mesh)
        return PhysicsState(*parts), rewards.T.contiguous()
