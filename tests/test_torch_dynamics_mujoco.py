"""The port's dense engine (`physics/dynamics.py`) against the MuJoCo C engine.

Float64 on the CPU, the model from the port's `humanoid_model.to_xml()` with
MuJoCo's Euler integrator at h 0.002, as `tests/test_dynamics.py` pins the
JAX engine. Smooth dynamics (mass matrix, bias forces, qacc) and a 150-step
flight must agree to machine precision; contact is solver-dependent (MuJoCo:
PGS constraints; the engine: implicitly damped penalty), so standing balance
agrees statistically (COM within 5 cm after 0.5 s).
"""
import os

import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu_torch.data.mocap import load_clip
from deepmimic_diffusion_mujoco_tpu_torch.physics import dynamics as dyn
from deepmimic_diffusion_mujoco_tpu_torch.physics.humanoid_model import to_xml

mujoco = pytest.importorskip("mujoco")

torch.set_num_threads(2)

WALK = os.path.join(os.path.dirname(__file__), "..", "data", "motions", "humanoid3d_walk.txt")
H = 0.002


def _model(constraints: bool = True):
    model = mujoco.MjModel.from_xml_string(to_xml())
    # the parity target is the body model, pinned to the engine's
    # integration: semi-implicit Euler at h 0.002
    model.opt.integrator = mujoco.mjtIntegrator.mjINT_EULER
    model.opt.timestep = H
    if not constraints:
        # limits and contacts are penalties in the engine: the smooth checks
        # leave both out
        model.opt.disableflags |= mujoco.mjtDisableBit.mjDSBL_CONSTRAINT
    return model


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


@pytest.fixture(scope="module")
def walk_qpos():
    return np.asarray(load_clip(WALK).qpos, np.float64)


@pytest.mark.parametrize("frame", [0, 11, 27])
def test_smooth_dynamics_matches_mj_forward(walk_qpos, frame):
    """M, bias and qacc at a walk frame with seeded velocities and torques
    match mj_forward / mj_fullM to 1e-10 / 1e-9 / 1e-7."""
    rng = np.random.default_rng(frame)
    qpos = walk_qpos[frame].copy()
    qvel = rng.normal(size=34)
    tau = np.concatenate([np.zeros(6), rng.normal(size=28) * 20])
    model = _model(constraints=False)
    data = mujoco.MjData(model)
    data.qpos[:], data.qvel[:], data.qfrc_applied[:] = qpos, qvel, tau
    mujoco.mj_forward(model, data)
    M_mj = np.zeros((model.nv, model.nv))
    mujoco.mj_fullM(model, data, M_mj)

    M = dyn.mass_matrix(dyn.fk_dynamics(_t(qpos))).numpy()
    np.testing.assert_allclose(M, M_mj, atol=1e-10)
    bias = dyn.bias_forces(_t(qpos), _t(qvel)).numpy()
    np.testing.assert_allclose(bias, data.qfrc_bias, atol=1e-9)
    qacc = dyn.forward_dynamics(_t(qpos), _t(qvel), _t(tau), contacts=False, limits=False)
    np.testing.assert_allclose(qacc.numpy(), data.qacc, atol=1e-7)


def test_flight_trajectory_matches_mj_step(walk_qpos):
    """Ballistic tumbling, no contact: 150 Euler steps agree with mj_step
    to 1e-10 (integrator and free-joint quaternion convention)."""
    model = _model(constraints=False)
    data = mujoco.MjData(model)
    qpos = walk_qpos[3].copy()
    qpos[2] += 1.0
    qvel = np.zeros(34)
    qvel[0:3] = [0.2, 0.1, 0.5]
    qvel[3:6] = [0.5, -0.3, 0.8]
    data.qpos[:], data.qvel[:] = qpos, qvel

    q, v = _t(qpos), _t(qvel)
    tau = torch.zeros(34, dtype=torch.float64)
    for _ in range(150):
        mujoco.mj_step(model, data)
        q, v = dyn.step_physics(q, v, tau, H, contacts=False, limits=False)
    np.testing.assert_allclose(q.numpy(), data.qpos, atol=1e-10)


def test_standing_pd_contact_statistical(walk_qpos):
    """Standing balance under DeepMimic PD with ground contact: the COM
    stays within 5 cm of MuJoCo's over 0.5 s. The MuJoCo side folds the
    PD's kd into dof_damping so that its Euler treats it implicitly too."""
    kp = np.asarray(dyn.PD_KP, np.float64)
    kd = np.asarray(dyn.PD_KD, np.float64)
    q0 = walk_qpos[3]
    model = _model()
    model.dof_damping[6:] += kd
    data = mujoco.MjData(model)
    data.qpos[:] = q0

    q, v, target, kd_t = _t(q0), torch.zeros(34, dtype=torch.float64), _t(q0), _t(kd)
    for _ in range(250):
        data.qfrc_applied[6:] = kp * (q0[7:] - data.qpos[7:])
        mujoco.mj_step(model, data)
        q, v = dyn.step_physics(q, v, dyn.pd_torques(q, v, target), H, kd_extra=kd_t)
    mass = np.asarray(dyn.BODY_MASS)
    com = (mass[:, None] * dyn.fk_dynamics(q).com_w.numpy()).sum(0) / mass.sum()
    mujoco.mj_forward(model, data)
    assert np.linalg.norm(com - data.subtree_com[0]) < 0.05
    # neither simulation fell or blew up
    assert 0.7 < float(q[2]) < 1.1
    assert 0.7 < data.qpos[2] < 1.1
