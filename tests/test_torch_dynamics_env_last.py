"""The port's env-last engines (`physics/dynamics_lanes.py`,
`physics/dynamics_aba.py`) against the JAX package's functions of the same
name: `step_physics_lanes`, `forward_dynamics_aba` and `step_physics_aba`.

Float64, the inputs of `test_torch_dynamics_engines.py` (N 6 walk frames,
contacts engaged on every other one, seeded velocities and torques, limits
on, the PD's kd implicit). The JAX side runs once for the module, eagerly,
with its unrolled solve and the stages outside the nested jvp jitted (eager
per-shape compiles of the solve alone cost about 30 s); never a substep
scan. Tolerances are those of JAX's own cross-layout tests
(`tests/test_dynamics.py:250-331`).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.physics import dynamics as jd
from deepmimic_diffusion_mujoco_tpu.physics import dynamics_aba as ja
from deepmimic_diffusion_mujoco_tpu.physics import dynamics_lanes as jl
from deepmimic_diffusion_mujoco_tpu_torch.data.mocap import load_clip
from deepmimic_diffusion_mujoco_tpu_torch.physics import dynamics_aba as ta
from deepmimic_diffusion_mujoco_tpu_torch.physics import dynamics_lanes as tl

torch.set_num_threads(2)

WALK = os.path.join(os.path.dirname(__file__), "..", "data", "motions", "humanoid3d_walk.txt")
H = 0.002
JAX_JITTED = ("spd_solve_lanes", "contact_terms_lanes", "mass_matrix_lanes",
              "body_jacobians_lanes", "passive_forces_lanes", "limit_forces_lanes",
              "integrate_lanes")


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


@pytest.fixture(scope="module")
def inputs():
    """qpos_T, qvel_T, tau_T (35/34/34, 6) and kd (28,), float64 numpy."""
    clip = load_clip(WALK)
    rng = np.random.default_rng(3)
    idx = (np.arange(6) * 7) % len(clip.qpos)
    qpos = np.asarray(clip.qpos[idx], np.float64).copy()
    qpos[::2, 2] -= 0.3
    qvel = rng.normal(size=(6, 34)) * 1.5
    tau = rng.normal(size=(6, 34)) * 10.0
    return qpos.T.copy(), qvel.T.copy(), tau.T.copy(), np.asarray(jd.PD_KD, np.float64)


@pytest.fixture(scope="module")
def jax_env_last(inputs):
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        for name in JAX_JITTED:
            fn = jax.jit(getattr(jl, name))
            mp.setattr(jl, name, fn)
            if hasattr(ja, name):   # dynamics_aba imports these by name
                mp.setattr(ja, name, fn)
        args = tuple(jnp.asarray(a) for a in inputs[:3])
        kd = jnp.asarray(inputs[3])
        lanes = jl.step_physics_lanes(*args, H, kd_extra=kd)
        qacc = ja.forward_dynamics_aba(*args, h_implicit=H, kd_extra=kd)
        aba = ja.step_physics_aba(*args, H, kd_extra=kd)
        return {"lanes": [np.asarray(x) for x in lanes], "qacc_aba": np.asarray(qacc),
                "aba": [np.asarray(x) for x in aba]}


def test_step_physics_lanes_matches_jax(inputs, jax_env_last):
    qT, vT, tT, kd = inputs
    q1, v1 = tl.step_physics_lanes(_t(qT), _t(vT), _t(tT), H, kd_extra=_t(kd))
    np.testing.assert_allclose(q1.numpy(), jax_env_last["lanes"][0], atol=1e-9)
    np.testing.assert_allclose(v1.numpy(), jax_env_last["lanes"][1], atol=1e-6)


def test_forward_dynamics_aba_matches_jax(inputs, jax_env_last):
    qT, vT, tT, kd = inputs
    qacc = ta.forward_dynamics_aba(_t(qT), _t(vT), _t(tT), h_implicit=H, kd_extra=_t(kd))
    np.testing.assert_allclose(qacc.numpy(), jax_env_last["qacc_aba"], atol=1e-8)


def test_step_physics_aba_matches_jax(inputs, jax_env_last):
    qT, vT, tT, kd = inputs
    q1, v1 = ta.step_physics_aba(_t(qT), _t(vT), _t(tT), H, kd_extra=_t(kd))
    np.testing.assert_allclose(q1.numpy(), jax_env_last["aba"][0], atol=1e-12)
    np.testing.assert_allclose(v1.numpy(), jax_env_last["aba"][1], atol=1e-9)
