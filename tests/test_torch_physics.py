"""The port's humanoid model, static tables, FK, tracking reward, kinematic
env and physics plausibility scoring against the JAX package's
(`deepmimic_diffusion_mujoco_tpu/physics/`), on numpy inputs."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.data.mocap import load_clip
from deepmimic_diffusion_mujoco_tpu.physics import dynamics as jdyn
from deepmimic_diffusion_mujoco_tpu.physics import dynamics_aba as jaba
from deepmimic_diffusion_mujoco_tpu.physics import env as jenv
from deepmimic_diffusion_mujoco_tpu.physics import humanoid_model as jhm
from deepmimic_diffusion_mujoco_tpu.physics import kinematics as jkin
from deepmimic_diffusion_mujoco_tpu.physics.plausibility import track_motions as jax_track
from deepmimic_diffusion_mujoco_tpu_torch.physics import dynamics as tdyn
from deepmimic_diffusion_mujoco_tpu_torch.physics import dynamics_aba as taba
from deepmimic_diffusion_mujoco_tpu_torch.physics import env as tenv
from deepmimic_diffusion_mujoco_tpu_torch.physics import humanoid_model as thm
from deepmimic_diffusion_mujoco_tpu_torch.physics import kinematics as tkin
from deepmimic_diffusion_mujoco_tpu_torch.physics.plausibility import (
    _joint_velocities,
    track_motions,
)

torch.set_num_threads(2)

WALK = os.path.join(os.path.dirname(__file__), "..", "data", "motions", "humanoid3d_walk.txt")


@pytest.fixture(scope="module")
def clip():
    return load_clip(WALK)


TABLES = [
    (tdyn, jdyn, name) for name in (
        "NB", "NJ", "NV", "NQ", "BODY_MASS", "BODY_COM", "BODY_INERTIA", "JOINT_BODY",
        "JOINT_AXIS", "JOINT_ANCHOR", "ANCESTOR_MASK", "PD_KP", "PD_KD", "LIMIT_LO", "LIMIT_HI",
        "CONTACT_BODY", "CONTACT_POINT", "CONTACT_RADIUS")
] + [(taba, jaba, name) for name in ("LINK_PARENT", "LINK_CARRIER")] + [
    (thm, jhm, name) for name in (
        "BODIES", "BODY_INDEX", "TOTAL_MASS", "END_EFFECTOR_BODIES", "JOINT_ARMATURE",
        "JOINT_DAMPING", "JOINT_STIFFNESS", "FLOOR_FRICTION", "GRAVITY")
]


@pytest.mark.parametrize("ours,theirs,name", TABLES, ids=[t[2] for t in TABLES])
def test_static_tables_equal_jax(ours, theirs, name):
    a, b = getattr(ours, name), getattr(theirs, name)
    if name == "BODIES":  # two dataclass types with the same fields
        a, b = [dataclasses.asdict(x) for x in a], [dataclasses.asdict(x) for x in b]
    if isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_body_last_link_and_xml_equal_jax():
    assert taba._BODY_LAST_LINK == jaba._BODY_LAST_LINK
    assert thm.to_xml() == jhm.to_xml()
    assert thm.to_xml(0.001) == jhm.to_xml(0.001)


def test_forward_kinematics_matches_jax(clip):
    """Every walk-clip frame, plus a batch with two leading axes."""
    q = clip.qpos.astype(np.float32)
    ours = tkin.forward_kinematics(torch.from_numpy(q))
    ref = jax.jit(jkin.forward_kinematics)(jnp.asarray(q))
    for field in ("body_pos", "body_quat", "com", "end_effectors"):
        np.testing.assert_allclose(getattr(ours, field).numpy(), np.asarray(getattr(ref, field)),
                                   atol=1e-6, rtol=0, err_msg=field)
    batched = tkin.forward_kinematics_batch(torch.from_numpy(q[:36].reshape(6, 6, 35)))
    np.testing.assert_allclose(batched.com.numpy().reshape(36, 3), ours.com.numpy()[:36],
                               atol=1e-7, rtol=0)


def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(1)
    q1 = rng.normal(size=(5, 4)).astype(np.float32)
    q1 /= np.linalg.norm(q1, axis=-1, keepdims=True)
    q2 = rng.normal(size=(5, 4)).astype(np.float32)
    q2 /= np.linalg.norm(q2, axis=-1, keepdims=True)
    v = rng.normal(size=(5, 3)).astype(np.float32)
    e = rng.normal(size=(5, 3)).astype(np.float32)
    T = torch.from_numpy
    pairs = [
        (tkin.quat_mul(T(q1), T(q2)), jkin.quat_mul(jnp.asarray(q1), jnp.asarray(q2))),
        (tkin.quat_rotate(T(q1), T(v)), jkin.quat_rotate(jnp.asarray(q1), jnp.asarray(v))),
        (tkin.quat_from_euler_rxyz(T(e)), jkin.quat_from_euler_rxyz(jnp.asarray(e))),
        (tkin.quat_geodesic_angle(T(q1), T(q2)),
         jkin.quat_geodesic_angle(jnp.asarray(q1), jnp.asarray(q2))),
    ]
    for ours, ref in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_tracking_reward_matches_jax(clip):
    rng = np.random.default_rng(0)
    q = clip.qpos[:8].astype(np.float32)
    v = clip.qvel[:8].astype(np.float32)
    q_bad = (q + rng.normal(0, 0.3, q.shape)).astype(np.float32)
    v_bad = (v + rng.normal(0, 1.0, v.shape)).astype(np.float32)
    jax_reward = jax.jit(jenv.tracking_reward)
    for qq, vv in ((q, v), (q_bad, v), (q, v_bad), (q_bad, v_bad)):
        ours = tenv.tracking_reward(*(torch.from_numpy(a) for a in (qq, vv, q, v)))
        ref = jax_reward(*(jnp.asarray(a) for a in (qq, vv, q, v)))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    perfect = tenv.tracking_reward(*(torch.from_numpy(a) for a in (q, v, q, v)))
    np.testing.assert_allclose(perfect.numpy(), 1.0, atol=1e-5)


def test_kinematic_env_steps_match_jax(clip):
    """Three steps from frames near the clip's end, so some instances wrap
    and carry the root xy phase offset."""
    ours_env = tenv.KinematicEnv(clip.qpos, clip.qvel, device="cpu")
    ref_env = jenv.KinematicEnv(clip.qpos, clip.qvel)
    n = ours_env.num_frames
    frames = np.asarray([n - 3, n - 2, n - 1, 0, 5, n - 1], np.int64)
    ours = tenv.EnvState(torch.from_numpy(frames), torch.zeros(6, 3),
                         ours_env.motion[frames], ours_env.vel[frames])
    ref = jenv.EnvState(jnp.asarray(frames, jnp.int32), jnp.zeros((6, 3), jnp.float32),
                        ref_env.motion[frames], ref_env.vel[frames])
    for _ in range(3):
        ours, fk, r = ours_env.step(ours)
        ref, jfk, jr = ref_env.step(ref)
        np.testing.assert_array_equal(ours.frame.numpy(), np.asarray(ref.frame))
        for a, b in ((ours.phase_offset, ref.phase_offset), (ours.qpos, ref.qpos),
                     (ours.qvel, ref.qvel), (fk.body_pos, jfk.body_pos), (fk.com, jfk.com)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=2e-5, rtol=0)
    assert (np.abs(ours.phase_offset[:, 0].numpy()) > 1e-6).sum() == 4
    st = ours_env.reset(8)
    np.testing.assert_array_equal(st.frame.numpy(), np.asarray(ref_env.reset(8).frame))


def test_joint_velocities_match_jax(clip):
    m = np.stack([clip.qpos, clip.qpos[::-1]]).astype(np.float32)
    from deepmimic_diffusion_mujoco_tpu.physics.plausibility import _joint_velocities as jv

    np.testing.assert_allclose(_joint_velocities(torch.from_numpy(m), 1 / 30).numpy(),
                               np.asarray(jv(jnp.asarray(m), 1 / 30)), atol=1e-4, rtol=1e-6)


def test_track_motions_matches_jax(clip):
    """The walk clip and a joint-scrambled copy, horizon 3. JAX tracks them
    on its O(n) ABA engine (its CPU default); the port on the whole-control-
    step math: the same algebra, float32 association apart."""
    real = clip.qpos.astype(np.float32)
    rng = np.random.default_rng(0)
    fake = real.copy()
    fake[:, 7:] += rng.normal(0, 0.4, fake[:, 7:].shape).astype(np.float32)
    motions = np.stack([real, fake])
    ours = track_motions(motions, horizon=3, substeps=2, device="cpu")
    ref = jax_track(motions, horizon=3, substeps=2)
    assert ours["reward_curve"].shape == (3,)
    for key in ("reward_mean", "reward_auc", "reward_curve"):
        np.testing.assert_allclose(ours[key], np.asarray(ref[key]), atol=1e-4, rtol=0, err_msg=key)
    np.testing.assert_array_equal(ours["survival_steps"], np.asarray(ref["survival_steps"]))
    assert set(ours["summary"]) == set(ref["summary"])
    for key, val in ref["summary"].items():
        assert ours["summary"][key] == pytest.approx(val, abs=1e-4), key
    assert ours["reward_mean"][0] > ours["reward_mean"][1]
    one = track_motions(real, horizon=1, substeps=2, device="cpu")
    assert one["reward_mean"].shape == (1,) and one["reward_curve"].shape == (1,)


def test_pd_torques_and_integrate_qpos_match_jax(clip):
    q = clip.qpos[:8].astype(np.float32)
    v = clip.qvel[:8].astype(np.float32)
    tgt = clip.qpos[1:9].astype(np.float32)
    v[0, 3:6] = 0.0  # the series branch at |w| = 0
    T = torch.from_numpy
    np.testing.assert_allclose(
        tdyn.pd_torques(T(q), T(v), T(tgt), 0.5, 2.0).numpy(),
        np.asarray(jdyn.pd_torques(jnp.asarray(q), jnp.asarray(v), jnp.asarray(tgt), 0.5, 2.0)),
        atol=1e-4, rtol=1e-6)
    for dt in (1.0 / 510, 0.1):
        np.testing.assert_allclose(
            tdyn.integrate_qpos(T(q), T(v), dt).numpy(),
            np.asarray(jdyn.integrate_qpos(jnp.asarray(q), jnp.asarray(v), dt)),
            atol=1e-6, rtol=0)
