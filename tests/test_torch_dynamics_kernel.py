"""The port's whole-control-step, rollout and reward math (the plain
versions of B5, B6 and B7, `physics/dynamics_kernel.py`) against the JAX
package's component form (`physics/dynamics_pallas.py`) on numpy inputs.

The JAX side runs eagerly (`unroll=True`, as `tests/test_dynamics_pallas.py`
runs it on the CPU) and is computed once for the module: 2 substeps on the
walk-clip frames of `tests/test_dynamics_pallas.py:34`, and 3 rollout steps
with two envs done.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.data.mocap import load_clip
from deepmimic_diffusion_mujoco_tpu.physics import dynamics_pallas as dp
from deepmimic_diffusion_mujoco_tpu.physics import env as jenv
from deepmimic_diffusion_mujoco_tpu_torch.physics import dynamics_kernel as tk
from deepmimic_diffusion_mujoco_tpu_torch.physics import env as tenv
from deepmimic_diffusion_mujoco_tpu_torch.physics.dynamics import NQ, NV, DynamicsEnv

torch.set_num_threads(2)

WALK = os.path.join(os.path.dirname(__file__), "..", "data", "motions", "humanoid3d_walk.txt")
HEADER = os.path.join(os.path.dirname(__file__), "..", "deepmimic_diffusion_mujoco_tpu_torch",
                      "csrc", "humanoid_tables.h")
H = (1.0 / 30.0) / 17.0
SUBSTEPS = 2
IDX = np.asarray([0, 5, 11, 20, 27, 33, 14, 8])
ROLL_N, ROLL_T, ROLL_DONE = 6, 3, [False, False, True, False, True, False]
KW = dict(h=H, substeps=SUBSTEPS, kp_scale=1.0, kd_scale=1.0, contacts=True, limits=True)


def _comps(x, dtype):
    return [jnp.asarray(x[:, k], dtype)[None] for k in range(x.shape[1])]


def _stack(cs):
    return np.stack([np.asarray(c[0]) for c in cs], axis=1)


@pytest.fixture(scope="module")
def clip():
    return load_clip(WALK)


@pytest.fixture(scope="module")
def frames(clip):
    rqv = clip.qvel[(IDX + 1) % len(clip.qpos)]
    return clip.qpos[IDX], clip.qvel[IDX], clip.qpos[(IDX + 1) % len(clip.qpos)], rqv


@pytest.fixture(scope="module")
def jax_step(frames):
    """JAX control_step_components + tracking_reward_components, float64
    and float32."""
    qpos, qvel, target, rqv = frames
    out = {}
    for name, dtype in (("f64", jnp.float64), ("f32", jnp.float32)):
        with jax.enable_x64(dtype == jnp.float64):
            tg = _comps(target, dtype)
            qp, qv = dp.control_step_components(_comps(qpos, dtype), _comps(qvel, dtype), tg,
                                                h=H, substeps=SUBSTEPS, unroll=True)
            r = dp.tracking_reward_components(qp, qv, tg, _comps(rqv, dtype))
            out[name] = (_stack(qp), _stack(qv), np.asarray(r[0]))
    return out


@pytest.fixture(scope="module")
def jax_rollout(clip):
    """dynamics_pallas._rollout_env_step over ROLL_T steps from the
    staggered reset of ROLL_N envs, two of them done."""
    frame0 = (np.arange(ROLL_N) * len(clip.qpos) // ROLL_N) % len(clip.qpos)
    qp = _comps(clip.qpos[frame0], jnp.float32)
    qv = _comps(clip.qvel[frame0], jnp.float32)
    dn = jnp.asarray(ROLL_DONE, jnp.float32)[None]
    steps = []
    for t in range(ROLL_T):
        fr = (frame0 + 1 + t) % len(clip.qpos)
        qp, qv, dn, r = dp._rollout_env_step(
            qp, qv, dn, _comps(clip.qpos[fr], jnp.float32), _comps(clip.qvel[fr], jnp.float32),
            fall_height=0.3, unroll=True, **KW)
        steps.append((_stack(qp), _stack(qv), np.asarray(dn[0]) > 0.5, np.asarray(r[0])))
    return frame0, steps


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def test_control_step_plain_matches_jax_f64(frames, jax_step):
    """Same recursions in the same association order: float64 agrees to
    rounding."""
    qpos, qvel, target, rqv = frames
    qp, qv, r = tk.control_step_plain(*(_t(a, torch.float64) for a in frames), **KW)
    jq, jv, jr = jax_step["f64"]
    np.testing.assert_allclose(qp.numpy(), jq, atol=1e-8, rtol=0)
    np.testing.assert_allclose(qv.numpy(), jv, atol=1e-6, rtol=0)
    np.testing.assert_allclose(r.numpy(), jr, atol=1e-10, rtol=0)


def test_control_step_plain_matches_jax_f32(frames, jax_step):
    """float32: the two frameworks' sin/cos/rsqrt differ in the last bit, and
    stiff contacts (30,000 N/m at h = 1/510 s) amplify it in the velocities."""
    qp, qv, r = tk.control_step_plain(*(_t(a) for a in frames), **KW)
    jq, jv, jr = jax_step["f32"]
    np.testing.assert_allclose(qp.numpy(), jq, atol=1e-5, rtol=0)
    np.testing.assert_allclose(qv.numpy(), jv, atol=1e-3 * np.abs(jv).max(), rtol=0)
    np.testing.assert_allclose(r.numpy(), jr, atol=2e-6, rtol=0)


def test_fused_reward_is_the_reward_of_the_stepped_state(frames):
    """B5's fused reward equals the reward kernel's plain version (B7) and
    env.tracking_reward on the post-step state."""
    qpos, qvel, target, rqv = (_t(a) for a in frames)
    qp, qv, r = tk.control_step_plain(qpos, qvel, target, rqv, **KW)
    qp2, qv2 = tk.control_step_plain(qpos, qvel, target, **KW)
    assert torch.equal(qp, qp2) and torch.equal(qv, qv2)
    assert torch.equal(r, tk.tracking_reward_plain(qp, qv, target, rqv))
    torch.testing.assert_close(r, tenv.tracking_reward(qp, qv, target, rqv), atol=2e-5, rtol=0)


def test_tracking_reward_plain_matches_jax(frames):
    """B7's plain version against the JAX component reward and the JAX
    env.tracking_reward, on clip frames against perturbed references."""
    qpos, qvel, target, rqv = frames
    rng = np.random.default_rng(0)
    ref_q = target + rng.normal(0, 0.05, target.shape)
    ref_v = rqv + rng.normal(0, 0.5, rqv.shape)
    ours = tk.tracking_reward_plain(_t(qpos), _t(qvel), _t(ref_q), _t(ref_v)).numpy()
    comp = dp.tracking_reward_components(*(_comps(a, jnp.float32)
                                           for a in (qpos, qvel, ref_q, ref_v)))[0]
    np.testing.assert_allclose(ours, np.asarray(comp), atol=1e-6, rtol=0)
    ref = jenv.tracking_reward(*(jnp.asarray(a, jnp.float32) for a in (qpos, qvel, ref_q, ref_v)))
    np.testing.assert_allclose(ours, np.asarray(ref), atol=2e-5, rtol=0)
    assert ours.min() < 0.9  # the perturbation costs reward


def _rollout_inputs(clip, frame0):
    fr = (frame0[None] + 1 + np.arange(ROLL_T)[:, None]) % len(clip.qpos)
    return (_t(clip.qpos[frame0]), _t(clip.qvel[frame0]), _t(clip.qpos[fr]), _t(clip.qvel[fr]),
            torch.tensor(ROLL_DONE))


def _assert_step_matches(qp, qv, done, r, ref):
    jq, jv, jd, jr = ref
    np.testing.assert_allclose(qp.numpy(), jq, atol=5e-5, rtol=0)
    np.testing.assert_allclose(qv.numpy(), jv, atol=1e-3 * np.abs(jv).max(), rtol=0)
    np.testing.assert_array_equal(done.numpy(), jd)
    np.testing.assert_allclose(r.numpy(), jr, atol=2e-5, rtol=0)


def test_rollout_plain_matches_jax_rollout_env_step(clip, jax_rollout):
    frame0, steps = jax_rollout
    qpos, qvel, targets, rqvs, done = _rollout_inputs(clip, frame0)
    for t in range(1, ROLL_T + 1):
        qp, qv, rewards, dn = tk.rollout_plain(qpos, qvel, targets[:t], rqvs[:t], done,
                                               fall_height=0.3, **KW)
        assert rewards.shape == (t, ROLL_N)
        _assert_step_matches(qp, qv, dn, rewards[-1], steps[t - 1])
    # frozen instances never moved and earned nothing
    assert (rewards[:, [2, 4]] == 0).all()
    assert torch.equal(qp[[2, 4]], qpos[[2, 4]])


def _physics_env(clip):
    # dt / substeps == H exactly (SUBSTEPS is a power of two)
    env = tenv.PhysicsTrackingEnv(clip.qpos, clip.qvel, dt=H * SUBSTEPS, substeps=SUBSTEPS,
                                  device="cpu")
    assert env.engine.h == H
    return env


def _start_state(env, frame0):
    st = env.reset(ROLL_N, stagger=True)
    assert np.array_equal(st.frame.numpy(), frame0)
    return tenv.PhysicsState(st.frame, st.qpos, st.qvel, torch.tensor(ROLL_DONE))


def test_physics_env_step_matches_jax(clip, jax_rollout):
    frame0, steps = jax_rollout
    env = _physics_env(clip)
    s = _start_state(env, frame0)
    for t in range(ROLL_T):
        s, r = env.step(s)
        _assert_step_matches(s.qpos, s.qvel, s.done, r, steps[t])
        np.testing.assert_array_equal(s.frame.numpy(), (frame0 + 1 + t) % len(clip.qpos))


def test_physics_env_rollout_matches_steps_and_jax(clip, jax_rollout):
    frame0, steps = jax_rollout
    env = _physics_env(clip)
    state = _start_state(env, frame0)
    final, rewards = env.rollout(state, ROLL_T)
    s, rs = state, []
    for _ in range(ROLL_T):
        s, r = env.step(s)
        rs.append(r)
    # the same plain arithmetic in the same order: identical
    assert torch.equal(rewards, torch.stack(rs))
    assert torch.equal(final.qpos, s.qpos) and torch.equal(final.done, s.done)
    assert torch.equal(final.frame, s.frame)
    _assert_step_matches(final.qpos, final.qvel, final.done, rewards[-1], steps[-1])


def test_dynamics_env_step_is_the_control_step(frames):
    qpos, qvel, target, _ = (_t(a) for a in frames)
    eng = DynamicsEnv(substeps=SUBSTEPS)
    assert eng.h == pytest.approx(1.0 / 30.0 / SUBSTEPS)
    qp, qv = eng.step(qpos, qvel, target)
    ref = tk.control_step_plain(qpos, qvel, target, h=eng.h, substeps=SUBSTEPS)
    assert torch.equal(qp, ref[0]) and torch.equal(qv, ref[1])
    assert qp.shape == (8, NQ) and qv.shape == (8, NV)


@pytest.mark.parametrize("contacts,limits", [(False, True), (True, False), (False, False)])
def test_control_step_options_match_jax(frames, contacts, limits):
    """The contact and limit switches, one substep in float64."""
    qpos, qvel, target, _ = frames
    kw = dict(KW, substeps=1, contacts=contacts, limits=limits)
    qp, qv = tk.control_step_plain(*(_t(a, torch.float64) for a in frames[:3]), **kw)
    with jax.enable_x64(True):
        jq, jv = dp.control_step_components(*(_comps(a, jnp.float64) for a in frames[:3]),
                                            unroll=True, **kw)
        jq, jv = _stack(jq), _stack(jv)
    np.testing.assert_allclose(qp.numpy(), jq, atol=1e-8, rtol=0)
    np.testing.assert_allclose(qv.numpy(), jv, atol=1e-6, rtol=0)


def test_committed_header_equals_the_tables():
    with open(HEADER) as f:
        assert f.read() == tk.tables_header()


@pytest.mark.parametrize("fn", ["control_step_cuda", "rollout_cuda", "tracking_reward_cuda"])
def test_cuda_wrappers_refuse_cpu_tensors(frames, fn):
    qpos, qvel, target, rqv = (_t(a) for a in frames)
    calls = {
        "control_step_cuda": lambda: tk.control_step_cuda(qpos, qvel, target, h=H, substeps=1),
        "rollout_cuda": lambda: tk.rollout_cuda(qpos, qvel, target[None], rqv[None],
                                                torch.zeros(8, dtype=torch.bool), h=H,
                                                substeps=1),
        "tracking_reward_cuda": lambda: tk.tracking_reward_cuda(qpos, qvel, target, rqv),
    }
    launches = getattr(tk, fn).launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        calls[fn]()
    assert getattr(tk, fn).launches == launches
