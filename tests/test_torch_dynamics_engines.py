"""The port's dense engine against the JAX package's, and the three engines
against each other and against the whole-control-step algebra.

Float64, N 6 walk frames, every other one pushed 0.3 m down so that
contacts engage, seeded velocities and torques, limits on, the PD's kd
integrated implicitly (`tests/test_dynamics.py:291-331`'s inputs). The JAX
side runs once for the module, eagerly, with its unrolled 34-step solve and
the stages outside the nested jvp jitted (eager per-shape compiles of the
solve alone cost about 25 s); never a substep scan.
The env-last engines against JAX are in `test_torch_dynamics_env_last.py`.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.physics import dynamics as jd
from deepmimic_diffusion_mujoco_tpu_torch.data.mocap import load_clip
from deepmimic_diffusion_mujoco_tpu_torch.physics import dynamics as td
from deepmimic_diffusion_mujoco_tpu_torch.physics import dynamics_aba as ta
from deepmimic_diffusion_mujoco_tpu_torch.physics import dynamics_kernel as DK
from deepmimic_diffusion_mujoco_tpu_torch.physics import dynamics_lanes as tl
from deepmimic_diffusion_mujoco_tpu_torch.physics import env as tenv

torch.set_num_threads(2)

WALK = os.path.join(os.path.dirname(__file__), "..", "data", "motions", "humanoid3d_walk.txt")
H = 0.002
LAYOUTS = ["vmap", "lanes", "aba"]
JAX_JITTED = ("spd_solve_unrolled", "contact_terms", "body_jacobians", "passive_forces",
              "limit_forces", "integrate_qpos")


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


@pytest.fixture(scope="module")
def clip():
    return load_clip(WALK)


@pytest.fixture(scope="module")
def inputs(clip):
    """qpos, qvel, tau (6, 35/34/34) and kd (28,), float64 numpy."""
    rng = np.random.default_rng(3)
    idx = (np.arange(6) * 7) % len(clip.qpos)
    qpos = np.asarray(clip.qpos[idx], np.float64).copy()
    qpos[::2, 2] -= 0.3
    qvel = rng.normal(size=(6, 34)) * 1.5
    tau = rng.normal(size=(6, 34)) * 10.0
    return qpos, qvel, tau, np.asarray(jd.PD_KD, np.float64)


@pytest.fixture(scope="module")
def jax_dense(inputs):
    """JAX forward_dynamics (implicit h 0.002) and step_physics, vmapped."""
    qpos, qvel, tau, kd = inputs
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        for name in JAX_JITTED:
            mp.setattr(jd, name, jax.jit(getattr(jd, name)))
        args = (jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(tau))
        k = jnp.asarray(kd)
        qacc = jax.vmap(lambda a, b, c: jd.forward_dynamics(
            a, b, c, h_implicit=H, kd_extra=k))(*args)
        q1, v1 = jax.vmap(lambda a, b, c: jd.step_physics(a, b, c, H, kd_extra=k))(*args)
        return np.asarray(qacc), np.asarray(q1), np.asarray(v1)


def test_forward_dynamics_matches_jax(inputs, jax_dense):
    qpos, qvel, tau, kd = inputs
    qacc = td.forward_dynamics(_t(qpos), _t(qvel), _t(tau), h_implicit=H, kd_extra=_t(kd))
    np.testing.assert_allclose(qacc.numpy(), jax_dense[0], atol=1e-8)


def test_step_physics_matches_jax(inputs, jax_dense):
    qpos, qvel, tau, kd = inputs
    q1, v1 = td.step_physics(_t(qpos), _t(qvel), _t(tau), H, kd_extra=_t(kd))
    np.testing.assert_allclose(q1.numpy(), jax_dense[1], atol=1e-12)
    np.testing.assert_allclose(v1.numpy(), jax_dense[2], atol=1e-9)


@pytest.mark.parametrize("contacts", [False, True])
@pytest.mark.parametrize("h", [0.0, H])
def test_env_last_engines_match_dense_qacc(inputs, contacts, h):
    """lanes and aba solve the dense engine's system: qacc within 1e-8 in
    every mode (contacts on/off, explicit and implicitly damped)."""
    qpos, qvel, tau, kd = inputs
    kw = dict(contacts=contacts, limits=True, h_implicit=h, kd_extra=_t(kd))
    ref = td.forward_dynamics(_t(qpos), _t(qvel), _t(tau), **kw)
    args_T = (_t(qpos.T), _t(qvel.T), _t(tau.T))
    for fn in (tl.forward_dynamics_lanes, ta.forward_dynamics_aba):
        got = fn(*args_T, **kw)
        np.testing.assert_allclose(got.T.numpy(), ref.numpy(), atol=1e-8, err_msg=fn.__name__)


def test_env_last_steps_match_dense_step(inputs):
    qpos, qvel, tau, kd = inputs
    q1, v1 = td.step_physics(_t(qpos), _t(qvel), _t(tau), H, kd_extra=_t(kd))
    for fn, qtol, vtol in ((tl.step_physics_lanes, 1e-9, 1e-6),
                           (ta.step_physics_aba, 1e-12, 1e-9)):
        qT, vT = fn(_t(qpos.T), _t(qvel.T), _t(tau.T), H, kd_extra=_t(kd))
        np.testing.assert_allclose(qT.T.numpy(), q1.numpy(), atol=qtol, err_msg=fn.__name__)
        np.testing.assert_allclose(vT.T.numpy(), v1.numpy(), atol=vtol, err_msg=fn.__name__)


def test_trajectory_jets_equal_nested_jvp(inputs):
    """The body rates behind bias_forces are jax.jvp nested twice: held
    against torch.func.jvp nested twice through integrate_qpos and
    fk_dynamics, with one env at zero root angular velocity (the
    integrate_qpos guard keeps its derivatives finite)."""
    qpos, qvel, _, _ = inputs
    qvel = qvel[:2].copy()
    qvel[1, 3:6] = 0.0
    q, v = _t(qpos[:2]), _t(qvel)
    one = torch.ones((), dtype=torch.float64)

    def kin(dt):
        fk = td.fk_dynamics(td.integrate_qpos(q, v, dt))
        return fk.com_w, fk.body_quat

    def vel(dt):
        return torch.func.jvp(kin, (dt,), (one,))

    ((c, r), (dc, dr)), ((_, _), (ddc, ddr)) = torch.func.jvp(vel, (torch.zeros_like(one),),
                                                              (one,))
    com, quat = td._trajectory_jets(q, v)
    for got, want in zip((*com, *quat), (c, dc, ddc, r, dr, ddr)):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12)


def test_spd_solves_match_linalg_solve():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(5, 34, 34))
    M = a @ a.transpose(0, 2, 1) + 34 * np.eye(34)
    b = rng.normal(size=(5, 34))
    want = torch.linalg.solve(_t(M), _t(b))
    np.testing.assert_allclose(td.spd_solve_unrolled(_t(M), _t(b)).numpy(), want.numpy(),
                               atol=1e-12)
    got = tl.spd_solve_lanes(_t(M.transpose(1, 2, 0)), _t(b.T))
    np.testing.assert_allclose(got.T.numpy(), want.numpy(), atol=1e-12)


@pytest.fixture(scope="module")
def control_step_case(clip):
    """Walk frames targeting the next frame, f32, 4 substeps: the plain
    whole-control-step result as the reference."""
    idx = (np.arange(6) * 5) % len(clip.qpos)
    q = torch.tensor(clip.qpos[idx], dtype=torch.float32)
    v = torch.tensor(clip.qvel[idx], dtype=torch.float32)
    tgt = torch.tensor(clip.qpos[(idx + 1) % len(clip.qpos)], dtype=torch.float32)
    ref = DK.control_step_plain(q, v, tgt, h=1.0 / 30.0 / 4, substeps=4)
    return q, v, tgt, ref


@pytest.mark.parametrize("layout", LAYOUTS)
def test_dynamics_env_step_matches_control_step(control_step_case, layout):
    """Each layout's control step in float32 within 5e-4 (qpos) of the
    whole-control-step algebra, the f32 cross-layout tolerance of
    tests/test_dynamics.py."""
    q, v, tgt, ref = control_step_case
    qp, qv = td.DynamicsEnv(substeps=4, layout=layout).step(q, v, tgt)
    assert qp.dtype == torch.float32 and qp.shape == q.shape and qv.shape == v.shape
    np.testing.assert_allclose(qp.numpy(), ref[0].numpy(), atol=5e-4)
    assert torch.isfinite(qv).all()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_dynamics_env_batched_matches_single(clip, layout):
    q = torch.tensor(clip.qpos[:3], dtype=torch.float32)
    v = torch.tensor(clip.qvel[:3], dtype=torch.float32)
    tgt = torch.tensor(clip.qpos[1:4], dtype=torch.float32)
    eng = td.DynamicsEnv(substeps=2, layout=layout)
    qb, vb = eng.step(q, v, tgt)
    for i in range(3):
        qi, vi = eng.step(q[i:i + 1], v[i:i + 1], tgt[i:i + 1])
        np.testing.assert_allclose(qb[i].numpy(), qi[0].numpy(), atol=2e-5)
        np.testing.assert_allclose(vb[i].numpy(), vi[0].numpy(), atol=2e-4)


def test_physics_env_aba_bookkeeping(clip):
    """PhysicsTrackingEnv(layout="aba"): step runs the engine then the
    reward; a done env holds its state at reward 0, an env that ends its
    step below the fall height is done, and rollout is step in a loop."""
    env = tenv.PhysicsTrackingEnv(clip.qpos, clip.qvel, substeps=2, layout="aba", device="cpu")
    s0 = env.reset(4)
    s0 = s0._replace(done=torch.tensor([False, True, False, False]))
    nxt = (s0.frame + 1) % env.num_frames
    want_q, want_v = env.engine.step(s0.qpos, s0.qvel, env.motion[nxt])
    live = ~s0.done
    # the lowest live env ends this step under the fall height
    low = int(torch.where(live, want_q[:, 2], torch.inf).argmin())
    env.fall_height = float(want_q[low, 2]) + 1e-6

    s1, r1 = env.step(s0)
    torch.testing.assert_close(s1.qpos[live], want_q[live], rtol=0, atol=0)
    torch.testing.assert_close(s1.qvel[live], want_v[live], rtol=0, atol=0)
    torch.testing.assert_close(s1.qpos[1], s0.qpos[1], rtol=0, atol=0)
    torch.testing.assert_close(s1.qvel[1], s0.qvel[1], rtol=0, atol=0)
    assert s1.done.tolist() == [i in (1, low) for i in range(4)]
    assert (r1[s1.done] == 0).all() and (r1[~s1.done] > 0).all()
    want_r = tenv.tracking_reward(s1.qpos, s1.qvel, env.motion[nxt], env.vel[nxt])
    torch.testing.assert_close(r1[~s1.done], want_r[~s1.done], rtol=0, atol=0)
    assert torch.equal(s1.frame, nxt)

    final, rewards = env.rollout(s0, 3)
    s, rs = s0, []
    for _ in range(3):
        s, r = env.step(s)
        rs.append(r)
    assert rewards.shape == (3, 4)
    torch.testing.assert_close(rewards, torch.stack(rs), rtol=0, atol=0)
    torch.testing.assert_close(final.qpos, s.qpos, rtol=0, atol=0)
    assert torch.equal(final.done, s.done) and torch.equal(final.frame, s.frame)
