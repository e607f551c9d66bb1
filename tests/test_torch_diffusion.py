"""The port's schedules, process formulas, conditioners and timestep
embedding against the JAX package's, on the same numpy inputs."""
from dataclasses import fields

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.diffusion import conditioning as JC
from deepmimic_diffusion_mujoco_tpu.diffusion import process as JP
from deepmimic_diffusion_mujoco_tpu.diffusion import schedules as JS
from deepmimic_diffusion_mujoco_tpu.models.embeddings import sinusoidal_pos_emb as jax_emb
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import conditioning as TC
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import process as TP
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import schedules as TS
from deepmimic_diffusion_mujoco_tpu_torch.models.embeddings import sinusoidal_pos_emb

torch.set_num_threads(2)

B, H, D, T = 3, 16, 35, 50


@pytest.mark.parametrize("timesteps", [20, 1000])
@pytest.mark.parametrize("kind,convention", [
    ("cosine", "diffuser"), ("cosine", "v4"), ("linear", "v4")])
def test_schedule_tables_match(kind, convention, timesteps):
    ref = JS.make_schedule(kind, timesteps, convention=convention)
    ours = TS.make_schedule(kind, timesteps, convention=convention, device="cpu")
    assert ours.num_timesteps == timesteps
    for f in fields(JS.Schedule):
        np.testing.assert_allclose(getattr(ours, f.name).numpy(),
                                   np.asarray(getattr(ref, f.name)), atol=1e-7, rtol=0,
                                   err_msg=f.name)


def _scheds():
    return (JS.make_schedule("cosine", T, convention="diffuser"),
            TS.make_schedule("cosine", T, convention="diffuser", device="cpu"))


def _arrays(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, D)).astype(np.float32) for _ in range(n)]


T_IDX = np.array([0, 7, T - 1])
T_PREV = np.array([-1, 3, T - 6])  # -1: DDIM's final step

# name -> number of (B, H, D) input arrays
PROCESS = {
    "q_sample": 2,
    "predict_start_from_noise": 2,
    "predict_noise_from_start": 2,
    "predict_v": 2,
    "predict_start_from_v": 2,
    "q_posterior": 2,
    "ddpm_step": 3,
    "posterior_step": 3,
}


def _call(mod, sched, name, arrays, t, conv):
    a = [conv(x) for x in arrays]
    t = conv(t)
    if name in ("q_sample", "predict_v"):                # (x0, t, noise)
        return getattr(mod, name)(sched, a[0], t, a[1])
    if name == "q_posterior":                            # (x0, x_t, t)
        return mod.q_posterior(sched, a[0], a[1], t)
    if name == "ddpm_step":                              # (x_t, t, eps, noise)
        return mod.ddpm_step(sched, a[0], t, a[1], a[2])
    if name == "posterior_step":                         # (x_t, t, x0, noise)
        return mod.posterior_step(sched, a[0], t, a[1], a[2])
    return getattr(mod, name)(sched, a[0], t, a[1])      # (x_t, t, other)


def _np(out):
    if isinstance(out, tuple):
        return [_np(o) for o in out]
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


@pytest.mark.parametrize("name", sorted(PROCESS))
def test_process_function_matches(name):
    jsched, tsched = _scheds()
    arrays = _arrays(PROCESS[name])
    ref = _np(_call(JP, jsched, name, arrays, T_IDX, jnp.asarray))
    ours = _np(_call(TP, tsched, name, arrays, T_IDX, torch.from_numpy))
    for o, r in zip(ours if name == "q_posterior" else [ours],
                    ref if name == "q_posterior" else [ref]):
        np.testing.assert_allclose(o, r, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_step_matches(eta):
    jsched, tsched = _scheds()
    x, x0, eps, noise = _arrays(4, seed=1)
    args = (x, T_IDX, T_PREV, x0, eps, noise)
    ref = JP.ddim_step(jsched, *map(jnp.asarray, args), eta)
    ours = TP.ddim_step(tsched, *map(torch.from_numpy, args), eta)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


def _conditioner_pair(name):
    rng = np.random.default_rng(7)
    clip_a = rng.normal(size=(H, D)).astype(np.float32)
    clip_b = rng.normal(size=(H, D)).astype(np.float32)
    cpu = {"device": "cpu"}
    if name == "identity":
        return JC.identity, TC.identity
    if name == "masked_overwrite":
        mask = (rng.random((1, H, D)) > 0.5).astype(np.float32)
        return JC.masked_overwrite(mask, clip_a[None]), TC.masked_overwrite(mask, clip_a[None], **cpu)
    if name == "clamp_dims":
        dims = {0: 0.5, 7: -1.0, 34: 2.0}
        return JC.clamp_dims(dims, D), TC.clamp_dims(dims, D, **cpu)
    if name == "holding_box":
        return JC.holding_box(D), TC.holding_box(D, **cpu)
    if name == "clamp_frame0":
        f0 = rng.normal(size=(B, 20)).astype(np.float32)
        return JC.clamp_frame0(f0), TC.clamp_frame0(f0, **cpu)
    if name == "clamp_frames":
        args = (clip_a, [0, 3, 15], slice(2, 30))
        return JC.clamp_frames(*args), TC.clamp_frames(*args, **cpu)
    if name == "inbetween":
        return JC.inbetween(clip_a, clip_b, H, 4), TC.inbetween(clip_a, clip_b, H, 4, **cpu)
    if name == "blend":
        (s1, j), (s2, t) = JC.blend(clip_a[:8], clip_b[:8], 2), TC.blend(clip_a[:8], clip_b[:8], 2, **cpu)
        np.testing.assert_array_equal(s1, s2)
        return j, t
    if name == "steer_root":
        path = rng.normal(size=(5, 2)).astype(np.float32)
        return (JC.steer_root(path, H, D, frames=[0, 2, 4, 6, 8]),
                TC.steer_root(path, H, D, frames=[0, 2, 4, 6, 8], **cpu))
    if name == "chain":
        return (JC.chain(JC.holding_box(D), JC.clamp_dims({13: 3.0}, D)),
                TC.chain(TC.holding_box(D, **cpu), TC.clamp_dims({13: 3.0}, D, **cpu)))
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "identity", "masked_overwrite", "clamp_dims", "holding_box", "clamp_frame0",
    "clamp_frames", "inbetween", "blend", "steer_root", "chain"])
def test_conditioner_matches(name):
    jfn, tfn = _conditioner_pair(name)
    (x,) = _arrays(1, seed=9)
    np.testing.assert_array_equal(tfn(torch.from_numpy(x)).numpy(), np.asarray(jfn(jnp.asarray(x))))


def test_holding_box_clamps_exactly():
    x = torch.randn(2, H, D)
    out = TC.holding_box(D, device="cpu")(x)
    assert (out[..., [13, 14, 15, 17, 18, 19]] == 0).all()
    assert (out[..., [16, 20]] == 1.57).all()
    torch.testing.assert_close(out[..., :13], x[..., :13], rtol=0, atol=0)


@pytest.mark.parametrize("dim", [16, 128])
def test_sinusoidal_pos_emb_matches(dim):
    """Equal to JAX at small timesteps; at t near 1000 the angles reach ~1e3,
    where one float32 ulp is 6.1e-5 and the two libraries' exp/sin differ
    in the last bit, so there both are held to the float64 value instead."""
    small = np.array([0, 1, 17], np.float32)
    np.testing.assert_allclose(sinusoidal_pos_emb(torch.from_numpy(small), dim).numpy(),
                               np.asarray(jax_emb(jnp.asarray(small), dim)), atol=1e-6, rtol=0)
    t = np.array([0, 1, 17, 500, 999], np.float32)
    half = dim // 2
    ang = t[:, None].astype(np.float64) * np.exp(np.log(10000.0) / (half - 1) * -np.arange(half))
    exact = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    ulp = np.spacing(np.float32(1000.0))
    for out in (sinusoidal_pos_emb(torch.from_numpy(t), dim).numpy(),
                np.asarray(jax_emb(jnp.asarray(t), dim))):
        np.testing.assert_allclose(out, exact, atol=ulp, rtol=0)
