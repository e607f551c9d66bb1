"""Full reverse chains of the port against the JAX sampler, same noise.

Both samplers draw gaussians in the same order (the initial draw unless a
starting motion is given, then one per step). The test pre-draws that
sequence with numpy and hands it out through a deque: on the JAX side in
place of ``jax.random.normal`` with the chain run under ``jax.disable_jit``
(so the scan runs step by step), on the port's side in place of
``torch.randn``. The denoiser is the converted dim-16 TemporalUnet; on the
JAX side its forward re-enables jit so it runs compiled.
"""
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.diffusion import conditioning as JC
from deepmimic_diffusion_mujoco_tpu.diffusion import sampling as JSam
from deepmimic_diffusion_mujoco_tpu.diffusion import schedules as JS
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import conditioning as TC
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import sampling as TSam
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import schedules as TS
from test_torch_temporal_unet import jax_unet, torch_unet

torch.set_num_threads(2)

B, H, D, T = 2, 16, 35, 20
SHAPE = (B, H, D)


def _bank(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=SHAPE).astype(np.float32) for _ in range(n)]


def _jax_chain(monkeypatch, bank, mode, denoiser, **kw):
    q = deque(bank)
    real_normal = jax.random.normal

    def fake_normal(key, shape=(), dtype=jnp.float32):
        if tuple(shape) == SHAPE:
            return jnp.asarray(q.popleft(), dtype)
        return real_normal(key, shape, dtype)

    _, params, apply = jax_unet(16, False) if denoiser == "unet" else (None, None, None)

    def model_fn(x, t, y):
        if denoiser != "unet":
            return 0.1 * x
        with jax.disable_jit(False):
            return apply(params, x, t)

    sched = JS.make_schedule("cosine", T, convention="diffuser")
    if "conditioning_fn" in kw:
        kw["conditioning_fn"] = JC.holding_box(D)
    with monkeypatch.context() as m, jax.disable_jit():
        m.setattr(JSam.jax.random, "normal", fake_normal)
        out = JSam.sample_loop(sched, model_fn, SHAPE, jax.random.PRNGKey(0), mode=mode, **kw)
    assert not q, "JAX chain drew fewer gaussians than expected"
    return out


def _torch_chain(monkeypatch, bank, mode, denoiser, **kw):
    q = deque(bank)

    def fake_randn(shape, generator=None, device=None, dtype=None):
        assert tuple(shape) == SHAPE
        return torch.from_numpy(q.popleft()).to(device=device, dtype=dtype)

    model_fn = torch_unet(16, False) if denoiser == "unet" else (lambda x, t, y: 0.1 * x)
    sched = TS.make_schedule("cosine", T, convention="diffuser", device="cpu")
    if "conditioning_fn" in kw:
        kw["conditioning_fn"] = TC.holding_box(D, device="cpu")
    with monkeypatch.context() as m:
        m.setattr(TSam.torch, "randn", fake_randn)
        out = TSam.sample_loop(sched, model_fn, SHAPE, torch.Generator().manual_seed(0),
                               mode=mode, **kw)
    assert not q, "port chain drew fewer gaussians than expected"
    return out


# name -> (mode, denoiser, gaussians drawn, sample_loop options). The
# untrained U-Net's epsilon is far from the true noise, so without clipping
# x0_hat grows to ~1e3 at the chain's start; its chains clip (the stack-A
# default) to keep values O(1) and atol meaningful. The unclipped update is
# covered with the stand-in denoiser, whose values stay O(1).
CASES = {
    "posterior_box_chain": ("posterior", "unet", T + 1,
                            dict(conditioning_fn=True, return_chain=True, clip_denoised=True)),
    "ddim5_box_chain": ("ddim", "unet", 6,
                        dict(ddim_steps=5, conditioning_fn=True, return_chain=True,
                             clip_denoised=True)),
    "posterior_start_motion": ("posterior", "unet", 8,
                               dict(starting_motion=True, t_start=8, conditioning_fn=True,
                                    clip_denoised=True)),
    "ddim_start_motion": ("ddim", "unet", 4,
                          dict(starting_motion=True, t_start=12, ddim_steps=4,
                               clip_denoised=True)),
    "posterior_standin": ("posterior", "standin", T + 1, dict(conditioning_fn=True)),
    "ddim_standin_eta": ("ddim", "standin", T + 1, dict(eta=0.5)),
    "v4_standin": ("v4", "standin", T, dict(clip_denoised=True)),
    "ddpm_standin_x0": ("ddpm", "standin", T + 1, dict(predict_epsilon=False)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_matches_jax(monkeypatch, case):
    mode, denoiser, n_draws, kw = CASES[case]
    start = None
    if kw.get("starting_motion"):
        start = np.random.default_rng(11).normal(size=(H, D)).astype(np.float32)
    bank = _bank(n_draws, seed=len(case))
    jkw = {**kw, "starting_motion": None if start is None else jnp.asarray(start)}
    tkw = {**kw, "starting_motion": start}
    ref = _jax_chain(monkeypatch, bank, mode, denoiser, **jkw)
    ours = _torch_chain(monkeypatch, bank, mode, denoiser, **tkw)

    x = ours.trajectories.numpy()
    np.testing.assert_allclose(x, np.asarray(ref.trajectories), atol=1e-4, rtol=0)
    if kw.get("return_chain"):
        assert ours.chain.shape == ref.chain.shape
        np.testing.assert_allclose(ours.chain.numpy(), np.asarray(ref.chain), atol=1e-4, rtol=0)
    else:
        assert ours.chain is None
    if kw.get("conditioning_fn"):
        assert (x[..., [13, 14, 15, 17, 18, 19]] == 0).all()
        assert (x[..., [16, 20]] == np.float32(1.57)).all()


def test_unknown_mode_raises():
    sched = TS.make_schedule("cosine", T, device="cpu")
    with pytest.raises(ValueError, match="unknown sampling mode"):
        TSam.sample_loop(sched, lambda x, t, y: x, SHAPE, torch.Generator(), mode="bogus")


def test_cfg_lerp_batched_matches_two_calls():
    calls = []

    def model_fn(x, t, y):
        calls.append(x.shape[0])
        return x * (1.0 + y.to(x.dtype)[:, None, None])

    x = torch.randn(SHAPE)
    t = torch.full((B,), 3)
    y, uy = torch.full((B,), 2), torch.full((B,), 5)
    batched = TSam._model_prediction(model_fn, x, t, y, 3.0, uy, cfg_batched=True)
    split = TSam._model_prediction(model_fn, x, t, y, 3.0, uy, cfg_batched=False)
    assert calls == [2 * B, B, B]
    torch.testing.assert_close(batched, split)
    torch.testing.assert_close(batched, x * (1 + 5) + 3.0 * (x * 3 - x * 6))
