"""Value guidance in the port against the JAX package's: the
``ValueFunction`` (the U-Net's down path and a Dense head) with converted
weights, ``value_gradients`` against ``jax.grad``, ``guided_step`` with the
converted dim-16 U-Net, a T 8 ``guided_sample_loop`` with the same
gaussians (sorted order included), and ``value_diffusion_loss`` with its
gradient.

Noise is drawn with numpy and handed out in draw order: on the JAX side in
place of ``jax.random.normal`` with the chain run under
``jax.disable_jit`` (the scan then runs step by step), on the port's side
in place of ``torch.randn``, as ``tests/test_torch_sampling.py`` does.
"""
import functools
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.diffusion import conditioning as JC
from deepmimic_diffusion_mujoco_tpu.diffusion import guidance as JG
from deepmimic_diffusion_mujoco_tpu.diffusion import schedules as JS
from deepmimic_diffusion_mujoco_tpu.models.temporal_unet import ValueFunction as JaxValue
from deepmimic_diffusion_mujoco_tpu_torch.convert import value_function_from_flax
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import conditioning as TC
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import guidance as TG
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import schedules as TS
from deepmimic_diffusion_mujoco_tpu_torch.models.temporal_unet import ValueFunction
from test_torch_temporal_unet import jax_unet, torch_unet

torch.set_num_threads(2)

D, B, T = 35, 3, 8
TOL = 1e-5        # max abs error of values, steps and losses
GRAD_TOL = 1e-4   # max abs error of a gradient / JAX's max |gradient|
GUIDE = dict(scale=0.1, t_stopgrad=2, n_guide_steps=2)


def _draw(rng, name, shape):
    if name.endswith("kernel"):
        a = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
    elif name == "gn_scale":
        a = 1.0 + 0.05 * rng.normal(size=shape)
    else:
        a = 0.05 * rng.normal(size=shape)
    return a.astype(np.float32)


@functools.lru_cache(maxsize=None)
def value_pair(horizon: int, dim: int = 16):
    """(jitted flax apply, numpy params, port ValueFunction) of one seeded init."""
    jm = JaxValue(transition_dim=D, dim=dim)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, horizon, D)),
                            jnp.zeros((1,)))
    rng = np.random.default_rng(horizon + dim)
    params = jax.tree_util.tree_map_with_path(lambda p, s: _draw(rng, p[-1].key, s.shape), shapes)
    model = ValueFunction(D, horizon, dim=dim)
    model.load_state_dict(value_function_from_flax(params), strict=True)
    return jax.jit(jm.apply), params, model.eval()


def _inputs(horizon, seed=0):
    """x and t (0, 3, 5): below T-1, where the cosine schedule's 1 / sqrt(alpha
    bar) (163 at T 8) would multiply the U-Net's rounding in x0_hat."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, horizon, D)).astype(np.float32), np.array([0, 3, 5], np.int32))


@pytest.mark.parametrize("horizon", [32, 64])
def test_value_function_matches_jax(horizon):
    """H 32 ends its mid blocks at 2 and 1 rows; H 64 at 4 and 2."""
    apply, params, model = value_pair(horizon)
    x, t = _inputs(horizon)
    t[-1] = T - 1
    ref = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert ours.shape == (B,)
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)


def test_converter_is_strict_and_counts_every_parameter():
    _, params, model = value_pair(32)
    n_flax = sum(np.size(a) for a in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_flax
    assert len(model.res_blocks) == 10 and len(model.downsamples) == 5
    tree = {**params["params"], "mystery": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(KeyError, match="mystery"):
        value_function_from_flax({"params": tree})
    with pytest.raises(ValueError, match="horizon"):
        model(torch.zeros(1, 16, D), torch.zeros(1))


def _jax_value(apply, params):
    def value_fn(x, t):
        with jax.disable_jit(False):
            return apply(params, x, t)
    return value_fn


def test_value_gradients_match_jax_grad():
    apply, params, model = value_pair(32)
    x, t = _inputs(32, seed=1)
    y_ref, g_ref = JG.value_gradients(_jax_value(apply, params), jnp.asarray(x), jnp.asarray(t))
    y, g = TG.value_gradients(model, torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=TOL, rtol=0)
    g_ref = np.asarray(g_ref)
    assert np.abs(g.numpy() - g_ref).max() <= GRAD_TOL * np.abs(g_ref).max()
    assert not g.requires_grad and not y.requires_grad


def _scheds():
    return (JS.make_schedule("cosine", T, convention="diffuser"),
            TS.make_schedule("cosine", T, convention="diffuser", device="cpu"))


def test_guided_step_matches_jax(monkeypatch):
    """Two nudges up the value gradient (no nudge where t < t_stopgrad),
    the conditioner after each, then the posterior step of the converted
    dim-16 U-Net, with the same noise."""
    apply, params, model = value_pair(32)
    _, uparams, uapply = jax_unet(16, False)
    unet = torch_unet(16, False)
    x, t = _inputs(32, seed=2)
    noise = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    jsched, tsched = _scheds()
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32: jnp.asarray(noise, dtype))
    (x_ref, y_ref) = JG.guided_step(
        jsched, lambda xx, tt: uapply(uparams, xx, tt), _jax_value(apply, params),
        jnp.asarray(x), jnp.asarray(t), jax.random.PRNGKey(0),
        conditioning_fn=JC.holding_box(D), **GUIDE)
    with torch.no_grad():
        out, y = TG.guided_step(tsched, unet, model, torch.from_numpy(x), torch.from_numpy(t),
                                torch.from_numpy(noise), conditioning_fn=TC.holding_box(D, "cpu"),
                                **GUIDE)
    np.testing.assert_allclose(out.numpy(), np.asarray(x_ref), atol=TOL, rtol=0)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=TOL, rtol=0)


def test_guided_sample_loop_matches_jax(monkeypatch):
    """The T 8 chain with the same gaussians (one initial draw, then one per
    step): trajectories and final values, sorted highest first. The
    denoiser is a fixed x0 map, which keeps every step O(1)."""
    apply, params, model = value_pair(32)
    bank = [np.random.default_rng(10 + i).normal(size=(B, 32, D)).astype(np.float32)
            for i in range(T + 1)]
    jsched, tsched = _scheds()
    jq, tq = deque(bank), deque(bank)
    real_normal = jax.random.normal

    def fake_normal(key, shape=(), dtype=jnp.float32):
        if tuple(shape) == (B, 32, D):
            return jnp.asarray(jq.popleft(), dtype)
        return real_normal(key, shape, dtype)

    def fake_randn(shape, generator=None, device=None, dtype=None):
        assert tuple(shape) == (B, 32, D)
        return torch.from_numpy(tq.popleft()).to(device=device, dtype=dtype)

    kw = dict(GUIDE, predict_epsilon=False)
    with monkeypatch.context() as m, jax.disable_jit():
        m.setattr(jax.random, "normal", fake_normal)
        ref, v_ref = JG.guided_sample_loop(
            jsched, lambda xx, tt: 0.8 * jnp.tanh(xx), _jax_value(apply, params), (B, 32, D),
            jax.random.PRNGKey(0), conditioning_fn=JC.holding_box(D), **kw)
    with monkeypatch.context() as m:
        m.setattr(TG.torch, "randn", fake_randn)
        out, values = TG.guided_sample_loop(
            tsched, lambda xx, tt: 0.8 * torch.tanh(xx), model, (B, 32, D),
            torch.Generator().manual_seed(0), conditioning_fn=TC.holding_box(D, "cpu"), **kw)
    assert not jq and not tq
    v_ref = np.asarray(v_ref)
    assert (np.diff(values.numpy()) <= 0).all() and (np.diff(v_ref) <= 0).all()
    np.testing.assert_allclose(values.numpy(), v_ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(out.trajectories.numpy(), np.asarray(ref.trajectories),
                               atol=TOL, rtol=0)


def test_value_diffusion_loss_and_gradient_match_jax():
    apply, params, model = value_pair(32)
    x0, t = _inputs(32, seed=4)
    rng = np.random.default_rng(5)
    target = rng.normal(size=(B,)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    jsched, tsched = _scheds()
    real_normal = jax.random.normal

    def loss(p):
        jax.random.normal = lambda key, shape=(), dtype=jnp.float32: jnp.asarray(noise, dtype)
        try:
            return JG.value_diffusion_loss(jsched, (lambda pp, x, tt: apply(pp, x, tt), p),
                                           jnp.asarray(x0), jnp.asarray(target), jnp.asarray(t),
                                           jax.random.PRNGKey(0))[0]
        finally:
            jax.random.normal = real_normal

    l_ref, g_ref = jax.value_and_grad(loss)(params)
    model.zero_grad(set_to_none=True)
    ours, info = TG.value_diffusion_loss(tsched, model, torch.from_numpy(x0),
                                         torch.from_numpy(target), torch.from_numpy(t),
                                         torch.from_numpy(noise))
    ours.backward()
    assert info == {}
    np.testing.assert_allclose(ours.item(), float(l_ref), atol=TOL, rtol=0)
    ref = value_function_from_flax(jax.tree_util.tree_map(np.asarray, g_ref))
    scale = max(v.abs().max().item() for v in ref.values())
    for k, p in model.named_parameters():
        err = (p.grad - ref[k]).abs().max().item()
        assert err <= GRAD_TOL * scale, (k, err, scale)
