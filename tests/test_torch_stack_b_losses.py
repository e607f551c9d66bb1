"""The port's stack-B and stack-C training losses against the JAX package's:
``mse_loss``, the KL losses, ``angle_velocity_loss``, ``v_training_loss``
and ``v4_training_loss`` (eps and x0 loss spaces, with and without a frame
mask and importance weights, and its per-sample losses).

The JAX losses draw their noise from a key; the port takes the same draw.
A fixed nonlinear map stands in for the denoiser on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.diffusion import process as JP
from deepmimic_diffusion_mujoco_tpu.diffusion import schedules as JS
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import process as TP
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import schedules as TS

torch.set_num_threads(2)

B, H, D, T = 4, 16, 12, 50
LOSS_TOL = 2e-6      # f32, the same arithmetic in another order


def _t(a):
    return torch.from_numpy(np.array(a))


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(B, H, D)).astype(np.float32)
    W = (rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32)
    t = np.array([0, 3, 27, T - 1], np.int32)
    key = jax.random.PRNGKey(seed + 1)
    noise = np.asarray(jax.random.normal(key, x0.shape, jnp.float32))
    mask = np.ones((B, H), np.float32)
    mask[1, 10:] = 0.0
    mask[3, 4:] = 0.0
    t_weights = rng.uniform(0.5, 2.0, size=B).astype(np.float32)

    def jmodel(x, tt):
        return jnp.tanh(x @ W) + 0.01 * tt[:, None, None]

    def tmodel(x, tt):
        return torch.tanh(x @ _t(W)) + 0.01 * tt[:, None, None]

    return dict(x0=x0, t=t, key=key, noise=noise, mask=mask, t_weights=t_weights,
                jmodel=jmodel, tmodel=tmodel,
                jsched=JS.make_schedule("cosine", T, convention="v4"),
                tsched=TS.make_schedule("cosine", T, convention="v4", device="cpu"))


def _close(ours, ref):
    np.testing.assert_allclose(np.asarray(ours.detach()), np.asarray(ref), rtol=LOSS_TOL,
                               atol=LOSS_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_mse_loss_matches(masked):
    s = _setup(1)
    pred = s["noise"] * 0.5 + 0.1
    mask = s["mask"] if masked else None
    _close(TP.mse_loss(_t(pred), _t(s["x0"]), None if mask is None else _t(mask)),
           JP.mse_loss(jnp.asarray(pred), jnp.asarray(s["x0"]),
                       None if mask is None else jnp.asarray(mask)))


def test_kl_divergence_loss_matches():
    s = _setup(2)
    x_t = s["x0"] + s["noise"]
    x0_hat = 0.9 * s["x0"] + 0.05
    _close(TP.kl_divergence_loss(s["tsched"], _t(s["x0"]), _t(x_t), _t(x0_hat), _t(s["t"])),
           JP.kl_divergence_loss(s["jsched"], jnp.asarray(s["x0"]), jnp.asarray(x_t),
                                 jnp.asarray(x0_hat), jnp.asarray(s["t"])))


@pytest.mark.parametrize("predict_x0", [True, False])
def test_kl_training_loss_matches(predict_x0):
    s = _setup(3)
    ref, _ = JP.kl_training_loss(s["jsched"], s["jmodel"], jnp.asarray(s["x0"]),
                                 jnp.asarray(s["t"]), s["key"], predict_x0=predict_x0)
    ours, info = TP.kl_training_loss(s["tsched"], s["tmodel"], _t(s["x0"]), _t(s["t"]),
                                     _t(s["noise"]), predict_x0=predict_x0)
    _close(ours, ref)
    assert info == {}


def test_angle_velocity_loss_matches():
    s = _setup(4)
    ref, ref_info = JP.angle_velocity_loss(s["jsched"], s["jmodel"], jnp.asarray(s["x0"]),
                                           jnp.asarray(s["t"]), s["key"], smooth_loss_weight=0.3)
    ours, info = TP.angle_velocity_loss(s["tsched"], s["tmodel"], _t(s["x0"]), _t(s["t"]),
                                        _t(s["noise"]), smooth_loss_weight=0.3)
    _close(ours, ref)
    assert info.keys() == ref_info.keys()
    for k in info:
        _close(info[k], ref_info[k])


@pytest.mark.parametrize("masked", [False, True])
def test_v_training_loss_matches(masked):
    s = _setup(5)
    mask = s["mask"] if masked else None
    ref, _ = JP.v_training_loss(s["jsched"], s["jmodel"], jnp.asarray(s["x0"]),
                                jnp.asarray(s["t"]), s["key"],
                                None if mask is None else jnp.asarray(mask))
    ours, _ = TP.v_training_loss(s["tsched"], s["tmodel"], _t(s["x0"]), _t(s["t"]),
                                 _t(s["noise"]), None if mask is None else _t(mask))
    _close(ours, ref)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("predict_x0", [True, False])
@pytest.mark.parametrize("loss_space", ["eps", "x0"])
def test_v4_training_loss_matches(loss_space, predict_x0, masked, weighted):
    """Unweighted: the global (masked) mean; weighted: the mean of weighted
    per-sample means; per_sample_loss in both."""
    s = _setup(6)
    mask = s["mask"] if masked else None
    w = s["t_weights"] if weighted else None
    ref, ref_info = JP.v4_training_loss(
        s["jsched"], s["jmodel"], jnp.asarray(s["x0"]), jnp.asarray(s["t"]), s["key"],
        predict_x0=predict_x0, mask=None if mask is None else jnp.asarray(mask),
        t_weights=None if w is None else jnp.asarray(w), loss_space=loss_space)
    ours, info = TP.v4_training_loss(
        s["tsched"], s["tmodel"], _t(s["x0"]), _t(s["t"]), _t(s["noise"]),
        predict_x0=predict_x0, mask=None if mask is None else _t(mask),
        t_weights=None if w is None else _t(w), loss_space=loss_space)
    _close(ours, ref)
    _close(info["per_sample_loss"], ref_info["per_sample_loss"])
    if not weighted and masked:
        # the global masked mean, not the mean of per-sample means
        assert abs(ours.item() - info["per_sample_loss"].mean().item()) > 1e-4
