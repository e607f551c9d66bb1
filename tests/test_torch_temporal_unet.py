"""The port's TemporalUnet against the JAX package's, with converted weights.

Inputs and perturbed parameters come from numpy seeds; the JAX side runs
jitted at "highest" matmul precision (tests/conftest.py), the port on the
CPU in float32 through the conv block's plain version.
"""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.models.temporal_unet import TemporalUnet as JaxUnet
from deepmimic_diffusion_mujoco_tpu_torch.convert import temporal_unet_from_flax
from deepmimic_diffusion_mujoco_tpu_torch.models.temporal_unet import TemporalUnet

torch.set_num_threads(2)

D = 35


def random_flax_params(model, seed: int):
    """numpy params in the model's flax tree, drawn from a seed: kernels
    N(0, 1/fan_in), scales 1 + N(0, 0.05^2), biases N(0, 0.05^2), so a
    mis-mapped bias or scale shows too."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, D)),
                            jnp.zeros((1,)))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name.endswith("kernel"):
            a = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("gn_scale", "g"):
            a = 1.0 + 0.05 * rng.normal(size=s.shape)
        else:
            a = 0.05 * rng.normal(size=s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def jax_unet(dim: int, attention: bool):
    """(flax model, numpy params, jitted apply)."""
    model = JaxUnet(transition_dim=D, dim=dim, attention=attention)
    return model, random_flax_params(model, dim + attention), jax.jit(model.apply)


def torch_unet(dim: int, attention: bool) -> TemporalUnet:
    _, params, _ = jax_unet(dim, attention)
    model = TemporalUnet(D, dim=dim, attention=attention)
    model.load_state_dict(temporal_unet_from_flax(params), strict=True)
    return model.eval()


@pytest.mark.parametrize("attention", [False, True])
def test_converted_state_dict_loads_strict(attention):
    _, params, _ = jax_unet(16, attention)
    sd = temporal_unet_from_flax(params)
    model = TemporalUnet(D, dim=16, attention=attention)
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    n_flax = sum(np.size(a) for a in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_flax


@pytest.mark.parametrize("horizon", [16, 24, 48])
@pytest.mark.parametrize("attention", [False, True])
@pytest.mark.parametrize("dim", [16, 32])
def test_forward_matches_jax(dim, attention, horizon):
    _, params, apply = jax_unet(dim, attention)
    model = torch_unet(dim, attention)
    rng = np.random.default_rng(horizon)
    x = rng.normal(size=(2, horizon, D)).astype(np.float32)
    t = np.array([3, 17], np.int32)
    ref = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.inference_mode():
        out = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert out.shape == (2, horizon, D)
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)


def test_conv_transpose_mapping_flips_kernel():
    """flax ConvTranspose(4, stride 2, "SAME") == torch ConvTranspose1d(4, 2,
    padding=1) only with the kernel flipped along k, as convert maps it."""
    C, H = 6, 8
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, H, C)).astype(np.float32)
    layer = fnn.ConvTranspose(C, (4,), strides=(2,), padding="SAME")
    params = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)).astype(np.float32), params)
    ref = np.asarray(layer.apply(params, jnp.asarray(x)))

    sd = temporal_unet_from_flax({"ConvTranspose_0": params["params"]})
    conv = torch.nn.ConvTranspose1d(C, C, 4, stride=2, padding=1)
    conv.load_state_dict({"weight": sd["upsamples.0.weight"], "bias": sd["upsamples.0.bias"]})
    with torch.no_grad():
        out = conv(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
        assert out.shape == (2, 2 * H, C)
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)

        kernel = params["params"]["kernel"]
        conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(kernel.transpose(1, 2, 0))))
        unflipped = conv(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    assert np.abs(unflipped - ref).max() > 1e-2


def test_horizon_must_divide_downsample_factor():
    model = TemporalUnet(D, dim=16)
    with pytest.raises(ValueError, match="divisible by 8"):
        model(torch.zeros(1, 12, D), torch.zeros(1))
