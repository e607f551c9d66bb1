"""TemporalUnet parameter gradients of the port (the conv block's backward
with its dW from ``ops/conv_weight_grad.py``) against ``jax.grad`` of the
JAX package's model, from the same converted weights.

The flax -> torch converter is linear (transposes, a flip, slicing), so the
JAX gradients map through it onto the port's parameters. Tolerance: each
tensor's max error within 1e-4 of its largest gradient (f32 sums in
another order through 33 conv blocks).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu_torch.convert import temporal_unet_from_flax
from test_torch_temporal_unet import D, jax_unet, torch_unet

torch.set_num_threads(2)

GRAD_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _jax_grad(dim, attention):
    model, _, _ = jax_unet(dim, attention)

    def loss(params, x, t, cot):
        return jnp.sum(model.apply(params, x, t) * cot)

    return jax.jit(jax.grad(loss))


@pytest.mark.parametrize("dim,attention,horizon", [
    (16, False, 16), (16, False, 24), (16, False, 48),
    (16, True, 16), (16, True, 24), (16, True, 48),
    (32, False, 16), (32, True, 16),
])
def test_param_grads_match_jax(dim, attention, horizon):
    _, params, _ = jax_unet(dim, attention)
    rng = np.random.default_rng(horizon + dim)
    x = rng.normal(size=(2, horizon, D)).astype(np.float32)
    cot = rng.normal(size=(2, horizon, D)).astype(np.float32)
    t = np.array([3, 17], np.int32)
    jgrads = _jax_grad(dim, attention)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cot))
    ref = temporal_unet_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))

    model = torch_unet(dim, attention).train()
    (model(torch.from_numpy(x), torch.from_numpy(t)) * torch.from_numpy(cot)).sum().backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert grads.keys() == ref.keys()
    for k, g in ref.items():
        scale = max(g.abs().max().item(), 1e-12)
        err = (grads[k] - g).abs().max().item()
        assert err <= GRAD_TOL * scale, (k, err, scale)
