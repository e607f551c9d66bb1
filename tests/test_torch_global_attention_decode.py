"""Local attention's global-attention inserts and KV-cache decode: the port
against the JAX package with converted weights, and the decode against the
port's own full causal forward.

Parameters and inputs come from numpy seeds; JAX runs jitted at "highest"
matmul precision (tests/conftest.py), the port on the CPU in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.models import local_attention as JLA
from deepmimic_diffusion_mujoco_tpu_torch.convert import local_transformer_from_flax
from deepmimic_diffusion_mujoco_tpu_torch.models import local_attention as LA
from test_torch_local_transformer import D, MODEL_TOL, SMALL, random_flax_params

torch.set_num_threads(2)

B, N = 2, 32
DECODE_FRAMES = 40  # more than two windows of 16


def _pair(streams, causal=False, **kw):
    """(jitted JAX apply, params, port model) of one small LocalTransformer."""
    args = dict(input_dim=D, max_seq_len=64, num_residual_streams=streams, causal=causal,
                **SMALL, **kw)
    jmodel = JLA.LocalTransformer(**args)
    params = random_flax_params(jmodel, (jnp.zeros((1, N, D)), jnp.zeros((1,))),
                                seed=31 + streams + 2 * causal)
    model = LA.LocalTransformer(**args)
    model.load_state_dict(local_transformer_from_flax(params), strict=True)
    return jmodel, params, model.eval()


@pytest.mark.parametrize("streams,layers", [(1, ()), (4, (2,))])
def test_global_attention_inserts_match_jax(streams, layers):
    """GlobalMHA before the chosen layers' local attention (every layer, or
    layer 2 of 2 with its own hyper-connection slot), with a prefix key
    mask: the whole forward within MODEL_TOL of JAX."""
    jmodel, params, model = _pair(streams, use_global_attn=True, global_attn_layers=layers)
    expected = {"0", "1"} if not layers else {"1"}
    assert set(model.global_attn) == expected
    if streams > 1:
        assert set(model.hc_global) == expected
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    t = np.array([5.0, 700.0], np.float32)
    mask = (np.arange(N)[None] < np.array([[N], [20]])).astype(np.float32)
    ref = np.asarray(jax.jit(jmodel.apply)(params, x, t, None, mask))
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(t),
                     mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(ours, ref, atol=MODEL_TOL, rtol=0)


@pytest.mark.parametrize("streams", [1, 4])
def test_decode_matches_jax_and_the_full_causal_forward(streams):
    """DECODE_FRAMES frames decoded one at a time through the ring buffer:
    each output within MODEL_TOL of JAX's decode step and of the port's full
    causal forward at that frame."""
    jmodel, params, model = _pair(streams, causal=True)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, DECODE_FRAMES, D)).astype(np.float32)
    t = np.array([3.0, 400.0], np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)  # pos_emb indexed by a traced step
    jstep = jax.jit(lambda c, xi, p: jmodel.apply(jparams, xi, t, cache=c, decode_pos=p))
    jcache = jmodel.init_decode_cache(B)
    cache = model.init_decode_cache(B)
    assert all(k.shape == (B, SMALL["heads"], SMALL["window_size"], SMALL["dim_head"])
               for k, _ in cache)
    with torch.no_grad():
        full = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
        for i in range(DECODE_FRAMES):
            ref, jcache = jstep(jcache, x[:, i:i + 1], i)
            out, cache = model(torch.from_numpy(x[:, i:i + 1]), torch.from_numpy(t),
                               cache=cache, decode_pos=i)
            assert out.shape == (B, 1, D)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=MODEL_TOL, rtol=0)
            np.testing.assert_allclose(out.numpy()[:, 0], full[:, i], atol=MODEL_TOL, rtol=0)


def test_decode_refuses_what_it_does_not_cover():
    _, _, model = _pair(1, causal=True)
    cache = model.init_decode_cache(1)
    with pytest.raises(ValueError, match="one frame"):
        model(torch.zeros(1, 2, D), torch.zeros(1), cache=cache, decode_pos=0)
    _, _, bidirectional = _pair(1)
    with pytest.raises(ValueError, match="causal"):
        bidirectional(torch.zeros(1, 1, D), torch.zeros(1),
                      cache=bidirectional.init_decode_cache(1), decode_pos=0)
