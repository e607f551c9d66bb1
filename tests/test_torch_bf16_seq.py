"""bf16 models under a horizon split over two gloo ranks, and the bf16
KV-cache decode, against the port's one-process bf16 forward and the JAX
package's bf16 forward, on the CPU.

The models are ``tests/test_torch_bf16_models.py``'s (the dim-16 U-Net, and
the local transformer with a ``GlobalMHA`` insert before its second layer),
built with ``bf16=True`` from the same converted float32 parameters, at H 64:
32 frames a rank. The ranks run ``tests/_torch_seq_workers.py``
(``bf16_seq_worker``): one forward of each model on the rank's frames (the
U-Net's conv blocks through K1 / K2's bf16 plain forms, the local
transformer's attention through K3's) and a 5-step posterior chain of the
U-Net with holding_box. JAX's references are unsharded: the U-Net compiled
with its Pallas conv block interpreted, the local transformer op by op
(``tests/test_torch_bf16_models.py`` says why).

Bounds are (max, median) of |d| / max |ref|, the pair
``tests/test_torch_bf16_models.py`` holds each model to (MODEL_TOL); the
float32 port fails each against the bf16 reference, and the tests check
that it does. Measured: the split forwards equal the one-process bf16
forwards to the bit, and JAX's at (7.3e-3, 3.2e-4) for the U-Net and to the
bit for the local transformer (the float32 port: (1.9e-2, 1.5e-3) and
(5.8e-3, 8.0e-4)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_seq_workers as W
from deepmimic_diffusion_mujoco_tpu.models import local_attention as JLA
from deepmimic_diffusion_mujoco_tpu.ops.pallas import conv_block_kernel as JCK
from deepmimic_diffusion_mujoco_tpu.ops.pallas import fused_local_attention as JFK
from deepmimic_diffusion_mujoco_tpu_torch.convert import local_transformer_from_flax
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import conditioning
from deepmimic_diffusion_mujoco_tpu_torch.models.local_attention import LocalTransformer
from deepmimic_diffusion_mujoco_tpu_torch.parallel.launch import spawn_ranks
from test_torch_bf16_models import CONVERT, MODEL_TOL, _cfg, _jax_forward, _within, jax_pair
from test_torch_local_transformer import SMALL, random_flax_params

torch.set_num_threads(2)

SPAWN_TIMEOUT = 240.0
B, H, D = 2, 64, W.D
GLOBAL = dict(use_global_attn=True, global_attn_layers=(2,))
ARCHS = {"unet": ("temporal", {}), "la": ("local_attention", GLOBAL)}
CHAIN_SHAPE = (B, H, D)
# The split chain against the one-process bf16 chain: the chain's float32 state differs in
# its last bits between the two (tests/test_torch_seq_unet.py holds the float32 chains to
# rtol 1e-4), and a flipped bf16 rounding in the model spreads through GroupNorm. Measured
# (7.6e-3, 0); the float32 port's chain lies about 1e-3 from the bf16 chain in the median.
SPLIT_CHAIN_TOL = (2e-2, 1e-4)
# The bf16 decode: against JAX's bf16 decode run op by op (measured: equal to the bit or a
# few flipped roundings, (4.4e-3, 0) at most; the float32 port's decode (5.8e-3, 8.7e-4)
# and more), and against the port's full causal bf16 forward, whose attention core is
# B3 in float32 where the decode rounds its rotary, scores and softmax to bf16 as JAX's
# decode does (measured (8.7e-3, 1.1e-3); JAX's own decode and causal forward part by
# (1.1e-2, 1.3e-3)).
DECODE_TOL = (1e-2, 2e-4)
DECODE_FULL_TOL = (2e-2, 3e-3)
DECODE_FRAMES = 40  # more than two windows of 16


@pytest.fixture(scope="module")
def interpret():
    """The JAX package's Pallas kernels through the interpreter, as its own
    CPU tests run them."""
    old = JCK.INTERPRET, JFK.INTERPRET
    JCK.INTERPRET = JFK.INTERPRET = True
    yield
    JCK.INTERPRET, JFK.INTERPRET = old


def _state(arch, **over):
    return {k: v.numpy() for k, v in CONVERT[arch](jax_pair(arch, **over)[1]).items()}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(B, H, D)).astype(np.float32), np.array([3, 517], np.int32),
            np.array([1, 3], np.int32))


@pytest.fixture(scope="module")
def models(inputs):
    """name -> (bf16 config dict, converted state, the forward's inputs)."""
    x, t, y = inputs
    return {name: (_cfg(arch, **over), _state(arch, **over),
                   (x, t) if arch == "temporal" else (x, t, y))
            for name, (arch, over) in ARCHS.items()}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, models):
    store = tmp_path_factory.mktemp("store")
    return spawn_ranks(W.bf16_seq_worker, 2, str(store), device="cpu",
                       args=(models, CHAIN_SHAPE), timeout=SPAWN_TIMEOUT, threads=1)


def _one_process(cfg, state, inputs, bf16=True):
    model = W.built({**cfg, "bf16": bf16}, state)
    with torch.inference_mode():
        return model(*map(torch.from_numpy, inputs)).numpy()


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_bf16_split_forward_matches_one_process_and_jax(two_ranks, models, inputs, interpret,
                                                        name):
    cfg, state, args = models[name]
    arch, over = ARCHS[name]
    got = np.concatenate([r[name] for r in two_ranks], axis=1)
    assert got.shape == (B, H, D) and np.isfinite(got).all()
    tol = MODEL_TOL[arch]
    assert _within(got, _one_process(cfg, state, args), tol)
    ref = _jax_forward(arch, *inputs, op_by_op=arch != "temporal", **over)
    assert _within(got, ref, tol)
    assert not _within(_one_process(cfg, state, args, bf16=False), ref, tol)


def test_bf16_split_chain_matches_one_process(two_ranks, models):
    """Five posterior steps of the bf16 U-Net with holding_box, split over two
    ranks, against the same chain in one process; the float32 port's chain
    falls outside the bound."""
    cfg, state, _ = models["unet"]
    got = np.concatenate([r["chain"] for r in two_ranks], axis=1)

    def one(bf16):
        return W.chain(W.built({**cfg, "bf16": bf16}, state), CHAIN_SHAPE, 3, None,
                       conditioning.holding_box(D, device="cpu")).numpy()

    ref = one(True)
    assert np.isfinite(got).all() and _within(got, ref, SPLIT_CHAIN_TOL)
    np.testing.assert_array_equal(got[..., [13, 14, 15, 17, 18, 19]], 0.0)
    assert not _within(one(False), ref, SPLIT_CHAIN_TOL)


def _decode_pair(streams, dim_head):
    """(flax model at bf16, params, port models at bf16 and float32) of a
    causal local transformer."""
    args = dict(input_dim=D, max_seq_len=64, num_residual_streams=streams, causal=True,
                **{**SMALL, "dim_head": dim_head})
    params = random_flax_params(JLA.LocalTransformer(**args),
                                (jnp.zeros((1, 32, D)), jnp.zeros((1,))), seed=31 + streams)
    ports = []
    for dtype in (torch.bfloat16, torch.float32):
        model = LocalTransformer(**args, dtype=dtype)
        model.load_state_dict(local_transformer_from_flax(params), strict=True)
        ports.append(model.eval())
    return JLA.LocalTransformer(**args, dtype=jnp.bfloat16, use_pallas=True), params, *ports


def _decoded(model, x, t):
    cache = model.init_decode_cache(B)
    outs = []
    with torch.no_grad():
        for i in range(x.shape[1]):
            out, cache = model(torch.from_numpy(x[:, i:i + 1]), torch.from_numpy(t),
                               cache=cache, decode_pos=i)
            outs.append(out.numpy())
    return np.concatenate(outs, axis=1), cache


@pytest.mark.parametrize("streams,dim_head", [(1, 32), (4, 16)])
def test_bf16_decode_matches_jax_and_the_full_causal_forward(streams, dim_head, interpret):
    """DECODE_FRAMES frames decoded one at a time at bf16 (ring buffers in
    bf16): against JAX's bf16 decode op by op and the port's full causal
    bf16 forward. dh 32 takes the scale as a bf16 constant (dh 16's is exact)."""
    jmodel, params, m16, m32 = _decode_pair(streams, dim_head)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, DECODE_FRAMES, D)).astype(np.float32)
    t = np.array([3.0, 400.0], np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jcache, refs = jmodel.init_decode_cache(B), []
    with jax.disable_jit():
        for i in range(DECODE_FRAMES):
            out, jcache = jmodel.apply(jparams, x[:, i:i + 1], t, cache=jcache, decode_pos=i)
            refs.append(np.asarray(out))
    ref = np.concatenate(refs, axis=1)
    got, cache = _decoded(m16, x, t)
    assert all(k.dtype == v.dtype == torch.bfloat16 for k, v in cache)
    assert got.dtype == np.float32 and _within(got, ref, DECODE_TOL)
    assert not _within(_decoded(m32, x, t)[0], ref, DECODE_TOL)
    with torch.no_grad():
        full = m16(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert _within(got, full, DECODE_FULL_TOL)
