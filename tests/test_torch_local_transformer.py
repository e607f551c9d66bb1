"""The port's local-attention transformer against the JAX package's, with
converted weights: the hyper-connections, the feed-forward's norm and GELU,
the whole ``LocalTransformer`` (its attention through the kernel route's
plain versions on the CPU), and the sampling CLI on a local-attention run.

Inputs and parameters come from numpy seeds; the JAX side runs jitted at
"highest" matmul precision (tests/conftest.py), the port on the CPU in
float32.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepmimic_diffusion_mujoco_tpu.models import hyper_connections as jhc
from deepmimic_diffusion_mujoco_tpu.models import local_attention as JLA
from deepmimic_diffusion_mujoco_tpu.train.config import ExperimentConfig as JaxConfig
from deepmimic_diffusion_mujoco_tpu_torch.cli import sample as cli
from deepmimic_diffusion_mujoco_tpu_torch.convert import local_transformer_from_flax
from deepmimic_diffusion_mujoco_tpu_torch.models import hyper_connections as hc
from deepmimic_diffusion_mujoco_tpu_torch.models import local_attention as LA
from deepmimic_diffusion_mujoco_tpu_torch.ops import fused_local_attention as FK
from deepmimic_diffusion_mujoco_tpu_torch.train.checkpoint import Checkpointer

torch.set_num_threads(2)

D = 69
HC_TOL = 1e-6
FF_TOL = 1e-5
MODEL_TOL = 1e-4  # f32 through depth 2; rotary at absolute vs relative positions
SMALL = dict(dim=64, depth=2, heads=4, dim_head=16, window_size=16)
BOX_ZERO, BOX_ELBOW = [13, 14, 15, 17, 18, 19], [16, 20]


def _draw(rng, name, shape):
    """A parameter of flax's ``shape`` named ``name``: kernels N(0, 1/fan_in),
    norm scales 1 + N(0, 0.05^2), the hyper-connections' dynamic weights and
    scales large enough that their tanh terms matter, biases N(0, 0.05^2)."""
    if name == "kernel":
        a = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
    elif name == "scale":
        a = 1.0 + 0.05 * rng.normal(size=shape)
    elif name in ("pos_emb", "embedding"):
        a = rng.normal(size=shape)
    elif name in ("dynamic_alpha_fn", "dynamic_beta_fn"):
        a = rng.normal(size=shape) / np.sqrt(shape[0])
    elif name in ("dynamic_alpha_scale", "dynamic_beta_scale"):
        a = 0.3 + 0.1 * rng.normal(size=shape)
    elif name in ("static_alpha", "static_beta"):
        a = 0.5 + 0.3 * rng.normal(size=shape)
    else:
        a = 0.05 * rng.normal(size=shape)
    return a.astype(np.float32)


def random_flax_params(model, sample_args, seed: int):
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *sample_args)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(lambda p, s: _draw(rng, p[-1].key, s.shape), shapes)


@functools.lru_cache(maxsize=None)
def jax_transformer(streams: int, num_classes: int, max_seq_len: int = 384, dpb: bool = False):
    """(flax model, numpy params, jitted apply) of a small LocalTransformer."""
    model = JLA.LocalTransformer(input_dim=D, max_seq_len=max_seq_len,
                                 num_residual_streams=streams, num_classes=num_classes,
                                 use_dynamic_pos_bias=dpb, **SMALL)
    params = random_flax_params(model, (jnp.zeros((1, 32, D)), jnp.zeros((1,))),
                                seed=17 * streams + num_classes + dpb)
    return model, params, jax.jit(model.apply)


def torch_transformer(streams: int, num_classes: int, max_seq_len: int = 384,
                      dpb: bool = False) -> LA.LocalTransformer:
    _, params, _ = jax_transformer(streams, num_classes, max_seq_len, dpb)
    model = LA.LocalTransformer(D, max_seq_len=max_seq_len, num_residual_streams=streams,
                                num_classes=num_classes, use_dynamic_pos_bias=dpb, **SMALL)
    model.load_state_dict(local_transformer_from_flax(params), strict=True)
    return model.eval()


@pytest.mark.parametrize("streams,num_classes,dpb", [(4, 3, False), (1, 0, False), (1, 0, True)])
def test_converted_state_dict_loads_strict(streams, num_classes, dpb):
    _, params, _ = jax_transformer(streams, num_classes, dpb=dpb)
    model = LA.LocalTransformer(D, max_seq_len=384, num_residual_streams=streams,
                                num_classes=num_classes, use_dynamic_pos_bias=dpb, **SMALL)
    result = model.load_state_dict(local_transformer_from_flax(params), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    n_flax = sum(np.size(a) for a in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_flax


def test_converter_refuses_unknown_parameters():
    _, params, _ = jax_transformer(1, 0)
    tree = {**params["params"], "mystery": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(KeyError, match="mystery"):
        local_transformer_from_flax({"params": tree})


@pytest.mark.parametrize("streams", [4, 2])
def test_hyper_connection_matches_flax(streams):
    dim, layer = 32, 5
    jmod = jhc.HyperConnection(streams, layer)
    rng = np.random.default_rng(streams)
    x = rng.normal(size=(2, 7, streams, dim)).astype(np.float32)
    params = random_flax_params(jmod, (jnp.zeros((1, 3, streams, dim)),), seed=streams)
    ref = jax.jit(jmod.apply)(params, jnp.asarray(x))
    ours_mod = hc.HyperConnection(dim, streams, layer)
    flat = params["params"]
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in flat.items() if k != "norm"}
    sd["norm.scale"] = torch.from_numpy(np.asarray(flat["norm"]["scale"]))
    ours_mod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        ours = ours_mod(torch.from_numpy(x))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=HC_TOL, rtol=0)
    branch = rng.normal(size=(2, 7, dim)).astype(np.float32)
    np.testing.assert_allclose(
        hc.depth_connection(torch.from_numpy(branch), ours[1], ours[2]).numpy(),
        np.asarray(jhc.depth_connection(jnp.asarray(branch), ref[1], ref[2])),
        atol=HC_TOL, rtol=0)
    np.testing.assert_array_equal(hc.expand_streams(torch.from_numpy(x[:, :, 0]), streams).numpy(),
                                  np.asarray(jhc.expand_streams(jnp.asarray(x[:, :, 0]), streams)))
    np.testing.assert_allclose(hc.reduce_streams(torch.from_numpy(x)).numpy(),
                               np.asarray(jhc.reduce_streams(jnp.asarray(x))), atol=HC_TOL, rtol=0)


def test_hyper_connection_init_matches_flax():
    """Freshly built, the port's parameters equal flax's initial values."""
    jmod = jhc.HyperConnection(4, 6)
    params = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 4, 8)))["params"]
    ours = hc.HyperConnection(8, 4, 6).state_dict()
    assert ours.keys() == {*(k for k in params if k != "norm"), "norm.scale"}
    for k, v in params.items():
        ref = v["scale"] if k == "norm" else v
        np.testing.assert_array_equal(ours["norm.scale" if k == "norm" else k].numpy(),
                                      np.asarray(ref))


def test_feed_forward_pins_flax_eps_and_tanh_gelu():
    """flax's LayerNorm eps is 1e-6 (torch's default 1e-5) and nn.gelu is the
    tanh approximation: inputs of tiny variance and a wide gate range show
    both against the JAX GEGLU block."""
    dim = 64
    jmod = JLA.GEGLUFeedForward()
    x = (1e-3 * np.random.default_rng(0).normal(size=(2, 9, dim))).astype(np.float32)
    params = random_flax_params(jmod, (jnp.zeros((1, 3, dim)),), seed=1)
    ref = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x)))
    ff = LA.GEGLUFeedForward(dim)
    p = params["params"]
    ff.load_state_dict({
        "norm.weight": torch.from_numpy(np.asarray(p["LayerNorm_0"]["scale"])),
        "norm.bias": torch.from_numpy(np.asarray(p["LayerNorm_0"]["bias"])),
        "proj_in.weight": torch.from_numpy(np.asarray(p["Dense_0"]["kernel"]).T.copy()),
        "proj_out.weight": torch.from_numpy(np.asarray(p["Dense_1"]["kernel"]).T.copy()),
    }, strict=True)
    assert ff.proj_out.in_features == int(dim * 4 * 2 / 3) and ff.norm.eps == 1e-6
    with torch.no_grad():
        ours = ff(torch.from_numpy(x)).numpy()
        ff.norm.eps = 1e-5
        torch_eps = ff(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, atol=FF_TOL, rtol=0)
    assert np.abs(torch_eps - ref).max() > 100 * FF_TOL
    g = torch.linspace(-6, 6, 101)
    np.testing.assert_allclose(F.gelu(g, approximate="tanh").numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(g.numpy()))), atol=1e-6)
    assert (F.gelu(g) - F.gelu(g, approximate="tanh")).abs().max() > 1e-4


def test_local_transformer_full_width_ff_inner():
    """At the config's dim 512 the GEGLU inner width is int(512 * 4 * 2/3)."""
    assert LA.GEGLUFeedForward(512).proj_out.in_features == 1365


@pytest.mark.parametrize("horizon", [32, 40, 384])
@pytest.mark.parametrize("streams,num_classes", [(4, 0), (4, 3), (1, 3)])
def test_forward_matches_jax(streams, num_classes, horizon):
    _, params, apply = jax_transformer(streams, num_classes)
    model = torch_transformer(streams, num_classes)
    assert all(m.uses_kernel(horizon) for m in model.attn)  # the kernel route's plain version
    rng = np.random.default_rng(horizon + streams)
    x = rng.normal(size=(2, horizon, D)).astype(np.float32)
    t = np.array([3, 917], np.int32)
    y = np.array([1, num_classes], np.int32) if num_classes else None
    ref = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(t),
                           None if y is None else jnp.asarray(y)))
    calls = []
    real = FK.fused_qkv_local_attention_plain

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    FK.fused_qkv_local_attention_plain = counted
    try:
        with torch.no_grad():
            ours = model(torch.from_numpy(x), torch.from_numpy(t),
                         None if y is None else torch.from_numpy(y)).numpy()
    finally:
        FK.fused_qkv_local_attention_plain = real
    assert len(calls) == SMALL["depth"]
    assert ours.shape == (2, horizon, D)
    np.testing.assert_allclose(ours, ref, atol=MODEL_TOL, rtol=0)


def test_forward_with_prefix_key_mask_matches_jax():
    _, params, apply = jax_transformer(4, 3)
    model = torch_transformer(4, 3)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 40, D)).astype(np.float32)
    t = np.array([5, 600], np.int32)
    mask = (np.arange(40)[None, :] < np.array([[40], [23]])).astype(np.float32)
    ref = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(t), None, jnp.asarray(mask)))
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(t), None, torch.from_numpy(mask))
    np.testing.assert_allclose(ours.numpy(), ref, atol=MODEL_TOL, rtol=0)


def test_forward_with_dynamic_position_bias_matches_jax():
    """Rotary off and a bias table on: the bucketed path, not the kernel's."""
    _, params, apply = jax_transformer(1, 0, dpb=True)
    model = torch_transformer(1, 0, dpb=True)
    assert not any(m.uses_kernel(48) for m in model.attn)
    x = np.random.default_rng(12).normal(size=(2, 48, D)).astype(np.float32)
    t = np.array([0, 999], np.int32)
    ref = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(ours, ref, atol=MODEL_TOL, rtol=0)


def test_unsupported_options_raise_naming_roadmap():
    """The global inserts and the KV-cache decode are ported (held against
    JAX in tests/test_torch_global_attention_decode.py): both run here; the
    decode refuses a bidirectional model; a horizon past max_seq_len still
    raises."""
    model = LA.LocalTransformer(D, use_global_attn=True, **SMALL).eval()
    with torch.no_grad():
        assert model(torch.zeros(1, 16, D), torch.zeros(1)).shape == (1, 16, D)
    model = torch_transformer(1, 0)
    x = torch.zeros(1, 1, D)
    with pytest.raises(ValueError, match="causal"):
        model(x, torch.zeros(1), cache=model.init_decode_cache(1), decode_pos=0)
    causal = LA.LocalTransformer(D, causal=True, **SMALL).eval()
    with torch.no_grad():
        out, cache = causal(x, torch.zeros(1), cache=causal.init_decode_cache(1), decode_pos=0)
    assert out.shape == (1, 1, D) and len(cache) == SMALL["depth"]
    with pytest.raises(ValueError, match="max_seq_len"):
        model(torch.zeros(1, 400, D), torch.zeros(1))


def _make_run(tmp_path, max_seq_len=32):
    cfg = JaxConfig.from_dict({
        "name": "port_local_attention",
        "model": {"architecture": "local_attention", "input_dim": D, "latent_dim": 32,
                  "depth": 1, "n_heads": 2, "dim_head": 16, "window_size": 16,
                  "max_seq_len": max_seq_len, "num_residual_streams": 4,
                  "attn_dropout": 0.3, "ff_dropout": 0.3},
        "diffusion": {"noise_steps": 8, "schedule_type": "cosine", "convention": "v4",
                      "predict_x0": True, "mode": "v4"},
    })
    cfg.save(str(tmp_path / "config.json"))
    jmodel = JLA.LocalTransformer(input_dim=D, max_seq_len=max_seq_len, dim=32, depth=1,
                                  heads=2, dim_head=16, window_size=16)
    params = random_flax_params(jmodel, (jnp.zeros((1, 16, D)), jnp.zeros((1,))), seed=3)
    sd = local_transformer_from_flax(params)
    Checkpointer(str(tmp_path / "checkpoints")).save_best(4, sd, sd, loss=0.5)
    return tmp_path


@pytest.mark.parametrize("frames", [32, 24])
def test_sample_cli_serves_local_attention(tmp_path, frames):
    run = _make_run(tmp_path)
    paths = cli.main(["--run", str(run), "--num", "2", "--frames", str(frames),
                      "--conditioner", "holding_box", "--out", str(tmp_path / "out"),
                      "--device", "cpu"])
    assert len(paths) == 2
    for p in paths:
        m = np.load(p)
        assert m.shape == (frames, 35) and np.isfinite(m).all()
        assert (m[:, BOX_ZERO] == 0).all() and (m[:, BOX_ELBOW] == np.float32(1.57)).all()


def test_sample_cli_refuses_frames_past_max_seq_len(tmp_path):
    run = _make_run(tmp_path)
    with pytest.raises(ValueError, match="max_seq_len"):
        cli.main(["--run", str(run), "--num", "1", "--frames", "40", "--device", "cpu",
                  "--out", str(tmp_path / "out")])
