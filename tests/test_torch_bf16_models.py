"""The four denoisers at bf16 against the JAX package's at
``dtype=jnp.bfloat16``, from the same converted float32 parameters and the
same seeded numpy inputs, on the CPU.

Both packages build the model from one ``ModelConfig`` with ``bf16=True``
(each through its own factory). The JAX U-Net runs its Pallas conv block
(``use_pallas=True``) and the local transformer its Pallas attention
kernel, both through the Pallas interpreter: those are the forms the port
implements (B1's and B3's bf16 forms). The transformers' references run op
by op (``jax.disable_jit``): XLA rounds every bf16 primitive, but a fused
reduction may read an intermediate before its rounding, and the order the
flax source writes is the one fixed reference; the U-Net's runs compiled
(op by op its 33 interpreted kernels take about 23 s).

Every tolerance is relative to max |ref| and stands with its reason. A
bf16 rounding moves a value by up to 2^-8 = 3.9e-3 of it. Where the port
rounds where flax does, the two agree to the bit, as the MDM transformer
and the decoder do, and as each U-Net residual block does given the JAX
block's input; where a float32 sum taken in another order (the strided
conv, B3's sliced plan, the norms' statistics) flips one rounding, the
flip spreads through the layers that follow, GroupNorm's shared statistics
first. So each model is held by two bounds: on the largest difference, and
on the median one, which a spread leaves near the size of a few roundings.
The float32 port, a model that rounds nowhere, fails at least one of them
against the bf16 reference, and the test checks that it does.

Also here: the distances to the JAX forms the port does not implement
(the U-Net's default ``use_pallas=False``, the local transformer's "auto"
bucketed path), which operands each layer sees at bf16, a few chain steps
with injected noise against the JAX sampler, and ``cli.sample`` and
``cli.cfg_eval`` on runs whose ``config.json`` says ``"bf16": true``.
"""
import functools
import json
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from deepmimic_diffusion_mujoco_tpu import factory as jax_factory
from deepmimic_diffusion_mujoco_tpu.diffusion import conditioning as JC
from deepmimic_diffusion_mujoco_tpu.diffusion import sampling as JSam
from deepmimic_diffusion_mujoco_tpu.diffusion import schedules as JS
from deepmimic_diffusion_mujoco_tpu.ops.pallas import conv_block_kernel as JCK
from deepmimic_diffusion_mujoco_tpu.ops.pallas import fused_local_attention as JFK
from deepmimic_diffusion_mujoco_tpu.train.config import ModelConfig as JaxModelConfig
from deepmimic_diffusion_mujoco_tpu_torch import convert, factory
from deepmimic_diffusion_mujoco_tpu_torch.cli import cfg_eval as cfg_eval_cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import sample as cli
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import conditioning as TC
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import sampling as TSam
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import schedules as TS
from deepmimic_diffusion_mujoco_tpu_torch.models import precision as P
from deepmimic_diffusion_mujoco_tpu_torch.models import temporal_unet as TU
from deepmimic_diffusion_mujoco_tpu_torch.ops import fused_local_attention as FK
from deepmimic_diffusion_mujoco_tpu_torch.train.checkpoint import Checkpointer
from deepmimic_diffusion_mujoco_tpu_torch.train.config import ExperimentConfig, ModelConfig

torch.set_num_threads(2)

D, B, N = 35, 2, 32
CONFIGS = {  # a few layers, narrow widths; the Pallas forms in JAX
    "temporal": dict(channel_dim=16, use_pallas=True),
    "local_attention": dict(latent_dim=64, depth=2, n_heads=4, dim_head=16, window_size=16,
                            max_seq_len=64, num_classes=3, use_pallas=True),
    "transformer": dict(latent_dim=64, n_heads=4, num_layers=2, dim_feedforward=128,
                        max_seq_len=64, num_classes=3, conditioning="adaln"),
    "decoder": dict(latent_dim=64, n_heads=4, num_layers=2, max_seq_len=64),
}
CONVERT = {"temporal": convert.temporal_unet_from_flax,
           "local_attention": convert.local_transformer_from_flax,
           "transformer": convert.transformer_from_flax, "decoder": convert.decoder_from_flax}
# (max, median) of |port - JAX| / max |JAX| at bf16. Measured, max: MDM
# transformer and decoder 0, local transformer 4.1e-03, U-Net 9.7e-03; the
# float32 port 8.8e-03, 9.1e-03, 2.5e-02 and 1.1e-02 from the same
# references. Median: 0, 0, 0 and 4.1e-04; the float32 port 1.4e-03,
# 1.7e-03, 1.0e-03 and 1.5e-03. The MDM transformer and the decoder: a few
# flipped roundings at most. The local transformer: B3's and the norms'
# float32 sums in another order flip roundings in 7.6 % of its outputs. The
# U-Net: one flip in a strided conv's output spreads through every later
# GroupNorm (its blocks agree to the bit, given JAX's input), which takes its
# largest difference as far as the float32 port's; only the median tells the
# two apart at the whole-model level.
MODEL_TOL = {"temporal": (2e-2, 8e-4), "local_attention": (1e-2, 2e-4),
             "transformer": (2e-3, 2e-4), "decoder": (2e-3, 2e-4)}
# The JAX forms the port does not implement, against the port at bf16:
# the U-Net's jnp conv block rounds each conv output to bf16 before its
# GroupNorm and returns float32 (measured 1.1e-02); below N 1024 "auto" sends
# the local transformer to its bucketed path, which computes rotary, scores
# and softmax in bf16 (measured 5.4e-03).
OTHER_FORM_TOL = {"temporal": 3e-2, "local_attention": 3e-2}


def _draw(rng, name, shape):
    if name.endswith("kernel"):
        a = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
    elif name in ("scale", "gn_scale", "g"):
        a = 1.0 + 0.05 * rng.normal(size=shape)
    elif name in ("pos_emb", "embedding", "position_embed", "seq_queries"):
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


def _cfg(arch, bf16=True, **over):
    return dict(architecture=arch, input_dim=D, bf16=bf16, **{**CONFIGS[arch], **over})


def _args(arch, x, t, y):
    return (x, t, y) if arch in ("transformer", "local_attention") else (x, t)


def jax_model(arch, **over):
    return jax_factory.build_model(JaxModelConfig(**_cfg(arch, **over)))


@functools.lru_cache(maxsize=None)
def jax_pair(arch, **over):
    """(jitted JAX apply at bf16, numpy params)."""
    model = jax_model(arch, **over)
    sample = _args(arch, jnp.zeros((1, N, D)), jnp.zeros((1,), jnp.int32),
                   jnp.zeros((1,), jnp.int32))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *sample)
    rng = np.random.default_rng(len(arch))
    params = jax.tree_util.tree_map_with_path(lambda p, s: _draw(rng, p[-1].key, s.shape),
                                              shapes)
    return jax.jit(model.apply), params


@functools.lru_cache(maxsize=None)
def unet_traced():
    """The JAX U-Net at bf16, jitted once: (params, x, t) -> (output, each
    residual block's (input, time embedding, output))."""
    from deepmimic_diffusion_mujoco_tpu.models.temporal_unet import ResidualTemporalBlock
    import flax.linen as fnn

    model = jax_model("temporal")

    def run(p, x, t):
        seen = []

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, ResidualTemporalBlock):
                seen.append((args[0], args[1], out))
            return out

        with fnn.intercept_methods(record):
            return model.apply(p, x, t), seen

    return jax.jit(run)


def port_model(arch, bf16=True):
    _, params = jax_pair(arch)
    model = factory.build_model(ModelConfig(**_cfg(arch, bf16)), device="cpu")
    model.load_state_dict(CONVERT[arch](params), strict=True)
    return model.eval()


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, N, D)).astype(np.float32), np.array([3, 517], np.int32),
            np.array([1, 3], np.int32))


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's Pallas kernels through the interpreter, as its own
    CPU tests run them."""
    monkeypatch.setattr(JCK, "INTERPRET", True)
    monkeypatch.setattr(JFK, "INTERPRET", True)


def _jax_forward(arch, x, t, y, op_by_op=False, **over):
    apply, params = jax_pair(arch, **over)
    args = _args(arch, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    if op_by_op:
        with jax.disable_jit():
            ref = jax_model(arch, **over).apply(params, *args)
    elif arch == "temporal" and not over:
        ref = unet_traced()(params, *args)[0]
    else:
        ref = apply(params, *args)
    assert ref.dtype == jnp.float32
    return np.asarray(ref)


def _port_forward(model, arch, x, t, y):
    with torch.inference_mode():
        out = model(*_args(arch, *map(torch.from_numpy, (x, t, y))))
    assert out.dtype == torch.float32 and out.shape == (B, N, D)
    return out.numpy()


def _rel(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _within(a, ref, tol):
    """Both bounds of ``tol`` = (max, median) on |a - ref| / max |ref|."""
    d = np.abs(a - ref) / np.abs(ref).max()
    return float(d.max()) <= tol[0] and float(np.median(d)) <= tol[1]


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_bf16_forward_matches_jax(arch, interpret):
    x, t, y = _inputs()
    ref = _jax_forward(arch, x, t, y, op_by_op=arch != "temporal")
    out = _port_forward(port_model(arch), arch, x, t, y)
    assert np.isfinite(out).all()
    assert _within(out, ref, MODEL_TOL[arch])
    # the float32 port is no bf16 model
    out32 = _port_forward(port_model(arch, bf16=False), arch, x, t, y)
    assert not _within(out32, ref, MODEL_TOL[arch])


def test_unet_blocks_match_jax_given_its_inputs(interpret):
    """Each of the 16 residual blocks (two conv blocks through B1's bf16
    form, the time Dense on mish, the 1x1 residual conv) given the bf16
    input and time embedding the JAX block got: within one bf16 ulp of its
    output plus B1's float32 tolerance (measured: equal to the bit)."""
    x, t, _ = _inputs(3)
    seen = unet_traced()(jax_pair("temporal")[1], jnp.asarray(x), jnp.asarray(t))[1]
    blocks = port_model("temporal").res_blocks
    assert len(seen) == len(blocks) == 16

    def torch_bf16(a):
        assert a.dtype == jnp.bfloat16
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)

    with torch.inference_mode():
        for block, (xi, ti, oi) in zip(blocks, seen):
            out = block(torch_bf16(xi), torch_bf16(ti))
            ref = np.asarray(oi.astype(jnp.float32))
            assert out.dtype == torch.bfloat16
            d = np.abs(out.float().numpy() - ref)
            assert (d <= 2.0 ** -7 * np.abs(ref) + 1e-4).all()


@pytest.mark.parametrize("arch,over", [("temporal", {"use_pallas": False}),
                                       ("local_attention", {"use_pallas": "auto"})])
def test_distance_to_the_jax_forms_not_implemented(arch, over):
    x, t, y = _inputs(1)
    ref = _jax_forward(arch, x, t, y, **over)
    assert _rel(_port_forward(port_model(arch), arch, x, t, y), ref) <= OTHER_FORM_TOL[arch]


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_one_checkpoint_loads_into_float32_and_bf16(arch):
    """Parameters stay float32 at bf16: one converted flax tree loads
    strictly into both, with the same parameters."""
    m32, m16 = port_model(arch, bf16=False), port_model(arch)
    sd32, sd16 = m32.state_dict(), m16.state_dict()
    assert sd32.keys() == sd16.keys()
    assert all(v.dtype == torch.float32 and torch.equal(v, sd32[k]) for k, v in sd16.items()
               if v.is_floating_point())


LAYERS = (nn.Linear, nn.Conv1d, nn.ConvTranspose1d, nn.Embedding, nn.LayerNorm)


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_every_layer_and_kernel_takes_bf16(arch, monkeypatch):
    """Hooks on the layers' functional calls, B1 and B3: every Dense and conv
    multiplies bf16 operands, every conv block and attention core gets bf16,
    no layer runs its own float32 forward, and the output is float32."""
    seen, bad = [], []

    def record(name, *tensors):
        seen.append(name)
        bad.extend(f"{name}: {t.dtype}" for t in tensors
                   if t is not None and t.dtype != torch.bfloat16)

    def hooked(name, fn, n_args):
        def call(*a, **k):
            record(name, *a[:n_args])
            return fn(*a, **k)
        return call

    fns = {n: getattr(F, n) for n in ("linear", "conv1d", "conv_transpose1d", "embedding")}
    monkeypatch.setattr(P, "F", type("F", (), {
        "linear": staticmethod(hooked("linear", fns["linear"], 2)),
        "conv1d": staticmethod(hooked("conv1d", fns["conv1d"], 2)),
        "conv_transpose1d": staticmethod(hooked("conv_transpose1d",
                                                fns["conv_transpose1d"], 2)),
        "embedding": staticmethod(hooked("embedding", fns["embedding"], 0)),
        "layer_norm": staticmethod(F.layer_norm)}))
    monkeypatch.setattr(TU, "conv_gn_mish", hooked("conv_gn_mish", TU.conv_gn_mish, 2))
    monkeypatch.setattr(FK, "fused_qkv_local_attention",
                        hooked("b3", FK.fused_qkv_local_attention, 1))
    model = port_model(arch)
    for m in model.modules():
        if isinstance(m, LAYERS):
            m.register_forward_pre_hook(lambda mod, inp: bad.append(type(mod).__name__))
    x, t, y = _inputs(2)
    out = _port_forward(model, arch, x, t, y)
    assert not bad, bad
    assert out.dtype == np.float32 and "linear" in seen
    kernel = {"temporal": "conv_gn_mish", "local_attention": "b3"}.get(arch)
    if kernel:
        assert seen.count(kernel) == (33 if arch == "temporal" else CONFIGS[arch]["depth"])


T_CHAIN, SHAPE = 4, (B, N, D)
# (max, median) of |port - JAX| / max |JAX| after the chain; the posterior's
# coefficients scale each step's model difference down. Measured: 1.5e-03 and
# 5.9e-05; with the float32 port's U-Net 7.4e-03 and 6.3e-04.
CHAIN_TOL = (4e-3, 2.5e-4)


def test_bf16_chain_steps_match_jax(monkeypatch, interpret):
    """Four posterior steps of the bf16 U-Net with injected noise: the chain
    state, the noise and the conditioner stay float32 around the bf16 model
    in both samplers. The same chain with the float32 port's U-Net falls
    outside CHAIN_TOL."""
    bank = [np.random.default_rng(s).normal(size=SHAPE).astype(np.float32)
            for s in range(T_CHAIN + 1)]
    params, apply = jax_pair("temporal")[1], unet_traced()
    q = deque(bank)
    real_normal = jax.random.normal

    def fake_normal(key, shape=(), dtype=jnp.float32):
        if tuple(shape) == SHAPE:
            return jnp.asarray(q.popleft(), dtype)
        return real_normal(key, shape, dtype)

    def model_fn(x, t, y):
        with jax.disable_jit(False):
            return apply(params, x, t)[0]

    sched = JS.make_schedule("cosine", T_CHAIN, convention="diffuser")
    with monkeypatch.context() as m, jax.disable_jit():
        m.setattr(JSam.jax.random, "normal", fake_normal)
        ref = JSam.sample_loop(sched, model_fn, SHAPE, jax.random.PRNGKey(0), mode="posterior",
                               conditioning_fn=JC.holding_box(D)).trajectories
    assert not q
    ref = np.asarray(ref)

    def port_chain(unet):
        tq, states = deque(bank), []

        def fake_randn(shape, generator=None, device=None, dtype=None):
            return torch.from_numpy(tq.popleft()).to(device=device, dtype=dtype)

        def model(x, t, y=None):  # the chain state goes in float32, the prediction comes out so
            out = unet(x, t, y)
            states.append((x.dtype, out.dtype))
            return out

        tsched = TS.make_schedule("cosine", T_CHAIN, convention="diffuser", device="cpu")
        with monkeypatch.context() as m, torch.inference_mode():
            m.setattr(TSam.torch, "randn", fake_randn)
            out = TSam.sample_loop(tsched, model, SHAPE,
                                   torch.Generator().manual_seed(0), mode="posterior",
                                   conditioning_fn=TC.holding_box(D, device="cpu")).trajectories
        assert out.dtype == torch.float32 and not tq
        assert states == [(torch.float32, torch.float32)] * T_CHAIN
        return out.numpy()

    out = port_chain(port_model("temporal"))
    assert _within(out, ref, CHAIN_TOL)
    np.testing.assert_array_equal(out[..., [13, 14, 15, 17, 18, 19]], 0.0)
    assert not _within(port_chain(port_model("temporal", bf16=False)), ref, CHAIN_TOL)


def _write_run(tmp_path, arch):
    """A run directory whose config.json says "bf16": true, with the
    converted weights (the same checkpoint a float32 run would hold)."""
    run = tmp_path / arch
    run.mkdir()
    model = {**_cfg(arch), "use_pallas": None}
    ExperimentConfig.from_dict({"model": model, "diffusion": {"noise_steps": 6}}).save(
        str(run / "config.json"))
    assert json.loads((run / "config.json").read_text())["model"]["bf16"] is True
    sd = port_model(arch, bf16=False).state_dict()
    Checkpointer(str(run / "checkpoints")).save_best(1, sd, sd, loss=0.5)
    return run


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_sample_cli_serves_a_bf16_run(tmp_path, arch):
    run = _write_run(tmp_path, arch)
    paths = cli.main(["--run", str(run), "--num", "2", "--frames", "16", "--conditioner",
                      "holding_box", "--device", "cpu", "--out", str(tmp_path / "out")])
    motions = np.stack([np.load(p) for p in paths])
    assert motions.shape == (2, 16, 35) and np.isfinite(motions).all()
    np.testing.assert_array_equal(motions[..., [13, 14, 15, 17, 18, 19]], 0.0)
    np.testing.assert_allclose(motions[..., [16, 20]], 1.57, rtol=1e-6)


def test_cfg_eval_cli_takes_a_bf16_run(tmp_path):
    run = _write_run(tmp_path, "transformer")
    report = cfg_eval_cli.main(["--run", str(run), "--scales", "0,3", "--num", "1",
                                "--frames", "24", "--device", "cpu"])
    assert report is not None


def test_cached_casts_follow_parameter_updates():
    """Serving keeps each parameter's bf16 copy between forwards; an update
    of the parameter (an optimizer step, load_state_dict) makes a new one,
    and where a gradient is recorded nothing is kept."""
    layer = nn.Linear(8, 4)
    with torch.inference_mode():
        first = P.cast(layer.weight, torch.bfloat16)
        assert P.cast(layer.weight, torch.bfloat16) is first
    with torch.no_grad():
        layer.weight.mul_(2.0)
        again = P.cast(layer.weight, torch.bfloat16)
    assert again is not first and torch.equal(again, layer.weight.detach().to(torch.bfloat16))
    fresh = P.cast(layer.weight, torch.bfloat16)
    assert fresh.requires_grad and fresh is not again
    model = port_model("decoder")
    inputs = _inputs(4)
    before = _port_forward(model, "decoder", *inputs)
    model.load_state_dict(port_model("decoder", bf16=False).state_dict())
    assert np.array_equal(_port_forward(model, "decoder", *inputs), before)
    with torch.no_grad():
        model.output_process.weight.mul_(0.5)
    assert not np.array_equal(_port_forward(model, "decoder", *inputs), before)
