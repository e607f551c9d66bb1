"""Training at bf16 against the JAX package's, on the CPU: the dim-16 U-Net
and a small local-attention transformer through ``Trainer`` (three AdamW
steps from the same converted weights, batch, timesteps, noise and keep
masks), one gradient each of the MDM transformer and the decoder, value
guidance with a bf16 ``ValueFunction``, and ``cli.train`` on a bf16 config
of each architecture, whose run then serves through ``cli.sample``.

JAX builds each model at ``dtype=jnp.bfloat16`` with float32 parameters.
Its U-Net and ValueFunction take the Pallas conv block, the form the port
implements (B1's bf16 form), through the Pallas interpreter: the U-Net with
``use_pallas=True``, the ValueFunction (which has no such option) with the
reference routed to the Pallas block. The Pallas block's custom VJP cannot
take its own bf16 cotangent (``tests/test_torch_bf16_backward.py``), so the
fixture below registers the same VJP with the cotangent widened to float32,
the reading the port follows.

Tolerances, each relative to the largest JAX value and measured here. One
step's gradients are held by two bounds over all elements: the largest
difference (a gradient computed in bf16 in both frameworks, such as a bf16
bias's, can differ by a flipped rounding: 1-2 bf16 ulps of the largest
element) and the median (a few roundings). The float32 port, which rounds
nowhere, misses at least one of them, and each test checks that it does.
After a few AdamW steps each element has moved by about lr a step whatever
its gradient's size, so an element whose gradient is near zero, where one
flipped rounding flips its sign, may differ by up to 2 lr a step: the
parameters are held loosely (GRAD_TOL's reason, PARAM_*).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.diffusion import guidance as JG
from deepmimic_diffusion_mujoco_tpu.diffusion import process as JP
from deepmimic_diffusion_mujoco_tpu.diffusion import schedules as JS
from deepmimic_diffusion_mujoco_tpu.models import local_attention as JLA
from deepmimic_diffusion_mujoco_tpu.models.temporal_unet import TemporalUnet as JaxUnet
from deepmimic_diffusion_mujoco_tpu.models.temporal_unet import ValueFunction as JaxValue
from deepmimic_diffusion_mujoco_tpu.ops.pallas import conv_block_kernel as CK
from deepmimic_diffusion_mujoco_tpu.ops.pallas import fused_local_attention as JFK
from deepmimic_diffusion_mujoco_tpu.train import loop as JL
from deepmimic_diffusion_mujoco_tpu.train import state as JSt
from deepmimic_diffusion_mujoco_tpu_torch import factory
from deepmimic_diffusion_mujoco_tpu_torch.cli import sample as sample_cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import train as train_cli
from deepmimic_diffusion_mujoco_tpu_torch.convert import (
    local_transformer_from_flax,
    temporal_unet_from_flax,
    value_function_from_flax,
)
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import guidance as TG
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import schedules as TS
from deepmimic_diffusion_mujoco_tpu_torch.models import local_attention as LA
from deepmimic_diffusion_mujoco_tpu_torch.models import precision as P
from deepmimic_diffusion_mujoco_tpu_torch.models.temporal_unet import TemporalUnet, ValueFunction
from deepmimic_diffusion_mujoco_tpu_torch.train import loop as TL
from deepmimic_diffusion_mujoco_tpu_torch.train import state as TSt
from deepmimic_diffusion_mujoco_tpu_torch.train.checkpoint import Checkpointer
from deepmimic_diffusion_mujoco_tpu_torch.train.config import ExperimentConfig
import test_torch_bf16_models as BM
from test_torch_local_transformer import random_flax_params as la_flax_params
from test_torch_local_transformer_train import CONFIG as LA_CONFIG
from test_torch_local_transformer_train import P_DROP, SMALL, MaskFeed
from test_torch_local_transformer_train import TINY as LA_TINY
from test_torch_stack_b_train import FixedBatch as LabelledBatch
from test_torch_temporal_unet import random_flax_params as unet_flax_params
from test_torch_train import D, H, T, FixedBatch, _jax_draws, _t
from test_torch_train_cli import CLIP
from test_torch_train_cli import CONFIG as UNET_CONFIG
from test_torch_train_cli import TINY as UNET_TINY

torch.set_num_threads(2)

BF = torch.bfloat16
STEPS, LR = 3, 1e-3
# One step's gradients: (max, median) of |port - JAX| / max |JAX| over all elements.
# Measured, bf16 port: U-Net 5.2e-3 and 1.4e-5, local transformer 3.7e-3 and 1.5e-5, MDM
# transformer 9.1e-3 and 4.7e-5, decoder 7.9e-3 and 0; the float32 port 1.2e-2 and 4.3e-5,
# 3.0e-2 and 2.8e-5, 3.8e-2 and 1.6e-4, 6.8e-2 and 2.0e-4.
GRAD_TOL = {"temporal": (8e-3, 2.5e-5), "local_attention": (1e-2, 2.5e-5),
            "transformer": (1.5e-2, 1e-4), "decoder": (1.5e-2, 1e-4)}
LOSS_RTOL = 2e-3         # each logged loss (measured at most 5.3e-4 after 3 steps)
# Parameters after STEPS AdamW steps: the median element within PARAM_MEDIAN lr, PARAM_SHARE
# of them within 0.1 lr, every one within 2 lr a step (measured: median 0.0049 / 0.0026 lr,
# 98.0 / 99.5 % within 0.1 lr, the largest 4.4 / 2.3 lr for the U-Net / local transformer).
PARAM_MEDIAN, PARAM_SHARE = 0.05, 0.95
D_LA, T_LA = 69, 20      # the local transformer's input width and chain length


@pytest.fixture
def pallas_bf16(monkeypatch):
    """JAX's Pallas kernels through the interpreter; the conv block's VJP
    with the cotangent widened; the reference block routed to the Pallas
    one (the ValueFunction's)."""
    reference = CK.conv_gn_mish_reference

    def bwd(groups, eps, res, g):
        _, vjp = jax.vjp(lambda *a: reference(*a, groups, eps), *res)
        return vjp(g.astype(jnp.float32))

    monkeypatch.setattr(CK, "INTERPRET", True)
    monkeypatch.setattr(JFK, "INTERPRET", True)
    monkeypatch.setattr(CK.conv_gn_mish, "bwd", bwd)
    monkeypatch.setattr(CK, "conv_gn_mish_reference", CK.conv_gn_mish)


def _grad_distance(ours: dict, ref: dict):
    """(max, median) of |ours - ref| / max |ref| over every element."""
    scale = max(v.abs().max().item() for v in ref.values())
    assert ours.keys() == ref.keys()
    d = torch.cat([(ours[k] - v).abs().flatten() for k, v in ref.items()]) / scale
    return d.max().item(), d.median().item()


def _within(dist, tol) -> bool:
    return dist[0] <= tol[0] and dist[1] <= tol[1]


def _params_close(model, ref: dict):
    d = torch.cat([(model.state_dict()[k] - v).abs().flatten() for k, v in ref.items()])
    assert d.median().item() <= PARAM_MEDIAN * LR, d.median().item() / LR
    assert (d <= 0.1 * LR).float().mean().item() >= PARAM_SHARE
    assert d.max().item() <= 2 * STEPS * LR, d.max().item() / LR


def _recording_tx(grads: list):
    """JAX's AdamW behind a transform that keeps each step's gradients."""
    def update(updates, state, params=None):
        jax.debug.callback(lambda u: grads.append(jax.tree_util.tree_map(np.asarray, u)),
                           updates)
        return updates, state

    return optax.chain(optax.GradientTransformation(lambda p: optax.EmptyState(), update),
                       JSt.make_optimizer("adamw", lr=LR, betas=(0.9, 0.98),
                                          schedule="exponential"))


def _port_trainer(model, loss_fn, data, cfg, grads: list, num_timesteps: int):
    opt, sched = TSt.make_optimizer(model.parameters(), "adamw", lr=LR, betas=(0.9, 0.98),
                                    schedule="exponential")
    opt.register_step_pre_hook(lambda o, a, k: grads.append(
        {n: p.grad.clone() for n, p in model.named_parameters()}))
    state = TSt.TrainState(model, opt, sched, TSt.EMAConfig(0.9, 1, 1))
    return TL.Trainer(state, loss_fn, data, TL.TrainerConfig(**cfg), log_fn=lambda s: None,
                      num_timesteps=num_timesteps)


def _losses_match(trainer, jtrainer):
    assert len(trainer.metrics) == len(jtrainer.metrics) == STEPS
    for ours, ref in zip(trainer.metrics, jtrainer.metrics):
        assert ours["step"] == ref["step"]
        np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=LOSS_RTOL)
    assert trainer.best_step == jtrainer.best_step


def test_unet_trainer_steps_match_jax(pallas_bf16):
    """The dim-16 U-Net at bf16 (every conv block through B1's bf16 form and
    its backward) against JAX's Pallas U-Net."""
    jm = JaxUnet(transition_dim=D, dim=16, use_pallas=True, dtype=jnp.bfloat16)
    params = unet_flax_params(jm, 16)
    x0 = np.random.default_rng(5).normal(size=(2, H, D)).astype(np.float32)
    weights = JP.diffuser_loss_weights(H, D, 1.0, 1.0)
    cfg = dict(num_train_steps=STEPS, batch_size=2, log_every=1, seed=0)
    jgrads, tgrads = [], []
    tx = _recording_tx(jgrads)
    jtrainer = JL.Trainer(
        JSt.TrainState.create(params, tx, JSt.EMAConfig(decay=0.9, start=1, every=1)), tx,
        JL.make_loss_fn(JS.make_schedule("cosine", T, convention="diffuser"), jm.apply,
                        kind="diffuser", weights=weights),
        FixedBatch(x0), JL.TrainerConfig(**cfg), log_fn=lambda s: None, wrap_accum=False)
    jtrainer.train()

    def port(dtype):
        model = TemporalUnet(D, dim=16, dtype=dtype)
        model.load_state_dict(temporal_unet_from_flax(params), strict=True)
        return model, TL.make_loss_fn(TS.make_schedule("cosine", T, convention="diffuser",
                                                       device="cpu"),
                                      model, weights=_t(np.asarray(weights)))

    model, loss_fn = port(BF)
    trainer = _port_trainer(model, loss_fn, FixedBatch(x0), cfg, tgrads, T)
    draws = _jax_draws(0, STEPS, x0.shape)
    replay = iter(draws)
    trainer.draw = lambda x: tuple(map(_t, next(replay)))
    trainer.train()
    _losses_match(trainer, jtrainer)
    ref = temporal_unet_from_flax(jgrads[0])
    assert all(g.dtype == torch.float32 for g in tgrads[0].values())
    assert _within(_grad_distance(tgrads[0], ref), GRAD_TOL["temporal"])
    m32, loss32 = port(torch.float32)
    loss32(torch.from_numpy(x0), *map(_t, draws[0]))[0].backward()
    assert not _within(_grad_distance({k: p.grad for k, p in m32.named_parameters()}, ref),
                       GRAD_TOL["temporal"])
    _params_close(model, temporal_unet_from_flax(
        jax.tree_util.tree_map(np.asarray, jtrainer.state.params)))


def test_local_transformer_trainer_steps_match_jax(pallas_bf16, monkeypatch):
    """A small local transformer at bf16, v4 loss, attention and feed-forward
    dropout live: B3's bf16 form with the keep mask and its bf16 gradient,
    the feed-forward's bf16 dropout."""
    B, N = 4, 32
    kw = dict(max_seq_len=64, num_residual_streams=4, attn_dropout=P_DROP, ff_dropout=P_DROP,
              **SMALL)
    jm = JLA.LocalTransformer(input_dim=D_LA, dtype=jnp.bfloat16, **kw)
    params = la_flax_params(jm, (jnp.zeros((1, 32, D_LA)), jnp.zeros((1,))), seed=124)
    feed = MaskFeed(5, sites=2 * SMALL["depth"])
    feed.patch(monkeypatch)
    x0 = np.random.default_rng(5).normal(size=(B, N, D_LA)).astype(np.float32)
    data = LabelledBatch(x0)
    cfg = dict(num_train_steps=STEPS, batch_size=B, log_every=1, seed=0)
    loss_kw = dict(predict_epsilon=False, use_mask=True, dropout=True)
    jgrads, tgrads, draws = [], [], []
    tx = _recording_tx(jgrads)
    jtrainer = JL.Trainer(
        JSt.TrainState.create(params, tx, JSt.EMAConfig(decay=0.9, start=1, every=1)), tx,
        JL.make_loss_fn(JS.make_schedule("cosine", T_LA, convention="v4"), jm.apply, kind="v4",
                        **loss_kw),
        data, JL.TrainerConfig(**cfg), log_fn=lambda s: None, wrap_accum=False)
    real_step = jtrainer.step_fn

    def recording_step(*args):
        t_rng, n_rng, _, _ = jax.random.split(args[-1], 4)
        draws.append((np.asarray(jax.random.randint(t_rng, (B,), 0, T_LA)),
                      np.asarray(jax.random.normal(n_rng, x0.shape))))
        return real_step(*args)

    jtrainer.step_fn = recording_step
    jtrainer.train()

    def port(dtype):
        model = LA.LocalTransformer(D_LA, dtype=dtype, **kw)
        model.load_state_dict(local_transformer_from_flax(params), strict=True)
        return model, TL.make_loss_fn(TS.make_schedule("cosine", T_LA, convention="v4",
                                                       device="cpu"),
                                      model, kind="v4", **loss_kw)

    model, loss_fn = port(BF)
    trainer = _port_trainer(model, loss_fn, data, cfg, tgrads, T_LA)
    replay = iter(draws)
    trainer.draw = lambda x: tuple(torch.from_numpy(np.array(a)) for a in next(replay))
    trainer.train()
    assert feed.torch_calls == STEPS * feed.sites
    _losses_match(trainer, jtrainer)
    ref = local_transformer_from_flax(jgrads[0])
    assert _within(_grad_distance(tgrads[0], ref), GRAD_TOL["local_attention"])
    # the float32 port on the first step's batch, draws and keep masks (call k % sites)
    m32, loss32 = port(torch.float32)
    m32.train()
    t, noise = (torch.from_numpy(np.array(a)) for a in draws[0])
    loss32(torch.from_numpy(x0), t.long(), noise, mask=torch.from_numpy(data.batch.mask),
           y=torch.from_numpy(data.batch.motion_class).long(),
           generator=torch.Generator().manual_seed(0))[0].backward()
    assert not _within(_grad_distance({k: p.grad for k, p in m32.named_parameters()}, ref),
                       GRAD_TOL["local_attention"])
    _params_close(model, local_transformer_from_flax(
        jax.tree_util.tree_map(np.asarray, jtrainer.state.params)))



@pytest.mark.parametrize("arch", ["transformer", "decoder"])
def test_transformer_gradients_match_jax(arch):
    """One gradient of the MDM transformer and of the decoder at bf16 (no
    kernel lies on them), dropout off, against ``jax.grad`` of JAX's run op
    by op, as ``tests/test_torch_bf16_models.py`` holds their forwards (a
    compiled gradient keeps fused intermediates unrounded: 4.6e-2 apart)."""
    _, params = BM.jax_pair(arch)
    x, t, y = BM._inputs(5)
    cot = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
    args = BM._args(arch, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    with jax.disable_jit():
        g = jax.grad(lambda p: jnp.sum(BM.jax_model(arch).apply(p, *args) * cot))(params)
    ref = BM.CONVERT[arch](jax.tree_util.tree_map(np.asarray, g))
    dist = {}
    for bf16 in (True, False):
        model = BM.port_model(arch, bf16)
        out = model(*BM._args(arch, *map(torch.from_numpy, (x, t, y))))
        (out * torch.from_numpy(cot)).sum().backward()
        grads = {k: p.grad for k, p in model.named_parameters()}
        assert all(v.dtype == torch.float32 for v in grads.values())
        dist[bf16] = _grad_distance(grads, ref)
    assert _within(dist[True], GRAD_TOL[arch]) and not _within(dist[False], GRAD_TOL[arch])


# ---------------------------------------------------------------------------
# Value guidance with a bf16 ValueFunction

VB, VH = 3, 32
# Against JAX's compiled value model (fusions keep some intermediates unrounded). Measured,
# bf16 port: values 1.1e-3 of max |JAX value|, dx (1.3e-2, 1.7e-3) as (max, median) of
# |d| / max |JAX dx| (a gradient through 20 conv blocks, rounded at each), the value loss
# 1.1e-3 relative, its parameter gradients (4.7e-3, 4.8e-5); the float32 port: values
# 2.5e-2, dx (1.7e-2, 2.4e-3), the loss 1.6e-2, its gradients (1.2e-2, 1.6e-4).
VALUE_TOL = 5e-3
VALUE_DX_TOL = (2e-2, 2.5e-3)
VALUE_GRAD_TOL = (8e-3, 1e-4)


def _value_pair():
    """(JAX ValueFunction at bf16, numpy params, the port's at bf16 and at
    float32) from one seeded init."""
    jm = JaxValue(transition_dim=D, dim=16, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, VH, D)),
                            jnp.zeros((1,)))
    rng = np.random.default_rng(VH + 16)
    params = jax.tree_util.tree_map_with_path(lambda p, s: BM._draw(rng, p[-1].key, s.shape),
                                              shapes)
    models = []
    for dtype in (BF, torch.float32):
        models.append(ValueFunction(D, VH, dim=16, dtype=dtype))
        models[-1].load_state_dict(value_function_from_flax(params), strict=True)
    return jm, params, models


def _value_inputs(seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(VB, VH, D)).astype(np.float32), np.array([0, 3, 5], np.int32)


def test_value_gradients_bf16_match_jax(pallas_bf16):
    """``value_gradients`` through a frozen bf16 ValueFunction: its 20 conv
    blocks' B1 bf16 backward takes dx only (no B2). The float32 port's
    values miss VALUE_TOL."""
    jm, params, models = _value_pair()
    x, t = _value_inputs(1)
    y_ref, g_ref = jax.jit(lambda xx, tt: JG.value_gradients(
        lambda a, b: jm.apply(params, a, b), xx, tt))(jnp.asarray(x), jnp.asarray(t))
    y_ref, g_ref = np.asarray(y_ref), np.asarray(g_ref)
    rel = []
    for model in models:
        y, g = TG.value_gradients(model.requires_grad_(False), torch.from_numpy(x),
                                  torch.from_numpy(t))
        assert y.dtype == g.dtype == torch.float32 and g.shape == x.shape
        rel.append(np.abs(y.numpy() - y_ref).max() / np.abs(y_ref).max())
        if len(rel) == 1:
            d = np.abs(g.numpy() - g_ref) / np.abs(g_ref).max()
            assert d.max() <= VALUE_DX_TOL[0] and np.median(d) <= VALUE_DX_TOL[1]
    assert rel[0] <= VALUE_TOL < rel[1]


def test_value_diffusion_loss_bf16_step_matches_jax(pallas_bf16, monkeypatch):
    """One ``value_diffusion_loss`` step with a bf16 ValueFunction: the loss
    and every parameter's gradient (each conv block's dW through B2's bf16
    form's plain version here). The float32 port misses both bounds."""
    jm, params, models = _value_pair()
    x0, t = _value_inputs(4)
    rng = np.random.default_rng(5)
    target = rng.normal(size=(VB,)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    sched = JS.make_schedule("cosine", 8, convention="diffuser")
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32: jnp.asarray(noise, dtype))
    l_ref, g_ref = jax.jit(jax.value_and_grad(lambda p: JG.value_diffusion_loss(
        sched, (jm.apply, p), jnp.asarray(x0), jnp.asarray(target), jnp.asarray(t),
        jax.random.PRNGKey(0))[0]))(params)
    ref = value_function_from_flax(jax.tree_util.tree_map(np.asarray, g_ref))
    within = []
    for model in models:
        loss, _ = TG.value_diffusion_loss(
            TS.make_schedule("cosine", 8, convention="diffuser", device="cpu"), model,
            torch.from_numpy(x0), torch.from_numpy(target), torch.from_numpy(t),
            torch.from_numpy(noise))
        loss.backward()
        assert loss.dtype == torch.float32
        dist = _grad_distance({k: p.grad for k, p in model.named_parameters()}, ref)
        within.append((abs(loss.item() - float(l_ref)) / float(l_ref) <= VALUE_TOL,
                       _within(dist, VALUE_GRAD_TOL)))
    assert within == [(True, True), (False, False)]


# ---------------------------------------------------------------------------
# The CLI


ARCH_SETS = {
    "temporal": (UNET_CONFIG, UNET_TINY),
    "local_attention": (LA_CONFIG, LA_TINY),
    "transformer": (UNET_CONFIG, ["model.architecture=transformer", "model.latent_dim=32",
                                  "model.num_layers=1", "model.n_heads=2",
                                  "model.dim_feedforward=64", "model.max_seq_len=16",
                                  "diffusion.noise_steps=8"]),
    "decoder": (UNET_CONFIG, ["model.architecture=decoder", "model.latent_dim=32",
                              "model.num_layers=1", "model.n_heads=2", "model.max_seq_len=16",
                              "diffusion.noise_steps=8"]),
}


@pytest.mark.parametrize("arch", sorted(ARCH_SETS))
def test_train_cli_trains_a_bf16_config_and_its_run_serves(tmp_path, arch):
    """``cli.train`` on a ``"bf16": true`` config of each architecture: the
    run's parameters, checkpoints and EMA stay float32, the losses finite;
    the checkpoint loads into the float32 build, and ``cli.sample`` serves
    the run (at bf16, as its config says)."""
    config, tiny = ARCH_SETS[arch]
    trainer = train_cli.main(["--config", config, "--data", CLIP, "--steps", "4",
                              "--batch-size", "2", "--out", str(tmp_path), "--device", "cpu",
                              "--set", *tiny, "model.bf16=true"])
    cfg = ExperimentConfig.load(str(tmp_path / "config.json"))
    assert cfg.model.bf16 and cfg.model.architecture == arch
    params = dict(trainer.state.model.named_parameters())
    assert all(p.dtype == torch.float32 for p in params.values())
    assert all(v.dtype == torch.float32 for v in trainer.state.ema_params.values()
               if v.is_floating_point())
    metrics = json.loads((tmp_path / "training_metrics.json").read_text())
    assert np.isfinite([r["loss"] for r in metrics["metrics"]]).all()
    payload, _ = Checkpointer(str(tmp_path / "checkpoints")).restore(best=True)
    model32 = factory.build_model(dataclasses.replace(cfg.model, bf16=False), device="cpu")
    model32.load_state_dict(payload["params"], strict=True)
    frames = 16
    paths = sample_cli.main(["--run", str(tmp_path), "--num", "2", "--frames", str(frames),
                             "--device", "cpu", "--out", str(tmp_path / "samples")])
    motions = np.stack([np.load(p) for p in paths])
    assert motions.shape[:2] == (2, frames) and np.isfinite(motions).all()


def test_training_never_meets_a_kept_bf16_copy():
    """Where a gradient is recorded ``precision.cast`` keeps nothing, so an
    optimizer step is never followed by a stale bf16 copy; a forward
    without gradients after the step casts the updated parameter."""
    layer = torch.nn.Linear(8, 4)
    opt = torch.optim.SGD(layer.parameters(), lr=0.5)
    x = torch.randn(3, 8)
    with torch.no_grad():
        before = P.linear(x, layer, BF)
    P.linear(x, layer, BF).float().sum().backward()
    assert layer.weight.grad is not None and layer.weight.grad.dtype == torch.float32
    opt.step()
    with torch.no_grad():
        after = P.linear(x, layer, BF)
        fresh = torch.nn.functional.linear(x.to(BF), layer.weight.to(BF)) + layer.bias.to(BF)
    assert torch.equal(after, fresh) and not torch.equal(after, before)
