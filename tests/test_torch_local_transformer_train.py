"""The local-attention transformer in training mode against the JAX
package's: attention dropout through the kernel route (B3's keep mask,
the kernel's plain version on the CPU; the JAX side runs the Pallas kernel
in interpret mode), attention dropout through the bucketed path (a
position-bias table), feed-forward dropout, a few ``Trainer`` steps, and
``cli/train.py`` on a local-attention config with ``--resume``.

The two frameworks' random streams differ, so every keep mask is drawn
with numpy: on the JAX side in place of ``jax.random.bernoulli`` (which
``dropout_keep_mask``, ``nn.Dropout`` and the bucketed path call), on the
port's side in place of ``dropout_keep_mask`` and ``keep_mask``. The
masks are handed out in call order (per layer: the attention's, then the
feed-forward's), the k-th call of a forward getting the k-th mask.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.diffusion import schedules as JS
from deepmimic_diffusion_mujoco_tpu.models import local_attention as JLA
from deepmimic_diffusion_mujoco_tpu.ops.pallas import fused_local_attention as JFK
from deepmimic_diffusion_mujoco_tpu.train import loop as JL
from deepmimic_diffusion_mujoco_tpu.train import state as JSt
from deepmimic_diffusion_mujoco_tpu_torch.cli import evaluate as evaluate_cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import sample as sample_cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import train as train_cli
from deepmimic_diffusion_mujoco_tpu_torch.convert import local_transformer_from_flax
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import schedules as TS
from deepmimic_diffusion_mujoco_tpu_torch.models import local_attention as LA
from deepmimic_diffusion_mujoco_tpu_torch.ops import fused_local_attention as FK
from deepmimic_diffusion_mujoco_tpu_torch.train import loop as TL
from deepmimic_diffusion_mujoco_tpu_torch.train import state as TSt
from test_torch_local_transformer import random_flax_params
from test_torch_stack_b_train import FixedBatch

torch.set_num_threads(2)

D = 69
P_DROP = 0.3
FWD_TOL = 1e-5    # max abs error of the forward
GRAD_TOL = 1e-4   # max abs error of each gradient / JAX's max |gradient| over all
SMALL = dict(dim=32, depth=2, heads=2, dim_head=16, window_size=16)
ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIG = os.path.join(ROOT, "experiments", "localattn5k_r3", "config.json")
WALK = os.path.join(ROOT, "data", "motions", "humanoid3d_walk.txt")
TINY = ["model.latent_dim=32", "model.depth=1", "model.n_heads=2", "model.dim_head=16",
        "model.max_seq_len=40", "diffusion.noise_steps=8", "train.log_every=2",
        "train.save_every=2", "train.ema_start=2", "train.ema_every=2"]


@pytest.fixture(autouse=True)
def interpret():
    JFK.INTERPRET = True
    yield
    JFK.INTERPRET = False


class MaskFeed:
    """Keep masks from numpy, handed to both sides in call order: call k
    of a forward gets mask k % sites (so a re-traced JAX step draws the same
    masks again)."""

    def __init__(self, seed, sites=None):
        self.rng = np.random.default_rng(seed)
        self.sites = sites
        self.masks = []   # (shape, keep_prob, bool mask)
        self.jax_calls = self.torch_calls = 0

    def _next(self, calls, shape, keep_prob):
        i = calls if self.sites is None else calls % self.sites
        if i == len(self.masks):
            self.masks.append((tuple(shape), keep_prob,
                               self.rng.random(tuple(shape)) < keep_prob))
        want, p, mask = self.masks[i]
        assert (want, p) == (tuple(shape), keep_prob), (want, p, shape, keep_prob)
        return mask

    def jax_bernoulli(self, key, p=0.5, shape=None, mode=None):
        mask = self._next(self.jax_calls, shape, float(p))
        self.jax_calls += 1
        return jnp.asarray(mask)

    def _torch(self, shape, keep_prob):
        mask = self._next(self.torch_calls, shape, float(keep_prob))
        self.torch_calls += 1
        return torch.from_numpy(mask)

    def torch_keep_mask(self, shape, keep_prob, generator, device):
        assert generator is not None
        return self._torch(shape, keep_prob).to(device)

    def torch_kernel_mask(self, generator, keep_prob, batch, N, heads, window_size,
                          causal=False, dtype=torch.float32):
        p = FK.plan(N, window_size, causal)
        return self._torch((batch, p["Np"], heads * p["K"]), keep_prob).to(dtype)

    def patch(self, monkeypatch):
        monkeypatch.setattr(jax.random, "bernoulli", self.jax_bernoulli)
        monkeypatch.setattr(FK, "dropout_keep_mask", self.torch_kernel_mask)
        monkeypatch.setattr(LA, "keep_mask", self.torch_keep_mask)


def _grads_close(ours: dict, ref: dict):
    scale = max(float(np.abs(v).max()) for v in ref.values())
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        err = float(np.abs(ours[k] - v).max())
        assert err <= GRAD_TOL * scale, (k, err, scale)


def _flat_grads(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat_grads(v, path) if hasattr(v, "items") else {path: np.asarray(v)})
    return out


@pytest.mark.parametrize("N,masked", [(32, False), (40, True), (256, True)])
def test_local_mha_training_matches_jax(monkeypatch, N, masked):
    """One LocalMHA in training mode on the kernel route, the same keep
    mask on both sides: the context and the gradients of the parameters and
    of the input. N 40 pads to 48 (one chunk), N 256 is two chunks of 128
    with neighbour slices; ``masked`` adds a prefix key mask."""
    heads, dh, w, dim = 2, 16, 16, 32
    jmod = JLA.LocalMHA(window_size=w, heads=heads, dim_head=dh, attn_dropout=P_DROP)
    params = random_flax_params(jmod, (jnp.zeros((1, 16, dim)),), seed=N)
    rng = np.random.default_rng(N + 1)
    x = rng.normal(size=(2, N, dim)).astype(np.float32)
    cot = rng.normal(size=(2, N, dim)).astype(np.float32)
    km = ((np.arange(N)[None, :] < np.array([[N], [N - 13]])).astype(np.float32)
          if masked else None)
    feed = MaskFeed(N)
    feed.patch(monkeypatch)

    def loss(p, xx):
        out = jmod.apply(p, xx, None if km is None else jnp.asarray(km), deterministic=False,
                         rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(out * cot), out

    (_, ref), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    plan = FK.plan(N, w, False)
    assert feed.jax_calls == 1 and feed.masks[0][0] == (2, plan["Np"], heads * plan["K"])

    mha = LA.LocalMHA(dim, w, heads, dh, attn_dropout=P_DROP).train()
    p = params["params"]
    mha.load_state_dict({
        "norm.weight": torch.from_numpy(np.asarray(p["LayerNorm_0"]["scale"])),
        "norm.bias": torch.from_numpy(np.asarray(p["LayerNorm_0"]["bias"])),
        "to_qkv.weight": torch.from_numpy(np.asarray(p["Dense_0"]["kernel"]).T.copy()),
        "to_out.weight": torch.from_numpy(np.asarray(p["Dense_1"]["kernel"]).T.copy()),
    }, strict=True)
    assert mha.uses_kernel(N)
    xt = torch.from_numpy(x).requires_grad_()
    out = mha(xt, None if km is None else torch.from_numpy(km),
              generator=torch.Generator().manual_seed(0))
    (out * torch.from_numpy(cot)).sum().backward()
    assert feed.torch_calls == 1
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=FWD_TOL, rtol=0)
    gp = _flat_grads(gp["params"])
    ours = {"LayerNorm_0/scale": mha.norm.weight.grad, "LayerNorm_0/bias": mha.norm.bias.grad,
            "Dense_0/kernel": mha.to_qkv.weight.grad.T, "Dense_1/kernel": mha.to_out.weight.grad.T}
    _grads_close({**{k: v.numpy() for k, v in ours.items()}, "x": xt.grad.numpy()},
                 {**gp, "x": np.asarray(gx)})


def test_eval_mode_draws_no_mask(monkeypatch):
    """Out of training mode the dropout layers are identities and draw nothing."""
    feed = MaskFeed(0)
    feed.patch(monkeypatch)
    model = LA.LocalTransformer(D, max_seq_len=32, attn_dropout=P_DROP, ff_dropout=P_DROP,
                                **SMALL).eval()
    with torch.no_grad():
        model(torch.randn(2, 32, D), torch.tensor([1, 2]))
    assert feed.torch_calls == 0


def _pair(streams, dpb, attn_dropout=P_DROP, ff_dropout=P_DROP, max_seq_len=64):
    jm = JLA.LocalTransformer(input_dim=D, max_seq_len=max_seq_len, num_residual_streams=streams,
                              use_dynamic_pos_bias=dpb, attn_dropout=attn_dropout,
                              ff_dropout=ff_dropout, **SMALL)
    params = random_flax_params(jm, (jnp.zeros((1, 32, D)), jnp.zeros((1,))),
                                seed=31 * streams + dpb)
    model = LA.LocalTransformer(D, max_seq_len=max_seq_len, num_residual_streams=streams,
                                use_dynamic_pos_bias=dpb, attn_dropout=attn_dropout,
                                ff_dropout=ff_dropout, **SMALL)
    model.load_state_dict(local_transformer_from_flax(params), strict=True)
    return jm, params, model


@pytest.mark.parametrize("streams,dpb,horizon", [(4, False, 32), (4, False, 56), (1, True, 48)])
def test_local_transformer_training_matches_jax(monkeypatch, streams, dpb, horizon):
    """The whole model in training mode, attention and feed-forward dropout
    on: the output and every parameter's gradient. With the position-bias
    table (rotary off) the attention takes the bucketed path and its
    dropout, as the JAX package's jnp path does."""
    jm, params, model = _pair(streams, dpb)
    rng = np.random.default_rng(horizon + streams)
    x = rng.normal(size=(2, horizon, D)).astype(np.float32)
    t = np.array([3, 917], np.int32)
    cot = rng.normal(size=(2, horizon, D)).astype(np.float32)
    feed = MaskFeed(horizon)
    feed.patch(monkeypatch)

    def loss(p):
        out = jm.apply(p, jnp.asarray(x), jnp.asarray(t), deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(out * cot), out

    (_, ref), gp = jax.value_and_grad(loss, has_aux=True)(params)
    assert feed.jax_calls == 2 * SMALL["depth"]

    model.train()
    assert all(m.uses_kernel(horizon) != dpb for m in model.attn)
    out = model(torch.from_numpy(x), torch.from_numpy(t),
                generator=torch.Generator().manual_seed(0))
    (out * torch.from_numpy(cot)).sum().backward()
    assert feed.torch_calls == 2 * SMALL["depth"]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=FWD_TOL, rtol=0)
    ref_grads = {k: v.numpy() for k, v in local_transformer_from_flax(gp).items()}
    _grads_close({k: p.grad.numpy() for k, p in model.named_parameters()}, ref_grads)


def test_trainer_steps_match_jax(monkeypatch):
    """3 optimizer steps of the v4 loss with dropout live, from the same
    converted weights, batch, timesteps, noise and keep masks: the losses,
    the best model and the parameters. In the first layer every residual
    stream is the same copy, so the attention's input is that copy times
    the sum of column 0 of the width connection (``hc_attn.0``'s
    ``static_alpha`` and ``dynamic_alpha_fn`` terms), a scale which the
    attention's LayerNorm divides out: those columns' gradients are zero in
    exact arithmetic (1e-7 of rounding noise here), and Adam steps each of
    their elements by about lr in the noise's direction, on each side on
    its own. They are held within 2 x steps x lr only."""
    steps, seed, lr, B, H = 3, 0, 1e-3, 4, 32
    jm, params, model = _pair(4, False)
    feed = MaskFeed(5, sites=2 * SMALL["depth"])
    feed.patch(monkeypatch)
    x0 = np.random.default_rng(5).normal(size=(B, H, D)).astype(np.float32)
    data = FixedBatch(x0)
    T = 20
    tx = JSt.make_optimizer("adamw", lr=lr, betas=(0.9, 0.98), schedule="exponential")
    cfg = dict(num_train_steps=steps, batch_size=B, log_every=1, seed=seed)
    loss_kw = dict(predict_epsilon=False, use_mask=True, dropout=True)
    jtrainer = JL.Trainer(
        JSt.TrainState.create(params, tx, JSt.EMAConfig(decay=0.9, start=1, every=1)), tx,
        JL.make_loss_fn(JS.make_schedule("cosine", T, convention="v4"), jm.apply, kind="v4",
                        **loss_kw),
        data, JL.TrainerConfig(**cfg), log_fn=lambda s: None, wrap_accum=False)
    draws = []
    real_step = jtrainer.step_fn

    def recording_step(*args):
        t_rng, n_rng, _, _ = jax.random.split(args[-1], 4)
        draws.append((np.asarray(jax.random.randint(t_rng, (B,), 0, T)),
                      np.asarray(jax.random.normal(n_rng, x0.shape))))
        return real_step(*args)

    jtrainer.step_fn = recording_step
    jtrainer.train()
    assert feed.jax_calls % feed.sites == 0 and len(feed.masks) == feed.sites

    opt, sched = TSt.make_optimizer(model.parameters(), "adamw", lr=lr, betas=(0.9, 0.98),
                                    schedule="exponential")
    state = TSt.TrainState(model, opt, sched, TSt.EMAConfig(0.9, 1, 1))
    loss_fn = TL.make_loss_fn(TS.make_schedule("cosine", T, convention="v4", device="cpu"),
                              model, kind="v4", **loss_kw)
    trainer = TL.Trainer(state, loss_fn, data, TL.TrainerConfig(**cfg), log_fn=lambda s: None,
                         num_timesteps=T)
    replay = iter(draws)

    def draw(x):
        t, noise = next(replay)
        return torch.from_numpy(np.array(t)).long(), torch.from_numpy(np.array(noise))

    trainer.draw = draw
    trainer.train()
    assert feed.torch_calls == steps * feed.sites
    assert len(trainer.metrics) == len(jtrainer.metrics) == steps
    for ours, ref in zip(trainer.metrics, jtrainer.metrics):
        assert ours["step"] == ref["step"]
        np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=1e-4)
    assert trainer.best_step == jtrainer.best_step
    ref = local_transformer_from_flax(jax.tree_util.tree_map(np.asarray, jtrainer.state.params))
    for k, v in ref.items():
        diff = (model.state_dict()[k] - v).abs()
        if k in ("hc_attn.0.static_alpha", "hc_attn.0.dynamic_alpha_fn"):
            assert diff[:, 0].max().item() <= 2 * steps * lr, diff[:, 0].max().item()
            diff, v = diff[:, 1:], v[:, 1:]
        close = (diff <= 1e-5 * v.abs().max() + 1e-2 * lr).float().mean().item()
        assert close >= 0.999 and diff.max().item() <= lr, (k, close, diff.max().item())


def _train(out, *extra):
    return train_cli.main(["--config", CONFIG, "--steps", "4",
                           "--batch-size", "2", "--out", str(out), "--device", "cpu",
                           "--set", *TINY, *extra])


def test_train_cli_trains_local_attention_and_resumes(tmp_path):
    """The user config (the dance_a clip, H 96) cut to depth 1 and dim 32:
    dropout live, the data cut to max_seq_len 40, the run directory's
    records; ``--resume`` continues it, ``cli/sample.py`` answers from it
    and ``cli/evaluate.py`` scores it."""
    run = tmp_path / "run"
    trainer = _train(run)
    model = trainer.state.model
    assert isinstance(model, LA.LocalTransformer) and model.training
    assert model.attn[0].attn_dropout == model.ff[0].dropout == P_DROP
    assert trainer.dataset.horizon == 40
    metrics = json.loads((run / "training_metrics.json").read_text())
    assert [r["step"] for r in metrics["metrics"]] == [2, 4]
    assert all(np.isfinite(r["loss"]) for r in metrics["metrics"])
    names = sorted(p.name for p in (run / "checkpoints").glob("*.pt"))
    assert names == ["best_model.pt", "state_2.pt", "state_4.pt"]

    resumed = tmp_path / "resumed"
    shutil.copytree(run, resumed)
    trainer = train_cli.main(["--config", str(resumed / "config.json"), "--out", str(resumed),
                              "--resume", "--device", "cpu"])
    assert trainer.state.step == 8
    assert [r["step"] for r in trainer.metrics] == [6, 8]

    paths = sample_cli.main(["--run", str(resumed), "--num", "2", "--frames", "24",
                             "--conditioner", "holding_box", "--out", str(tmp_path / "s"),
                             "--device", "cpu"])
    for p in paths:
        m = np.load(p)
        assert m.shape == (24, 35) and np.isfinite(m).all()
        assert (m[:, [13, 14, 15, 17, 18, 19]] == 0).all()
        assert (m[:, [16, 20]] == np.float32(1.57)).all()
    scores = evaluate_cli.main(["--run", str(resumed), "--gt", WALK, "--num", "2", "--reps",
                                "1", "--frames", "24", "--device", "cpu"])
    assert scores and all(np.isfinite([v["mean"], v["std"]]).all() for v in scores.values())


def test_dropout_needs_a_generator():
    model = LA.LocalTransformer(D, max_seq_len=32, attn_dropout=P_DROP, **SMALL).train()
    with pytest.raises(ValueError, match="Generator"):
        model(torch.randn(1, 32, D), torch.tensor([1]))
