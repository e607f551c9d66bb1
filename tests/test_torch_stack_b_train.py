"""Stack-B training in the port against the JAX package's: a few ``Trainer``
steps of the MDM transformer with the x0 loss (label drop, frame mask) and
with the v4 loss under the loss-aware timestep sampler, from the same
converted weights, batch, timesteps, noise and label-drop masks; then the
CLI path end to end on the CPU: ``cli/train.py`` for each stack-B loss and
``cli/sample.py --class-id --cfg-scale`` answering from the run with one
2B-batch forward per step.

Timesteps, noise and drop masks are drawn with JAX's keys exactly as the
JAX trainer draws them, then injected into the port (``Trainer.draw`` and
the loss function's ``drop``), since the two frameworks' random streams
differ.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.data import datasets as JD
from deepmimic_diffusion_mujoco_tpu.diffusion import schedules as JS
from deepmimic_diffusion_mujoco_tpu.diffusion import timestep_sampling as JTS
from deepmimic_diffusion_mujoco_tpu.train import loop as JL
from deepmimic_diffusion_mujoco_tpu.train import state as JSt
from deepmimic_diffusion_mujoco_tpu_torch.cli import sample as sample_cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import train as train_cli
from deepmimic_diffusion_mujoco_tpu_torch.convert import transformer_from_flax
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import schedules as TS
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import timestep_sampling as TTS
from deepmimic_diffusion_mujoco_tpu_torch.models import transformer as TM
from deepmimic_diffusion_mujoco_tpu_torch.train import loop as TL
from deepmimic_diffusion_mujoco_tpu_torch.train import state as TSt
from deepmimic_diffusion_mujoco_tpu_torch.train.config import ExperimentConfig
from test_torch_transformer import make_pair

torch.set_num_threads(2)

B, H, D, T, NC = 4, 12, 8, 20, 3
DROP_P = 0.5
ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIG = os.path.join(ROOT, "experiments", "allclips12k_r5", "config.json")
TINY = ["model.latent_dim=32", "model.num_layers=1", "model.n_heads=2",
        "model.dim_feedforward=64", "model.max_seq_len=40", "diffusion.noise_steps=8",
        "data.max_files=3", "train.log_every=2", "train.scan_chunk=1", "train.save_every=2",
        "train.ema_start=2", "train.ema_every=2"]


def _t(a):
    return torch.from_numpy(np.array(a))


class FixedBatch:
    """A dataset whose every batch is the same one: labels and a padded mask."""

    def __init__(self, x0):
        mask = np.ones(x0.shape[:2], np.float32)
        mask[1, 8:] = 0.0
        self.batch = JD.Batch(trajectories=x0, motion_class=np.array([0, 1, 2, 1], np.int32),
                              mask=mask, cond_frame=x0[:, 0])

    def epochs(self, batch_size, seed=0, class_balanced=False):
        while True:
            yield self.batch


def _warm_sampler(seed=7):
    """A loss-aware state with every row full, the same on both sides, so
    that the weights are not uniform from the first step."""
    losses = np.random.default_rng(seed).uniform(0.1, 2.0, size=(T, 10)).astype(np.float32)
    js = JTS.LossSecondMomentState(losses=jnp.asarray(losses),
                                   counts=jnp.full((T,), 10, jnp.int32))
    ts = TTS.LossSecondMomentState(losses=_t(losses), counts=torch.full((T,), 10))
    return js, ts


@pytest.mark.parametrize("kind,loss_aware", [("x0", False), ("v4", True)])
def test_trainer_steps_match_jax(kind, loss_aware):
    """5 optimizer steps at accumulation 2 (10 micro-steps) from the same
    converted weights: losses and the best model within 1e-4 (relative);
    params and EMA bounded as tests/test_torch_train.py's U-Net trainer test
    bounds them (Adam moves an element by about lr whatever its gradient's
    size); the loss-aware ring buffer within 1e-4. The attention's key bias
    has a gradient of exactly zero in exact arithmetic (softmax ignores a
    constant added to a query's logits), so Adam steps each element by about
    lr in the direction of rounding noise, on each side on its own: it is
    held within 2 x steps x lr only."""
    steps, accum, seed, lr = 5, 2, 0, 1e-3
    jm, params, model = make_pair("adaln", NC, num_layers=1)
    x0 = np.random.default_rng(5).normal(size=(B, H, D)).astype(np.float32)
    data = FixedBatch(x0)
    tx = optax.MultiSteps(JSt.make_optimizer("adamw", lr=lr, betas=(0.9, 0.98),
                                             schedule="exponential"), accum)
    cfg = dict(num_train_steps=steps, batch_size=B, gradient_accumulate_every=accum,
               log_every=1, seed=seed)
    loss_kw = dict(predict_epsilon=False, label_drop_prob=DROP_P, null_label=NC, use_mask=True)
    jsampler, tsampler = _warm_sampler() if loss_aware else (None, None)
    jtrainer = JL.Trainer(
        JSt.TrainState.create(params, tx, JSt.EMAConfig(decay=0.9, start=4, every=3)), tx,
        JL.make_loss_fn(JS.make_schedule("cosine", T, convention="v4"), jm.apply, kind=kind,
                        **loss_kw),
        data, JL.TrainerConfig(**cfg), log_fn=lambda s: None, wrap_accum=False,
        sampler_state=jsampler)

    draws = []  # (t, noise, drop) per micro-step, as the JAX step draws them
    real_step = jtrainer.step_fn

    def recording_step(*args):
        step_rng = args[-1]
        if loss_aware:
            t_rng, step_rng = jax.random.split(step_rng)
            t, _ = JTS.loss_aware_timesteps(args[1], t_rng, B)
        t_rng, n_rng, d_rng, _ = jax.random.split(step_rng, 4)
        if not loss_aware:
            t = jax.random.randint(t_rng, (B,), 0, T)
        draws.append((np.asarray(t), np.asarray(jax.random.normal(n_rng, x0.shape)),
                      np.asarray(jax.random.bernoulli(d_rng, DROP_P, (B,)))))
        return real_step(*args)

    jtrainer.step_fn = recording_step
    jtrainer.train()
    assert any(d[2].any() for d in draws)  # some labels dropped

    opt, sched = TSt.make_optimizer(model.parameters(), "adamw", lr=lr, betas=(0.9, 0.98),
                                    schedule="exponential")
    state = TSt.TrainState(model, opt, sched, TSt.EMAConfig(0.9, 4, 3), accum=accum)
    loss_fn = TL.make_loss_fn(TS.make_schedule("cosine", T, convention="v4", device="cpu"),
                              model, kind=kind, **loss_kw)
    trainer = TL.Trainer(state, lambda *a, **k: loss_fn(*a, **k, drop=_t(next(drops))),
                         data, TL.TrainerConfig(**cfg), log_fn=lambda s: None,
                         num_timesteps=T, sampler_state=tsampler)
    replay = iter(draws)
    drops = (d[2] for d in draws)

    def draw(x):
        t, noise, _ = next(replay)
        return _t(t).long(), _t(noise)

    trainer.draw = draw
    trainer.train()

    assert len(trainer.metrics) == len(jtrainer.metrics) == steps * accum
    for ours, ref in zip(trainer.metrics, jtrainer.metrics):
        assert ours.keys() == ref.keys() and ours["step"] == ref["step"]
        np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=1e-4)
    assert trainer.best_step == jtrainer.best_step
    np.testing.assert_allclose(trainer.best_loss, jtrainer.best_loss, rtol=1e-4)
    if loss_aware:
        np.testing.assert_array_equal(tsampler.counts.numpy(),
                                      np.asarray(jtrainer.sampler_state.counts))
        np.testing.assert_allclose(tsampler.losses.numpy(),
                                   np.asarray(jtrainer.sampler_state.losses), rtol=1e-4)
    for ours, ref in ((model.state_dict(), jtrainer.state.params),
                      (state.ema_params, jtrainer.state.ema_params)):
        ref = transformer_from_flax(jax.tree_util.tree_map(np.asarray, ref))
        for k, v in ref.items():
            diff = (ours[k] - v).abs()
            if k.endswith("attn.key.bias"):
                assert diff.max().item() <= 2 * steps * lr, (k, diff.max().item())
                continue
            close = (diff <= 1e-5 * v.abs().max() + 1e-2 * lr).float().mean().item()
            assert close >= 0.999 and diff.max().item() <= lr, (k, close, diff.max().item())


def test_label_drop_and_dropout_draw_from_the_generator():
    """Without an injected mask, labels drop with probability
    ``label_drop_prob`` from the generator; dropout draws from it too, so
    the same seed gives the same loss."""
    _, _, model = make_pair("both", NC, dropout=0.2, num_layers=1)
    model.train()
    seen = []
    real_forward = model.forward

    def forward(x, t, y=None, **kw):
        seen.append(y.clone())
        return real_forward(x, t, y, **kw)

    model.forward = forward
    loss_fn = TL.make_loss_fn(TS.make_schedule("cosine", T, convention="v4", device="cpu"),
                              model, kind="x0", predict_epsilon=False, label_drop_prob=DROP_P,
                              null_label=NC, dropout=True)
    x0 = torch.randn(256, H, D)
    y = torch.zeros(256, dtype=torch.long)
    t = torch.randint(0, T, (256,))
    losses = [loss_fn(x0, t, torch.zeros_like(x0), y=y,
                      generator=torch.Generator().manual_seed(3))[0].item() for _ in range(2)]
    assert losses[0] == losses[1]
    dropped = (seen[0] == NC).float().mean().item()
    assert abs(dropped - DROP_P) < 0.1 and set(seen[0].tolist()) == {0, NC}
    assert torch.equal(seen[0], seen[1])


def _train(out, *extra):
    return train_cli.main(["--config", CONFIG, "--steps", "4", "--batch-size", "2",
                           "--out", str(out), "--device", "cpu", "--set", *TINY, *extra])


@pytest.mark.parametrize("overrides", [
    ("diffusion.loss=x0",),
    ("diffusion.loss=v4", "train.timestep_sampler=loss_aware"),
    ("diffusion.loss=kl",),
    ("diffusion.loss=angle_velocity",),
])
def test_train_cli_trains_the_transformer(tmp_path, overrides):
    """Each stack-B loss through the CLI: the data cut to max_seq_len, the
    run directory's records, finite losses, and a loss-aware ring buffer
    that recorded every sample."""
    trainer = _train(tmp_path, *overrides)
    assert isinstance(trainer.state.model, TM.TransformerMotionModel)
    assert trainer.dataset.horizon == 40
    metrics = json.loads((tmp_path / "training_metrics.json").read_text())
    assert [r["step"] for r in metrics["metrics"]] == [2, 4]
    assert all(np.isfinite(r["loss"]) for r in metrics["metrics"])
    if "diffusion.loss=angle_velocity" in overrides:
        assert {"loss_angle", "loss_velocity"} <= metrics["metrics"][0].keys()
    names = sorted(p.name for p in (tmp_path / "checkpoints").glob("*.pt"))
    assert names == ["best_model.pt", "state_2.pt", "state_4.pt"]
    if trainer.sampler_state is not None:
        assert trainer.sampler_state.counts.sum().item() == 4 * 2
    else:
        assert "train.timestep_sampler=loss_aware" not in overrides


def test_sample_cli_serves_cfg_from_a_trained_run(tmp_path, monkeypatch):
    """--class-id with --cfg-scale: every step is one 2B-batch forward whose
    first half carries the class and second half the null label; the
    motions keep the holding_box dims exact. Without a class: one B forward
    with the null label; --cfg-sweep: each scale's chain in turn."""
    _train(tmp_path, "diffusion.loss=x0")
    calls = []
    real_forward = TM.TransformerMotionModel.forward

    def forward(self, x, t, y=None, *a, **k):
        calls.append((x.shape[0], None if y is None else y.tolist()))
        return real_forward(self, x, t, y, *a, **k)

    monkeypatch.setattr(TM.TransformerMotionModel, "forward", forward)
    cfg = ExperimentConfig.load(str(tmp_path / "config.json"))
    paths = sample_cli.main(["--run", str(tmp_path), "--num", "2", "--frames", "24",
                             "--class-id", "4", "--cfg-scale", "2.5",
                             "--conditioner", "holding_box", "--out", str(tmp_path / "s"),
                             "--device", "cpu"])
    nc = cfg.model.num_classes
    assert len(calls) == cfg.diffusion.noise_steps - 1  # v4: t = T-1 .. 1
    assert all(c == (4, [4, 4, nc, nc]) for c in calls)
    for p in paths:
        m = np.load(p)
        assert m.shape == (24, 35) and np.isfinite(m).all()
        assert (m[:, [13, 14, 15, 17, 18, 19]] == 0).all()
        assert (m[:, [16, 20]] == np.float32(1.57)).all()
    calls.clear()
    sample_cli.main(["--run", str(tmp_path), "--num", "2", "--frames", "24", "--out",
                     str(tmp_path / "u"), "--device", "cpu"])
    assert calls and all(c == (2, None) for c in calls)  # no class: one B forward, null label
    calls.clear()
    sweep = sample_cli.main(["--run", str(tmp_path), "--num", "2", "--frames", "24",
                             "--class-id", "4", "--cfg-sweep", "0,2", "--out",
                             str(tmp_path / "w"), "--device", "cpu"])
    steps = cfg.diffusion.noise_steps - 1
    # scale 0 samples the class without guidance; scale 2 one 2B forward a step
    assert calls == [(2, [4, 4])] * steps + [(4, [4, 4, nc, nc])] * steps
    assert len(sweep) == 4 and (tmp_path / "w" / "cfg_sweep.json").exists()
