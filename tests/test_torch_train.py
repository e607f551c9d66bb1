"""The port's training stack against the JAX package's: the stack-A losses,
the optimizers and LR schedules against optax, the EMA gates and gradient
accumulation against ``TrainState.apply_gradients`` / ``optax.MultiSteps``,
and a few ``Trainer`` steps of the temporal U-Net on the same batch, t and
noise sequence.

Timesteps and noise are drawn with JAX's keys exactly as the JAX trainer
draws them, then injected into the port (its ``Trainer.draw``), since the
two frameworks' random streams differ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.data import datasets as JD
from deepmimic_diffusion_mujoco_tpu.diffusion import process as JP
from deepmimic_diffusion_mujoco_tpu.diffusion import schedules as JS
from deepmimic_diffusion_mujoco_tpu.train import loop as JL
from deepmimic_diffusion_mujoco_tpu.train import state as JSt
from deepmimic_diffusion_mujoco_tpu_torch.convert import temporal_unet_from_flax
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import process as TP
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import schedules as TS
from deepmimic_diffusion_mujoco_tpu_torch.train import loop as TL
from deepmimic_diffusion_mujoco_tpu_torch.train import state as TSt
from test_torch_temporal_unet import jax_unet, torch_unet

torch.set_num_threads(2)

B, H, D, T = 3, 16, 35, 50
LOSS_TOL = 1e-6      # f32, the same arithmetic in another order
OPT_TOL = 1e-6       # params after 5 optimizer steps of size ~1e-2


def _t(a):
    return torch.from_numpy(np.array(a))


# -- losses -----------------------------------------------------------------


@pytest.mark.parametrize("action_weight,discount,weights_dict", [
    (1.0, 1.0, None), (10.0, 0.9, {3: 2.0, 20: 0.5})])
def test_diffuser_loss_weights_match(action_weight, discount, weights_dict):
    ref = JP.diffuser_loss_weights(H, D, action_weight, discount, weights_dict)
    ours = TP.diffuser_loss_weights(H, D, action_weight, discount, weights_dict, device="cpu")
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=LOSS_TOL, atol=0)


@pytest.mark.parametrize("kind", ["l1", "l2"])
def test_weighted_loss_matches(kind):
    rng = np.random.default_rng(1)
    pred, target = (rng.normal(size=(B, H, D)).astype(np.float32) for _ in range(2))
    w = np.asarray(JP.diffuser_loss_weights(H, D, 10.0, 0.95))
    ref_loss, ref_info = JP.weighted_loss(jnp.asarray(pred), jnp.asarray(target),
                                          jnp.asarray(w), kind)
    loss, info = TP.weighted_loss(_t(pred), _t(target), _t(w), kind)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_TOL)
    np.testing.assert_allclose(info["a0_loss"].item(), float(ref_info["a0_loss"]),
                               rtol=LOSS_TOL)


@pytest.mark.parametrize("predict_epsilon", [True, False])
def test_diffuser_p_losses_with_injected_t_and_noise(predict_epsilon):
    """The JAX loss draws its noise from a key; the port takes the same noise."""
    rng = np.random.default_rng(2)
    x0 = rng.normal(size=(B, H, D)).astype(np.float32)
    W = (rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32)
    t = np.array([0, 17, T - 1], np.int32)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, x0.shape, jnp.float32))
    w = JP.diffuser_loss_weights(H, D, 10.0, 0.97)
    jsched = JS.make_schedule("cosine", T, convention="diffuser")
    tsched = TS.make_schedule("cosine", T, convention="diffuser", device="cpu")

    def jmodel(x, tt):
        return jnp.tanh(x @ W) + 0.01 * tt[:, None, None]

    def tmodel(x, tt):
        return torch.tanh(x @ _t(W)) + 0.01 * tt[:, None, None]

    ref_loss, ref_info = JP.diffuser_p_losses(jsched, jmodel, jnp.asarray(x0), jnp.asarray(t),
                                              key, w, predict_epsilon=predict_epsilon)
    loss, info = TP.diffuser_p_losses(tsched, tmodel, _t(x0), _t(t), _t(noise),
                                      _t(np.asarray(w)), predict_epsilon=predict_epsilon)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_TOL)
    np.testing.assert_allclose(info["a0_loss"].item(), float(ref_info["a0_loss"]),
                               rtol=LOSS_TOL)


# -- optimizers, EMA, accumulation on a toy parameter set -------------------


class Toy(torch.nn.Module):
    def __init__(self, params: dict):
        super().__init__()
        self.a = torch.nn.Parameter(_t(params["a"]).clone())
        self.b = torch.nn.Parameter(_t(params["b"]).clone())


def _toy(seed=0):
    rng = np.random.default_rng(seed)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(8)]
    return params, grads


def _set_grads(model, g):
    for name, p in model.named_parameters():
        p.grad = _t(g[name]).clone()


@pytest.mark.parametrize("schedule", [None, "cosine", "linear", "exponential"])
@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_make_optimizer_matches_optax(kind, schedule):
    params, grads = _toy()
    kw = dict(lr=1e-2, weight_decay=0.1, betas=(0.9, 0.98), schedule=schedule,
              num_train_steps=6, schedule_kwargs={"decay_steps": 2, "decay_rate": 0.5})
    tx = JSt.make_optimizer(kind, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    model = Toy(params)
    opt, sched = TSt.make_optimizer(model.parameters(), kind, **kw)
    for g in grads[:5]:
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        _set_grads(model, g)
        opt.step()
        sched.step()
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[name]),
                                       rtol=OPT_TOL, atol=OPT_TOL, err_msg=name)


@pytest.mark.parametrize("accum", [1, 2])
def test_ema_gates_match_apply_gradients(accum):
    """EMA copy before ``start``, lerp every ``every`` micro-steps, gates in
    micro-steps (the JAX CLI's MultiSteps wrap with wrap_accum=False)."""
    params, grads = _toy(1)
    tx = JSt.make_optimizer("adam", lr=1e-2)
    if accum > 1:
        tx = optax.MultiSteps(tx, accum)
    ema = JSt.EMAConfig(decay=0.9, start=4, every=2)
    jstate = JSt.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx, ema)
    model = Toy(params)
    opt, sched = TSt.make_optimizer(model.parameters(), "adam", lr=1e-2)
    tstate = TSt.TrainState(model, opt, sched, TSt.EMAConfig(0.9, 4, 2), accum=accum)
    for g in grads:
        jstate = jstate.apply_gradients(jax.tree_util.tree_map(jnp.asarray, g), tx)
        _set_grads(model, g)
        tstate.apply_gradients()
        assert tstate.step == int(jstate.step)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jstate.params[name]),
                                       rtol=OPT_TOL, atol=OPT_TOL)
            np.testing.assert_allclose(tstate.ema_params[name].numpy(),
                                       np.asarray(jstate.ema_params[name]),
                                       rtol=OPT_TOL, atol=OPT_TOL)


def test_multisteps_two_micro_batches_equal_one_full_batch():
    """k=2 accumulation of two half batches == one step on the full batch
    (the mean loss's gradient is the mean of the halves'), and the
    parameters do not move after the first micro-step."""
    rng = np.random.default_rng(4)
    params, _ = _toy(2)
    x = rng.normal(size=(8, 3)).astype(np.float32)
    y = rng.normal(size=(8, 4)).astype(np.float32)

    def run(accum, batches):
        model = Toy(params)
        opt, sched = TSt.make_optimizer(model.parameters(), "adamw", lr=1e-2,
                                        weight_decay=0.1)
        state = TSt.TrainState(model, opt, sched, accum=accum)
        seen = []
        for xb, yb in batches:
            opt.zero_grad(set_to_none=True)
            loss = ((_t(xb) @ model.a - _t(yb)) ** 2).mean() + model.b.square().mean()
            loss.backward()
            state.apply_gradients()
            seen.append(model.a.detach().clone())
        return seen

    split = run(2, [(x[:4], y[:4]), (x[4:], y[4:])])
    full = run(1, [(x, y)])
    np.testing.assert_array_equal(split[0].numpy(), params["a"])
    np.testing.assert_allclose(split[1].numpy(), full[0].numpy(), rtol=1e-6, atol=1e-7)


# -- Trainer steps of the temporal U-Net -------------------------------------


class FixedBatch:
    """A dataset whose every batch is the same one."""

    def __init__(self, x0):
        self.batch = JD.Batch(trajectories=x0, motion_class=np.zeros(len(x0), np.int32),
                              mask=np.ones(x0.shape[:2], np.float32), cond_frame=x0[:, 0])

    def epochs(self, batch_size, seed=0, class_balanced=False):
        while True:
            yield self.batch


def _jax_draws(seed, n, shape):
    """(t, noise) per micro-step, as the JAX Trainer + make_loss_fn draw them."""
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n):
        rng, step_rng = jax.random.split(rng)
        t_rng, n_rng, _, _ = jax.random.split(step_rng, 4)
        t = jax.random.randint(t_rng, (shape[0],), 0, T)
        noise = jax.random.normal(n_rng, shape, jnp.float32)
        out.append((np.asarray(t), np.asarray(noise)))
    return out


def test_trainer_steps_match_jax():
    """5 optimizer steps at accumulation 2 (10 micro-steps) of a dim-16 U-Net
    from the same converted weights: losses and the best model within 1e-4
    (relative). Params and EMA: at least 99.9 % of each tensor's elements
    within 1e-5 of its largest value plus 1 % of the learning rate, and
    every element within one learning rate. Adam moves each element by about lr per update whatever its
    gradient's size, so an element whose gradient is near zero (and so
    differs in sign between two f32 evaluations) may differ by a fraction of
    lr; a wrong rule (schedule, decay, EMA gate, accumulation) moves every
    element."""
    steps, accum, seed, lr = 5, 2, 0, 1e-3
    model_j, params, _ = jax_unet(16, False)
    x0 = np.random.default_rng(5).normal(size=(2, H, D)).astype(np.float32)
    weights = JP.diffuser_loss_weights(H, D, 1.0, 1.0)
    jsched = JS.make_schedule("cosine", T, convention="diffuser")
    tx = optax.MultiSteps(JSt.make_optimizer("adamw", lr=lr, betas=(0.9, 0.98),
                                             schedule="exponential"), accum)
    ema = JSt.EMAConfig(decay=0.9, start=4, every=3)
    cfg = dict(num_train_steps=steps, batch_size=2, gradient_accumulate_every=accum,
               log_every=1, seed=seed)
    jtrainer = JL.Trainer(
        JSt.TrainState.create(params, tx, ema), tx,
        JL.make_loss_fn(jsched, model_j.apply, kind="diffuser", weights=weights),
        FixedBatch(x0), JL.TrainerConfig(**cfg), log_fn=lambda s: None, wrap_accum=False)
    jtrainer.train()

    model = torch_unet(16, False)
    opt, sched = TSt.make_optimizer(model.parameters(), "adamw", lr=lr, betas=(0.9, 0.98),
                                    schedule="exponential")
    state = TSt.TrainState(model, opt, sched, TSt.EMAConfig(0.9, 4, 3), accum=accum)
    loss_fn = TL.make_loss_fn(TS.make_schedule("cosine", T, convention="diffuser", device="cpu"),
                              model, weights=_t(np.asarray(weights)))
    trainer = TL.Trainer(state, loss_fn, FixedBatch(x0), TL.TrainerConfig(**cfg),
                         log_fn=lambda s: None, num_timesteps=T)
    draws = iter(_jax_draws(seed, steps * accum, x0.shape))
    trainer.draw = lambda x: tuple(map(_t, next(draws)))
    trainer.train()

    assert len(trainer.metrics) == len(jtrainer.metrics) == steps * accum
    for ours, ref in zip(trainer.metrics, jtrainer.metrics):
        assert ours.keys() == ref.keys() and ours["step"] == ref["step"]
        np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=1e-4)
        np.testing.assert_allclose(ours["a0_loss"], ref["a0_loss"], rtol=1e-4)
    assert trainer.best_step == jtrainer.best_step
    np.testing.assert_allclose(trainer.best_loss, jtrainer.best_loss, rtol=1e-4)
    assert state.step == int(jtrainer.state.step) == steps * accum

    for ours, ref in ((model.state_dict(), jtrainer.state.params),
                      (state.ema_params, jtrainer.state.ema_params)):
        ref = temporal_unet_from_flax(jax.tree_util.tree_map(np.asarray, ref))
        for k, v in ref.items():
            diff = (ours[k] - v).abs()
            close = (diff <= 1e-5 * v.abs().max() + 1e-2 * lr).float().mean().item()
            assert close >= 0.999 and diff.max().item() <= lr, (k, close, diff.max().item())
