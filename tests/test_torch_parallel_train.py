"""The port's parallel layer, part 2: data-parallel training. Two gloo ranks
against one process over the same global batches, for the repo's
experiment configs cut small: the U-Net (diffuser loss, accumulation 2),
stack B (x0 loss with jagged masks, label drop and dropout; v4 with the
loss-aware sampler) and local attention (attention and feed-forward
dropout through the keep masks), plus one data-parallel ``cli.train`` run;
and the single-process step against JAX's single-device step, the oracle
JAX's own data-parallel test holds its sharded step to.

The two ranks run ``tests/_torch_dist_workers.py:train_worker`` in fresh
processes; the single-process reference is the same function run here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as W
from deepmimic_diffusion_mujoco_tpu.data import datasets as JD
from deepmimic_diffusion_mujoco_tpu.diffusion import process as JP
from deepmimic_diffusion_mujoco_tpu.diffusion import schedules as JS
from deepmimic_diffusion_mujoco_tpu.train import loop as JL
from deepmimic_diffusion_mujoco_tpu.train import state as JSt
from deepmimic_diffusion_mujoco_tpu_torch.convert import temporal_unet_from_flax
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import schedules as TS
from deepmimic_diffusion_mujoco_tpu_torch.parallel.launch import spawn_ranks
from deepmimic_diffusion_mujoco_tpu_torch.train import loop as TL
from deepmimic_diffusion_mujoco_tpu_torch.train import state as TSt
from test_torch_temporal_unet import jax_unet, torch_unet

torch.set_num_threads(2)

GRAD_TOL = 1e-5       # |g(2 ranks) - g(1 process)| / max |g(1 process)|
LOSS_TOL = 1e-6       # relative
STEP_LOSS_TOL = 1e-5  # relative, every micro-step's loss after parameters drift by rounding
SAMPLER_TOL = 1e-6    # relative: per-sample losses from forwards over other batch sizes
LR = 1e-3             # train_config's learning rate
SPAWN_TIMEOUT = 300.0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's, rank 1's, one process's) train_worker results."""
    store = tmp_path_factory.mktemp("store")
    ranks = spawn_ranks(W.train_worker, 2, str(store), device="cpu", timeout=SPAWN_TIMEOUT,
                        threads=1, args=(str(tmp_path_factory.mktemp("dp_run")),))
    return ranks[0], ranks[1], W.train_worker(0, 1, str(tmp_path_factory.mktemp("run")))


def _close_params(ours, ref, key="params", steps=1, tight=True):
    """Parameters after ``steps`` Adam steps. An element whose first-step
    gradient lies within GRAD_TOL of zero has no sign the gradient check
    settles, and Adam steps it by about +-lr whatever its size: it may
    differ by 2 lr a step (the conv biases in front of GroupNorm, whose
    gradient is zero in exact arithmetic, are such). Every other element
    within one learning rate, and with ``tight`` test_trainer_steps_match_jax's
    bound: at least 99.9 % of a tensor's within 1e-5 of its largest value
    plus 1 % of the learning rate."""
    gmax = max(np.abs(g).max() for g in ref["grads"].values())
    bad = []
    for k, v in ref[key].items():
        diff = np.abs(ours[key][k] - v)
        free = np.abs(ref["grads"][k]) <= GRAD_TOL * gmax
        if diff[free].size and diff[free].max() > 2 * LR * steps:
            bad.append((k, "sign-free", diff[free].max()))
        d = diff[~free]
        if d.size:
            close = (d <= 1e-5 * np.abs(v).max() + 1e-2 * LR).mean() if tight else 1.0
            if close < 0.999 or d.max() > LR:
                bad.append((k, close, d.max()))
    assert not bad, bad


@pytest.mark.parametrize("case", W.TRAIN_CASES)
def test_ranks_hold_the_same_bits(runs, case):
    r0, r1, _ = runs
    for key in ("params", "ema", "grads"):
        for k, v in r0[case][key].items():
            np.testing.assert_array_equal(v, r1[case][key][k], err_msg=f"{key} {k}")
    assert r0[case]["losses"] == r1[case]["losses"]


@pytest.mark.parametrize("case", W.TRAIN_CASES)
def test_two_ranks_give_the_single_process_step(runs, case):
    """The first step's averaged gradients within GRAD_TOL, its loss within
    LOSS_TOL and the parameters after it within the trainer bound, against
    one process's over the same global batch. Over 1 + MORE_STEPS optimizer
    steps: every micro-step's loss within STEP_LOSS_TOL (a random draw that
    drifted from one process's would move it far more) and every parameter
    within one learning rate (Adam's steps on elements whose gradient is
    near zero follow its sign, which rounding flips)."""
    r0, _, one = runs
    ours, ref = r0[case], one[case]
    gmax = max(np.abs(g).max() for g in ref["grads"].values())
    assert gmax > 0
    for k, g in ref["grads"].items():
        err = np.abs(ours["grads"][k] - g).max()
        assert err <= GRAD_TOL * gmax, (k, err, gmax)
    np.testing.assert_allclose(ours["first_loss"], ref["first_loss"], rtol=LOSS_TOL)
    _close_params(ours, ref, "first_params")
    np.testing.assert_allclose(ours["losses"], ref["losses"], rtol=STEP_LOSS_TOL)
    _close_params(ours, ref, steps=1 + W.MORE_STEPS, tight=False)


def test_masked_losses_see_jagged_ranks(runs):
    """The stack-B batches split into halves with different numbers of valid
    frames, so only the global count gives the single-process loss."""
    _, _, one = runs
    for case in ("b_x0", "b_loss_aware"):
        frames = one[case]["valid_frames"]
        assert frames[0] != frames[1], frames


def test_loss_aware_state_over_two_ranks(runs):
    """Every rank records all (t, loss) pairs in rank order: the counts are
    the single process's exactly, the losses within SAMPLER_TOL."""
    r0, r1, one = runs
    ref = one["b_loss_aware"]
    for r in (r0, r1):
        np.testing.assert_array_equal(r["b_loss_aware"]["sampler_counts"], ref["sampler_counts"])
        np.testing.assert_allclose(r["b_loss_aware"]["sampler_losses"], ref["sampler_losses"],
                                   rtol=SAMPLER_TOL, atol=0)
    assert ref["sampler_counts"].sum() == 3 * 8


def test_cli_train_data_parallel(runs):
    """cli.train in a group of two: rank 0 alone prints and writes
    training_metrics.json; both hold the bits; the parameters match a
    single-process cli.train run."""
    r0, r1, one = runs
    assert r0["cli"]["printed_lines"] == one["cli"]["printed_lines"] > 0
    assert r1["cli"]["printed_lines"] == 0
    assert r0["cli"]["wrote_metrics"]
    for k, v in r0["cli"]["params"].items():
        np.testing.assert_array_equal(v, r1["cli"]["params"][k])
    ref = {"params": one["cli"]["params"], "grads": one["unet"]["grads"]}
    _close_params(r0["cli"], ref, steps=2, tight=False)


def test_single_process_step_matches_jax():
    """One Adam step of a dim-8 U-Net from converted weights, with JAX's t
    and noise: the loss and every gradient against JAX's single-device
    step, the parameters after it within the trainer bound."""
    B, H, D, T = 4, 16, 35, 50
    model_j, params, _ = jax_unet(8, False)
    x0 = np.random.default_rng(8).normal(size=(B, H, D)).astype(np.float32)
    weights = JP.diffuser_loss_weights(H, D, 1.0, 1.0)
    jsched = JS.make_schedule("cosine", T, convention="diffuser")
    jloss = JL.make_loss_fn(jsched, model_j.apply, kind="diffuser", weights=weights)
    tx = JSt.make_optimizer("adam", lr=LR)
    rng = jax.random.PRNGKey(4)
    batch = JD.Batch(trajectories=jnp.asarray(x0), motion_class=jnp.zeros(B, jnp.int32),
                  mask=jnp.ones((B, H)), cond_frame=jnp.asarray(x0[:, 0]))
    # make_train_step's body: the jitted loss and gradients, then apply_gradients
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params, batch, rng)
    state_j = JSt.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    state_j = state_j.apply_gradients(ref_grads, tx)
    t_rng, n_rng, _, _ = jax.random.split(rng, 4)
    t = np.array(jax.random.randint(t_rng, (B,), 0, T))
    noise = np.array(jax.random.normal(n_rng, x0.shape, jnp.float32))

    model = torch_unet(8, False).train()
    opt, sched = TSt.make_optimizer(model.parameters(), "adam", lr=LR)
    state = TSt.TrainState(model, opt, sched)
    loss_fn = TL.make_loss_fn(TS.make_schedule("cosine", T, convention="diffuser", device="cpu"),
                              model, weights=torch.from_numpy(np.array(weights)))
    loss, _ = TL.train_step(state, loss_fn, torch.from_numpy(x0), torch.from_numpy(t),
                            torch.from_numpy(noise))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_TOL)
    ref_g = temporal_unet_from_flax(jax.tree_util.tree_map(np.asarray, ref_grads))
    ours_g = {n: p.grad for n, p in model.named_parameters()}
    gmax = max(g.abs().max().item() for g in ref_g.values())
    for k, g in ref_g.items():
        err = (ours_g[k] - g).abs().max().item()
        assert err <= GRAD_TOL * gmax, (k, err, gmax)
    ref = {"params": {k: v.numpy() for k, v in temporal_unet_from_flax(
        jax.tree_util.tree_map(np.asarray, state_j.params)).items()},
        "grads": {k: v.numpy() for k, v in ref_g.items()}}
    _close_params({"params": {k: v.numpy() for k, v in model.state_dict().items()}}, ref)
