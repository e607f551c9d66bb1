"""The port's timestep samplers against the JAX package's: the loss-aware
distribution before and after every row of the ring buffer is full, its
importance weights, and ``update_with_losses`` with timesteps repeated
inside one batch (more often than a row holds), step after step."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.diffusion import timestep_sampling as JTS
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import timestep_sampling as TTS

torch.set_num_threads(2)

T, HIST = 8, 3
W_TOL = 1e-6


def _states(batches):
    """Feed the same (t, losses) batches to both samplers; -> both states."""
    js, ts = JTS.LossSecondMomentState.create(T, HIST), TTS.LossSecondMomentState.create(T, HIST, device="cpu")
    for t, losses in batches:
        js = JTS.update_with_losses(js, jnp.asarray(t), jnp.asarray(losses))
        TTS.update_with_losses(ts, torch.from_numpy(t), torch.from_numpy(losses))
    return js, ts


def _batches(seed, n, batch=7):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, T, size=batch), rng.random(batch).astype(np.float32) + 0.1)
            for _ in range(n)]


def test_update_with_repeated_timesteps_matches_scan():
    """One t five times in a batch (more than HIST), another twice, then
    mixed batches: every loss enters its row in batch order, the oldest
    falling out, exactly as the JAX scan records them."""
    first = (np.array([2, 2, 5, 2, 2, 5, 2, 0]), np.arange(1, 9, dtype=np.float32))
    batches = [first] + _batches(1, 6)
    js, ts = JTS.LossSecondMomentState.create(T, HIST), TTS.LossSecondMomentState.create(T, HIST, device="cpu")
    for t, losses in batches:
        js = JTS.update_with_losses(js, jnp.asarray(t), jnp.asarray(losses))
        TTS.update_with_losses(ts, torch.from_numpy(t), torch.from_numpy(losses))
        np.testing.assert_array_equal(ts.losses.numpy(), np.asarray(js.losses))
        np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
    np.testing.assert_array_equal(_states([first])[1].losses[2].numpy(), [4, 5, 7])


def test_update_over_a_device_axis_raises(tmp_path):
    """update_with_losses over a process group is ported: in a group of one it
    records exactly what the update without a group records (two ranks:
    tests/test_torch_parallel_mesh.py)."""
    from _torch_dist_workers import one_rank_group

    t, losses = torch.tensor([3, 1, 3, 0]), torch.tensor([0.5, 2.0, 1.5, 0.25])
    ours = TTS.LossSecondMomentState.create(T, HIST, device="cpu")
    ref = TTS.LossSecondMomentState.create(T, HIST, device="cpu")
    TTS.update_with_losses(ref, t, losses)
    with one_rank_group(tmp_path) as group:
        TTS.update_with_losses(ours, t, losses, group)
    assert torch.equal(ours.losses, ref.losses) and torch.equal(ours.counts, ref.counts)
    assert ref.counts[3] == 2


@pytest.mark.parametrize("steps", [0, 2, 12])
def test_weights_before_and_after_warm_up(steps):
    """Uniform until every row holds HIST losses, then sqrt(E[loss^2])
    mixed with uniform; the importance weights 1 / (T p[t]) at every t."""
    js, ts = _states(_batches(2, steps))
    warm = bool((np.asarray(js.counts) >= HIST).all())
    assert warm == (steps == 12)
    ref = np.asarray(JTS.loss_aware_weights(js))
    np.testing.assert_allclose(TTS.loss_aware_weights(ts).numpy(), ref, rtol=W_TOL)
    if not warm:
        np.testing.assert_array_equal(ref, np.full(T, 1.0 / T, np.float32))
    t = torch.arange(T)
    np.testing.assert_allclose(TTS.importance_weights(ts, t).numpy(), 1.0 / (T * ref),
                               rtol=W_TOL)


def test_loss_aware_timesteps_follow_the_distribution():
    """Draws from the warm distribution: their frequencies match p (400k
    draws, 4 sigma), and each weight is 1 / (T p[t])."""
    _, ts = _states(_batches(3, 12))
    p = TTS.loss_aware_weights(ts)
    g = torch.Generator().manual_seed(0)
    t, w = TTS.loss_aware_timesteps(ts, g, 400_000)
    freq = torch.bincount(t, minlength=T).double() / t.numel()
    sigma = torch.sqrt(p.double() * (1 - p.double()) / t.numel())
    assert ((freq - p.double()).abs() <= 4 * sigma).all()
    np.testing.assert_allclose(w.numpy(), (1.0 / (T * p[t])).numpy(), rtol=W_TOL)


def test_uniform_timesteps():
    g = torch.Generator().manual_seed(0)
    t, w = TTS.uniform_timesteps(g, 1000, T)
    assert t.min() >= 0 and t.max() < T and len(t.unique()) == T
    assert (w == 1).all() and w.dtype == torch.float32
