"""Sequence-sharded sampling of the temporal U-Net: the horizon split over
gloo ranks on the CPU, held against one process and against JAX.

- B1's sharded form through its plain versions (K1 on each rank's rows with
  its halo, the statistics merged by Chan's formula, K2) over R in {2, 4}
  slices, against the whole horizon's ``conv_gn_mish_plain`` and JAX's
  ``conv_gn_mish_reference``;
- ``exchange_halo`` and ``gather_horizon``, exact;
- the dim-16 ``TemporalUnet`` forward at H 512 over two ranks against JAX's
  ``TemporalUnet.apply`` on converted weights, with and without attention;
- the posterior chain (cosine T 5, (2, 512, 35)) over 2 and 4 ranks against
  the one-process chain from the same generator (``tests/test_parallel.py:
  30-53``'s tolerance), and ``holding_box`` / ``inbetween`` chains whose
  clamped frames stay exact;
- ``multihost_check --seq 2``: four processes on a 2 x 2 (data, seq) grid
  against one process (``tests/test_multihost.py:81-104``'s counterpart);
- the refusals.

The ranks run ``tests/_torch_seq_workers.py`` (``parallel.launch.spawn_ranks``,
a file store under the test's temporary directory).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_seq_workers as W
from deepmimic_diffusion_mujoco_tpu.models.temporal_unet import TemporalUnet as JaxUnet
from deepmimic_diffusion_mujoco_tpu.ops.pallas.conv_block_kernel import conv_gn_mish_reference
from deepmimic_diffusion_mujoco_tpu_torch.convert import temporal_unet_from_flax
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import conditioning
from deepmimic_diffusion_mujoco_tpu_torch.models.local_attention import LocalTransformer
from deepmimic_diffusion_mujoco_tpu_torch.models.temporal_unet import TemporalUnet
from deepmimic_diffusion_mujoco_tpu_torch.models.transformer import TransformerMotionModel
from deepmimic_diffusion_mujoco_tpu_torch.models.transformer_decoder import (
    TransformerDecoderMotionModel,
)
from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_block_kernel as CB
from deepmimic_diffusion_mujoco_tpu_torch.parallel import multihost_check
from deepmimic_diffusion_mujoco_tpu_torch.parallel.launch import spawn_ranks
from deepmimic_diffusion_mujoco_tpu_torch.utils import rng as rnglib
from deepmimic_diffusion_mujoco_tpu_torch.utils import seq as seqlib

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 240.0
BLOCK_TOL = 1e-4      # f32 sums in another order (tests/test_torch_conv_block.py's tolerance)
FORWARD_TOL = 2e-4    # port against JAX after 33 blocks (tests/test_torch_temporal_unet.py's)
CHAIN_RTOL, CHAIN_ATOL = 1e-4, 1e-3  # tests/test_parallel.py:50-53
CHECK_TOL = 1e-5      # multihost_check against one process (tests/test_torch_parallel_tools.py)
H_FORWARD = 512


def _flax_params(model, seed):
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, W.D)),
                            jnp.zeros((1,)))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name.endswith("kernel"):
            a = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("gn_scale", "g"):
            a = 1.0 + 0.05 * rng.normal(size=s.shape)
        else:
            a = 0.05 * rng.normal(size=s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _numpy_state(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def jax_unets():
    """attention -> (flax model, numpy params)."""
    out = {}
    for attention in (False, True):
        model = JaxUnet(transition_dim=W.D, dim=16, attention=attention)
        out[attention] = (model, _flax_params(model, 16 + attention))
    return out


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, H_FORWARD, W.D)).astype(np.float32)
    return x, np.array([3, 17], np.int64)


@pytest.fixture(scope="module")
def states():
    """Seeded port weights of the chain models (dim 16 and COND_DIM)."""
    torch.manual_seed(0)
    chain = _numpy_state(TemporalUnet(W.D, dim=16))
    cond = _numpy_state(TemporalUnet(W.D, dim=W.COND_DIM))
    return chain, cond


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, jax_unets, inputs, states):
    store = tmp_path_factory.mktemp("store")
    unets = {att: temporal_unet_from_flax(p) for att, (_, p) in jax_unets.items()}
    unets = {att: {k: v.numpy() for k, v in sd.items()} for att, sd in unets.items()}
    return spawn_ranks(W.seq_unet_worker, 2, str(store), device="cpu",
                       args=(unets, *inputs, *states), timeout=SPAWN_TIMEOUT, threads=1)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, states):
    store = tmp_path_factory.mktemp("store4")
    return spawn_ranks(W.seq_unet_worker, 4, str(store), device="cpu",
                       args=({}, None, None, *states, False), timeout=SPAWN_TIMEOUT, threads=1)


def _joined(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=1)


# -- B1's sharded form: K1, the merge, K2 ------------------------------------

def _sharded_block(x, w, b, gamma, beta, groups, ranks):
    """K1 on each of ``ranks`` slices with its zero-padded halo, the
    statistics merged, K2 on each: the whole horizon put back together."""
    k = w.shape[0]
    pad = k // 2
    n = x.shape[1] // ranks
    padded = torch.nn.functional.pad(x, (0, 0, pad, pad))
    parts = [CB.conv_gn_stats_plain(padded[:, r * n:(r + 1) * n + 2 * pad], w, b, groups)
             for r in range(ranks)]
    count = n * (w.shape[2] // groups)
    merged = CB.chan_merge(torch.stack([s for _, s in parts]), count, 1e-5)
    return torch.cat([CB.gn_affine_mish_plain(pre, merged, gamma, beta, groups)
                      for pre, _ in parts], dim=1)


@pytest.mark.parametrize("H", [32, 64])
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("cin,cout,groups", [(35, 32, 8), (64, 48, 4)])
def test_sharded_conv_block_plain_matches_whole_horizon(H, k, ranks, cin, cout, groups):
    rng = np.random.default_rng(H + k + ranks + cin)
    x = rng.normal(size=(3, H, cin)).astype(np.float32)
    w = (rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin)).astype(np.float32)
    b, gamma, beta = (rng.normal(scale=s, size=(cout,)).astype(np.float32) + m
                      for s, m in ((0.5, 0.0), (0.05, 1.0), (0.05, 0.0)))
    arrays = [torch.from_numpy(a) for a in (x, w, b, gamma, beta)]
    out = _sharded_block(*arrays, groups, ranks).numpy()
    whole = CB.conv_gn_mish_plain(*arrays, groups).numpy()
    ref = np.asarray(conv_gn_mish_reference(*map(jnp.asarray, (x, w, b, gamma, beta)), groups))
    np.testing.assert_allclose(out, whole, atol=BLOCK_TOL, rtol=0)
    np.testing.assert_allclose(out, ref, atol=BLOCK_TOL, rtol=0)


@pytest.mark.parametrize("B,H,cin,cout", [(4, 512, 35, 128), (4, 64, 1024, 1024),
                                           (4, 64, 2048, 512), (16, 8, 1024, 1024),
                                           (32, 160, 128, 128), (2, 5, 8, 16),
                                           (4, 256, 128, 256), (4, 128, 512, 512),
                                           (4, 512, 128, 128)])
def test_stats_plan_fills_the_card(B, H, cin, cout):
    """K1's plan is B1's with the cluster doubled while the grid has fewer
    than FILL_CTAS CTAs (up to 8, one input channel a rank at least)."""
    b1, k1 = CB.conv_plan(B, H, cin, cout, 5, 8), CB.stats_plan(B, H, cin, cout, 5, 8)
    assert (k1.rows, k1.tile_h) == (b1.rows, b1.tile_h) and k1.cluster >= b1.cluster
    assert k1.grid == b1.grid // b1.cluster * k1.cluster and k1.cluster <= cin
    full = k1.grid >= CB.FILL_CTAS or k1.cluster == 8 or 2 * k1.cluster > cin
    assert full and (k1.cluster == b1.cluster or k1.grid // 2 < CB.FILL_CTAS)
    assert k1.smem_bytes + CB.STATIC_SMEM <= CB.MAX_SMEM


def test_chan_merge_keeps_the_two_pass_accuracy():
    """Slices whose mean is far above their spread: the merged variance is
    float64's of the whole, where E[x^2] - mean^2 in float32 loses it."""
    rng = np.random.default_rng(0)
    x = (1e3 + 1e-2 * rng.normal(size=(1, 4096, 1))).astype(np.float32)
    parts = []
    for r in range(4):
        s = torch.from_numpy(x[:, r * 1024:(r + 1) * 1024])
        mean = s.mean(dim=1)
        parts.append(torch.stack([mean, ((s - mean) ** 2).sum(dim=1)], dim=-1))
    merged = CB.chan_merge(torch.stack(parts), 1024, 0.0)  # (R, B, groups, 2)
    var = x.astype(np.float64).var()
    np.testing.assert_allclose(merged[0, 0, 1].item(), 1 / np.sqrt(var), rtol=1e-4)


def test_sharded_block_refuses_gradients():
    x = torch.zeros(1, 12, 4, requires_grad=True)
    w, b = torch.zeros(5, 4, 8), torch.zeros(8)
    with pytest.raises(RuntimeError, match="sampling only"):
        CB.conv_gn_mish_sharded(x, w, b, torch.ones(8), torch.zeros(8), 8, 1e-5, None)


# -- the exact helpers ----------------------------------------------------------

def test_exchange_halo_and_gather_horizon_are_exact(two_ranks):
    x = [W.exact_parts(r) for r in range(2)]
    whole = torch.cat([p[0] for p in x], dim=1).numpy()
    ints = torch.cat([p[1] for p in x], dim=1).numpy()
    r0, r1 = two_ranks
    for r in (r0, r1):
        np.testing.assert_array_equal(r["gathered"], whole)
        np.testing.assert_array_equal(r["gathered_ints"], ints)
        assert r["gathered_ints"].dtype == np.int64
    np.testing.assert_array_equal(r0["after"], x[1][0][:, :2].numpy())
    np.testing.assert_array_equal(r1["before"], x[0][0][:, -3:].numpy())
    assert not r0["before"].any() and not r1["after"].any()
    assert r0["before"].shape == (2, 3, 2) and r1["after"].shape == (2, 2, 2)
    assert list(r0["real"]) == [False, True] and list(r1["real"]) == [True, False]
    assert list(r0["frames"]) == [0, 8] and list(r1["frames"]) == [8, 16]


# -- the model and the chains ---------------------------------------------------

@pytest.mark.parametrize("attention", [False, True])
def test_sharded_unet_forward_matches_jax(two_ranks, jax_unets, inputs, attention):
    model, params = jax_unets[attention]
    x, t = inputs
    ref = np.asarray(jax.jit(model.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    out = _joined(two_ranks, f"forward_attention_{attention}")
    assert out.shape == (2, H_FORWARD, W.D)
    np.testing.assert_allclose(out, ref, atol=FORWARD_TOL, rtol=0)


@pytest.fixture(scope="module")
def one_process(states):
    chain_state, cond_state = states
    out = {"chain": W.chain(W.unet(chain_state, 16), W.CHAIN_SHAPE, 1).numpy()}
    model = W.unet(cond_state, W.COND_DIM)
    for name, cond in W.conditioners(W.COND_SHAPE[1]).items():
        for mode in ("posterior", "ddim"):
            out[f"{name}_{mode}"] = W.chain(model, W.COND_SHAPE, 2, None, cond, mode).numpy()
    return out


@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_posterior_chain_matches_one_process(two_ranks, four_ranks, one_process, ranks):
    got = _joined(two_ranks if ranks == 2 else four_ranks, "chain")
    assert got.shape == W.CHAIN_SHAPE and np.isfinite(got).all()
    # untrained eps-chains reach |x| ~ 1e2: compared relatively, as JAX's test does
    np.testing.assert_allclose(got, one_process["chain"], rtol=CHAIN_RTOL, atol=CHAIN_ATOL)


def test_sharded_chain_on_a_data_seq_grid(four_ranks, states):
    """Four ranks as a 2 x 2 (data, seq) mesh: each holds 2 rows and 64
    frames of the (4, 128, 35) chain, and the blocks put together are the
    one-process chain."""
    ref = W.chain(W.unet(states[0], 16), W.GRID_SHAPE, 1).numpy()
    assert [tuple(r["grid_block"]) for r in four_ranks] == [
        (d, s, 2, 64, W.D) for d in range(2) for s in range(2)]
    for r in four_ranks:
        np.testing.assert_allclose(r["grid_chain"], ref, rtol=CHAIN_RTOL, atol=CHAIN_ATOL)


@pytest.mark.parametrize("mode", ["posterior", "ddim"])
@pytest.mark.parametrize("name", ["holding_box", "inbetween"])
def test_conditioned_chains_keep_their_frames_exact(two_ranks, four_ranks, one_process, name,
                                                    mode):
    ref = one_process[f"{name}_{mode}"]
    box = np.array([0, 0, 0, 1.57, 0, 0, 0, 1.57], np.float32)
    rng = np.random.default_rng(5)
    start, end = (rng.normal(size=(W.COND_SHAPE[1], W.D)).astype(np.float32) for _ in range(2))
    e = W.COND_EDGE
    for ranks in (two_ranks, four_ranks):
        got = _joined(ranks, f"{name}_{mode}")
        np.testing.assert_allclose(got, ref, rtol=CHAIN_RTOL, atol=CHAIN_ATOL)
        if name == "holding_box":
            np.testing.assert_array_equal(got[:, :, 13:21], np.broadcast_to(box, got[:, :, 13:21]
                                                                            .shape))
        else:
            np.testing.assert_array_equal(got[:, :e], np.broadcast_to(start[:e], got[:, :e].shape))
            np.testing.assert_array_equal(got[:, -e:],
                                          np.broadcast_to(end[-e:], got[:, -e:].shape))
            np.testing.assert_array_equal(got[:, e:-e, 13:21],
                                          np.broadcast_to(box, got[:, e:-e, 13:21].shape))


def test_for_frames_slices_masks_and_frame0():
    """A conditioner on frames [lo, hi) acts as the whole one does there;
    clamp_frame0 acts on the rank holding frame 0 only; a callable without
    a per-frame form is refused."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 16, W.D)).astype(np.float32))
    ref = rng.normal(size=(16, W.D)).astype(np.float32)
    cond = conditioning.chain(
        conditioning.clamp_frames(ref, [0, 5, 9, 15], dims=[0, 1, 2], device="cpu"),
        conditioning.clamp_frame0(np.ones((2, 3)), device="cpu"),
        conditioning.steer_root(np.zeros((3, 2)), 16, W.D, frames=[4, 8, 12], device="cpu"))
    whole = cond(x)
    for lo, hi in ((0, 8), (8, 16), (4, 12)):
        part = conditioning.for_frames(cond, lo, hi, 16)(x[:, lo:hi])
        torch.testing.assert_close(part, whole[:, lo:hi], rtol=0, atol=0)
    assert conditioning.for_frames(None, 0, 8, 16) is None
    with pytest.raises(ValueError, match="per-frame form"):
        conditioning.for_frames(lambda t: t, 0, 8, 16)


def test_draw_frames_is_the_global_draw():
    full = torch.Generator().manual_seed(4)
    whole = torch.randn(2, 12, 3, generator=full)
    for rank in range(3):
        g = torch.Generator().manual_seed(4)
        part = rnglib.draw_frames(g, (2, 4, 3), lambda s: torch.randn(s, generator=g), rank, 3)
        torch.testing.assert_close(part, whole[:, 4 * rank:4 * rank + 4], rtol=0, atol=0)
        assert torch.equal(g.get_state(), full.get_state())


# -- the process grid -----------------------------------------------------------

def test_multihost_check_seq_grid_matches_one_process(tmp_path):
    """Four processes of the CLI with --seq 2: a 2 x 2 (data, seq) mesh whose
    seq pairs feed the same rows. The loss and the checksum are
    bit-identical across the four and within CHECK_TOL of one process."""
    store = f"file://{tmp_path}/store"
    cmd = [sys.executable, "-m", "deepmimic_diffusion_mujoco_tpu_torch.parallel.multihost_check",
           "--coordinator", store, "--num-processes", "4", "--device", "cpu", "--seq", "2"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(cmd + ["--process-id", str(i)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(4)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=SPAWN_TIMEOUT)
            assert p.returncode == 0, stderr
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    one = multihost_check.run_check(device="cpu")
    assert [o["process_id"] for o in outs] == [0, 1, 2, 3]
    assert all(o["process_count"] == 4 and o["data_ranks"] == 2 and o["seq"] == 2
               for o in outs)
    assert [o["data_rank"] for o in outs] == [0, 0, 1, 1]
    assert len({o["loss"] for o in outs}) == 1 and len({o["param_checksum"] for o in outs}) == 1
    for key in ("loss", "param_checksum"):
        np.testing.assert_allclose(outs[0][key], one[key], rtol=CHECK_TOL)
    with pytest.raises(ValueError, match="needs a group"):
        multihost_check.run_check(device="cpu", seq=2)


# -- refusals -------------------------------------------------------------------

class _Split:
    """A horizon split over two ranks whose collectives must not be reached."""
    rank, world = 0, 2

    def __getattr__(self, name):
        raise AssertionError(f"a refusal reached the collective {name}")


@pytest.mark.parametrize("case", ["horizon", "deepest", "grads", "transformer", "decoder",
                                  "decode", "la_training"])
def test_sharded_forwards_refuse_what_they_do_not_take(case):
    torch.manual_seed(0)
    unet = TemporalUnet(W.D, dim=8)
    expected = {"horizon": (ValueError, "divisible by ranks x 8 = 16"),
                "deepest": (ValueError, "fewer than the conv blocks' 2-row halo"),
                "grads": (RuntimeError, "sampling only"),
                "transformer": (NotImplementedError, "Queue A, seq sharding of the MDM"),
                "decoder": (NotImplementedError, "Queue A, seq sharding of the MDM"),
                "decode": (ValueError, "KV-cache decode does not run under a horizon split"),
                "la_training": (RuntimeError, "eval mode")}
    err, match = expected[case]
    with seqlib.sharded(_Split()), pytest.raises(err, match=match):
        if case == "grads":
            unet(torch.zeros(1, 16, W.D), torch.zeros(1))
            return
        with torch.no_grad():
            if case == "horizon":
                unet(torch.zeros(1, 12, W.D), torch.zeros(1))
            elif case == "deepest":
                unet(torch.zeros(1, 8, W.D), torch.zeros(1))
            elif case == "transformer":
                TransformerMotionModel(input_dim=W.D, latent_dim=32, n_heads=2, num_layers=1,
                                       dim_feedforward=64)(torch.zeros(1, 8, W.D),
                                                           torch.zeros(1))
            elif case == "decoder":
                TransformerDecoderMotionModel(16, W.D, dim=32, n_heads=2,
                                              num_layers=1)(torch.zeros(1, 8, W.D),
                                                            torch.zeros(1))
            elif case == "decode":
                la = LocalTransformer(W.D, dim=32, depth=1, heads=2, dim_head=16, causal=True)
                la(torch.zeros(1, 1, W.D), torch.zeros(1), cache=la.init_decode_cache(1),
                   decode_pos=0)
            else:
                LocalTransformer(W.D, dim=32, depth=1, heads=2, dim_head=16).train()(
                    torch.zeros(1, 16, W.D), torch.zeros(1))
