"""Sequence-sharded sampling of the local-attention transformer: the
horizon split over two gloo ranks on the CPU, held against JAX and against
one process.

- B3's halo entry (K3) through its plain version, each rank's QKV rows with
  one window of each neighbour's, against JAX's ``local_attention`` at B 2,
  h 2, N 512, dh 16, w 16 (``tests/test_parallel.py:56-75``);
- the ``LocalTransformer`` (dim 32, depth 2, 2 heads of 16, w 16) end to end
  against JAX's on converted weights (``tests/test_parallel.py:78-93``), and
  against the port's one-process forward with a prefix key mask, causal,
  and with a global-attention insert;
- K3's launch plan and the slab geometry it takes.

The ranks run ``tests/_torch_seq_workers.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_seq_workers as W
from deepmimic_diffusion_mujoco_tpu.models import local_attention as JLA
from deepmimic_diffusion_mujoco_tpu_torch.convert import local_transformer_from_flax
from deepmimic_diffusion_mujoco_tpu_torch.models.local_attention import LocalTransformer
from deepmimic_diffusion_mujoco_tpu_torch.ops import fused_local_attention as FK
from deepmimic_diffusion_mujoco_tpu_torch.parallel.launch import spawn_ranks

torch.set_num_threads(2)

SPAWN_TIMEOUT = 240.0
ATTN_TOL = 2e-5    # tests/test_parallel.py:75
MODEL_TOL = 3e-5   # tests/test_parallel.py:93
PORT_TOL = 1e-5    # sharded against the port's one-process forward: f32 sums in another order
B, HEADS, N, DH, WINDOW = 2, 2, 512, 16, 16


@pytest.fixture(scope="module")
def qkv_heads():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(B, HEADS, N, DH)).astype(np.float32) for _ in range(3)]


@pytest.fixture(scope="module")
def jax_model():
    model = JLA.LocalTransformer(input_dim=W.D, **W.LA)
    x = np.random.default_rng(1).normal(size=(2, N, W.D)).astype(np.float32)
    t = np.array([3, 40], np.int64)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))
    params = jax.tree_util.tree_map(np.asarray, params)
    return model, params, x, t


@pytest.fixture(scope="module")
def states(jax_model):
    _, params, _, _ = jax_model
    state = {k: v.numpy() for k, v in local_transformer_from_flax(params).items()}
    torch.manual_seed(2)  # the global-insert model: seeded port weights
    glob = LocalTransformer(W.D, **W.LA, **W.GLOBAL)
    return state, {k: v.detach().numpy() for k, v in glob.state_dict().items()}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, qkv_heads, jax_model, states):
    q, k, v = qkv_heads
    qkv = np.concatenate([a.transpose(0, 2, 1, 3).reshape(B, N, HEADS * DH) for a in (q, k, v)],
                         axis=-1)
    _, _, x, t = jax_model
    store = tmp_path_factory.mktemp("store")
    return spawn_ranks(W.seq_attention_worker, 2, str(store), device="cpu",
                       args=(qkv, *states, x, t), timeout=SPAWN_TIMEOUT, threads=1)


def _joined(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=1)


def test_halo_attention_matches_jax_local_attention(two_ranks, qkv_heads):
    q, k, v = (jnp.asarray(a) for a in qkv_heads)
    ref = np.asarray(JLA.local_attention(q, k, v, WINDOW, exact_windowsize=True,
                                         use_rotary=True))               # (B, h, N, dh)
    out = _joined(two_ranks, "attention").reshape(B, N, HEADS, DH).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out, ref, atol=ATTN_TOL, rtol=0)


def test_sharded_local_transformer_matches_jax(two_ranks, jax_model):
    model, params, x, t = jax_model
    ref = np.asarray(jax.jit(model.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    out = _joined(two_ranks, "model")
    assert out.shape == (2, N, W.D)
    np.testing.assert_allclose(out, ref, atol=MODEL_TOL, rtol=0)


@pytest.mark.parametrize("case", ["masked", "causal", "global"])
def test_sharded_local_transformer_matches_one_process(two_ranks, jax_model, states, case):
    """A prefix key mask (lengths summed over the ranks; frames whose window
    holds no valid key are padding and not compared), the causal model (no
    rows from the right), a global-attention insert (K/V gathered)."""
    _, _, x, t = jax_model
    state, glob = states
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    with torch.inference_mode():
        if case == "masked":
            mask = (torch.arange(N)[None] < torch.tensor(W.LA_MASK_LENGTHS)[:, None]).float()
            ref = W.local_transformer(state)(xt, tt, mask=mask).numpy()
        elif case == "causal":
            ref = W.local_transformer(state, causal=True)(xt, tt).numpy()
        else:
            ref = W.local_transformer(glob, **W.GLOBAL)(xt, tt).numpy()
    out = _joined(two_ranks, f"model_{case}")
    if case == "masked":
        for row, length in enumerate(W.LA_MASK_LENGTHS):
            np.testing.assert_allclose(out[row, :length], ref[row, :length], atol=PORT_TOL,
                                       rtol=0)
    else:
        np.testing.assert_allclose(out, ref, atol=PORT_TOL, rtol=0)


@pytest.mark.parametrize("q0,after", [(0, 16), (16, 16), (16, 0), (0, 0)])
def test_halo_key_slots_clamp_the_trajectory_ends(q0, after):
    """K3's Nq + 2w key slots are the slab's rows, the missing neighbour's
    side clamped onto the rank's own rows and flagged, as B3 clamps its edge
    chunks."""
    Nq, w = 64, 16
    Nh = q0 + Nq + after
    rows, invalid = FK.halo_key_slots(Nh, q0, Nq, w)
    assert rows.shape == (Nq + 2 * w,) and rows.min() >= 0 and rows.max() < Nh
    np.testing.assert_array_equal(rows[w:w + Nq], np.arange(q0, q0 + Nq))
    assert invalid[:w].all() == (q0 == 0) and invalid[-w:].all() == (after == 0)
    assert not invalid[w:w + Nq].any()


@pytest.mark.parametrize("Nq,causal", [(512, False), (512, True), (64, False), (16, False)])
def test_halo_plan_covers_the_rank_rows(Nq, causal):
    """The default plan's slabs cover the rank's own rows once, from slab
    row q0; each block's key band stays in the slab and holds every key its
    rows' windows reach."""
    w, q0 = WINDOW, WINDOW
    Nh = q0 + Nq + (0 if causal else w)
    plan = FK.halo_plan(4, 8, 64, w, q0, Nq, Nh, causal, True)
    slabs = FK.slab_rows(Nh, Nq, plan.slab, base=q0, Nq=Nq)
    assert [r for s0, s1 in slabs for r in range(s0, s1)] == list(range(q0, q0 + Nq))
    assert plan.blocks == len(slabs) and plan.cap >= plan.band
    for s0, s1 in slabs:
        lo, hi = FK.key_band(s0, s1, w, causal, Nq, w, Nh, base=q0)
        assert 0 <= lo and hi <= Nh and hi - lo <= plan.band
        assert lo <= max((s0 // w - 1) * w, 0) and hi >= min(s1 + (0 if causal else w), Nh)


@pytest.mark.parametrize("Nh,q0,Nq,pos0", [(80, 8, 64, 48), (96, 0, 64, 0), (96, 16, 60, 16),
                                           (96, 16, 64, 8)])
def test_halo_entry_refuses_other_slabs(Nh, q0, Nq, pos0):
    qkv = torch.zeros(1, Nh, 3 * 2 * 16)
    with pytest.raises(ValueError, match="K3 takes"):
        FK.local_attention_halo(qkv, 2, 16, 16, q0, Nq, pos0)


def test_halo_entry_refuses_gradients():
    qkv = torch.zeros(1, 96, 96, requires_grad=True)
    with pytest.raises(RuntimeError, match="sampling only"):
        FK.local_attention_halo(qkv, 2, 16, 16, 16, 64, 48)
