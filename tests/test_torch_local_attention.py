"""The port's windowed attention against the JAX package on the CPU: B3's
plain version (``fused_qkv_local_attention`` on CPU tensors) against the
interpreted Pallas kernel, the bucketed ``local_attention`` against JAX's,
B4's entry against the interpreted ``local_attention_tpu``, and B3's
gradient against ``jax.grad`` of the JAX kernel. Inputs are numpy arrays
from a seed, handed to both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.models import local_attention as JLA
from deepmimic_diffusion_mujoco_tpu.ops.pallas import fused_local_attention as JFK
from deepmimic_diffusion_mujoco_tpu.ops.pallas import local_attention_kernel as JK
from deepmimic_diffusion_mujoco_tpu_torch.models import local_attention as LA
from deepmimic_diffusion_mujoco_tpu_torch.ops import fused_local_attention as FK
from deepmimic_diffusion_mujoco_tpu_torch.ops import local_attention_kernel as LK

torch.set_num_threads(2)

TOL = 1e-5       # f32, the same chunk semantics and absolute-position rotary
GRAD_TOL = 1e-4
H, DH = 2, 16


@pytest.fixture(autouse=True)
def interpret():
    JFK.INTERPRET = JK.INTERPRET = True
    yield
    JFK.INTERPRET = JK.INTERPRET = False


def _inputs(N, w, causal, masks, seed=0, B=2, h=H, dh=DH):
    """qkv, prefix key mask (or None), keep mask (or None), keep_prob."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, N, 3 * h * dh)).astype(np.float32)
    km = keep = None
    if "mask" in masks:
        lengths = np.array([N - 5, N // 3])[:B]
        km = (np.arange(N)[None, :] < lengths[:, None]).astype(np.float32)
    if "keep" in masks:
        p = FK.plan(N, w, causal)
        keep = (rng.random((B, p["Np"], h * p["K"])) < 0.7).astype(np.float32)
    return qkv, km, keep, (0.7 if keep is not None else 1.0)


def _jax_b3(qkv, km, keep, kp, w, causal, h=H, dh=DH):
    as_j = lambda a: None if a is None else jnp.asarray(a)
    return np.asarray(JFK.fused_qkv_local_attention(jnp.asarray(qkv), h, dh, w, causal, True,
                                                    True, as_j(km), as_j(keep), kp))


def _port_b3(qkv, km, keep, kp, w, causal, h=H, dh=DH):
    as_t = lambda a: None if a is None else torch.from_numpy(a)
    return FK.fused_qkv_local_attention(torch.from_numpy(qkv), h, dh, w, causal, True, True,
                                        as_t(km), as_t(keep), kp).numpy()


@pytest.mark.parametrize("N", [32, 40, 384])  # single plan, autopad plan, sliced plan
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masks", ["none", "mask", "keep", "mask+keep"])
def test_fused_qkv_plain_matches_interpreted_kernel(N, causal, masks):
    qkv, km, keep, kp = _inputs(N, 16, causal, masks)
    ours = _port_b3(qkv, km, keep, kp, 16, causal)
    np.testing.assert_allclose(ours, _jax_b3(qkv, km, keep, kp, 16, causal), atol=TOL, rtol=0)


@pytest.mark.parametrize("N,w,causal", [
    (32, 16, False), (40, 16, True), (120, 16, False), (384, 16, False), (384, 16, True),
    (256, 8, False), (384, 48, False), (256, 64, True), (96, 24, False), (1000, 16, False),
])
def test_plan_and_supports_match_jax(N, w, causal):
    assert FK.plan(N, w, causal) == JFK._plan(N, w, causal)
    for xpos in (False, True):
        assert FK.supports(N, w, xpos, causal) == JFK.supports(N, w, xpos, causal)
    assert LK.supports(N, w, causal) == (not (N % w or N % 128 or w > 128))


def test_autopad_keys_are_valid_zero_keys():
    """N 120 pads to 128 with 8 zero keys that take part in the softmax: the
    result equals the N 128 call on zero-padded rows, and differs from the
    call where a key mask removes them."""
    N, Np, w = 120, 128, 16
    qkv, _, _, _ = _inputs(N, w, False, "none", seed=1)
    padded = np.concatenate([qkv, np.zeros((2, Np - N, qkv.shape[2]), np.float32)], axis=1)
    ours = _port_b3(qkv, None, None, 1.0, w, False)
    np.testing.assert_array_equal(ours, _port_b3(padded, None, None, 1.0, w, False)[:, :N])
    np.testing.assert_allclose(ours, _jax_b3(qkv, None, None, 1.0, w, False), atol=TOL, rtol=0)
    no_pad = (np.arange(Np)[None, :] < N).repeat(2, 0).astype(np.float32)
    masked = _port_b3(padded, no_pad, None, 1.0, w, False)[:, :N]
    assert np.abs(ours - masked)[:, N - w:].max() > 1e-3


@pytest.mark.parametrize("N", [48, 384])
def test_fully_masked_rows_take_the_chunk_mean_of_v(N):
    """A query whose keys are all masked (length 2: rows past 2 + w) gets
    the mean of V over its chunk's K key rows, clamped duplicates and pad
    rows included, not zero and not NaN."""
    w = 16
    qkv, km, keep, kp = _inputs(N, w, False, "mask+keep", seed=2)
    km[1] = (np.arange(N) < 2).astype(np.float32)
    p = FK.plan(N, w, False)
    idx, _ = FK.chunk_index_sets(p)
    v = np.concatenate([qkv[1, :, 2 * H * DH:], np.zeros((p["Np"] - N, H * DH), np.float32)])
    rows = np.arange(2 + w + 1, N)
    expected = np.stack([
        np.concatenate([
            ((keep[1, i, hd * p["K"]:(hd + 1) * p["K"]] / kp)[:, None]
             * v[idx[i // p["C"]], hd * DH:(hd + 1) * DH]).mean(0)
            for hd in range(H)])
        for i in rows])
    ours = _port_b3(qkv, km, keep, kp, w, False)
    assert np.isfinite(ours).all() and np.abs(ours[1, rows]).max() > 0
    np.testing.assert_allclose(ours[1, rows], expected, atol=TOL, rtol=0)
    np.testing.assert_allclose(ours, _jax_b3(qkv, km, keep, kp, w, False), atol=TOL, rtol=0)


def _qkv_heads(N, seed, B=2, h=H, dh=DH):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, h, N, dh)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("variant", [
    "plain", "causal", "not_exact", "autopad", "key_mask", "xpos", "bias_table",
    "mask_window_size", "no_rotary",
])
def test_local_attention_matches_jax(variant):
    N, w = (40 if variant == "autopad" else 64), 16
    q, k, v = _qkv_heads(N, seed=3)
    kw = {"causal": variant == "causal", "exact_windowsize": variant != "not_exact",
          "use_rotary": variant != "no_rotary"}
    rng = np.random.default_rng(4)
    jkw, tkw = dict(kw), dict(kw)
    if variant == "key_mask":
        km = (np.arange(N)[None, :] < np.array([[N], [N - 20]])).astype(np.float32)
        jkw["key_mask"], tkw["key_mask"] = jnp.asarray(km), torch.from_numpy(km)
    if variant == "xpos":
        jkw.update(use_xpos=True, xpos_scale_base=8, mask_window_size=w)
        tkw.update(use_xpos=True, xpos_scale_base=8, mask_window_size=w)
    if variant == "bias_table":
        table = rng.normal(size=(2 * w, H)).astype(np.float32)
        jkw["bias_table"], tkw["bias_table"] = jnp.asarray(table), torch.from_numpy(table)
    window = w
    if variant == "mask_window_size":  # a runtime window over the trained one
        window = 32
        jkw.update(use_xpos=True, mask_window_size=w)
        tkw.update(use_xpos=True, mask_window_size=w)
    ref = JLA.local_attention(*(jnp.asarray(t) for t in (q, k, v)), window, **jkw)
    ours = LA.local_attention(*(torch.from_numpy(t) for t in (q, k, v)), window, **tkw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_local_attention_dropout_draws_from_the_generator():
    q, k, v = (torch.from_numpy(t) for t in _qkv_heads(64, seed=5))

    def run(seed):
        return LA.local_attention(q, k, v, 16, attn_dropout=0.3,
                                  generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    plain = LA.local_attention(q, k, v, 16)
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(a).all()
    assert (a - plain).abs().max() > 1e-3
    with pytest.raises(ValueError, match="Generator"):
        LA.local_attention(q, k, v, 16, attn_dropout=0.3)


def test_dropout_keep_mask_layout_and_rate():
    g = torch.Generator().manual_seed(0)
    keep = FK.dropout_keep_mask(g, 0.7, 2, 120, 4, 16)
    p = FK.plan(120, 16, False)
    assert keep.shape == (2, p["Np"], 4 * p["K"]) and keep.dtype == torch.float32
    assert set(keep.unique().tolist()) == {0.0, 1.0}
    assert abs(keep.mean().item() - 0.7) < 0.01
    assert FK.dropout_keep_mask(g, 0.7, 2, 300, 4, 16) is None


@pytest.mark.parametrize("causal", [False, True])
def test_local_attention_heads_matches_interpreted_kernel(causal):
    """B4's entry on the CPU (its plain version) against the interpreted
    local_attention_tpu, and against the bucketed local_attention."""
    q, k, v = _qkv_heads(256, seed=6, h=3, dh=32)
    ref = JK.local_attention_tpu(*(jnp.asarray(t) for t in (q, k, v)), 16, causal, True, True)
    ours = LK.local_attention_heads(*(torch.from_numpy(t) for t in (q, k, v)), 16, causal)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    bucketed = LA.local_attention(*(torch.from_numpy(t) for t in (q, k, v)), 16, causal=causal)
    np.testing.assert_allclose(ours.numpy(), bucketed.numpy(), atol=TOL, rtol=0)


def test_windowed_attention_routes_like_local_attention_pallas():
    """The front door: the kernel entry where it applies, the bucketed path
    for unaligned N and xpos, as JAX's local_attention_pallas does."""
    for N, xpos in ((128, False), (96, False), (128, True)):
        q, k, v = _qkv_heads(N, seed=7)
        ref = jax.jit(lambda a, b, c: __import__(
            "deepmimic_diffusion_mujoco_tpu.ops.pallas", fromlist=["x"]).local_attention_pallas(
                a, b, c, 16, use_xpos=xpos, xpos_scale_base=8))(*(jnp.asarray(t) for t in (q, k, v)))
        ours = LK.windowed_attention(*(torch.from_numpy(t) for t in (q, k, v)), 16, use_xpos=xpos,
                                     xpos_scale_base=8)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="supports"):
        LK.local_attention_heads(*(torch.from_numpy(t) for t in _qkv_heads(96, seed=7)), 16)


@pytest.mark.parametrize("N,masks", [(32, "none"), (40, "mask+keep"), (384, "mask")])
def test_fused_qkv_gradient_matches_jax(N, masks):
    qkv, km, keep, kp = _inputs(N, 16, False, masks, seed=8)
    rng = np.random.default_rng(9)
    cot = rng.normal(size=(2, N, H * DH)).astype(np.float32)
    as_j = lambda a: None if a is None else jnp.asarray(a)
    g_ref = jax.grad(lambda x: (JFK.fused_qkv_local_attention(
        x, H, DH, 16, False, True, True, as_j(km), as_j(keep), kp) * cot).sum())(jnp.asarray(qkv))
    x = torch.from_numpy(qkv).requires_grad_()
    out = FK.fused_qkv_local_attention(x, H, DH, 16, False, True, True,
                                       None if km is None else torch.from_numpy(km),
                                       None if keep is None else torch.from_numpy(keep), kp)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_ref), atol=GRAD_TOL, rtol=0)


def test_local_attention_heads_gradient_matches_jax():
    q, k, v = _qkv_heads(128, seed=10)
    g_ref = jax.grad(lambda a, b, c: (JK.local_attention_tpu(a, b, c, 16) ** 2).sum(),
                     argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    (LK.local_attention_heads(*leaves, 16) ** 2).sum().backward()
    for ours, ref in zip(leaves, g_ref):
        np.testing.assert_allclose(ours.grad.numpy(), np.asarray(ref), atol=GRAD_TOL, rtol=0)


def test_non_prefix_key_mask_is_refused_when_checked(monkeypatch):
    mask = torch.ones(2, 64)
    assert FK.key_lengths(mask).tolist() == [64, 64]
    mask[0, 10] = 0
    monkeypatch.setattr(FK, "CHECK_MASKS", True)
    with pytest.raises(ValueError, match="prefix-valid"):
        FK.key_lengths(mask)


def test_entries_refuse_shapes_without_a_plan():
    with pytest.raises(ValueError, match="supports"):
        FK.fused_qkv_local_attention(torch.zeros(1, 300, 3 * H * DH), H, DH, 16)
    assert not FK.supports(300, 16, False) and not FK.supports(64, 16, True)
