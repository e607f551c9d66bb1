"""The port's conv weight gradient (B2) against the JAX package's.

``conv1d_weight_grad_plain`` is held against the XLA oracle
(``conv1d_weight_grad_xla``, the vjp of the conv with respect to its
kernel) and against the Pallas kernel run through the Pallas interpreter,
at 1e-5 (the JAX package's own tolerance for the kernel against XLA),
down to the ValueFunction's short, narrow shapes. The CUDA kernel's launch
plan (``wgrad_plan``) is checked at every main-path shape, and its
arithmetic (3xTF32) is emulated in numpy against float64.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.ops.pallas import conv_weight_grad as CW
from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_weight_grad as TW

torch.set_num_threads(2)

B, COUT = 3, 24
TOL = 1e-5
WGRAD_TOL = 1e-5  # the card's tolerance for the kernel: of max |dW|, over up to 10,240 rows


def _inputs(H, cin, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, cin)).astype(np.float32),
            rng.normal(size=(B, H, COUT)).astype(np.float32))


def _plain(x, dy, k):
    return TW.conv1d_weight_grad_plain(torch.from_numpy(x), torch.from_numpy(dy), k).numpy()


@pytest.mark.parametrize("H", [12, 20])
@pytest.mark.parametrize("cin", [35, 64])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_plain_matches_xla_oracle(k, cin, H):
    x, dy = _inputs(H, cin, seed=k * 100 + cin + H)
    ref = np.asarray(CW.conv1d_weight_grad_xla(jnp.asarray(x), jnp.asarray(dy), k))
    out = _plain(x, dy, k)
    assert out.shape == (k, cin, COUT) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("H", [12, 20])
@pytest.mark.parametrize("cin", [35, 64])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_plain_matches_interpreted_pallas_kernel(k, cin, H):
    x, dy = _inputs(H, cin, seed=k * 100 + cin + H + 1)
    old = CW.INTERPRET
    CW.INTERPRET = True
    try:
        ker = np.asarray(CW.conv1d_weight_grad(jnp.asarray(x), jnp.asarray(dy), k,
                                               block_cin=cin, block_cout=COUT))
    finally:
        CW.INTERPRET = old
    np.testing.assert_allclose(_plain(x, dy, k), ker, rtol=TOL, atol=TOL)


def test_dispatch_uses_plain_version_on_cpu():
    x, dy = map(torch.from_numpy, _inputs(12, 35, seed=7))
    launches = TW.conv1d_weight_grad_cuda.launches
    np.testing.assert_array_equal(TW.conv1d_weight_grad(x, dy, 5).numpy(),
                                  TW.conv1d_weight_grad_plain(x, dy, 5).numpy())
    assert TW.conv1d_weight_grad_cuda.launches == launches


def test_cuda_wrapper_refuses_cpu_tensors():
    x, dy = map(torch.from_numpy, _inputs(12, 35, seed=8))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        TW.conv1d_weight_grad_cuda(x, dy, 5)


# The 26 (B, H, Cin, Cout) at which B2 runs on a main path, all at k 5: a
# dim-128 U-Net training micro-step (B 32, H 160) and a dim-32 ValueFunction
# value-training step (B 16, H 64)
MAIN_PATH_SHAPES = [(32, *s) for s in [
    (160, 35, 128), (160, 128, 128), (80, 128, 256), (80, 256, 256), (40, 256, 512),
    (40, 512, 512), (20, 512, 1024), (20, 1024, 1024), (20, 2048, 512), (20, 512, 512),
    (40, 1024, 256), (40, 256, 256), (80, 512, 128), (80, 128, 128)]] + [(16, *s) for s in [
        (64, 35, 32), (64, 32, 32), (32, 32, 64), (32, 64, 64), (16, 64, 128), (16, 128, 128),
        (8, 128, 256), (8, 256, 256), (8, 256, 128), (8, 128, 128), (4, 128, 64), (4, 64, 64)]]
H100_SMS = 132


@pytest.mark.parametrize("B_,H,cin,cout", MAIN_PATH_SHAPES)
def test_wgrad_plan(B_, H, cin, cout):
    """The plan covers every flattened (b, h) row exactly once per channel
    tile, walking the chunk -> row map the kernel uses; it fits a cluster
    and a CTA's shared memory, and its splits add up in shared memory (no
    workspace in device memory)."""
    k = 5
    plan = TW.wgrad_plan(B_, H, cin, cout, k, H100_SMS)
    assert plan.R == B_ * H and plan.rows % 8 == 0 and plan.rows <= TW.MAX_ROWS
    assert plan.path == "3xtf32"
    covered = np.zeros(plan.R, dtype=np.int64)
    for rank in range(plan.cluster):
        for c in plan.rank_chunks(rank):
            rows = plan.chunk_rows(c)
            assert len(rows) <= plan.rows
            covered[rows.start:rows.stop] += 1
    np.testing.assert_array_equal(covered, 1)
    assert 1 <= plan.cluster <= TW.MAX_CLUSTER == 16
    assert plan.smem_bytes + TW.STATIC_SMEM <= 227 * 1024
    assert plan.smem_bytes == TW.smem_bytes(plan.tci, plan.tco, plan.rows, plan.stages,
                                            plan.cluster, plan.slices, k)
    if plan.cluster > 1 or plan.slices > 1:  # partial tiles add up in shared memory
        assert plan.smem_bytes >= 4 * k * plan.tci * (plan.tco + TW.PAD_COLS)
    assert not any("workspace" in f.name for f in dataclasses.fields(plan))
    assert plan.tiles == -(-cin // plan.tci) * -(-cout // plan.tco)
    assert 32 <= plan.threads <= TW.MAX_THREADS and plan.grid == plan.tiles * plan.cluster
    assert 8 * plan.slices <= plan.rows  # every slice has k-steps


def _tf32(a):
    """float32 rounded to TF32 by masking the 13 low mantissa bits."""
    return (np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
            & np.uint32(0xFFFFE000)).view(np.float32)


def _emulated_wgrad(x, dy, k, products):
    """dW with each tap's product as the sum of ``products`` float32 matrix
    products of TF32 parts: ("hi", "hi") alone is TF32, adding ("hi", "lo")
    and ("lo", "hi") is 3xTF32 (the kernel's split: x = hi + lo)."""
    B, H, cin = x.shape
    pad_l = (k - 1) // 2
    xp = np.pad(x, ((0, 0), (pad_l, k - 1 - pad_l), (0, 0)))
    d = dy.reshape(B * H, -1)
    parts_d = {"hi": _tf32(d)}
    parts_d["lo"] = _tf32(d - parts_d["hi"])
    out = []
    for t in range(k):
        xt = np.ascontiguousarray(xp[:, t:t + H].reshape(B * H, cin).T)
        parts_x = {"hi": _tf32(xt)}
        parts_x["lo"] = _tf32(xt - parts_x["hi"])
        acc = np.zeros((cin, d.shape[1]), dtype=np.float32)
        for a, b in products:
            acc += parts_x[a] @ parts_d[b]
        out.append(acc)
    return np.stack(out)


@pytest.mark.parametrize("products,within", [
    ((("lo", "hi"), ("hi", "lo"), ("hi", "hi")), True),  # 3xTF32
    ((("hi", "hi"),), False),                            # TF32 alone
])
def test_3xtf32_emulation_holds_wgrad_tol_over_10240_rows(products, within):
    """Over B 64 x H 160 = 10,240 rows (the largest reduction WGRAD_TOL, 1e-5
    of max |dW|, covers) at 64 -> 64, k 5: three TF32 products stay within
    the tolerance of float64, one does not."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=(64, 160, 64)).astype(np.float32)
    dy = rng.normal(size=(64, 160, 64)).astype(np.float32)
    ref = _plain(x.astype(np.float64), dy.astype(np.float64), 5)
    err = np.abs(_emulated_wgrad(x, dy, 5, products) - ref).max() / np.abs(ref).max()
    assert (err <= WGRAD_TOL) == within, err


def _rz(a: np.ndarray) -> np.ndarray:
    """float64 values rounded to float32 toward zero."""
    f = a.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(a)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _bf16_chains_wgrad(x, dy, k, chain, rounds_per_step):
    """B2's bf16 sums as its tensor cores and epilogue make them: per tap,
    the exact products of each 16-row k-step added to a chain's accumulator
    and rounded toward zero (``rounds_per_step`` times a k-step: 1, or 2 for
    8-row halves), each ``chain`` k-steps joined into a float32 sum rounded
    to nearest."""
    B, H, cin = x.shape
    pad_l = (k - 1) // 2
    xp = np.pad(x, ((0, 0), (pad_l, k - 1 - pad_l), (0, 0)))
    d = dy.reshape(B * H, -1)
    n = 16 // rounds_per_step
    out = []
    for t in range(k):
        a = xp[:, t:t + H].reshape(B * H, cin)
        prods = np.einsum("sri,srj->sij", a.reshape(-1, n, cin), d.reshape(-1, n, d.shape[1]))
        total = np.zeros(prods.shape[1:], dtype=np.float32)
        acc = np.zeros_like(total)
        for s in range(prods.shape[0]):
            acc = _rz(acc.astype(np.float64) + prods[s])
            if (s + 1) % (chain * rounds_per_step) == 0:
                total, acc = total + acc, np.zeros_like(acc)
        out.append(total + acc)
    return np.stack(out)


@pytest.mark.parametrize("rounds_per_step", [1, 2])
@pytest.mark.parametrize("chain,within", [("plan", True), (TW.BF16_MAX_CHAIN, True),
                                          (640, False)])
def test_bf16_round_toward_zero_chains_hold_wgrad_tol_over_10240_rows(chain, within,
                                                                      rounds_per_step):
    """B2's bf16 form over B 64 x H 160 = 10,240 rows at 64 -> 64, k 5, on
    bf16 values: chains of the rule plan's longest (a rank's 640 rows, 40
    k-steps) and of BF16_MAX_CHAIN k-steps, rounded toward zero once or twice
    a k-step and joined in float32, stay within WGRAD_TOL of float64; one
    chain over every row (640 k-steps) does not."""
    rng = np.random.default_rng(10)
    rb = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    x = rb(rng.normal(size=(64, 160, 64))).astype(np.float64)
    dy = rb(rng.normal(size=(64, 160, 64))).astype(np.float64)
    if chain == "plan":
        chain = TW.wgrad_bf16_plan(64, 160, 64, 64, 5, 132).longest_chain()
        assert chain <= TW.BF16_MAX_CHAIN
    ref = _plain(x, dy, 5)
    err = np.abs(_bf16_chains_wgrad(x, dy, 5, chain, rounds_per_step) - ref).max()
    assert (err <= WGRAD_TOL * np.abs(ref).max()) == within, err / np.abs(ref).max()


def _value_inputs(H, cin, cout, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(16, H, cin)).astype(np.float32),
            rng.normal(size=(16, H, cout)).astype(np.float32))


@pytest.mark.parametrize("H", [4, 8])
@pytest.mark.parametrize("cin,cout", [(32, 32), (35, 64)])
def test_plain_matches_xla_oracle_at_short_narrow_shapes(H, cin, cout):
    """The ValueFunction's short horizons (H 4, 8: fewer rows than the
    taps' reach) and narrow channels (32, 35), B 16, k 5."""
    x, dy = _value_inputs(H, cin, cout, seed=H * 100 + cin)
    ref = np.asarray(CW.conv1d_weight_grad_xla(jnp.asarray(x), jnp.asarray(dy), 5))
    np.testing.assert_allclose(_plain(x, dy, 5), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("H", [4, 8])
@pytest.mark.parametrize("cin,cout", [(32, 32), (35, 64)])
def test_plain_matches_interpreted_pallas_kernel_at_short_narrow_shapes(H, cin, cout):
    x, dy = _value_inputs(H, cin, cout, seed=H * 100 + cin + 1)
    old = CW.INTERPRET
    CW.INTERPRET = True
    try:
        ker = np.asarray(CW.conv1d_weight_grad(jnp.asarray(x), jnp.asarray(dy), 5,
                                               block_cin=cin, block_cout=cout))
    finally:
        CW.INTERPRET = old
    np.testing.assert_allclose(_plain(x, dy, 5), ker, rtol=TOL, atol=TOL)
