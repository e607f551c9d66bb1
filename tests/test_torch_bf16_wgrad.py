"""B2's bf16 form (``csrc/conv1d_weight_grad_bf16.cu``) on the CPU: its plan
rule at the 26 main-path shapes, the plan's refusals, the Python mirror of
the kernel's instances and constants, and a plain-PyTorch model of the
kernel's split of the work (tiles, cluster ranks over chunks, warpgroups
over taps or columns, 16-row k-steps with the batch-row masks, chains
joined in float32, ranks added in rank order) held against JAX's
``conv1d_weight_grad_xla`` and the interpreted Pallas kernel on
bf16-rounded inputs. The kernel itself runs only on the card
(``tests/test_torch_bf16_cuda_kernels.py``); the round-toward-zero chains of
its tensor cores are emulated in ``tests/test_torch_conv_weight_grad.py``.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.ops.pallas import conv_weight_grad as CW
from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_weight_grad as TW

torch.set_num_threads(2)

WGRAD_TOL = 1e-5  # of max |dW|: float32 sums of the same exact products in another order
H100_SMS = 132
MAX_SMEM = 227 * 1024
SOURCE = Path(TW.__file__).resolve().parents[1] / "csrc" / "conv1d_weight_grad_bf16.cu"
# (B, H, Cin, Cout) of a dim-128 U-Net's bf16 training micro-step and of the
# dim-32 ValueFunction's value step, all at k 5
MAIN_PATH_SHAPES = [(32, 160, 35, 128), (32, 160, 128, 128), (32, 80, 128, 256),
                    (32, 80, 256, 256), (32, 40, 256, 512), (32, 40, 512, 512),
                    (32, 20, 512, 1024), (32, 20, 1024, 1024), (32, 20, 2048, 512),
                    (32, 20, 512, 512), (32, 40, 1024, 256), (32, 40, 256, 256),
                    (32, 80, 512, 128), (32, 80, 128, 128), (16, 64, 35, 32), (16, 64, 32, 32),
                    (16, 32, 32, 64), (16, 32, 64, 64), (16, 16, 64, 128), (16, 16, 128, 128),
                    (16, 8, 128, 256), (16, 8, 256, 256), (16, 8, 256, 128), (16, 8, 128, 128),
                    (16, 4, 128, 64), (16, 4, 64, 64)]


def _check_plan(plan, B, H, cin, cout, k):
    """What every plan must hold: its shared memory as the kernel lays it out
    (the mirror) within a CTA's, an instance whose accumulators fit its
    registers, every chunk reduced by exactly one rank and every row by one
    chunk, every tap below k by exactly one warpgroup at every column of
    the tile, and chains within BF16_MAX_CHAIN k-steps."""
    R = B * H
    assert (plan.R, plan.k, plan.Cin, plan.Cout) == (R, k, cin, cout)
    assert plan.smem_bytes == TW.bf16_smem_bytes(plan.nw, plan.wgs, plan.split, plan.rows,
                                                 plan.stages, plan.cluster, plan.chain, k)
    assert plan.smem_bytes + TW.BF16_STATIC_SMEM <= MAX_SMEM
    assert (plan.kt, plan.nw, plan.wgs) in TW.BF16_INSTANCES
    assert plan.accumulators() <= TW.BF16_MAX_ACC[plan.wgs]
    assert plan.rows % TW.BF16_STEP == 0 and plan.rows <= TW.BF16_MAX_ROWS
    covered = np.zeros(R, dtype=np.int64)
    chunks = []
    for rank in range(plan.cluster):
        chunks += list(plan.rank_chunks(rank))
        for c in plan.rank_chunks(rank):
            rows = plan.chunk_rows(c)
            covered[rows.start:rows.stop] += 1
    assert chunks == list(range(plan.chunks))
    np.testing.assert_array_equal(covered, 1)
    cells = np.zeros((k, plan.tco), dtype=np.int64)
    for taps, cols in plan.warpgroups():
        assert len(taps) == plan.kt and len(cols) == plan.nw
        for t in taps:
            if t < k:
                cells[t, cols.start:cols.stop] += 1
    np.testing.assert_array_equal(cells, 1)
    assert 1 <= plan.longest_chain() <= TW.BF16_MAX_CHAIN
    assert plan.grid == -(-cin // 64) * -(-cout // plan.tco) * plan.cluster
    assert plan.threads == 128 * plan.wgs


@pytest.mark.parametrize("B,H,cin,cout", MAIN_PATH_SHAPES)
def test_bf16_plan_rule_at_main_path_shapes(B, H, cin, cout):
    plan = TW.wgrad_bf16_plan(B, H, cin, cout, 5, H100_SMS)
    _check_plan(plan, B, H, cin, cout, 5)
    assert plan.chain == 0  # every main-path shape's ranks keep their chains in registers
    assert plan.x_staging == ("tma" if cin % 8 == 0 else "threads")


@pytest.mark.parametrize("B,H,cin,cout,k", [(3, 21, 37, 24, 3), (2, 5, 8, 16, 1),
                                            (1, 100, 70, 64, 9), (3, 12, 35, 24, 7),
                                            (64, 160, 64, 64, 5), (256, 160, 64, 64, 5),
                                            (1000, 160, 1024, 1024, 5)])
def test_bf16_plan_rule_at_other_shapes(B, H, cin, cout, k):
    """Every kernel size, ragged channels, and rows past MAX_CLUSTER ranks'
    chains (which join the float32 tile)."""
    plan = TW.wgrad_bf16_plan(B, H, cin, cout, k, H100_SMS)
    _check_plan(plan, B, H, cin, cout, k)
    assert (plan.chain > 0) == (B * H > TW.MAX_CLUSTER * 1024)


@pytest.mark.parametrize("fields,why", [
    (dict(nw=48), "out of range"),
    (dict(nw=64, wgs=4), "out of range"),
    (dict(nw=64, wgs=1, split=1), "two warpgroups"),
    (dict(nw=16, wgs=3), "no instance"),
    (dict(nw=64, wgs=2, rows=24), "multiple of 16"),
    (dict(nw=64, wgs=2, rows=144), "multiple of 16"),
    (dict(nw=64, wgs=1, cluster=17), "out of range"),
    (dict(nw=64, wgs=1, rows=128, cluster=2, chain=0), "chain"),
    (dict(nw=64, wgs=1, rows=128, cluster=2, chain=65), "chain"),
    (dict(nw=64, wgs=2, rows=128, cluster=1, stages=2), "shared memory"),
])
def test_bf16_plan_refuses_what_the_kernel_does_not_take(fields, why):
    """A field out of range, a layout without an instance, chunk rows off the
    k-step, a chain past BF16_MAX_CHAIN, a ring and chain tile past 227 KB."""
    with pytest.raises(ValueError, match=why):
        TW.make_wgrad_bf16_plan(32, 160, 512, 512, 5, **fields)


def test_bf16_instances_and_constants_mirror_the_source():
    """BF16_INSTANCES is the source's WGRAD_BF16_INSTANCES list, each within
    its accumulator budget, and the constants the mirror uses are the
    source's."""
    src = SOURCE.read_text()
    macro = src[src.index("#define WGRAD_BF16_INSTANCES(X)"):]
    macro = macro[:macro.index("\n\n")]
    listed = tuple(tuple(int(v) for v in m)
                   for m in re.findall(r"X\((\d+), (\d+), (\d+)\)", macro))
    assert listed == TW.BF16_INSTANCES
    for kt, nw, wgs in listed:
        assert kt * nw // 2 <= TW.BF16_MAX_ACC[wgs]
    consts = dict(re.findall(r"constexpr (?:int|size_t) (k\w+) = (\d+);", src))
    assert int(consts["kM"]) == TW.BF16_M and int(consts["kStep"]) == TW.BF16_STEP
    assert int(consts["kMaxRows"]) == TW.BF16_MAX_ROWS
    assert int(consts["kMaxStages"]) == TW.BF16_MAX_STAGES
    assert int(consts["kMaxWgs"]) == TW.BF16_MAX_WGS
    assert int(consts["kMaxChainSteps"]) == TW.BF16_MAX_CHAIN
    assert int(consts["kMaxCluster"]) == TW.MAX_CLUSTER
    assert int(consts["kPad"]) == TW.BF16_PAD and int(consts["kAlign"]) == TW.BF16_ALIGN


def _split_model(x: torch.Tensor, dy: torch.Tensor, k: int, plan) -> torch.Tensor:
    """dW as the kernel splits the work under ``plan``, in plain PyTorch: per
    64 x tco tile, each rank's chunks in 16-row k-steps, each warpgroup's
    taps (taps past k dropped) and columns; a k-step's x rows are the dy
    rows shifted by t - pad_l, zero where that row leaves its batch row or
    [0, B H); a chain sums at most ``plan.chain`` k-steps (all of a rank's
    without a chain join) and joins a float32 sum; the ranks' tiles are
    added in rank order."""
    B, H, cin = x.shape
    cout = dy.shape[-1]
    R, pad = B * H, (k - 1) // 2
    xs, ds = x.float().reshape(R, cin), dy.float().reshape(R, cout)
    out = torch.zeros(k, cin, cout)
    for ci0 in range(0, cin, TW.BF16_M):
        ci = torch.arange(ci0, ci0 + TW.BF16_M)
        for co0 in range(0, cout, plan.tco):
            tile = None
            for rank in range(plan.cluster):
                part = torch.zeros(k, TW.BF16_M, plan.tco)
                for taps, cols in plan.warpgroups():
                    co = torch.arange(co0 + cols.start, co0 + cols.stop)
                    for t in taps:
                        if t >= k:
                            continue
                        total = torch.zeros(TW.BF16_M, len(cols))
                        acc, steps = torch.zeros_like(total), 0
                        for c in plan.rank_chunks(rank):
                            for s0 in range(c * plan.rows, (c + 1) * plan.rows, TW.BF16_STEP):
                                if plan.chain and steps == plan.chain:
                                    total, acc, steps = total + acc, torch.zeros_like(acc), 0
                                r = torch.arange(s0, s0 + TW.BF16_STEP)
                                h = r % H + t - pad
                                ok = (r < R) & (h >= 0) & (h < H)
                                xr = (r + t - pad).clamp(0, R - 1)
                                a = torch.where(ok[:, None] & (ci < cin)[None],
                                                xs[xr][:, ci.clamp(max=cin - 1)], 0.0)
                                b = torch.where((r < R)[:, None] & (co < cout)[None],
                                                ds[r.clamp(max=R - 1)][:, co.clamp(max=cout - 1)],
                                                0.0)
                                acc = acc + a.T @ b
                                steps += 1
                        part[t, :, cols.start:cols.stop] = total + acc
                tile = part if tile is None else tile + part
            n_ci, n_co = min(TW.BF16_M, cin - ci0), min(plan.tco, cout - co0)
            out[:, ci0:ci0 + n_ci, co0:co0 + n_co] = tile[:, :n_ci, :n_co]
    return out


def _bf16(a: np.ndarray):
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("B,H,cin,cout,k,plans", [
    # Cin 35 (x staged by the threads), an odd B, the rule's plan and clusters, each split
    (3, 21, 35, 24, 5, [dict(nw=16, wgs=1, rows=16, cluster=3),
                        dict(nw=64, wgs=2, split=1, rows=32, cluster=2),
                        dict(nw=32, wgs=3, split=1, rows=16, cluster=1, chain=2)]),
    (5, 12, 64, 40, 3, [dict(nw=32, wgs=2, rows=16, cluster=4),
                        dict(nw=64, wgs=2, split=1, rows=48, cluster=1, chain=1)]),
    (3, 8, 35, 32, 1, [dict(nw=32, wgs=1, rows=16, cluster=2),
                       dict(nw=64, wgs=2, rows=16, cluster=1, chain=1)]),
    (3, 10, 16, 24, 9, [dict(nw=32, wgs=1, rows=16, cluster=2),
                        dict(nw=64, wgs=2, split=1, rows=32, cluster=1),
                        dict(nw=64, wgs=3, split=1, rows=16, cluster=2)]),
])
def test_bf16_split_model_matches_jax(B, H, cin, cout, k, plans):
    """The kernel's split, modelled, against JAX's XLA oracle and the
    interpreted Pallas kernel on the same bf16 values, under the rule's plan
    and the plans listed."""
    rng = np.random.default_rng(B * H + cin + k)
    xj, xt = _bf16(rng.normal(size=(B, H, cin)).astype(np.float32))
    dj, dt = _bf16(rng.normal(size=(B, H, cout)).astype(np.float32))
    xla = np.asarray(CW.conv1d_weight_grad_xla(xj.astype(jnp.float32), dj.astype(jnp.float32), k))
    old = CW.INTERPRET
    CW.INTERPRET = True
    try:
        pallas = np.asarray(CW.conv1d_weight_grad(xj, dj, k, block_cin=cin, block_cout=cout))
    finally:
        CW.INTERPRET = old
    scale = np.abs(xla).max()
    for fields in [None] + plans:
        plan = (TW.wgrad_bf16_plan(B, H, cin, cout, k, H100_SMS) if fields is None
                else TW.make_wgrad_bf16_plan(B, H, cin, cout, k, **fields))
        _check_plan(plan, B, H, cin, cout, k)
        out = _split_model(xt, dt, k, plan).numpy()
        for ref in (xla, pallas):
            assert np.abs(out - ref).max() <= WGRAD_TOL * scale, plan


def test_bf16_wrapper_refuses_cpu_tensors_and_dispatches_plain():
    x = torch.zeros(2, 8, 16, dtype=torch.bfloat16)
    dy = torch.ones(2, 8, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TW.conv1d_weight_grad_bf16_cuda(x, dy, 5)
    n = TW.conv1d_weight_grad_bf16_cuda.launches
    out = TW.conv1d_weight_grad(x, dy, 5)
    assert out.dtype == torch.float32 and TW.conv1d_weight_grad_bf16_cuda.launches == n
