"""B1's, B2's and B3's bf16 forms against their plain versions, on the
card, B1's bf16 backward and B3's bf16 entry with the keep mask, and the
shared-memory opt-in of the launchers.

Each bf16 kernel computes its plain version's function (float32 sums, one
bf16 rounding), so the two agree within one bf16 ulp of the value plus the
float32 forms' card tolerance for sums in another order: |d| <= 2^-7 |ref|
+ TOL elementwise. The dim-128 U-Net at bf16 sends every conv block to B1's
bf16 kernel, and the local transformer every attention call to B3's bf16
entry; no float32 launch happens on either path. B2's bf16 form sums the
exact products of bf16 values in float32, as its plain version does: within
WGRAD_TOL of max |dW| (the float32 form's card tolerance).

Marked ``cuda``; each test skips where no CUDA device is present. This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_bf16_cuda_kernels.py
"""
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from deepmimic_diffusion_mujoco_tpu_torch.models.local_attention import LocalTransformer
from deepmimic_diffusion_mujoco_tpu_torch.models.temporal_unet import TemporalUnet
from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_block_kernel as CB
from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_weight_grad as CW
from deepmimic_diffusion_mujoco_tpu_torch.ops import fused_local_attention as FA

BF = torch.bfloat16
ULP = 2.0 ** -7  # one bf16 ulp of a value v is at most 2^-7 |v|
TOL = 1e-4       # B1's and B3's float32 card tolerance: sums in another order
WGRAD_TOL = 1e-5  # B2: of max |dW|, float32 sums of the same products in another order
# B1's bf16 backward with its kernels against the same backward through their plain versions
# (the recompute and dx are cuDNN's in both): (max, median) of |d| / max |ref| for each
# gradient. A value where the two forwards' bf16 roundings flip moves the GroupNorm
# statistics of its group, so the largest difference is a few bf16 ulps of the largest value.
BWD_TOL = (4 * ULP, 1e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _within_one_ulp(out, ref):
    assert out.dtype == ref.dtype == BF
    d = (out.float() - ref.float()).abs()
    bound = ULP * ref.float().abs() + TOL
    beyond = int((d > bound).sum())
    assert beyond == 0, f"max |d| {d.max().item()}, {beyond} values beyond the bound"


def _conv_inputs(cuda, B, H, Cin, Cout, k, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(B, H, Cin, generator=g, device=cuda).to(BF)
    w = (torch.randn(k, Cin, Cout, generator=g, device=cuda) * (k * Cin) ** -0.5).to(BF)
    b, beta = (torch.randn(Cout, generator=g, device=cuda) * 0.1 for _ in range(2))
    gamma = 1 + 0.1 * torch.randn(Cout, generator=g, device=cuda)
    return x, w, b, gamma, beta


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Cin,Cout,k", [
    # the dim-128 U-Net's levels when serving (H 64 down to 8), the first block's 35
    # channels, the up path's concatenations; odd shapes: a group width under 8 and no
    # multiple of 8, H no multiple of 16, an odd batch, k 1 and 9
    (16, 64, 35, 128, 5), (16, 32, 256, 256, 5), (16, 16, 512, 512, 5), (16, 8, 1024, 1024, 5),
    (16, 8, 2048, 512, 5), (16, 64, 256, 128, 5), (3, 8, 64, 64, 5), (3, 21, 37, 24, 3),
    (2, 5, 8, 16, 1), (1, 100, 70, 1024, 9), (2, 1024, 35, 128, 5),
])
def test_conv_gn_mish_bf16_matches_plain(cuda, B, H, Cin, Cout, k):
    args = _conv_inputs(cuda, B, H, Cin, Cout, k)
    n, n32 = CB.conv_gn_mish_bf16_cuda.launches, CB.conv_gn_mish_cuda.launches
    out = CB.conv_gn_mish_bf16_cuda(*args, 8)
    torch.cuda.synchronize()
    assert CB.conv_gn_mish_bf16_cuda.launches == n + 1 and CB.conv_gn_mish_cuda.launches == n32
    _within_one_ulp(out, CB.conv_gn_mish_plain(*args, 8))
    # bit-identical reruns: sums in a fixed order
    assert torch.equal(out, CB.conv_gn_mish_bf16_cuda(*args, 8))


# Every plan family of the bf16 kernel: (B, H, Cin, Cout, k) and the plan's fields. R > 1 and
# C > 1 (channel split), the row split, both instances (wgmma, mma.sync), TMA off (the
# consumers stage both operands), Cin 35 (x staged by the consumers, w by TMA), a group width
# no multiple of 8 (w staged by the consumers), one and two warpgroups, rings of one stage and
# rings that wrap, k 9.
B1_BF16_FAMILIES = [
    ((5, 8, 256, 256, 5), dict(rows=5, cluster=4, split=0, mma=0)),
    ((5, 8, 256, 256, 5), dict(rows=5, cluster=4, split=0, mma=1)),
    ((5, 8, 256, 256, 5), dict(rows=2, cluster=2, split=0, mma=0, stages=1)),
    ((5, 8, 256, 256, 5), dict(rows=5, cluster=1, split=0, mma=0, stages=2)),
    ((5, 8, 256, 256, 5), dict(rows=5, cluster=1, split=0, mma=1, stages=3)),
    ((5, 8, 256, 256, 5), dict(rows=8, cluster=1, split=0, mma=0, tma=0)),
    ((5, 8, 256, 256, 5), dict(rows=3, cluster=4, split=0, mma=1, tma=0, wgs=2)),
    ((3, 100, 128, 512, 5), dict(rows=1, cluster=4, split=1, mma=0)),
    ((3, 100, 128, 512, 5), dict(rows=1, cluster=8, split=1, mma=1)),
    ((3, 100, 128, 512, 5), dict(rows=2, cluster=2, split=0, mma=0, wgs=2)),
    ((4, 64, 35, 128, 5), dict(rows=1, cluster=1, split=0, mma=0)),
    ((4, 64, 35, 128, 5), dict(rows=2, cluster=1, split=0, mma=1)),
    ((4, 160, 35, 128, 5), dict(rows=1, cluster=2, split=1, mma=0, wgs=2)),
    ((3, 21, 70, 24, 9), dict(rows=3, cluster=2, split=0, mma=0)),
    ((3, 21, 70, 24, 9), dict(rows=3, cluster=2, split=0, mma=1)),
    ((2, 16, 512, 2048, 3), dict(rows=2, cluster=8, split=0, mma=0)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,fields", B1_BF16_FAMILIES)
def test_conv_gn_mish_bf16_every_plan(cuda, shape, fields):
    """Each plan family against the plain version, and a rerun to the bit."""
    B, H, Cin, Cout, k = shape
    plan = CB.make_bf16_plan(B, H, Cin, Cout, k, 8, **fields)
    args = _conv_inputs(cuda, B, H, Cin, Cout, k, seed=sum(shape) + plan.mma)
    out = CB.conv_gn_mish_bf16_cuda(*args, 8, plan=plan)
    _within_one_ulp(out, CB.conv_gn_mish_plain(*args, 8))
    assert torch.equal(out, CB.conv_gn_mish_bf16_cuda(*args, 8, plan=plan))


@pytest.mark.cuda
def test_conv_gn_mish_bf16_layout_matches_the_kernel(cuda):
    """The host's shared-memory mirror equals the kernel's layout for every
    plan the rule picks at the sweep's shapes (serving, training, the
    ValueFunction's, K1's rank shapes)."""
    from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_block_sweep as S
    lib = CB._library_bf16()
    for B, H, cin, cout in S.bf16_shapes():
        plan = CB.bf16_plan(B, H, cin, cout, 5, 8)
        got = lib.conv_gn_mish_bf16_smem_bytes(H, cin, cout, 5, 8, ctypes.addressof(plan.ints))
        assert got == plan.smem_bytes, (B, H, cin, cout, plan)


@pytest.mark.cuda
def test_conv_gn_mish_bf16_refuses_what_it_does_not_take(cuda):
    x, w, b, gamma, beta = _conv_inputs(cuda, 1, 8, 16, 16, 5)
    with pytest.raises(ValueError, match="takes torch.bfloat16"):
        CB.conv_gn_mish_bf16_cuda(x.float(), w, b, gamma, beta, 8)
    with pytest.raises(ValueError, match="takes torch.float32"):
        CB.conv_gn_mish_bf16_cuda(x, w, b.to(BF), gamma, beta, 8)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        CB.conv_gn_mish_bf16_cuda(x.cpu(), w, b, gamma, beta, 8)
    bad = CB.make_bf16_plan(1, 8, 16, 16, 5, 8)
    bad = dataclasses.replace(bad, ints=(ctypes.c_int * 7)(0, *list(bad.ints)[1:]), checked={})
    with pytest.raises(RuntimeError, match="conv_gn_mish_bf16_cuda"):
        CB.conv_gn_mish_bf16_cuda(x, w, b, gamma, beta, 8, plan=bad)
    with pytest.raises(ValueError, match="no plan fits"):
        CB.make_bf16_plan(1, 8, 16, 16, 5, 8, rows=2, split=1)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Cin,Cout,k", [
    # a bf16 training micro-step of the dim-128 U-Net (B 32, H 160 down to 20) and the
    # ValueFunction's value step (B 16, H 64 down to 4); odd shapes: Cin or Cout no multiple
    # of 8 (staged through registers), k 1, 3 and 9, an odd batch
    (32, 160, 35, 128, 5), (32, 160, 128, 128, 5), (32, 80, 256, 256, 5),
    (32, 40, 512, 512, 5), (32, 20, 1024, 1024, 5), (32, 20, 2048, 512, 5),
    (32, 160, 256, 128, 5), (16, 64, 35, 32, 5), (16, 4, 256, 256, 5), (16, 8, 128, 128, 5),
    (3, 21, 37, 24, 3), (2, 5, 8, 16, 1), (1, 100, 70, 64, 9),
])
def test_b2_bf16_matches_plain(cuda, B, H, Cin, Cout, k):
    g = torch.Generator(device=cuda).manual_seed(B + H + Cin)
    x = torch.randn(B, H, Cin, generator=g, device=cuda).to(BF)
    dy = torch.randn(B, H, Cout, generator=g, device=cuda).to(BF)
    n, n32 = CW.conv1d_weight_grad_bf16_cuda.launches, CW.conv1d_weight_grad_cuda.launches
    out = CW.conv1d_weight_grad(x, dy, k)
    torch.cuda.synchronize()
    assert CW.conv1d_weight_grad_bf16_cuda.launches == n + 1
    assert CW.conv1d_weight_grad_cuda.launches == n32
    ref = CW.conv1d_weight_grad_plain(x, dy, k)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    assert (out - ref).abs().max().item() <= WGRAD_TOL * ref.abs().max().item()
    # no atomics: a rerun gives the same bits
    assert torch.equal(out, CW.conv1d_weight_grad_bf16_cuda(x, dy, k))


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [
    dict(tci=16, tco=32, rows=16, stages=1, cluster=1, slices=1),
    dict(tci=16, tco=64, rows=64, stages=4, cluster=16, slices=2),
    dict(tci=64, tco=64, rows=32, stages=2, cluster=4, slices=1),
    dict(tci=32, tco=32, rows=64, stages=3, cluster=2, slices=4),
    dict(tci=32, tco=128, rows=64, stages=2, cluster=8, slices=1),
])
def test_b2_bf16_plans(cuda, plan):
    """Tiles, chunk rows, ring depths, clusters (to the non-portable 16) and
    slices, at a training shape whose Cin (35) is staged through registers
    and one staged in 16-byte pieces."""
    for B, H, Cin, Cout in ((32, 160, 35, 128), (32, 40, 512, 256)):
        g = torch.Generator(device=cuda).manual_seed(Cin)
        x = torch.randn(B, H, Cin, generator=g, device=cuda).to(BF)
        dy = torch.randn(B, H, Cout, generator=g, device=cuda).to(BF)
        p = CW.make_wgrad_plan(B, H, Cin, Cout, 5, CW.sm_count(x.device), bf16=True, **plan)
        out = CW.conv1d_weight_grad_bf16_cuda(x, dy, 5, plan=p)
        ref = CW.conv1d_weight_grad_plain(x, dy, 5)
        assert (out - ref).abs().max().item() <= WGRAD_TOL * ref.abs().max().item(), (B, H)
    with pytest.raises(ValueError, match="bf16 path"):
        CW.conv1d_weight_grad_cuda(x.float(), dy.float(), 5, plan=p)


@pytest.mark.cuda
def test_b1_bf16_backward_matches_the_plain_versions(cuda):
    """One bf16 ``conv_gn_mish`` backward at a training shape with B1's and
    B2's bf16 kernels against the same backward with their plain versions:
    dx, dW (bf16), db, dgamma, dbeta (float32); B2's bf16 form launched once."""
    x, w, b, gamma, beta = _conv_inputs(cuda, 32, 80, 256, 256, 5, seed=3)
    cot = torch.randn(32, 80, 256, device=cuda).to(BF)

    def grads():
        leaves = [t.clone().requires_grad_() for t in (x, w, b, gamma, beta)]
        CB.conv_gn_mish(*leaves, 8).backward(cot)
        torch.cuda.synchronize()
        return [t.grad for t in leaves]

    n = CW.conv1d_weight_grad_bf16_cuda.launches
    ours = grads()
    assert CW.conv1d_weight_grad_bf16_cuda.launches == n + 1
    real = CB.conv_gn_mish_bf16_cuda, CB.conv1d_weight_grad
    CB.conv_gn_mish_bf16_cuda, CB.conv1d_weight_grad = (CB.conv_gn_mish_plain,
                                                        CW.conv1d_weight_grad_plain)
    try:
        ref = grads()
    finally:
        CB.conv_gn_mish_bf16_cuda, CB.conv1d_weight_grad = real
    assert [t.dtype for t in ours] == [BF, BF] + [torch.float32] * 3
    for o, r in zip(ours, ref):
        d = (o.float() - r.float()).abs() / r.float().abs().max()
        assert d.max().item() <= BWD_TOL[0] and d.median().item() <= BWD_TOL[1]


def _qkv(cuda, B, N, heads, dh, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(B, N, 3 * heads * dh, generator=g, device=cuda).to(BF)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,N,heads,dh,w", [(16, 128, 8, 64, 16), (4, 1024, 8, 64, 16),
                                            (4, 120, 8, 64, 16), (2, 96, 2, 16, 16),
                                            (2, 384, 4, 32, 32), (1, 256, 2, 128, 16)])
def test_b3_bf16_matches_plain(cuda, B, N, heads, dh, w, causal):
    qkv = _qkv(cuda, B, N, heads, dh, seed=N + dh)
    lengths = torch.linspace(N, 3, B, device=cuda).round()
    masks = (None, (torch.arange(N, device=cuda)[None] < lengths[:, None]).float())
    for key_mask in masks:
        n, n32 = FA.fused_qkv_local_attention_bf16_cuda.launches, \
            FA.fused_qkv_local_attention_cuda.launches
        args = (qkv, heads, dh, w, causal, True, True, key_mask)
        out = FA.fused_qkv_local_attention_bf16_cuda(*args)
        torch.cuda.synchronize()
        assert FA.fused_qkv_local_attention_bf16_cuda.launches == n + 1
        assert FA.fused_qkv_local_attention_cuda.launches == n32
        _within_one_ulp(out, FA.fused_qkv_local_attention_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,heads,dh", [(64, 96, 8, 64), (4, 1024, 8, 64), (2, 40, 2, 16)])
def test_b3_bf16_with_the_keep_mask_matches_plain(cuda, B, N, heads, dh):
    """la_train's shape (B 64 x N 96), a sliced plan and an autopad plan, with
    the float32 keep mask and a prefix key mask; the gradient through the
    autograd entry (the plain version's backward) comes back bf16."""
    w = 16
    qkv = _qkv(cuda, B, N, heads, dh, seed=B + N)
    keep = FA.dropout_keep_mask(torch.Generator(device=cuda).manual_seed(N), 0.7, B, N, heads,
                                w)
    lengths = torch.linspace(N, 3, B, device=cuda).round()
    for key_mask in (None, (torch.arange(N, device=cuda)[None] < lengths[:, None]).float()):
        args = (qkv, heads, dh, w, False, True, True, key_mask, keep, 0.7)
        n = FA.fused_qkv_local_attention_bf16_cuda.launches
        out = FA.fused_qkv_local_attention_bf16_cuda(*args)
        torch.cuda.synchronize()
        assert FA.fused_qkv_local_attention_bf16_cuda.launches == n + 1
        _within_one_ulp(out, FA.fused_qkv_local_attention_plain(*args))
    x = qkv.clone().requires_grad_()
    FA.fused_qkv_local_attention(x, heads, dh, w, dropout_keep=keep,
                                 keep_prob=0.7).float().sum().backward()
    assert x.grad.dtype == BF and bool(torch.isfinite(x.grad.float()).all())


@pytest.mark.cuda
def test_b3_bf16_every_plan(cuda):
    """Tensor and CUDA cores, each slab, at the serving shape."""
    B, N, heads, dh, w = 16, 128, 8, 64, 16
    qkv = _qkv(cuda, B, N, heads, dh, seed=5)
    ref = FA.fused_qkv_local_attention_plain(qkv, heads, dh, w)
    p = FA.plan(N, w, False)
    for mma in (True, False):
        for slab in (16, 32, 64, 128) if mma else (8, 16, 32, 64):
            lp = FA.attention_plan(p["Np"], p["C"], p["P"], w, False, dh, B * heads, True,
                                   slab=slab, mma=mma)
            _within_one_ulp(FA.fused_qkv_local_attention_bf16_cuda(qkv, heads, dh, w,
                                                                   launch_plan=lp), ref)


@pytest.mark.cuda
def test_bf16_models_launch_only_the_bf16_kernels(cuda):
    """The dim-128 U-Net: 33 launches of B1's bf16 kernel a forward; the
    local transformer (depth 6): 6 of B3's bf16 entry; no float32 launch."""
    torch.manual_seed(0)
    unet = TemporalUnet(35, dim=128, dtype=BF).to(cuda).eval()
    la = LocalTransformer(69, 128, dim=512, depth=6, heads=8, dim_head=64, window_size=16,
                          dtype=BF).to(cuda).eval()

    def counts():
        return (CB.conv_gn_mish_bf16_cuda.launches, CB.conv_gn_mish_cuda.launches,
                FA.fused_qkv_local_attention_bf16_cuda.launches,
                FA.fused_qkv_local_attention_cuda.launches)
    with torch.inference_mode():
        c0 = counts()
        u = unet(torch.randn(4, 64, 35, device=cuda), torch.randint(0, 1000, (4,), device=cuda))
        c1 = counts()
        a = la(torch.randn(4, 128, 69, device=cuda), torch.randint(0, 1000, (4,), device=cuda))
        c2 = counts()
    assert [x - y for x, y in zip(c1, c0)] == [33, 0, 0, 0]
    assert [x - y for x, y in zip(c2, c1)] == [0, 0, 6, 0]
    assert u.dtype == a.dtype == torch.float32
    assert bool(torch.isfinite(u).all()) and bool(torch.isfinite(a).all())


FIRST_PLAN = """
import json, sys, torch
from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_weight_grad as CW
from deepmimic_diffusion_mujoco_tpu_torch.ops import fused_local_attention as FA
g = torch.Generator(device="cuda").manual_seed(0)
if sys.argv[1] == "b1_bf16":
    # B1's bf16 kernel, its first launch at a plan above 48 KB (the plan check opts in)
    from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_block_kernel as CB
    x = torch.randn(16, 8, 1024, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(5, 1024, 1024, generator=g, device="cuda") / 72).to(torch.bfloat16)
    b, gamma, beta = (torch.randn(1024, generator=g, device="cuda") * 0.1 for _ in range(3))
    plan = CB.bf16_plan(16, 8, 1024, 1024, 5, 8)
    out = CB.conv_gn_mish_bf16_cuda(x, w, b, gamma + 1, beta, 8)
    err = (out.float() - CB.conv_gn_mish_plain(x, w, b, gamma + 1, beta, 8).float()).abs().max()
    smem, static = plan.smem_bytes, CB.BF16_STATIC_SMEM
elif sys.argv[1] == "b2_bf16":
    # the bf16 ring at 49,152 dynamic bytes (4 stages of 6,144 bf16): the bf16 instantiation
    # opts in on its own
    x = torch.randn(2, 96, 16, generator=g, device="cuda").to(torch.bfloat16)
    dy = torch.randn(2, 96, 64, generator=g, device="cuda").to(torch.bfloat16)
    plan = CW.make_wgrad_plan(2, 96, 16, 64, 1, 132, tci=16, tco=64, rows=64, stages=4,
                              cluster=1, slices=1, bf16=True)
    ref = CW.conv1d_weight_grad_plain(x, dy, 1)
    out = CW.conv1d_weight_grad_bf16_cuda(x, dy, 1, plan=plan)
    err = (out - ref).abs().max() / ref.abs().max()
    smem, static = plan.smem_bytes, CW.STATIC_SMEM
elif sys.argv[1] == "b2":
    # 49,152 dynamic bytes: 48 KB exactly, over it with the 64 static bytes
    x = torch.randn(2, 96, 16, generator=g, device="cuda")
    dy = torch.randn(2, 96, 64, generator=g, device="cuda")
    plan = CW.make_wgrad_plan(2, 96, 16, 64, 1, 132, tci=16, tco=64, rows=64, stages=2,
                              cluster=1, slices=1)
    ref = CW.conv1d_weight_grad_plain(x, dy, 1)
    err = (CW.conv1d_weight_grad_cuda(x, dy, 1, plan=plan) - ref).abs().max() / ref.abs().max()
    smem, static = plan.smem_bytes, CW.STATIC_SMEM
else:
    # B3's bf16 entry first, at a plan over 48 KB (its own instantiation opts in)
    qkv = torch.randn(2, 256, 3 * 2 * 128, generator=g, device="cuda").to(torch.bfloat16)
    p = FA.plan(256, 16, False)
    lp = FA.attention_plan(p["Np"], p["C"], p["P"], 16, False, 128, 4, True, slab=64, mma=True)
    out = FA.fused_qkv_local_attention_bf16_cuda(qkv, 2, 128, 16, launch_plan=lp)
    err = (out.float() - FA.fused_qkv_local_attention_plain(qkv, 2, 128, 16).float()).abs().max()
    smem, static = lp.smem_bytes, 16
torch.cuda.synchronize()
print(json.dumps({"smem": smem, "static": static, "err": err.item()}))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["b2", "b2_bf16", "b3_bf16", "b1_bf16"])
def test_first_plan_in_a_fresh_process_runs(cuda, kind):
    """B2's launcher opts in above 48 KB by its static and dynamic bytes
    together: a fresh process whose first B2 plan takes exactly 48 KB of
    dynamic shared memory (over it with the 64 static bytes) runs, in the
    float32 form and in the bf16 form (its 2-byte ring counted as such). B3's
    dynamic bytes are multiples of 80, 144, 272 or 528 and none lies within
    16 bytes under 48 KB, so its fresh process runs the bf16 entry's first
    launch at a plan above 48 KB: each instantiation opts in on its own. B1's
    bf16 kernel runs its first launch at the rule's plan for the deepest
    serve shape (197,888 dynamic bytes)."""
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", FIRST_PLAN, kind], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    if kind.startswith("b2"):
        assert got["smem"] <= 48 * 1024 < got["smem"] + got["static"]
        assert got["err"] <= 1e-5
    elif kind == "b1_bf16":
        assert got["smem"] > 48 * 1024 and got["err"] <= 0.05
    else:
        assert got["smem"] > 48 * 1024 and got["err"] <= 0.05
