"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where no CUDA device is present. This file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""
from pathlib import Path

import pytest
import torch

from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_block_kernel as TK
from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_weight_grad as TW
from deepmimic_diffusion_mujoco_tpu_torch.ops import fused_local_attention as TA
from deepmimic_diffusion_mujoco_tpu_torch.ops import local_attention_kernel as TH

WGRAD_TOL = 1e-5  # of max |dW|: f32 sums over up to B*H = 10,240 rows in another order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _conv_block_inputs(cuda, B, H, Cin, Cout, k, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(B, H, Cin, generator=g, device=cuda)
    w = torch.randn(k, Cin, Cout, generator=g, device=cuda) * (k * Cin) ** -0.5
    b, beta = (torch.randn(Cout, generator=g, device=cuda) * 0.1 for _ in range(2))
    gamma = 1 + 0.1 * torch.randn(Cout, generator=g, device=cuda)
    return x, w, b, gamma, beta


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Cin,Cout,k", [
    (16, 64, 35, 128, 5), (16, 8, 1024, 1024, 5), (3, 21, 37, 24, 3),
    (2, 5, 8, 16, 1), (1, 200, 70, 2048, 9), (2, 100, 64, 512, 5), (4, 8, 2048, 512, 5),
    # default plans: one rank and row (training's H 160), two ranks and rows (training's
    # H 20, and H 3), four row tiles
    (32, 160, 128, 128, 5), (32, 20, 1024, 1024, 5), (2, 3, 256, 64, 7), (2, 100, 512, 2048, 5),
])
def test_conv_gn_mish_kernel_matches_plain(cuda, B, H, Cin, Cout, k):
    args = _conv_block_inputs(cuda, B, H, Cin, Cout, k)
    launches = TK.conv_gn_mish_cuda.launches
    out = TK.conv_gn_mish_cuda(*args, 8)
    torch.cuda.synchronize()
    assert TK.conv_gn_mish_cuda.launches == launches + 1
    ref = TK.conv_gn_mish_plain(*args, 8)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("B,H,Cin,Cout,k", [(16, 8, 1024, 1024, 5), (4, 20, 512, 512, 3),
                                            (2, 100, 512, 2048, 5), (3, 48, 35, 24, 5)])
def test_conv_gn_mish_kernel_takes_every_cluster_size(cuda, cluster, B, H, Cin, Cout, k):
    args = _conv_block_inputs(cuda, B, H, Cin, Cout, k, seed=3)
    plan = TK.make_plan(B, H, Cin, Cout, k, 8, cluster=cluster)
    out = TK.conv_gn_mish_cuda(*args, 8, plan=plan)
    torch.testing.assert_close(out, TK.conv_gn_mish_plain(*args, 8), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 2, 3, 4])
@pytest.mark.parametrize("B,H,Cin,Cout,k", [(5, 8, 512, 512, 5), (3, 20, 256, 128, 5)])
def test_conv_gn_mish_kernel_takes_every_row_count(cuda, rows, B, H, Cin, Cout, k):
    """R batch rows per cluster, the last block partly past B."""
    args = _conv_block_inputs(cuda, B, H, Cin, Cout, k, seed=5)
    plan = TK.make_plan(B, H, Cin, Cout, k, 8, rows=rows)
    out = TK.conv_gn_mish_cuda(*args, 8, plan=plan)
    torch.testing.assert_close(out, TK.conv_gn_mish_plain(*args, 8), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Cin,Cout,k,cluster", [
    (16, 8, 1024, 1024, 5, 2), (32, 20, 1024, 1024, 5, 2), (32, 160, 128, 128, 5, 4),
    (2, 100, 512, 2048, 5, 8)])
def test_conv_gn_mish_kernel_is_deterministic(cuda, B, H, Cin, Cout, k, cluster):
    """Ranks' and slices' partial sums are added in a fixed order: two
    launches give the same bits."""
    args = _conv_block_inputs(cuda, B, H, Cin, Cout, k, seed=4)
    plan = TK.make_plan(B, H, Cin, Cout, k, 8, cluster=cluster)
    assert torch.equal(TK.conv_gn_mish_cuda(*args, 8, plan=plan),
                       TK.conv_gn_mish_cuda(*args, 8, plan=plan))


@pytest.mark.cuda
def test_conv_gn_mish_kernel_takes_unaligned_weights(cuda):
    """Weights that do not start on 16 bytes go through the scalar copies."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 16, 35, generator=g, device=cuda)
    w = (torch.randn(5 * 35 * 128 + 1, generator=g, device=cuda) * 0.05)[1:].view(5, 35, 128)
    assert w.is_contiguous() and w.data_ptr() % 16
    b, gamma, beta = torch.zeros(128, device=cuda), torch.ones(128, device=cuda), torch.zeros(
        128, device=cuda)
    out = TK.conv_gn_mish_cuda(x, w, b, gamma, beta, 8)
    torch.testing.assert_close(out, TK.conv_gn_mish_plain(x, w, b, gamma, beta, 8),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_conv_gn_mish_kernel_refuses_bad_inputs(cuda):
    x = torch.randn(2, 8, 16, device=cuda)
    w = torch.randn(5, 16, 12, device=cuda)
    b = torch.zeros(12, device=cuda)
    with pytest.raises(ValueError, match="multiple of groups"):
        TK.conv_gn_mish_cuda(x, w, b, b + 1, b, 8)
    with pytest.raises(ValueError, match="float32"):
        TK.conv_gn_mish_cuda(x.double(), w, b, b + 1, b, 4)
    with pytest.raises(ValueError, match="kernel size"):
        TK.conv_gn_mish_cuda(x, torch.randn(4, 16, 12, device=cuda), b, b + 1, b, 4)


def _wgrad_inputs(cuda, B, H, Cin, Cout, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn(B, H, Cin, generator=g, device=cuda),
            torch.randn(B, H, Cout, generator=g, device=cuda))


def _assert_wgrad_close(out, ref):
    assert out.shape == ref.shape and torch.isfinite(out).all()
    err = (out - ref).abs().max().item()
    assert err <= WGRAD_TOL * ref.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Cin,Cout,k", [
    (32, 160, 35, 128, 5), (32, 80, 512, 128, 5), (32, 20, 2048, 512, 5), (32, 20, 1024, 1024, 5),
    (3, 21, 37, 24, 3), (2, 5, 8, 16, 1), (1, 200, 70, 130, 9), (4, 7, 64, 64, 7), (1, 1, 4, 4, 5),
])
def test_conv1d_weight_grad_kernel_matches_plain(cuda, B, H, Cin, Cout, k):
    x, dy = _wgrad_inputs(cuda, B, H, Cin, Cout)
    launches = TW.conv1d_weight_grad_cuda.launches
    out = TW.conv1d_weight_grad_cuda(x, dy, k)
    torch.cuda.synchronize()
    assert TW.conv1d_weight_grad_cuda.launches == launches + 1
    _assert_wgrad_close(out, TW.conv1d_weight_grad_plain(x, dy, k))
    # split reductions add in a fixed order: bit-identical on a rerun
    assert torch.equal(out, TW.conv1d_weight_grad_cuda(x, dy, k))


@pytest.mark.cuda
@pytest.mark.parametrize("cluster,slices", [(1, 1), (1, 2), (2, 1), (16, 1), (4, 3)])
@pytest.mark.parametrize("B,H,Cin,Cout,tci,tco,rows", [
    (16, 4, 35, 64, 16, 64, 24), (16, 64, 35, 32, 32, 32, 32), (32, 160, 35, 128, 32, 32, 64),
    (4, 33, 70, 96, 16, 32, 24),
])
def test_conv1d_weight_grad_kernel_takes_every_plan(cuda, cluster, slices, B, H, Cin, Cout,
                                                    tci, tco, rows):
    """Every kind of plan: one CTA a tile, or a cluster of 2, 4 or 16 (the
    non-portable size), with one warp a piece of the tile or 2-3 slices
    splitting its k-steps, at H 4, 64 and 160 with Cin 35, and at ragged
    rows and channels; clusters with more CTAs than chunks leave some ranks
    without rows."""
    x, dy = _wgrad_inputs(cuda, B, H, Cin, Cout, seed=cluster)
    plan = TW.make_wgrad_plan(B, H, Cin, Cout, 5, TW.sm_count(cuda), tci=tci, tco=tco,
                              rows=rows, cluster=cluster, slices=slices)
    assert plan.path == "3xtf32" and (plan.cluster, plan.slices) == (cluster, slices)
    out = TW.conv1d_weight_grad_cuda(x, dy, 5, plan=plan)
    torch.cuda.synchronize()
    _assert_wgrad_close(out, TW.conv1d_weight_grad_plain(x, dy, 5))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Cin,Cout,cluster", [(32, 160, 128, 128, 16), (16, 8, 256, 256, 8)])
def test_conv1d_weight_grad_kernel_is_deterministic(cuda, B, H, Cin, Cout, cluster):
    """Split over a cluster, the ranks' partial tiles add in rank order:
    two launches give the same bits."""
    x, dy = _wgrad_inputs(cuda, B, H, Cin, Cout)
    plan = TW.make_wgrad_plan(B, H, Cin, Cout, 5, TW.sm_count(cuda), cluster=cluster)
    first = TW.conv1d_weight_grad_cuda(x, dy, 5, plan=plan)
    assert torch.equal(first, TW.conv1d_weight_grad_cuda(x, dy, 5, plan=plan))


@pytest.mark.cuda
def test_conv1d_weight_grad_kernel_takes_unaligned_rows(cuda):
    """x that does not start on 16 bytes goes through the scalar copies."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(4 * 40 * 64 + 1, generator=g, device=cuda)[1:].view(4, 40, 64)
    dy = torch.randn(4, 40, 128, generator=g, device=cuda)
    assert x.is_contiguous() and x.data_ptr() % 16
    _assert_wgrad_close(TW.conv1d_weight_grad_cuda(x, dy, 5), TW.conv1d_weight_grad_plain(x, dy, 5))


@pytest.mark.cuda
def test_conv1d_weight_grad_kernel_refuses_bad_inputs(cuda):
    x, dy = _wgrad_inputs(cuda, 2, 8, 16, 12)
    with pytest.raises(ValueError, match="kernel size"):
        TW.conv1d_weight_grad_cuda(x, dy, 4)
    with pytest.raises(ValueError, match="float32"):
        TW.conv1d_weight_grad_cuda(x.double(), dy.double(), 5)
    with pytest.raises(ValueError, match="contiguous"):
        TW.conv1d_weight_grad_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), dy, 5)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        TW.conv1d_weight_grad_cuda(x.cpu(), dy, 5)
    with pytest.raises(ValueError, match="plan made for"):
        TW.conv1d_weight_grad_cuda(x, dy, 5, plan=TW.wgrad_plan(2, 9, 16, 12, 5, 132))


@pytest.mark.cuda
def test_conv_block_backward_takes_dw_from_the_kernel(cuda):
    """The autograd entry on the card (B1 forward, B2 dW) against autograd
    through the plain version."""
    g = torch.Generator(device=cuda).manual_seed(2)
    B, H, Cin, Cout = 4, 40, 35, 128
    args = [torch.randn(B, H, Cin, generator=g, device=cuda),
            torch.randn(5, Cin, Cout, generator=g, device=cuda) * (5 * Cin) ** -0.5,
            0.1 * torch.randn(Cout, generator=g, device=cuda),
            1 + 0.1 * torch.randn(Cout, generator=g, device=cuda),
            0.1 * torch.randn(Cout, generator=g, device=cuda)]
    cot = torch.randn(B, H, Cout, generator=g, device=cuda)
    grads = []
    for fn in (TK.conv_gn_mish, TK.conv_gn_mish_plain):
        leaves = [a.clone().requires_grad_() for a in args]
        launches = TW.conv1d_weight_grad_cuda.launches
        (fn(*leaves, 8) * cot).sum().backward()
        torch.cuda.synchronize()
        grads.append([t.grad for t in leaves])
        expected = launches + (1 if fn is TK.conv_gn_mish else 0)
        assert TW.conv1d_weight_grad_cuda.launches == expected
    for ours, ref in zip(*grads):
        assert (ours - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


ATTN_TOL = 1e-4  # |kernel - plain|: f32 sums over at most 384 keys in another order


def _qkv_inputs(cuda, B, N, h, dh, w, causal, lengths=None, keep_prob=None, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(B, N, 3 * h * dh, generator=g, device=cuda)
    km = keep = None
    if lengths is not None:
        km = (torch.arange(N, device=cuda)[None, :]
              < torch.tensor(lengths, device=cuda)[:, None]).float()
    if keep_prob is not None:
        keep = TA.dropout_keep_mask(g, keep_prob, B, N, h, w, causal)
    return qkv, km, keep


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,h,dh,w,causal,exact", [
    (16, 128, 8, 64, 16, False, True), (4, 1024, 8, 64, 16, False, True),
    (4, 120, 8, 64, 16, False, True), (2, 40, 2, 32, 16, True, True),
    (2, 384, 2, 16, 48, False, True), (2, 384, 2, 16, 48, False, False),
    (1, 256, 2, 128, 64, True, True), (2, 256, 3, 64, 8, False, False),
    (1, 256, 1, 64, 128, False, True),
])
@pytest.mark.parametrize("masks", ["none", "lengths", "lengths+keep"])
def test_fused_qkv_local_attention_kernel_matches_plain(cuda, B, N, h, dh, w, causal, exact,
                                                         masks):
    lengths = [N - 3 * i * (N // 8) for i in range(B)] if masks != "none" else None
    qkv, km, keep = _qkv_inputs(cuda, B, N, h, dh, w, causal, lengths,
                                0.7 if masks == "lengths+keep" else None)
    kp = 0.7 if keep is not None else 1.0
    launches = TA.fused_qkv_local_attention_cuda.launches
    out = TA.fused_qkv_local_attention_cuda(qkv, h, dh, w, causal, exact, True, km, keep, kp)
    torch.cuda.synchronize()
    assert TA.fused_qkv_local_attention_cuda.launches == launches + 1
    ref = TA.fused_qkv_local_attention_plain(qkv, h, dh, w, causal, exact, True, km, keep, kp)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= ATTN_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("N", [48, 384])
def test_fused_qkv_kernel_fully_masked_rows_take_the_chunk_mean(cuda, N):
    """Rows whose keys are all masked get the mean of V over the chunk's K
    key rows (pad and clamped duplicate rows included), with the keep mask."""
    qkv, km, keep = _qkv_inputs(cuda, 2, N, 2, 32, 16, False, [N, 2], 0.5, seed=3)
    for kp_mask, kp in ((None, 1.0), (keep, 0.5)):
        out = TA.fused_qkv_local_attention_cuda(qkv, 2, 32, 16, False, True, True, km, kp_mask, kp)
        ref = TA.fused_qkv_local_attention_plain(qkv, 2, 32, 16, False, True, True, km, kp_mask,
                                                 kp)
        assert (out - ref).abs().max().item() <= ATTN_TOL
        assert out[1, 40:].abs().max().item() > 0  # the uniform rows are not zero


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,h,dh,w,causal,plan", [
    (2, 384, 2, 16, 48, False, dict(slab=32, mma=False)),  # slab edges off the window grid
    (2, 384, 2, 16, 48, False, dict(slab=64, mma=True)),
    (2, 384, 2, 32, 48, True, dict(slab=128, mma=True)),
    (4, 120, 2, 64, 16, False, dict(slab=8, mma=False)),
    (2, 1024, 2, 64, 16, False, dict(slab=16, mma=True)),
    (16, 128, 8, 64, 16, False, dict(slab=64, mma=False)),
    (1, 256, 2, 64, 128, False, dict(slab=64, mma=False, cap=40)),  # the band in segments
    (1, 256, 2, 128, 64, True, dict(slab=16, mma=True, cap=24)),
    (1, 256, 2, 128, 64, False, dict(slab=16, mma=True, cap=40)),
])
@pytest.mark.parametrize("masks", ["none", "lengths+keep"])
def test_fused_qkv_kernel_takes_every_plan(cuda, B, N, h, dh, w, causal, plan, masks):
    lengths = [N - 3 * i * (N // 8) for i in range(B)] if masks != "none" else None
    qkv, km, keep = _qkv_inputs(cuda, B, N, h, dh, w, causal, lengths,
                                0.7 if masks == "lengths+keep" else None)
    kp = 0.7 if keep is not None else 1.0
    p = TA.plan(N, w, causal)
    launch_plan = TA.attention_plan(p["Np"], p["C"], p["P"], w, causal, dh, **plan)
    assert ("cap" in plan) == (launch_plan.segments > 1)
    out = TA.fused_qkv_local_attention_cuda(qkv, h, dh, w, causal, True, True, km, keep, kp,
                                            launch_plan=launch_plan)
    ref = TA.fused_qkv_local_attention_plain(qkv, h, dh, w, causal, True, True, km, keep, kp)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= ATTN_TOL


@pytest.mark.cuda
def test_attention_kernels_are_deterministic(cuda):
    """Two launches on the same inputs give the same bits."""
    qkv, km, keep = _qkv_inputs(cuda, 16, 128, 8, 64, 16, False, [128, 100, 7, 3] * 4, 0.7)
    outs = [TA.fused_qkv_local_attention_cuda(qkv, 8, 64, 16, False, True, True, km, keep, 0.7)
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    g = torch.Generator(device=cuda).manual_seed(8)
    q, k, v = (torch.randn(4, 8, 1024, 64, generator=g, device=cuda) for _ in range(3))
    outs = [TH.local_attention_heads_cuda(q, k, v, 16) for _ in range(2)]
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_fused_qkv_kernel_refuses_bad_inputs(cuda):
    qkv = torch.randn(2, 64, 3 * 2 * 48, device=cuda)
    with pytest.raises(ValueError, match="head width"):
        TA.fused_qkv_local_attention_cuda(qkv, 2, 48, 16)
    with pytest.raises(ValueError, match="float32"):
        TA.fused_qkv_local_attention_cuda(torch.randn(2, 64, 96, device=cuda).double(), 2, 16, 16)
    with pytest.raises(ValueError, match="no chunk plan"):
        TA.fused_qkv_local_attention_cuda(torch.randn(2, 300, 96, device=cuda), 2, 16, 16)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        TA.fused_qkv_local_attention_cuda(torch.randn(2, 64, 96), 2, 16, 16)
    shifted = torch.randn(2 * 64 * 96 + 1, device=cuda)[1:].view(2, 64, 96)
    with pytest.raises(ValueError, match="16-byte aligned"):
        TA.fused_qkv_local_attention_cuda(shifted, 2, 16, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("B,h,N,dh,w,causal", [
    (16, 8, 128, 64, 16, False), (4, 8, 1024, 64, 16, False), (2, 3, 256, 32, 16, True),
    (1, 2, 384, 16, 48, False), (1, 2, 256, 128, 128, True),
])
def test_local_attention_heads_kernel_matches_plain(cuda, B, h, N, dh, w, causal):
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(B, h, N, dh, generator=g, device=cuda) for _ in range(3))
    launches = TH.local_attention_heads_cuda.launches
    out = TH.local_attention_heads_cuda(q, k, v, w, causal)
    torch.cuda.synchronize()
    assert TH.local_attention_heads_cuda.launches == launches + 1
    ref = TH.local_attention_heads_plain(q, k, v, w, causal)
    assert (out - ref).abs().max().item() <= ATTN_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [dict(slab=32, mma=False), dict(slab=16, mma=True, cap=50),
                                  dict(slab=128, mma=True), dict(slab=8, mma=False)])
def test_local_attention_heads_kernel_takes_every_plan(cuda, plan):
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn(2, 2, 384, 32, generator=g, device=cuda) for _ in range(3))
    launch_plan = TA.attention_plan(384, TH.CHUNK, TH.CHUNK, 48, False, 32, **plan)
    out = TH.local_attention_heads_cuda(q, k, v, 48, launch_plan=launch_plan)
    ref = TH.local_attention_heads_plain(q, k, v, 48)
    assert (out - ref).abs().max().item() <= ATTN_TOL


@pytest.mark.cuda
def test_local_attention_autograd_entries_on_the_card(cuda):
    """Both entries launch their kernel forward and backpropagate through
    the plain version."""
    qkv, km, _ = _qkv_inputs(cuda, 2, 128, 2, 32, 16, False, [128, 90])
    cot = torch.randn(2, 128, 64, device=cuda)
    grads = []
    for fn in (TA.fused_qkv_local_attention, TA.fused_qkv_local_attention_plain):
        x = qkv.clone().requires_grad_()
        (fn(x, 2, 32, 16, False, True, True, km) * cot).sum().backward()
        grads.append(x.grad)
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-4 * grads[1].abs().max().item()
    q, k, v = (t.reshape(2, 128, 2, 32).transpose(1, 2).contiguous() for t in qkv.chunk(3, -1))
    launches = TH.local_attention_heads_cuda.launches
    out = TH.local_attention_heads(q.requires_grad_(), k, v, 16)
    out.sum().backward()
    assert TH.local_attention_heads_cuda.launches == launches + 1
    assert torch.isfinite(q.grad).all()


@pytest.mark.cuda
def test_local_transformer_forward_launches_the_kernel(cuda):
    from deepmimic_diffusion_mujoco_tpu_torch.models.local_attention import LocalTransformer

    torch.manual_seed(0)
    model = LocalTransformer(input_dim=69, max_seq_len=128, dim=64, depth=2, heads=4,
                             dim_head=16, num_classes=3).to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(3, 120, 69, generator=g, device=cuda)
    t = torch.tensor([1, 500, 999], device=cuda)
    launches = TA.fused_qkv_local_attention_cuda.launches
    with torch.inference_mode():
        out = model(x, t)
    assert TA.fused_qkv_local_attention_cuda.launches == launches + 2
    real = TA.fused_qkv_local_attention_cuda
    TA.fused_qkv_local_attention_cuda = TA.fused_qkv_local_attention_plain
    try:
        with torch.inference_mode():
            ref = model(x, t)
    finally:
        TA.fused_qkv_local_attention_cuda = real
    assert (out - ref).abs().max().item() <= 1e-3


# B5-B7: the humanoid's control step, rollout and tracking reward. Tolerances:
# f32 through 17 substeps of stiff contact (30,000 N/m at h = 1/510 s), where
# FMA contraction and the order of sums differ from the plain version's.
STEP_QPOS_TOL, STEP_QVEL_REL, REWARD_TOL = 1e-4, 1e-2, 1e-4
WALK = str(Path(__file__).resolve().parents[1] / "data" / "motions" / "humanoid3d_walk.txt")


def _walk_inputs(cuda, N, T=0):
    import numpy as np

    from deepmimic_diffusion_mujoco_tpu_torch.data.mocap import load_clip

    clip = load_clip(WALK)
    nf = len(clip.qpos)
    mot = torch.tensor(clip.qpos, dtype=torch.float32, device=cuda)
    vel = torch.tensor(clip.qvel, dtype=torch.float32, device=cuda)
    i = torch.from_numpy(np.arange(N) * 7 % nf).to(cuda)
    frames = (i[None] + 1 + torch.arange(max(T, 1), device=cuda)[:, None]) % nf
    return mot[i], vel[i], mot[frames], vel[frames]


def _assert_step_close(out, ref):
    assert all(torch.isfinite(t).all() for t in out)
    assert (out[0] - ref[0]).abs().max().item() <= STEP_QPOS_TOL
    assert (out[1] - ref[1]).abs().max().item() <= STEP_QVEL_REL * ref[1].abs().max().item()
    if len(out) == 3:
        assert (out[2] - ref[2]).abs().max().item() <= REWARD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("N,substeps", [(8, 17), (45, 17), (100, 3)])
@pytest.mark.parametrize("reward", [False, True])
def test_control_step_kernel_matches_plain(cuda, N, substeps, reward):
    from deepmimic_diffusion_mujoco_tpu_torch.physics import dynamics_kernel as DK

    qpos, qvel, tgt, rqv = _walk_inputs(cuda, N)
    args = (qpos, qvel, tgt[0], rqv[0] if reward else None)
    kw = dict(h=1 / 30 / 17, substeps=substeps)
    launches = DK.control_step_cuda.launches
    out = DK.control_step_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert DK.control_step_cuda.launches == launches + 1
    assert len(out) == (3 if reward else 2)
    _assert_step_close(out, DK.control_step_plain(*args, **kw))
    assert torch.equal(DK.control_step(*args, **kw)[0], out[0])  # the dispatcher's kernel


@pytest.mark.cuda
@pytest.mark.parametrize("N", [8, 45])
def test_rollout_kernel_matches_plain_and_steps(cuda, N):
    from deepmimic_diffusion_mujoco_tpu_torch.physics import dynamics_kernel as DK

    qpos, qvel, tgts, rqvs = _walk_inputs(cuda, N, T=3)
    done = torch.zeros(N, dtype=torch.bool, device=cuda)
    done[::3] = True
    kw = dict(h=1 / 30 / 17, substeps=17, fall_height=0.3)
    launches = DK.rollout_cuda.launches
    qp, qv, rewards, dn = DK.rollout_cuda(qpos, qvel, tgts, rqvs, done, **kw)
    torch.cuda.synchronize()
    assert DK.rollout_cuda.launches == launches + 1
    assert rewards.shape == (3, N) and dn.dtype == torch.bool
    ref = DK.rollout_plain(qpos, qvel, tgts, rqvs, done, **kw)
    _assert_step_close((qp, qv), ref[:2])
    assert (rewards - ref[2]).abs().max().item() <= REWARD_TOL
    assert torch.equal(dn, ref[3])
    assert (rewards[:, ::3] == 0).all() and torch.equal(qp[::3], qpos[::3])
    # the same device code as three chained B5 steps with the bookkeeping
    s_qp, s_qv, s_dn = qpos, qvel, done
    for t in range(3):
        n_qp, n_qv, r = DK.control_step_cuda(s_qp, s_qv, tgts[t], rqvs[t], h=kw["h"], substeps=17)
        s_qp = torch.where(s_dn[:, None], s_qp, n_qp)
        s_qv = torch.where(s_dn[:, None], s_qv, n_qv)
        s_dn = s_dn | (s_qp[:, 2] < 0.3)
        assert (torch.where(s_dn, 0.0, r) - rewards[t]).abs().max().item() <= 5e-5
    assert (s_qp - qp).abs().max().item() <= 5e-5 and torch.equal(s_dn, dn)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [8, 45])
def test_tracking_reward_kernel_matches_plain(cuda, N):
    from deepmimic_diffusion_mujoco_tpu_torch.physics import dynamics_kernel as DK
    from deepmimic_diffusion_mujoco_tpu_torch.physics.env import tracking_reward

    qpos, qvel, tgt, rqv = _walk_inputs(cuda, N)
    g = torch.Generator(device=cuda).manual_seed(0)
    ref_q = tgt[0] + 0.05 * torch.randn(tgt[0].shape, generator=g, device=cuda)
    launches = DK.tracking_reward_cuda.launches
    out = DK.tracking_reward_cuda(qpos, qvel, ref_q, rqv[0])
    torch.cuda.synchronize()
    assert DK.tracking_reward_cuda.launches == launches + 1
    assert (out - DK.tracking_reward_plain(qpos, qvel, ref_q, rqv[0])).abs().max().item() <= 5e-5
    assert (out - tracking_reward(qpos, qvel, ref_q, rqv[0])).abs().max().item() <= 5e-5


@pytest.mark.cuda
def test_physics_kernels_refuse_bad_inputs(cuda):
    from deepmimic_diffusion_mujoco_tpu_torch.physics import dynamics_kernel as DK

    qpos, qvel, tgt, rqv = _walk_inputs(cuda, 8)
    kw = dict(h=1 / 510, substeps=1)
    with pytest.raises(ValueError, match="float32"):
        DK.control_step_cuda(qpos.double(), qvel.double(), tgt[0].double(), **kw)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        DK.control_step_cuda(qpos.cpu(), qvel, tgt[0], **kw)
    with pytest.raises(ValueError, match="float32"):
        DK.tracking_reward_cuda(qpos.double(), qvel, tgt[0], rqv[0])
    with pytest.raises(ValueError, match="expected"):
        DK.rollout_cuda(qpos, qvel, tgt[:, :4], rqv, torch.zeros(8, device=cuda), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        DK.control_step_cuda(qpos, qvel, tgt[0].t().contiguous().t(), **kw)


@pytest.mark.cuda
def test_physics_env_launches_the_kernels(cuda):
    from deepmimic_diffusion_mujoco_tpu_torch.data.mocap import load_clip
    from deepmimic_diffusion_mujoco_tpu_torch.physics import dynamics_kernel as DK
    from deepmimic_diffusion_mujoco_tpu_torch.physics.env import PhysicsTrackingEnv
    from deepmimic_diffusion_mujoco_tpu_torch.physics.plausibility import track_motions

    clip = load_clip(WALK)
    env = PhysicsTrackingEnv(clip.qpos, clip.qvel)
    state = env.reset(64)
    b5, b6 = DK.control_step_cuda.launches, DK.rollout_cuda.launches
    _, rewards = env.rollout(state, 4)
    s = state
    for _ in range(4):
        s, r = env.step(s)
    assert DK.rollout_cuda.launches == b6 + 1 and DK.control_step_cuda.launches == b5 + 4
    assert (rewards[-1] - r).abs().max().item() <= 5e-5
    res = track_motions(clip.qpos, horizon=3)
    assert DK.control_step_cuda.launches == b5 + 7
    assert res["reward_curve"].shape == (3,)


# B5-B7 under every launch plan (lanes per env, envs per block) of
# ``dynamics_plan``: ragged N, envs done before the rollout and envs that
# fall during it in one warp, contacts and limits off, and reruns.
_PLANS = [(lanes, threads // lanes) for lanes in (8, 16) for threads in (32, 64, 128, 256)]
_PLAIN = {}


def _plain_once(key, fn):
    if key not in _PLAIN:
        _PLAIN[key] = fn()
    return _PLAIN[key]


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,envs", _PLANS)
@pytest.mark.parametrize("N", [1, 33, 4097])
def test_control_step_every_plan_matches_plain(cuda, lanes, envs, N):
    from deepmimic_diffusion_mujoco_tpu_torch.physics import dynamics_kernel as DK

    qpos, qvel, tgt, rqv = _walk_inputs(cuda, N)
    kw = dict(h=1 / 30 / 17, substeps=17)
    plan = DK.dynamics_plan(N, lanes, envs)
    out = DK.control_step_cuda(qpos, qvel, tgt[0], rqv[0], plan=plan, **kw)
    torch.cuda.synchronize()
    ref = _plain_once(("step", N), lambda: DK.control_step_plain(qpos, qvel, tgt[0], rqv[0], **kw))
    _assert_step_close(out, ref)
    r7 = DK.tracking_reward_cuda(qpos, qvel, tgt[0], rqv[0], plan=plan)
    ref7 = _plain_once(("reward", N), lambda: DK.tracking_reward_plain(qpos, qvel, tgt[0], rqv[0]))
    assert (r7 - ref7).abs().max().item() <= 5e-5


def _falling_inputs(cuda, N, T):
    """Walk-clip frames with every third env done before the rollout and
    a fall height (FALL_HIGH) that some envs cross during the rollout and others do not."""
    qpos, qvel, tgts, rqvs = _walk_inputs(cuda, N, T)
    done = torch.zeros(N, dtype=torch.bool, device=cuda)
    done[::3] = True
    return qpos, qvel, tgts, rqvs, done


# after their first step these envs' roots are at 0.889-0.912 m (no closer than 5e-4 to
# this height), and they rise after: some cross it, some do not
FALL_HIGH = 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,envs", _PLANS)
def test_rollout_every_plan_with_done_and_falling_envs(cuda, lanes, envs):
    from deepmimic_diffusion_mujoco_tpu_torch.physics import dynamics_kernel as DK

    N, T = 45, 4
    args = _falling_inputs(cuda, N, T)
    kw = dict(h=1 / 30 / 17, substeps=17, fall_height=FALL_HIGH)
    qp, qv, rewards, dn = DK.rollout_cuda(*args, plan=DK.dynamics_plan(N, lanes, envs), **kw)
    torch.cuda.synchronize()
    ref = _plain_once("falling", lambda: DK.rollout_plain(*args, **kw))
    fell = dn & ~args[4]
    assert fell.any() and (~dn).any()  # some envs fall during the rollout, some do not
    _assert_step_close((qp, qv), ref[:2])
    assert (rewards - ref[2]).abs().max().item() <= REWARD_TOL
    assert torch.equal(dn, ref[3])
    assert (rewards[:, ::3] == 0).all() and torch.equal(qp[::3], args[0][::3])


@pytest.mark.cuda
@pytest.mark.parametrize("contacts,limits", [(False, False), (False, True), (True, False)])
@pytest.mark.parametrize("lanes", [8, 16])
def test_control_step_switches_match_plain(cuda, contacts, limits, lanes):
    from deepmimic_diffusion_mujoco_tpu_torch.physics import dynamics_kernel as DK

    N = 33
    qpos, qvel, tgt, rqv = _walk_inputs(cuda, N)
    kw = dict(h=1 / 30 / 17, substeps=17, contacts=contacts, limits=limits)
    out = DK.control_step_cuda(qpos, qvel, tgt[0], rqv[0], plan=DK.dynamics_plan(N, lanes), **kw)
    torch.cuda.synchronize()
    ref = _plain_once(("switch", contacts, limits),
                      lambda: DK.control_step_plain(qpos, qvel, tgt[0], rqv[0], **kw))
    _assert_step_close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,envs", _PLANS)
def test_physics_kernels_are_deterministic(cuda, lanes, envs):
    """Sums across lanes go in a fixed order: two launches give the same bits."""
    from deepmimic_diffusion_mujoco_tpu_torch.physics import dynamics_kernel as DK

    N, T = 300, 3
    args = _falling_inputs(cuda, N, T)
    kw = dict(h=1 / 30 / 17, substeps=17, fall_height=FALL_HIGH,
              plan=DK.dynamics_plan(N, lanes, envs))
    a = DK.rollout_cuda(*args, **kw)
    b = DK.rollout_cuda(*args, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    kw.pop("fall_height")
    a = DK.control_step_cuda(*args[:2], args[2][0], args[3][0], **kw)
    b = DK.control_step_cuda(*args[:2], args[2][0], args[3][0], **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_local_transformer_training_step_launches_b3_with_keep_masks(cuda):
    """A training step of a small LocalTransformer with attention and
    feed-forward dropout: one B3 launch a layer, each with the kernel-layout
    keep mask drawn on the card, and the loss and gradients of the same step
    through B3's plain version with the same masks (the generator reseeded)."""
    from deepmimic_diffusion_mujoco_tpu_torch.models.local_attention import LocalTransformer

    torch.manual_seed(0)
    model = LocalTransformer(69, max_seq_len=128, dim=64, depth=2, heads=2, dim_head=32,
                             window_size=16, attn_dropout=0.3, ff_dropout=0.3).to(cuda).train()
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(8, 96, 69, generator=g, device=cuda)
    t = torch.randint(0, 1000, (8,), generator=g, device=cuda)
    seen = []
    real = TA.fused_qkv_local_attention_cuda

    def step():
        model.zero_grad(set_to_none=True)
        out = model(x, t, generator=torch.Generator(device=cuda).manual_seed(2))
        (out ** 2).mean().backward()
        return out.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}

    def recorder(qkv, *args):
        seen.append(args[7] is not None and args[7].is_cuda)
        return real(qkv, *args)

    recorder.launches = 0  # the wrapper counts on the name it is reached by
    TA.fused_qkv_local_attention_cuda = recorder
    try:
        out_k, grads_k = step()
    finally:
        TA.fused_qkv_local_attention_cuda = real
    assert recorder.launches == 2 and seen == [True, True]
    TA.fused_qkv_local_attention_cuda = TA.fused_qkv_local_attention_plain
    try:
        out_p, grads_p = step()
    finally:
        TA.fused_qkv_local_attention_cuda = real
    assert (out_k - out_p).abs().max().item() <= 1e-4
    for k, gp in grads_p.items():
        assert (grads_k[k] - gp).abs().max().item() <= 1e-3 * gp.abs().max().item(), k


@pytest.mark.cuda
def test_decoder_forward_on_the_card_matches_float64(cuda):
    import copy

    from deepmimic_diffusion_mujoco_tpu_torch.models.transformer_decoder import (
        TransformerDecoderMotionModel,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    model = TransformerDecoderMotionModel(32, 69, dim=64, n_heads=4, num_layers=2).to(cuda).eval()
    g = torch.Generator().manual_seed(1)
    x, t = torch.randn(4, 24, 69, generator=g), torch.randint(0, 1000, (4,), generator=g)
    with torch.no_grad():
        out = model(x.to(cuda), t.to(cuda)).cpu().double()
        ref = copy.deepcopy(model).cpu().double()(x.double(), t)
    assert ((out - ref).abs().max() / ref.abs().max()).item() <= 1e-4


@pytest.mark.cuda
def test_value_function_launches_b1_and_b2_at_its_shapes(cuda):
    """The ValueFunction (dim 32 over H 64, Cout down to 32 and H down to 4)
    on the card: its 20 conv blocks launch B1; a frozen model's input
    gradient takes no B2; a value-training step takes 20 B2 launches; each
    against the plain versions."""
    from deepmimic_diffusion_mujoco_tpu_torch.diffusion.guidance import value_gradients
    from deepmimic_diffusion_mujoco_tpu_torch.models.temporal_unet import ValueFunction

    torch.manual_seed(0)
    value = ValueFunction(35, 64, dim=32).to(cuda).eval().requires_grad_(False)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(16, 64, 35, generator=g, device=cuda)
    t = torch.randint(0, 1000, (16,), generator=g, device=cuda)
    b1, b2 = TK.conv_gn_mish_cuda.launches, TW.conv1d_weight_grad_cuda.launches
    y, dx = value_gradients(value, x, t)
    torch.cuda.synchronize()
    assert (TK.conv_gn_mish_cuda.launches - b1, TW.conv1d_weight_grad_cuda.launches - b2) == (20, 0)
    real = TK.conv_gn_mish_cuda
    TK.conv_gn_mish_cuda = TK.conv_gn_mish_plain
    try:
        y_p, dx_p = value_gradients(value, x, t)
    finally:
        TK.conv_gn_mish_cuda = real
    assert (y - y_p).abs().max().item() <= 1e-3
    assert (dx - dx_p).abs().max().item() <= 1e-3 * dx_p.abs().max().item()

    value.requires_grad_(True)
    b2 = TW.conv1d_weight_grad_cuda.launches
    value(x, t).square().mean().backward()
    torch.cuda.synchronize()
    assert TW.conv1d_weight_grad_cuda.launches - b2 == 20
    assert all(torch.isfinite(p.grad).all() for p in value.parameters())
