"""The bf16 forms of the horizon-split kernels and of B4 against their plain
versions, on the card: K1 (``conv_gn_stats_bf16``), K2
(``gn_affine_mish_bf16``), K3 (``local_attention_halo_bf16``) and B4
(``local_attention_heads_bf16``).

Each computes its plain version's function (float32 sums, one bf16
rounding; K1's outputs stay float32), so a bf16 output agrees within one
bf16 ulp of the value plus the float32 forms' card tolerance for sums in
another order: |d| <= 2^-7 |ref| + TOL elementwise. Over one rank (zero halo
rows) bf16 K1 + K2 is B1's bf16 form; K3's slabs put together are B3's bf16
entry on the whole horizon. K2 with an addend rounds its Mish value to bf16
and then the sum: it equals the launch without the addend followed by the
bf16 add, to the bit, and its plain version within one bf16 ulp of the Mish
value carried through the add plus one of the sum.

Marked ``cuda``; each test skips where no CUDA device is present. This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_bf16_seq_cuda_kernels.py
"""
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_block_kernel as CB
from deepmimic_diffusion_mujoco_tpu_torch.ops import fused_local_attention as FA
from deepmimic_diffusion_mujoco_tpu_torch.ops import local_attention_kernel as LH
from test_torch_seq_cuda_kernels import K2_SHAPES, added, k2_inputs

BF = torch.bfloat16
ULP = 2.0 ** -7  # one bf16 ulp of a value v is at most 2^-7 |v|
TOL = 1e-4       # B1's and B3's float32 card tolerance: sums in another order
M2_RTOL = 1e-4   # K1's sum of squared deviations, relative


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _within_one_ulp(out, ref):
    assert out.dtype == ref.dtype == BF
    d = (out.float() - ref.float()).abs()
    beyond = int((d > ULP * ref.float().abs() + TOL).sum())
    assert beyond == 0, f"max |d| {d.max().item()}, {beyond} values beyond the bound"


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Cin,Cout,k", [
    # a rank's shapes of the dim-128 U-Net split 512 + 512 (B 4), and odd ones: a group width
    # no multiple of 8, H no multiple of 16, k 1 and 9
    (4, 512, 35, 128, 5), (4, 256, 256, 256, 5), (4, 64, 1024, 1024, 5),
    (4, 128, 1024, 256, 5), (3, 21, 37, 24, 3), (2, 5, 8, 16, 1), (2, 100, 70, 512, 9),
])
def test_k1_k2_bf16_match_plain_and_b1_bf16(cuda, B, H, Cin, Cout, k):
    g = torch.Generator(device=cuda).manual_seed(B + H + k)
    xh = torch.randn(B, H + k - 1, Cin, generator=g, device=cuda).to(BF)
    xh[:, :k // 2] = 0
    xh[:, H + k // 2:] = 0
    w = (torch.randn(k, Cin, Cout, generator=g, device=cuda) * (k * Cin) ** -0.5).to(BF)
    b, beta = (0.1 * torch.randn(Cout, generator=g, device=cuda) for _ in range(2))
    gamma = 1 + 0.1 * torch.randn(Cout, generator=g, device=cuda)
    counts = (CB.conv_gn_stats_bf16_cuda, CB.gn_affine_mish_bf16_cuda, CB.conv_gn_stats_cuda,
              CB.gn_affine_mish_cuda)
    before = [f.launches for f in counts]
    pre, stats = CB.conv_gn_stats_bf16_cuda(xh, w, b, 8)
    merged = CB.chan_merge(stats[None], H * (Cout // 8), 1e-5)
    out = CB.gn_affine_mish_bf16_cuda(pre, stats[None], H * (Cout // 8), 1e-5, gamma, beta, 8)
    torch.cuda.synchronize()
    assert [f.launches for f in counts] == [before[0] + 1, before[1] + 1, *before[2:]]
    assert pre.dtype == stats.dtype == torch.float32 and out.dtype == BF
    pre_p, stats_p = CB.conv_gn_stats_plain(xh, w, b, 8)
    torch.testing.assert_close(pre, pre_p, atol=TOL, rtol=TOL)
    torch.testing.assert_close(stats[..., 0], stats_p[..., 0], atol=TOL, rtol=TOL)
    torch.testing.assert_close(stats[..., 1], stats_p[..., 1], atol=0, rtol=M2_RTOL)
    _within_one_ulp(out, CB.gn_affine_mish_plain(pre, merged, gamma, beta, 8, BF))
    b1 = CB.conv_gn_mish_bf16_cuda(xh[:, k // 2:H + k // 2].contiguous(), w, b, gamma, beta, 8)
    _within_one_ulp(out, b1)


@pytest.mark.cuda
@pytest.mark.parametrize("fields", [
    dict(rows=1, cluster=4, split=1, mma=0), dict(rows=1, cluster=8, split=1, mma=1),
    dict(rows=2, cluster=2, split=0, mma=0), dict(rows=1, cluster=4, split=0, mma=1),
    dict(rows=2, cluster=1, split=0, mma=0, tma=0),
])
def test_k1_bf16_every_plan_family(cuda, fields):
    """K1's bf16 entry under the row split and the channel split, both
    instances, TMA off: the pre-norm rows and (mean, M2) against the plain
    version; a rerun gives the same bits."""
    B, H, Cin, Cout, k = 4, 200, 256, 256, 5
    g = torch.Generator(device=cuda).manual_seed(sum(fields.values()))
    xh = torch.randn(B, H + k - 1, Cin, generator=g, device=cuda).to(BF)
    w = (torch.randn(k, Cin, Cout, generator=g, device=cuda) * (k * Cin) ** -0.5).to(BF)
    b = 0.1 * torch.randn(Cout, generator=g, device=cuda)
    plan = CB.make_bf16_plan(B, H, Cin, Cout, k, 8, **fields)
    pre, stats = CB.conv_gn_stats_bf16_cuda(xh, w, b, 8, plan=plan)
    pre_p, stats_p = CB.conv_gn_stats_plain(xh, w, b, 8)
    torch.testing.assert_close(pre, pre_p, atol=TOL, rtol=TOL)
    torch.testing.assert_close(stats[..., 0], stats_p[..., 0], atol=TOL, rtol=TOL)
    torch.testing.assert_close(stats[..., 1], stats_p[..., 1], atol=0, rtol=M2_RTOL)
    again = CB.conv_gn_stats_bf16_cuda(xh, w, b, 8, plan=plan)
    assert torch.equal(pre, again[0]) and torch.equal(stats, again[1])


@pytest.mark.cuda
def test_k1_k2_bf16_refuse_what_they_do_not_take(cuda):
    w = torch.zeros(5, 4, 8, device=cuda, dtype=BF)
    with pytest.raises(ValueError, match="no output row"):
        CB.conv_gn_stats_bf16_cuda(torch.zeros(1, 4, 4, device=cuda, dtype=BF), w,
                                   torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="takes torch.bfloat16"):
        CB.conv_gn_stats_bf16_cuda(torch.zeros(1, 8, 4, device=cuda), w,
                                   torch.zeros(8, device=cuda))
    pre, gamma, beta = (torch.zeros(1, 4, 8, device=cuda), torch.ones(8, device=cuda),
                        torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="parts"):
        CB.gn_affine_mish_bf16_cuda(pre, torch.zeros(1, 4, 2, device=cuda), 4, 1e-5, gamma,
                                    beta, 8)
    parts = torch.zeros(2, 1, 8, 2, device=cuda)
    for add, match in ((torch.zeros(1, 4, 8, device=cuda), "add is"),
                       (torch.zeros(2, 8, dtype=BF, device=cuda), "add"),
                       (torch.zeros(1, 4, 8, dtype=BF), "contiguous CUDA tensor")):
        with pytest.raises(ValueError, match=match):
            CB.gn_affine_mish_bf16_cuda(pre, parts, 4, 1e-5, gamma, beta, 8, add=add)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["none", "row", "full"])
@pytest.mark.parametrize("R", [1, 2, 4])
@pytest.mark.parametrize("H,C", K2_SHAPES)
def test_k2_bf16_merges_and_adds_as_its_plain_version(cuda, H, C, R, kind):
    """R ranks' parts and each bf16 addend at every (H, C) of a rank's
    forward: without the addend within one bf16 ulp of the plain version;
    with it, the launch without it followed by the bf16 add, to the bit, and
    the plain version within one ulp of its Mish value plus one of the sum."""
    pre, parts, gamma, beta, count, add = k2_inputs(cuda, 4, H, C, R, kind, BF, H + C + R)
    n = CB.gn_affine_mish_bf16_cuda.launches
    out = CB.gn_affine_mish_bf16_cuda(pre, parts, count, 1e-5, gamma, beta, 8, add=add)
    bare = CB.gn_affine_mish_bf16_cuda(pre, parts, count, 1e-5, gamma, beta, 8)
    torch.cuda.synchronize()
    assert CB.gn_affine_mish_bf16_cuda.launches == n + 2 and out.dtype == BF
    bare_p = CB.gn_merge_mish_plain(pre, parts, count, 1e-5, gamma, beta, 8, dtype=BF)
    _within_one_ulp(bare, bare_p)
    assert torch.equal(out, added(bare, add))
    plain = CB.gn_merge_mish_plain(pre, parts, count, 1e-5, gamma, beta, 8, add=add, dtype=BF)
    d = (out.float() - plain.float()).abs()
    bound = ULP * (bare_p.float().abs() + plain.float().abs()) + TOL
    assert int((d > bound).sum()) == 0, f"max |d| {d.max().item()}"


def _qkv(cuda, B, N, heads, dh, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(B, N, 3 * heads * dh, generator=g, device=cuda).to(BF)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,Nq,heads,dh,w", [(4, 512, 8, 64, 16), (2, 64, 2, 16, 16),
                                             (2, 96, 4, 32, 32), (1, 256, 2, 128, 16)])
@pytest.mark.parametrize("rank", ["first", "middle", "last"])
def test_k3_bf16_matches_plain(cuda, B, Nq, heads, dh, w, causal, rank):
    """Each rank's slab geometry, with and without prefix lengths."""
    lf = 0 if causal else 1
    q0 = 0 if rank == "first" else w
    Nh = q0 + Nq + (lf * w if rank != "last" else 0)
    pos0 = {"first": 0, "middle": 3 * Nq - q0, "last": 7 * Nq - q0}[rank]
    qkv = _qkv(cuda, B, Nh, heads, dh, seed=Nq + dh)
    lengths = torch.linspace(pos0 + Nh, pos0 + 3, B, device=cuda).round().to(torch.int64)
    for lens in (None, FA.halo_lengths(lengths, pos0, Nh)):
        args = (qkv, heads, dh, w, q0, Nq, pos0, causal, True, True, lens)
        n, n32 = FA.local_attention_halo_bf16_cuda.launches, FA.local_attention_halo_cuda.launches
        out = FA.local_attention_halo_bf16_cuda(*args)
        torch.cuda.synchronize()
        assert FA.local_attention_halo_bf16_cuda.launches == n + 1
        assert FA.local_attention_halo_cuda.launches == n32
        _within_one_ulp(out, FA.local_attention_halo_plain(*args))


@pytest.mark.cuda
def test_k3_bf16_equals_b3_bf16_on_its_rows(cuda):
    """Two ranks' bf16 K3 outputs over H 1024 put together are B3's bf16
    entry on the whole horizon, within one bf16 ulp (the two sum a row's
    keys over other chunks)."""
    B, N, heads, dh, w = 2, 1024, 8, 64, 16
    qkv = _qkv(cuda, B, N, heads, dh, seed=1)
    whole = FA.fused_qkv_local_attention_bf16_cuda(qkv, heads, dh, w)
    n = N // 2
    first = FA.local_attention_halo(qkv[:, :n + w], heads, dh, w, 0, n, 0)
    second = FA.local_attention_halo(qkv[:, n - w:], heads, dh, w, w, n, n - w)
    _within_one_ulp(torch.cat([first, second], dim=1), whole)


@pytest.mark.cuda
@pytest.mark.parametrize("rotary", [True, False])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,N,dh", [(16, 128, 64), (4, 1024, 64), (2, 256, 32), (1, 256, 16),
                                    (1, 384, 128)])
def test_b4_bf16_matches_plain(cuda, B, N, dh, causal, rotary):
    """B4's bf16 entry (q * scale rounded to bf16 before the rotary) through
    its front door ``windowed_attention``, at the served head width and
    every other."""
    g = torch.Generator(device=cuda).manual_seed(N + dh)
    q, k, v = (torch.randn(B, 8 if dh == 64 else 2, N, dh, generator=g, device=cuda).to(BF)
               for _ in range(3))
    n, n32 = LH.local_attention_heads_bf16_cuda.launches, LH.local_attention_heads_cuda.launches
    with torch.no_grad():
        out = LH.windowed_attention(q, k, v, 16, causal=causal, use_rotary=rotary)
    torch.cuda.synchronize()
    assert LH.local_attention_heads_bf16_cuda.launches == n + 1
    assert LH.local_attention_heads_cuda.launches == n32
    _within_one_ulp(out, LH.local_attention_heads_plain(q, k, v, 16, causal, True, rotary))
