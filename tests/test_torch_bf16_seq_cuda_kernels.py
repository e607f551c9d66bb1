"""The bf16 forms of the horizon-split kernels and of B4 against their plain
versions, on the card: K1 (``conv_gn_stats_bf16``), K2
(``gn_affine_mish_bf16``), K3 (``local_attention_halo_bf16``) and B4
(``local_attention_heads_bf16``).

Each computes its plain version's function (float32 sums, one bf16
rounding; K1's outputs stay float32), so a bf16 output agrees within one
bf16 ulp of the value plus the float32 forms' card tolerance for sums in
another order: |d| <= 2^-7 |ref| + TOL elementwise. Over one rank (zero halo
rows) bf16 K1 + K2 is B1's bf16 form; K3's slabs put together are B3's bf16
entry on the whole horizon.

Marked ``cuda``; each test skips where no CUDA device is present. This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_bf16_seq_cuda_kernels.py
"""
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_block_kernel as CB
from deepmimic_diffusion_mujoco_tpu_torch.ops import fused_local_attention as FA
from deepmimic_diffusion_mujoco_tpu_torch.ops import local_attention_kernel as LH

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
    out = CB.gn_affine_mish_bf16_cuda(pre, merged, gamma, beta, 8)
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
def test_k1_k2_bf16_refuse_what_they_do_not_take(cuda):
    w = torch.zeros(5, 4, 8, device=cuda, dtype=BF)
    with pytest.raises(ValueError, match="no output row"):
        CB.conv_gn_stats_bf16_cuda(torch.zeros(1, 4, 4, device=cuda, dtype=BF), w,
                                   torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="takes torch.bfloat16"):
        CB.conv_gn_stats_bf16_cuda(torch.zeros(1, 8, 4, device=cuda), w,
                                   torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="stats"):
        CB.gn_affine_mish_bf16_cuda(torch.zeros(1, 4, 8, device=cuda),
                                    torch.zeros(1, 4, 2, device=cuda),
                                    torch.ones(8, device=cuda), torch.zeros(8, device=cuda), 8)


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
