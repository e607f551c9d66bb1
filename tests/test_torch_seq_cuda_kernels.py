"""The kernels of sequence-sharded sampling against their plain versions,
on the card: K1 (``conv_gn_stats``) and K2 (``gn_affine_mish``: the ranks'
statistics merge, normalise, Mish and the residual block's add), B1's
horizon-sharded form, and K3 (``local_attention_halo``), B3's halo entry.

Marked ``cuda``; each test skips where no CUDA device is present. This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_seq_cuda_kernels.py
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_block_kernel as CB
from deepmimic_diffusion_mujoco_tpu_torch.ops import fused_local_attention as FA

TOL = 1e-4       # f32 sums in another order (B1's and B3's card tolerance)
M2_RTOL = 1e-4   # K1's sum of squared deviations, relative
# (H, C) of K2's launches in a rank's sharded forward of the dim-128 U-Net (B 4, 512 rows a rank)
K2_SHAPES = [(512, 128), (256, 256), (128, 512), (64, 1024), (64, 512), (128, 256), (256, 128)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Cin,Cout,k", [
    (4, 512, 35, 128, 5), (4, 64, 1024, 1024, 5), (4, 64, 2048, 512, 5), (3, 21, 37, 24, 3),
    (2, 5, 8, 16, 1), (2, 100, 512, 2048, 9), (4, 128, 1024, 256, 5),
])
def test_k1_k2_match_plain_and_b1(cuda, B, H, Cin, Cout, k):
    """K1 and K2 against their plain versions; over one rank (zero halo
    rows, the statistics merged over that rank alone) K1 + K2 is B1."""
    g = torch.Generator(device=cuda).manual_seed(B + H + k)
    xh = torch.randn(B, H + k - 1, Cin, generator=g, device=cuda)
    xh[:, :k // 2] = 0
    xh[:, H + k // 2:] = 0
    w = torch.randn(k, Cin, Cout, generator=g, device=cuda) * (k * Cin) ** -0.5
    b, beta = (0.1 * torch.randn(Cout, generator=g, device=cuda) for _ in range(2))
    gamma = 1 + 0.1 * torch.randn(Cout, generator=g, device=cuda)
    n1, n2 = CB.conv_gn_stats_cuda.launches, CB.gn_affine_mish_cuda.launches
    pre, stats = CB.conv_gn_stats_cuda(xh, w, b, 8)
    count = H * (Cout // 8)
    out = CB.gn_affine_mish_cuda(pre, stats[None], count, 1e-5, gamma, beta, 8)
    torch.cuda.synchronize()
    assert (CB.conv_gn_stats_cuda.launches, CB.gn_affine_mish_cuda.launches) == (n1 + 1, n2 + 1)
    pre_p, stats_p = CB.conv_gn_stats_plain(xh, w, b, 8)
    torch.testing.assert_close(pre, pre_p, atol=TOL, rtol=TOL)
    torch.testing.assert_close(stats[..., 0], stats_p[..., 0], atol=TOL, rtol=TOL)
    torch.testing.assert_close(stats[..., 1], stats_p[..., 1], atol=0, rtol=M2_RTOL)
    merged = CB.chan_merge(stats[None], count, 1e-5)
    torch.testing.assert_close(out, CB.gn_affine_mish_plain(pre, merged, gamma, beta, 8),
                               atol=TOL, rtol=TOL)
    b1 = CB.conv_gn_mish_cuda(xh[:, k // 2:H + k // 2].contiguous(), w, b, gamma, beta, 8)
    torch.testing.assert_close(out, b1, atol=TOL, rtol=TOL)


def k2_inputs(cuda, B, H, C, R, kind, dtype, seed):
    """pre (B, H, C), R ranks' (mean, M2) parts, gamma, beta, count and the
    addend (None, (B, C) or (B, H, C) of ``dtype``), from a seed."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    pre = 0.5 + 2 * torch.randn(B, H, C, generator=g, device=cuda)
    count = H * (C // 8)
    means = 0.5 + 0.3 * torch.randn(R, B, 8, generator=g, device=cuda)
    m2 = count * (3 + 2 * torch.rand(R, B, 8, generator=g, device=cuda))
    gamma = 1 + 0.1 * torch.randn(C, generator=g, device=cuda)
    beta = 0.1 * torch.randn(C, generator=g, device=cuda)
    shape = {"none": None, "row": (B, C), "full": (B, H, C)}[kind]
    add = None if shape is None else torch.randn(shape, generator=g, device=cuda).to(dtype)
    return pre, torch.stack([means, m2], -1), gamma, beta, count, add


def added(out, add):
    """The unfused residual-block add."""
    return out if add is None else out + (add[:, None, :] if add.dim() == 2 else add)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["none", "row", "full"])
@pytest.mark.parametrize("R", [1, 2, 4])
@pytest.mark.parametrize("H,C", K2_SHAPES)
def test_k2_merges_and_adds_as_its_plain_version(cuda, H, C, R, kind):
    """R ranks' parts and each addend at every (H, C) of a rank's forward:
    the plain chain (chan_merge, normalise, Mish, the add) within TOL; the
    add is the epilogue's: the launch without the addend, then the add, to
    the bit; a rerun gives the same bits."""
    pre, parts, gamma, beta, count, add = k2_inputs(cuda, 4, H, C, R, kind, torch.float32,
                                                     H + C + R)
    n = CB.gn_affine_mish_cuda.launches
    out = CB.gn_affine_mish_cuda(pre, parts, count, 1e-5, gamma, beta, 8, add=add)
    torch.cuda.synchronize()
    assert CB.gn_affine_mish_cuda.launches == n + 1 and out.dtype == torch.float32
    plain = CB.gn_merge_mish_plain(pre, parts, count, 1e-5, gamma, beta, 8, add=add)
    torch.testing.assert_close(out, plain, atol=TOL, rtol=TOL)
    bare = CB.gn_affine_mish_cuda(pre, parts, count, 1e-5, gamma, beta, 8)
    assert torch.equal(out, added(bare, add))
    assert torch.equal(out, CB.gn_affine_mish_cuda(pre, parts, count, 1e-5, gamma, beta, 8,
                                                   add=add))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,groups", [(3, 21, 24, 8), (2, 5, 36, 4), (1, 7, 2048, 32)])
def test_k2_odd_shapes(cuda, B, H, C, groups):
    """A width no multiple of 4 per group or of 8 in all (the one-value
    path where C / 4 is not whole: C 36 at bf16), few rows, 2048 channels."""
    for dtype, fn in ((torch.float32, CB.gn_affine_mish_cuda),
                      (torch.bfloat16, CB.gn_affine_mish_bf16_cuda)):
        g = torch.Generator(device=cuda).manual_seed(C)
        pre = torch.randn(B, H, C, generator=g, device=cuda)
        count = H * (C // groups)
        parts = torch.stack([torch.randn(2, B, groups, generator=g, device=cuda),
                             count * (1 + torch.rand(2, B, groups, generator=g, device=cuda))],
                            -1)
        gamma, beta = torch.ones(C, device=cuda), torch.zeros(C, device=cuda)
        add = torch.randn(B, H, C, generator=g, device=cuda).to(dtype)
        out = fn(pre, parts, count, 1e-5, gamma, beta, groups, add=add)
        plain = CB.gn_merge_mish_plain(pre, parts, count, 1e-5, gamma, beta, groups,
                                       dtype=dtype)
        bare = fn(pre, parts, count, 1e-5, gamma, beta, groups)
        torch.testing.assert_close(bare.float(), plain.float(), atol=TOL,
                                   rtol=TOL if dtype == torch.float32 else 2.0 ** -7)
        assert torch.equal(out, added(bare, add))


FIRST_PLAN = """
import json, sys, torch
from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_block_kernel as CB
torch.backends.cudnn.allow_tf32 = False  # the plain versions' conv in f32
stats, H = sys.argv[1] == "k1", int(sys.argv[2])
g = torch.Generator(device="cuda").manual_seed(0)
x = torch.randn(4, H + 4 * stats, 35, generator=g, device="cuda")
w = torch.randn(5, 35, 128, generator=g, device="cuda") * 175 ** -0.5
b, beta = torch.zeros(128, device="cuda"), torch.zeros(128, device="cuda")
gamma = torch.ones(128, device="cuda")
plan = (CB.stats_plan if stats else CB.conv_plan)(4, H, 35, 128, 5, 8)
clusters = CB.max_active_clusters(plan, H, 35, 128, 5, 8, True, x.device, stats=stats)
if stats:
    err = CB.conv_gn_stats_cuda(x, w, b, 8)[0] - CB.conv_gn_stats_plain(x, w, b, 8)[0]
else:
    err = (CB.conv_gn_mish_cuda(x, w, b, gamma, beta, 8)
           - CB.conv_gn_mish_plain(x, w, b, gamma, beta, 8))
print(json.dumps({"smem": plan.smem_bytes, "clusters": clusters,
                  "err": err.abs().max().item()}))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("kind,H", [("k1", 512), ("b1", 256)])
def test_first_plan_in_a_fresh_process_runs(cuda, kind, H):
    """The first conv block plan a fresh process asks of the card, at 35 ->
    128 channels (K1's cluster-8 plan over 512 rows, B1's plan at H 256),
    takes under 48 KB of dynamic shared memory but over 48 KB beside the
    kernel's static shared memory. The launcher opts in to more for it, so
    the card holds its clusters and the launch runs (without that,
    cudaOccupancyMaxActiveClusters gave 0 and the launch was refused until
    a larger plan had opted in)."""
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", FIRST_PLAN, kind, str(H)], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["clusters"] >= 1 and got["err"] <= TOL
    assert got["smem"] <= 48 * 1024 < got["smem"] + CB.STATIC_SMEM


@pytest.mark.cuda
def test_k1_k2_refuse_what_they_do_not_take(cuda):
    w = torch.zeros(5, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="no output row"):
        CB.conv_gn_stats_cuda(torch.zeros(1, 4, 4, device=cuda), w, torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        CB.conv_gn_stats_cuda(torch.zeros(1, 8, 4), w, torch.zeros(8, device=cuda))
    pre, gamma, beta = (torch.zeros(1, 4, 8, device=cuda), torch.ones(8, device=cuda),
                        torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="parts"):
        CB.gn_affine_mish_cuda(pre, torch.zeros(1, 4, 2, device=cuda), 4, 1e-5, gamma, beta, 8)
    with pytest.raises(ValueError, match="parts"):
        CB.gn_affine_mish_cuda(pre, torch.zeros(2, 2, 8, 2, device=cuda), 4, 1e-5, gamma, beta,
                               8)
    parts = torch.zeros(2, 1, 8, 2, device=cuda)
    for add, match in ((torch.zeros(1, 5, 8, device=cuda), "add"),
                       (torch.zeros(1, 8, dtype=torch.bfloat16, device=cuda), "add is"),
                       (torch.zeros(1, 8), "contiguous CUDA tensor"),
                       (torch.zeros(1, 8, 4, device=cuda).transpose(1, 2), "contiguous CUDA")):
        with pytest.raises(ValueError, match=match):
            CB.gn_affine_mish_cuda(pre, parts, 4, 1e-5, gamma, beta, 8, add=add)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,Nq,heads,dh,w", [(4, 512, 8, 64, 16), (2, 64, 2, 16, 16),
                                             (2, 96, 4, 32, 32), (1, 256, 2, 128, 16)])
@pytest.mark.parametrize("rank", ["first", "middle", "last"])
def test_k3_matches_plain(cuda, B, Nq, heads, dh, w, causal, rank):
    """Each rank's slab geometry, with and without prefix lengths (some
    rows with every key masked)."""
    lf = 0 if causal else 1
    q0 = 0 if rank == "first" else w
    Nh = q0 + Nq + (lf * w if rank != "last" else 0)
    pos0 = {"first": 0, "middle": 3 * Nq - q0, "last": 7 * Nq - q0}[rank]
    g = torch.Generator(device=cuda).manual_seed(Nq + dh)
    qkv = torch.randn(B, Nh, 3 * heads * dh, generator=g, device=cuda)
    lengths = torch.linspace(pos0 + Nh, pos0 + 3, B, device=cuda).round().to(torch.int64)
    for lens in (None, FA.halo_lengths(lengths, pos0, Nh)):
        args = (qkv, heads, dh, w, q0, Nq, pos0, causal, True, True, lens)
        n = FA.local_attention_halo_cuda.launches
        out = FA.local_attention_halo_cuda(*args)
        torch.cuda.synchronize()
        assert FA.local_attention_halo_cuda.launches == n + 1
        torch.testing.assert_close(out, FA.local_attention_halo_plain(*args), atol=TOL, rtol=TOL)


@pytest.mark.cuda
def test_k3_equals_b3_on_its_rows(cuda):
    """Two ranks' K3 outputs over H 1024 put together are B3's on the whole
    horizon (rotary at the global positions)."""
    B, N, heads, dh, w = 2, 1024, 8, 64, 16
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(B, N, 3 * heads * dh, generator=g, device=cuda)
    whole = FA.fused_qkv_local_attention_cuda(qkv, heads, dh, w)
    n = N // 2
    first = FA.local_attention_halo_cuda(qkv[:, :n + w].contiguous(), heads, dh, w, 0, n, 0)
    second = FA.local_attention_halo_cuda(qkv[:, n - w:].contiguous(), heads, dh, w, w, n,
                                          n - w)
    torch.testing.assert_close(torch.cat([first, second], dim=1), whole, atol=TOL, rtol=TOL)
