"""The kernels of sequence-sharded sampling against their plain versions,
on the card: K1 (``conv_gn_stats``) and K2 (``gn_affine_mish``), B1's
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
    merged = CB.chan_merge(stats[None], H * (Cout // 8), 1e-5)
    out = CB.gn_affine_mish_cuda(pre, merged, gamma, beta, 8)
    torch.cuda.synchronize()
    assert (CB.conv_gn_stats_cuda.launches, CB.gn_affine_mish_cuda.launches) == (n1 + 1, n2 + 1)
    pre_p, stats_p = CB.conv_gn_stats_plain(xh, w, b, 8)
    torch.testing.assert_close(pre, pre_p, atol=TOL, rtol=TOL)
    torch.testing.assert_close(stats[..., 0], stats_p[..., 0], atol=TOL, rtol=TOL)
    torch.testing.assert_close(stats[..., 1], stats_p[..., 1], atol=0, rtol=M2_RTOL)
    torch.testing.assert_close(out, CB.gn_affine_mish_plain(pre, merged, gamma, beta, 8),
                               atol=TOL, rtol=TOL)
    b1 = CB.conv_gn_mish_cuda(xh[:, k // 2:H + k // 2].contiguous(), w, b, gamma, beta, 8)
    torch.testing.assert_close(out, b1, atol=TOL, rtol=TOL)


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
    with pytest.raises(ValueError, match="stats"):
        CB.gn_affine_mish_cuda(torch.zeros(1, 4, 8, device=cuda), torch.zeros(1, 4, 2,
                                                                              device=cuda),
                               torch.ones(8, device=cuda), torch.zeros(8, device=cuda), 8)


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
