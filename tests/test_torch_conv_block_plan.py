"""The launch plan of the conv block kernel (``ops/conv_block_kernel.py:
conv_plan``) at every shape the dim-128 U-Net gives it on the main paths,
and at the odd shapes the card tests run.

The kernel itself runs only on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``); what decides its work split is Python, checked here: the
cluster ranks' input channels, the threads' output tiles and slices, the
shared memory per CTA, and the cache. ``test_plan_split_reproduces_the_conv``
replays the plan's split of the reduction in numpy.
"""
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu_torch.models import temporal_unet
from deepmimic_diffusion_mujoco_tpu_torch.models.temporal_unet import TemporalUnet
from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_block_kernel as TK

torch.set_num_threads(2)

K, GROUPS, DIM, D = 5, 8, 128, 35
# (B, horizons): serving at B 16 (H 64, H 48, and the level-0 H 192 rows of
# chip_smoke.py), a training micro-step at B 32 (H 160)
MAIN_PATHS = [(16, (64, 48)), (32, (160,))]
# the odd shapes of tests/test_torch_cuda_kernels.py: (B, H, Cin, Cout, k)
ODD = [(16, 64, 35, 128, 5), (16, 8, 1024, 1024, 5), (3, 21, 37, 24, 3), (2, 5, 8, 16, 1),
       (1, 200, 70, 2048, 9), (2, 100, 64, 512, 5), (4, 8, 2048, 512, 5)]


def _block_shapes(H):
    """(H, Cin, Cout) of every conv block in one forward of the dim-128 U-Net."""
    seen = []
    real = temporal_unet.conv_gn_mish

    def recorder(x, w, *args):
        seen.append((x.shape[1], w.shape[1], w.shape[2]))
        return real(x, w, *args)

    torch.manual_seed(0)
    model = TemporalUnet(D, dim=DIM).eval()
    temporal_unet.conv_gn_mish = recorder
    try:
        with torch.inference_mode():
            model(torch.zeros(1, H, D), torch.zeros(1, dtype=torch.long))
    finally:
        temporal_unet.conv_gn_mish = real
    return seen


def _main_path_shapes():
    shapes = {}
    for B, horizons in MAIN_PATHS:
        for H in horizons:
            for h, cin, cout in _block_shapes(H):
                shapes[(B, h, cin, cout, K)] = None
    for cin in (D, DIM):  # level 0 at H 192
        shapes[(16, 192, cin, DIM, K)] = None
    return list(shapes)


MAIN = _main_path_shapes()


def test_main_path_shapes_are_the_unets():
    assert len(MAIN) == 44  # 28 serving (H 64, H 48), 2 at H 192, 14 training
    assert sum(1 for s in MAIN if s[0] == 32) == 14
    assert (16, 8, 1024, 1024, K) in MAIN and (32, 20, 2048, 512, K) in MAIN


def _groups(cout):
    return GROUPS if cout % GROUPS == 0 else 1


@pytest.mark.parametrize("B,H,Cin,Cout,k", MAIN + ODD)
def test_plan_is_whole(B, H, Cin, Cout, k):
    groups = _groups(Cout)
    p = TK.conv_plan(B, H, Cin, Cout, k, groups)
    cg = Cout // groups
    assert p.cluster in TK.CLUSTER_SIZES
    # the ranks cover Cin exactly once, each with some channels
    ranks = p.rank_channels(Cin)
    assert ranks[0][0] == 0 and ranks[-1][1] == Cin
    assert all(lo < hi for lo, hi in ranks)
    assert all(a[1] == b[0] for a, b in zip(ranks, ranks[1:]))
    # shared memory per CTA, dynamic and static, within the card's 227 KB
    assert p.smem_bytes == TK.smem_bytes(H, cg, k, p.rows, p.threads, p.tile_h, p.slices, p.ck,
                                         p.stages)
    assert p.smem_bytes + TK.STATIC_SMEM <= 227 * 1024
    # every thread owns one output tile (batch row, rows, channels) of one
    # slice; each slice's tiles cover the cluster's rows x row tile once
    ntc, rg = -(-cg // TK.TN), p.tile_h // TK.TM
    assert 1 <= p.rows <= min(B, TK.MAX_ROWS)
    assert p.tile_h % TK.TM == 0 and p.n_tiles * p.tile_h >= H > (p.n_tiles - 1) * p.tile_h
    assert p.n_out == p.rows * rg * ntc and p.threads == p.n_out * p.slices
    assert 32 <= p.threads <= TK.MAX_THREADS
    rgt = p.rows * rg  # the kernel's mapping: wr row groups side by side where ntc >= 32
    wr = 1 if ntc < 32 else 4 if rgt % 4 == 0 else 2 if rgt % 2 == 0 else 1
    owned = set()
    for tid in range(p.threads):
        slice_, o = divmod(tid, p.n_out)
        o_hi, lo = divmod(o, wr)
        rb, r = divmod((o_hi // ntc) * wr + lo, rg)
        assert rb < p.rows
        owned.add((slice_, rb, r * TK.TM, (o_hi % ntc) * TK.TN))
    assert len(owned) == p.threads
    cells = {(s, rb, r, c) for (s, rb, r0, c0) in owned for r in range(r0, r0 + TK.TM)
             for c in range(c0, c0 + TK.TN)}
    assert len(cells) == p.slices * p.rows * p.tile_h * ntc * TK.TN
    # the ring: whole slices per chunk, copies spread over the threads
    assert p.ck % p.slices == 0 and p.ck <= p.threads and 2 <= p.stages <= TK.MAX_STAGES
    assert p.grid == -(-B // p.rows) * groups * p.cluster


@pytest.mark.parametrize("B,H,Cin,Cout,k", MAIN + ODD)
def test_plan_is_cached(B, H, Cin, Cout, k):
    args = (B, H, Cin, Cout, k, _groups(Cout))
    assert TK.conv_plan(*args) is TK.conv_plan(*args)
    assert TK.conv_plan(*args) == TK.make_plan(*args)


@pytest.mark.parametrize("B,H,Cin,Cout", [s[:4] for s in MAIN if s[1] in (8, 20)])
def test_deep_main_path_shapes_split_across_a_cluster(B, H, Cin, Cout):
    """Serving's H 8 and training's H 20 shapes: two batch rows share each
    weight chunk, and a cluster splits their input channels."""
    p = TK.conv_plan(B, H, Cin, Cout, K, GROUPS)
    assert p.cluster > 1 and p.rows > 1


@pytest.mark.parametrize("cluster", TK.CLUSTER_SIZES)
def test_every_cluster_size_makes_a_plan(cluster):
    p = TK.make_plan(16, 8, 1024, 1024, K, GROUPS, cluster=cluster)
    assert p.cluster == cluster and p.grid == 16 // p.rows * GROUPS * cluster
    assert p.smem_bytes + TK.STATIC_SMEM <= 227 * 1024


def test_plan_refuses_more_ranks_than_channels():
    with pytest.raises(ValueError, match="cluster size"):
        TK.make_plan(2, 8, 4, 16, K, 4, cluster=8)


def _replay(x, w, b, p):
    """The kernel's sum for one (batch row, group), split as the plan
    splits it: ranks over contiguous input channels, chunks of ck, slices
    over each chunk, slices added in order, then ranks in order, then the
    bias."""
    H, cin = x.shape
    k = w.shape[0]
    xp = np.pad(x, ((k // 2, k // 2), (0, 0)))
    total = np.zeros((H, w.shape[2]), np.float32)
    cps = p.ck // p.slices
    for lo, hi in p.rank_channels(cin):
        part = np.zeros_like(total)
        for s in range(p.slices):
            acc = np.zeros_like(total)
            for c0 in range(lo, hi, p.ck):
                for ci in range(c0 + s * cps, min(c0 + (s + 1) * cps, hi)):
                    for tap in range(k):
                        acc += np.outer(xp[tap:tap + H, ci], w[tap, ci])
            part += acc
        total += part
    return total + b


@pytest.mark.parametrize("B,H,Cin,Cout,k,cluster", [
    (16, 8, 96, 32, 5, 4), (2, 13, 37, 24, 3, 2), (1, 20, 64, 16, 1, 8), (2, 5, 16, 8, 5, 1)])
def test_plan_split_reproduces_the_conv(B, H, Cin, Cout, k, cluster):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(H, Cin)).astype(np.float32)
    w = (rng.normal(size=(k, Cin, Cout)) * (k * Cin) ** -0.5).astype(np.float32)
    b = rng.normal(size=(Cout,)).astype(np.float32)
    p = TK.make_plan(B, H, Cin, Cout, k, 1, cluster=cluster)
    assert p.cluster == cluster
    ref = TK._conv(torch.from_numpy(x)[None], torch.from_numpy(w), torch.from_numpy(b))[0]
    np.testing.assert_allclose(_replay(x, w, b, p), ref.numpy(), atol=1e-5, rtol=0)
