"""The launch plan of the windowed-attention kernel (``ops/fused_local_attention.py:
attention_plan``) at every shape the card tests and the served requests give
B3 and B4, for its float32 form and its bf16 form (``elem=2``: bf16 rows
staged, float32 rotated Q and K rows beside them, cos/sin read in L2).

The kernel runs only on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``); what decides which rows a block stages is Python, checked
here in numpy against the chunk semantics (``window_mask``,
``chunk_index_sets``): the plan fits in shared memory, every query row falls
in exactly one slab, and the key rows a slab stages (and those each warp
walks) hold every key its rows may see.
"""
import numpy as np
import pytest

from deepmimic_diffusion_mujoco_tpu_torch.ops import _build
from deepmimic_diffusion_mujoco_tpu_torch.ops import fused_local_attention as FA
from deepmimic_diffusion_mujoco_tpu_torch.ops import local_attention_kernel as LH
from deepmimic_diffusion_mujoco_tpu_torch.ops import local_attention_sweep as SW

SMEM = 232448  # an H100 block's shared memory, dynamic and static
# B3: (N, dh, w, causal) of the card tests' matrices and the three served
# requests (B 16 x H 128, B 4 x H 1024, B 4 x H 120 at dh 64, w 16)
B3_SHAPES = [(128, 64, 16, False), (1024, 64, 16, False), (120, 64, 16, False),
             (40, 32, 16, True), (384, 16, 48, False), (256, 128, 64, True),
             (256, 64, 8, False), (256, 64, 128, False), (384, 32, 48, True),
             (256, 128, 64, False)]
# B4: (N, dh, w, causal) of the card tests and the two aligned requests
B4_SHAPES = [(128, 64, 16, False), (1024, 64, 16, False), (256, 32, 16, True),
             (384, 16, 48, False), (256, 128, 128, True), (384, 32, 48, False)]
# explicit plans of the card tests: (slab, tensor cores, cap)
PLANS = [(8, False, None), (32, False, None), (64, False, 40), (16, True, None),
         (64, True, None), (128, True, None), (16, True, 24), (16, True, 50)]


def _chunking(kind, N, w, causal):
    return FA.plan(N, w, causal) if kind == "b3" else LH.plan(N)


def _cases():
    for kind, shapes in (("b3", B3_SHAPES), ("b4", B4_SHAPES)):
        for N, dh, w, causal in shapes:
            name = f"{kind}-N{N}-dh{dh}-w{w}-c{int(causal)}"
            yield pytest.param(kind, N, dh, w, causal, 4, id=name)
            yield pytest.param(kind, N, dh, w, causal, 2, id=f"{name}-bf16")


def _plans(p, dh, w, causal, elem=4):
    """(plan, rotary) pairs: the defaults at 1, 32 and 128 (batch row, head)
    pairs (for the bf16 form with and without a keep mask) and the card
    tests' plans, with and without rotary."""
    out = []
    for rotary in (False, True):
        out += [(FA.attention_plan(p["Np"], p["C"], p["P"], w, causal, dh, bh, rotary,
                                   elem=elem, keep=keep), rotary)
                for bh in (1, 32, 128) for keep in ((False, True) if elem == 2 else (False,))]
        for slab, mma, cap in PLANS:
            if slab > -(-p["C"] // 16) * 16:
                continue
            try:
                out.append((FA.attention_plan(p["Np"], p["C"], p["P"], w, causal, dh,
                                              rotary=rotary, slab=slab, cap=cap, mma=mma,
                                              elem=elem), rotary))
            except ValueError as e:  # a cap that does not fit beside this slab
                assert "fit" in str(e)
    return out


def _layout_bytes(plan, dh, rotary):
    """The end of the kernel's shared-memory layout (windowed_attention's
    pointers), each region starting 16-byte aligned: float32 Q, K, V and
    with rotary the cos/sin rows, rows of dh + 4 floats; bf16 Q, K, V rows of
    dh + 8 values, then float32 rotated Q and K."""
    if plan.elem == 4:
        regions = [(plan.slab, 4 * (dh + 4)), (plan.cap, 4 * (dh + 4)), (plan.cap, 4 * (dh + 4))]
        if rotary:
            regions += [(plan.slab, 4 * (dh + 4)), (plan.cap, 4 * (dh + 4))]
    else:
        regions = [(plan.slab, 2 * (dh + 8)), (plan.cap, 2 * (dh + 8)), (plan.cap, 2 * (dh + 8)),
                   (plan.slab, 4 * (dh + 4)), (plan.cap, 4 * (dh + 4))]
    end = 0
    for rows, row_bytes in regions:
        assert end % 16 == 0 and row_bytes % 16 == 0
        end += rows * row_bytes
    return end


def _allowed(p, w, causal):
    """(Np, Np) bool: key row j may be seen by query row i (exact off: the
    widest window)."""
    idx, invalid = FA.chunk_index_sets(p)
    C, Np = p["C"], p["Np"]
    ok = np.zeros((Np, Np), bool)
    for c in range(p["nc"]):
        rows = np.arange(c * C, (c + 1) * C)
        bad = FA.window_mask(rows[:, None], idx[c][None, :], w, 1, 0 if causal else 1, causal,
                             False, invalid[c])
        for r, i in enumerate(rows):
            ok[i, idx[c][~bad[r]]] = True
    return ok


@pytest.mark.parametrize("kind,N,dh,w,causal,elem", list(_cases()))
def test_plan_fits_and_covers_the_chunk_semantics(kind, N, dh, w, causal, elem):
    p = _chunking(kind, N, w, causal)
    Np, C, P = p["Np"], p["C"], p["P"]
    allowed = _allowed(p, w, causal)
    for plan, rotary in _plans(p, dh, w, causal, elem):
        assert plan.smem_bytes + 16 <= SMEM and plan.elem == elem
        assert plan.smem_bytes == _layout_bytes(plan, dh, rotary)
        if elem == 4:
            rows = plan.slab + 2 * plan.cap + (plan.slab + plan.cap if rotary else 0)
            assert plan.smem_bytes == 4 * rows * (dh + 4)
        slabs = FA.slab_rows(Np, C, plan.slab)
        assert len(slabs) == plan.blocks
        seen = np.zeros(Np, int)
        for s0, s1 in slabs:
            assert s0 // C == (s1 - 1) // C and s1 - s0 <= plan.slab  # within one chunk
            seen[s0:s1] += 1
            lo, hi = FA.key_band(s0, s1, w, causal, C, P, Np)
            assert hi - lo <= plan.band
            staged = np.zeros(Np, bool)
            for seg_lo in range(lo, hi, plan.cap):  # the block's staging rounds
                staged[seg_lo:min(seg_lo + plan.cap, hi)] = True
            assert -(-(hi - lo) // plan.cap) <= plan.segments
            assert staged[allowed[s0:s1].any(axis=0)].all()
            rpw = FA.rows_per_warp(plan.mma)
            for q0 in range(s0, s1, rpw):  # each warp walks its own band
                q1 = min(q0 + rpw, s1)
                wlo, whi = FA.key_band(q0, q1, w, causal, C, P, Np)
                assert lo <= wlo and whi <= hi
                need = np.flatnonzero(allowed[q0:q1].any(axis=0))
                assert ((need >= wlo) & (need < whi)).all()
        assert (seen == 1).all()


def test_default_plans_at_the_served_shapes():
    """At the requests' shapes (8 heads of 64, w 16): the tensor cores in
    128-row slabs where that leaves 128 blocks, else the CUDA cores in
    32-row slabs; one staging round per block. dh 128 with w 128 needs
    segments even at the smallest slab."""
    for B, N, mma, slab in ((16, 128, True, 128), (4, 1024, True, 128), (4, 120, False, 32)):
        p = FA.plan(N, 16, False)
        plan = FA.attention_plan(p["Np"], p["C"], p["P"], 16, False, 64, B * 8)
        assert (plan.mma, plan.slab) == (mma, slab)
        assert plan.blocks * B * 8 >= FA.MIN_BLOCKS
        assert plan.segments == 1 and plan.cap == plan.band
    big = FA.attention_plan(256, 128, 128, 128, False, 128)
    assert big.slab == FA.rows_per_warp(big.mma) and big.segments > 1
    assert FA.attention_plan(256, 128, 128, 128, False, 128) is big  # cached


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiple of 16"):
        FA.attention_plan(128, 128, 0, 16, False, 64, slab=24, mma=True)
    with pytest.raises(ValueError, match="up to 64"):
        FA.attention_plan(256, 256, 0, 16, False, 64, slab=128, mma=False)
    with pytest.raises(ValueError, match="fit"):
        FA.attention_plan(256, 128, 128, 128, False, 128, slab=128, mma=True, cap=256)


def test_sweep_probe_finds_the_kernel_phases():
    """The sweep's probe build stamps every phase boundary of the kernel's
    source once (a source edit that moves a boundary fails here, not on the
    card)."""
    text = SW.probe_source(_build.CSRC / "local_attention.cu", SW.CURRENT_ANCHORS)
    assert [text.count(f"STAMP({k});") for k in range(SW.N_STAMPS)] == [1] * SW.N_STAMPS
    assert 'extern "C" int la_probe_read' in text


def test_bf16_plan_takes_the_most_rows_that_fit():
    """The bf16 form's cap is the most key rows its layout holds beside the
    slab: one more does not fit (so the rule never refuses what would fit,
    and never plans what the launch check refuses)."""
    for dh in FA.HEAD_DIMS:
        for slab in (16, 64, 128):
            for rotary in (False, True):
                fits = FA._fits(dh, slab, rotary, 2)
                assert FA.smem_bytes(dh, slab, fits, rotary, 2) <= FA.SMEM_LIMIT
                assert FA.smem_bytes(dh, slab, fits + 1, rotary, 2) > FA.SMEM_LIMIT
                kw = dict(rotary=rotary, slab=slab, mma=True, elem=2)
                assert FA.attention_plan(4096, 4096, 0, 128, False, dh, cap=fits, **kw).cap == fits
                with pytest.raises(ValueError, match="fit"):
                    FA.attention_plan(4096, 4096, 0, 128, False, dh, cap=fits + 1, **kw)
    with pytest.raises(ValueError, match="elem"):
        FA.attention_plan(128, 128, 0, 16, False, 64, elem=8)


def test_bf16_default_plans_at_the_served_shapes():
    """The bf16 rule at the requests' shapes (8 heads of 64, w 16; B3, its
    keep mask at la_train's B 64 x N 96, K3's rank slabs and B4): where the
    tensor cores get 256 blocks from slabs of 64 rows, those (at B 16 x H 128
    two slabs a sequence, two blocks an SM, each small enough that two fit
    an SM's shared memory; with the keep mask slabs of 32 rows), else the
    CUDA cores in slabs of 32 rows; one staging round a block. The float32
    defaults stay as test_default_plans_at_the_served_shapes pins them."""
    sm_bytes = 233472  # an H100 SM's shared memory for blocks (228 KB)
    for B, N, keep, mma, slab in ((16, 128, False, True, 64), (4, 1024, False, True, 64),
                                  (4, 120, False, False, 32), (64, 96, True, True, 32),
                                  (64, 96, False, True, 64)):
        p = FA.plan(N, 16, False)
        plan = FA.attention_plan(p["Np"], p["C"], p["P"], 16, False, 64, B * 8, elem=2,
                                 keep=keep)
        assert (plan.mma, plan.slab, plan.elem) == (mma, slab, 2)
        assert plan.blocks * B * 8 >= (FA.BF16_MIN_BLOCKS if mma else FA.MIN_BLOCKS)
        assert plan.segments == 1 and plan.cap == plan.band
    served = FA.attention_plan(128, 128, 0, 16, False, 64, 128, elem=2)
    assert served.blocks * 128 == 256 and 2 * (served.smem_bytes + 1024) <= sm_bytes
    for q0, Nh in ((0, 528), (16, 544)):  # K3: B 4, 512 own rows a rank
        k3 = FA.halo_plan(4, 8, 64, 16, q0, 512, Nh, False, True, elem=2)
        assert (k3.mma, k3.slab, k3.segments, k3.elem) == (True, 64, 1, 2)
    b4 = FA.attention_plan(128, 128, 128, 16, False, 64, 128, elem=2)
    assert (b4.mma, b4.slab, b4.blocks) == (True, 64, 2)
    assert FA.attention_plan(128, 128, 0, 16, False, 64, 128, elem=2) is served  # cached


@pytest.mark.parametrize("rounding", ["rna", "truncate"])
def test_widened_bf16_has_a_zero_tf32_low_half(rounding):
    """Every finite bf16 value widened to float32 (a 16-bit shift) is its own
    TF32 high half under cvt.rna.tf32.f32 (round to nearest, ties away: the
    magnitude plus half of the 13 dropped bits, then cut) and under
    truncation, so its low half x - hi is zero: the ground on which the bf16
    form's P V takes two TF32 products (P_lo V, P_hi V) where the float32
    form takes three."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    bits = bits[(bits & 0x7F80) != 0x7F80]  # finite: exponent not all ones
    u = bits << 16
    x = u.view(np.float32)
    hi = ((u + 0x1000) if rounding == "rna" else u) & np.uint32(0xFFFFE000)
    assert len(x) == 65536 - 256 and np.isfinite(x).all()  # 2 signs x 128 NaN / inf patterns
    assert np.array_equal(hi, u)
    lo = x - hi.view(np.float32)
    assert (lo == 0).all()
    lo_bits = lo.view(np.uint32)
    lo_hi = ((lo_bits + 0x1000) if rounding == "rna" else lo_bits) & np.uint32(0xFFFFE000)
    assert (lo_hi.view(np.float32) == 0).all()
