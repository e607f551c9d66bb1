"""B1, B3 and B4 in their bf16 forms, and the horizon-split forms of B1 (K1,
K2) and B3 (K3) at bf16, against the JAX package's kernels on the CPU.

A model built with ``bf16=True`` hands B1 bf16 x and w with float32 bias,
scale and shift, and B3 a bf16 qkv; both Pallas kernels compute in float32
and store bf16. The port's plain versions (the CPU path and the oracle of
the CUDA kernels) are held against the Pallas kernels run through the
Pallas interpreter, each within one bf16 ulp of the value plus the
float32 form's own tolerance: |d| <= 2^-7 |ref| + tol elementwise, tol the
float32 tests' bound for sums taken in another order (1e-4 for B1,
tests/test_torch_conv_block.py; 1e-5 for B3, tests/test_torch_local_attention.py).
Where a value is small beside the terms summed into it (2.9e-06 out of
terms of order 1 in B3's sliced plan), that order moves its float32 value by
more than its own bf16 ulp, and the two roundings land up to 3 ulps apart
(measured); everywhere else they are equal or adjacent bf16 values.
(Their gradients, B3's keep mask and training at bf16:
tests/test_torch_bf16_backward.py and test_torch_bf16_train.py.)

B4 follows its inputs' dtype: it scales q in bf16 (`q_ref * scale`, the
scale a bf16 constant) before its float32 rotary. Its reference is compiled
with ``xla_allow_excess_precision`` off, so that XLA keeps every bf16
rounding the kernel's source writes (the order as written, the rule of
``models/precision.py``). With XLA's default the CPU keeps q * scale
unrounded where it meets cos and rounded in the rotated half (measured at
dh 32: 1,392 of 16,384 values of the port beyond the bound, none with the
option off). At dh 32 and 128, where the scale is no power of two, q
widened before the scale lands beyond the bound (1,567 to 7,390 values).

K1, K2 and K3 at bf16 run through their plain versions on each of R slices
of the horizon (R 1 through ``conv_gn_mish_sharded`` itself), against the
unsharded bf16 plain forms and the interpreted Pallas kernels on the whole
horizon, to the same one-ulp bound.
Inputs are numpy arrays from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepmimic_diffusion_mujoco_tpu.ops.pallas import conv_block_kernel as CK
from deepmimic_diffusion_mujoco_tpu.ops.pallas import fused_local_attention as JFK
from deepmimic_diffusion_mujoco_tpu.ops.pallas import local_attention_kernel as JLK
from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_block_kernel as TK
from deepmimic_diffusion_mujoco_tpu_torch.ops import fused_local_attention as FK
from deepmimic_diffusion_mujoco_tpu_torch.ops import local_attention_kernel as LH

torch.set_num_threads(2)

ULP = 2.0 ** -7  # one bf16 ulp of a value v is at most 2^-7 |v|
B1_TOL, B3_TOL = 1e-4, 1e-5  # the float32 forms' CPU tolerances (absolute)
BF = torch.bfloat16
K, GROUPS = 5, 8


def _bf16(a: np.ndarray):
    """The bf16 values of a, as a JAX array and a torch tensor."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(BF)


def _within_one_ulp(out: torch.Tensor, ref, tol: float):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    d = np.abs(out.float().numpy() - ref)
    bound = ULP * np.abs(ref) + tol
    assert (d <= bound).all(), f"max |d| {d.max()}, {(d > bound).sum()} beyond"


def _conv_inputs(B, H, Cin, Cout, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, Cin)).astype(np.float32),
            (rng.normal(size=(K, Cin, Cout)) / np.sqrt(K * Cin)).astype(np.float32),
            (0.1 * rng.normal(size=Cout)).astype(np.float32),
            (1 + 0.1 * rng.normal(size=Cout)).astype(np.float32),
            (0.1 * rng.normal(size=Cout)).astype(np.float32))


@pytest.mark.parametrize("B,H,Cin,Cout", [(2, 16, 35, 64), (2, 8, 64, 64), (2, 24, 64, 128),
                                          (3, 4, 128, 256)])
def test_b1_bf16_plain_matches_interpreted_kernel(B, H, Cin, Cout):
    """The bf16 first block (35 channels: a reduction depth no multiple of
    16), a deep level (H 4 and 8), a wide group."""
    x, w, b, g, be = _conv_inputs(B, H, Cin, Cout, H + Cin)
    xj, xt = _bf16(x)
    wj, wt = _bf16(w)
    old = CK.INTERPRET
    CK.INTERPRET = True
    try:
        ref = CK.conv_gn_mish(xj, wj, jnp.asarray(b), jnp.asarray(g), jnp.asarray(be), GROUPS)
    finally:
        CK.INTERPRET = old
    assert ref.dtype == jnp.bfloat16
    with torch.no_grad():
        out = TK.conv_gn_mish(xt, wt, *map(torch.from_numpy, (b, g, be)), GROUPS)
    assert out.dtype == BF and TK.conv_gn_mish_bf16_cuda.launches == 0
    _within_one_ulp(out, ref, B1_TOL)


def test_b1_bf16_against_the_jnp_reference():
    """JAX's default U-Net path (``use_pallas=False``) rounds the conv output
    to bf16 before GroupNorm and returns float32: it parts from the Pallas
    form by about one bf16 rounding of the normalised value, within 1e-2 of
    max |ref| (measured 3.5e-3 to 4.7e-3 at these shapes)."""
    x, w, b, g, be = _conv_inputs(2, 16, 35, 64, 7)
    xj, xt = _bf16(x)
    wj, wt = _bf16(w)
    ref = np.asarray(CK.conv_gn_mish_reference(xj, wj, jnp.asarray(b), jnp.asarray(g),
                                               jnp.asarray(be), GROUPS))
    assert ref.dtype == np.float32
    out = TK.conv_gn_mish_plain(xt, wt, *map(torch.from_numpy, (b, g, be)), GROUPS)
    assert np.abs(out.float().numpy() - ref).max() <= 1e-2 * np.abs(ref).max()


H3, DH3 = 2, 16


@pytest.mark.parametrize("N,causal", [(32, False), (40, True), (384, False), (128, True)])
def test_b3_bf16_plain_matches_interpreted_kernel(N, causal):
    """The single plan, the autopad plan and the sliced plan, with a bf16 qkv."""
    rng = np.random.default_rng(N)
    qkvj, qkvt = _bf16(rng.normal(size=(2, N, 3 * H3 * DH3)).astype(np.float32))
    old = JFK.INTERPRET
    JFK.INTERPRET = True
    try:
        ref = JFK.fused_qkv_local_attention(qkvj, H3, DH3, 16, causal, True, True)
    finally:
        JFK.INTERPRET = old
    assert ref.dtype == jnp.bfloat16
    with torch.no_grad():
        out = FK.fused_qkv_local_attention(qkvt, H3, DH3, 16, causal, True, True)
    assert out.dtype == BF
    _within_one_ulp(out, ref, B3_TOL)


def test_b3_bf16_plain_is_the_float32_function_rounded_once():
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.normal(size=(2, 48, 3 * H3 * DH3)).astype(np.float32)).to(BF)
    out = FK.fused_qkv_local_attention_plain(qkv, H3, DH3, 16)
    ref = FK.fused_qkv_local_attention_plain(qkv.float(), H3, DH3, 16)
    assert torch.equal(out, ref.to(BF))


@pytest.mark.parametrize("H,Cin,Cout,ck", [(64, 35, 128, 16), (8, 1024, 1024, 64),
                                           (8, 2048, 512, 64), (4, 256, 256, 64),
                                           (64, 96, 128, 32), (1024, 35, 128, 16)])
def test_b1_bf16_plan_fits_shared_memory(H, Cin, Cout, ck):
    """The chunk that pads Cin least (the larger on a tie); the deepest ring
    that fits 227 KB with the kernel's static bytes. The dim-128 U-Net's
    shapes and a H 1024 first block all have a plan."""
    c, st = TK.bf16_plan(H, Cin, Cout, K, GROUPS)
    assert c == ck and 2 <= st <= TK.BF16_MAX_STAGES
    cg = Cout // GROUPS

    def fits(s):
        return TK.bf16_smem_bytes(H, cg, K, ck, s) + TK.BF16_STATIC_SMEM <= TK.MAX_SMEM

    assert fits(st) and not any(fits(s) for s in range(st + 1, TK.BF16_MAX_STAGES + 1))


def test_b1_bf16_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="no plan fits"):
        TK.bf16_plan(8192, 35, 2048, K, GROUPS)


def _interpreted(module, fn, *args, **compiler_options):
    """``fn(*args)`` with ``module``'s Pallas kernel through the interpreter,
    compiled with ``compiler_options``."""
    old = module.INTERPRET
    module.INTERPRET = True
    try:
        lowered = jax.jit(fn).lower(*args)
    finally:
        module.INTERPRET = old
    return lowered.compile(compiler_options=compiler_options or None)(*args)


# -- B4 at bf16 ------------------------------------------------------------

N4, W4 = 256, 16


@pytest.mark.parametrize("rotary", [True, False])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_b4_bf16_plain_matches_interpreted_kernel(dh, causal, rotary):
    """B4's front door ``windowed_attention`` on bf16 q, k, v (its plain
    version on the CPU) against ``local_attention_tpu`` on the same bf16
    values; at dh 32 and 128, q widened before the scale falls outside."""
    rng = np.random.default_rng(dh + 2 * causal + rotary)
    (qj, qt), (kj, kt), (vj, vt) = (_bf16(rng.normal(size=(1, 2, N4, dh)).astype(np.float32))
                                    for _ in range(3))
    ref = _interpreted(JLK, lambda q, k, v: JLK.local_attention_tpu(q, k, v, W4, causal, True,
                                                                       rotary),
                       qj, kj, vj, xla_allow_excess_precision=False)
    assert ref.dtype == jnp.bfloat16
    with torch.no_grad():
        out = LH.windowed_attention(qt, kt, vt, W4, causal=causal, use_rotary=rotary)
    assert out.dtype == BF and LH.local_attention_heads_bf16_cuda.launches == 0
    _within_one_ulp(out, ref, B3_TOL)
    if dh in (32, 128):
        wide = LH.local_attention_heads_plain(qt.float(), kt.float(), vt.float(), W4, causal,
                                              True, rotary).to(BF)
        with pytest.raises(AssertionError, match="beyond"):
            _within_one_ulp(wide, ref, B3_TOL)


def test_b4_bf16_plain_scales_in_bf16():
    """At bf16 the plain version takes q * bf16(dh ** -0.5) rounded to bf16,
    then the float32 function with the scale 1."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 128, 32)).astype(np.float32)).to(BF)
               for _ in range(3))
    scaled = (q * torch.tensor(32 ** -0.5, dtype=BF)).float()
    x = [t.transpose(1, 2).float() for t in (scaled, k, v)]
    ref = FK.chunked_attention(*x, LH.plan(128), 16, False, True, True, scale=1.0)
    out = LH.local_attention_heads_plain(q, k, v, 16)
    assert torch.equal(out, ref.transpose(1, 2).to(BF))


# -- K1, K2 and K3 at bf16 over rank slices ------------------------------------

class _OneRank:
    """A horizon split over one rank: the group ``conv_gn_mish_sharded``
    gathers statistics from."""

    @staticmethod
    def all_gather(t):
        return t[None]


def _sharded_bf16_block(x, w, b, gamma, beta, ranks):
    """bf16 K1 on each of ``ranks`` slices with its zero-padded halo, the
    statistics merged, bf16 K2 on each; one rank through
    ``conv_gn_mish_sharded``."""
    pad = w.shape[0] // 2
    padded = F.pad(x, (0, 0, pad, pad))
    if ranks == 1:
        return TK.conv_gn_mish_sharded(padded, w, b, gamma, beta, GROUPS, 1e-5, _OneRank)
    n = x.shape[1] // ranks
    parts = [TK.conv_gn_stats_plain(padded[:, r * n:(r + 1) * n + 2 * pad], w, b, GROUPS)
             for r in range(ranks)]
    assert all(p.dtype == s.dtype == torch.float32 for p, s in parts)
    merged = TK.chan_merge(torch.stack([s for _, s in parts]), n * (w.shape[2] // GROUPS), 1e-5)
    return torch.cat([TK.gn_affine_mish_plain(p, merged, gamma, beta, GROUPS, BF)
                      for p, _ in parts], dim=1)


@pytest.mark.parametrize("ranks", [1, 2, 4])
@pytest.mark.parametrize("B,H,Cin,Cout", [(2, 32, 35, 64), (2, 16, 64, 128)])
def test_k1_k2_bf16_over_rank_slices(B, H, Cin, Cout, ranks):
    """The first block's 35 channels and a wider level, split over 1, 2 and
    4 slices: the unsharded bf16 plain form and JAX's interpreted bf16 conv
    block on the whole horizon, within one bf16 ulp plus B1_TOL."""
    x, w, b, g, be = _conv_inputs(B, H, Cin, Cout, 7 * ranks + H)
    xj, xt = _bf16(x)
    wj, wt = _bf16(w)
    b, g, be = map(torch.from_numpy, (b, g, be))
    with torch.no_grad():
        out = _sharded_bf16_block(xt, wt, b, g, be, ranks)
    assert out.dtype == BF and out.shape == (B, H, Cout)
    assert TK.conv_gn_stats_bf16_cuda.launches == TK.gn_affine_mish_bf16_cuda.launches == 0
    _within_one_ulp(out, TK.conv_gn_mish_plain(xt, wt, b, g, be, GROUPS).float().numpy(), B1_TOL)
    ref = _interpreted(CK, lambda x, w: CK.conv_gn_mish(x, w, jnp.asarray(b.numpy()),
                                                         jnp.asarray(g.numpy()),
                                                         jnp.asarray(be.numpy()), GROUPS),
                       xj, wj)
    _within_one_ulp(out, ref, B1_TOL)


def test_k2_bf16_plain_rounds_once():
    rng = np.random.default_rng(8)
    pre = torch.from_numpy(rng.normal(size=(2, 8, 16)).astype(np.float32))
    stats = torch.from_numpy(np.stack([rng.normal(size=(2, 8)),
                                       1 + rng.random(size=(2, 8))], -1).astype(np.float32))
    gamma, beta = torch.ones(16), torch.zeros(16)
    out = TK.gn_affine_mish_plain(pre, stats, gamma, beta, 8, BF)
    assert out.dtype == BF
    assert torch.equal(out, TK.gn_affine_mish_plain(pre, stats, gamma, beta, 8).to(BF))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("ranks", [2, 4])
def test_k3_bf16_over_rank_slabs(ranks, causal):
    """Each rank's slab (its rows with a window of each neighbour's) through
    ``local_attention_halo`` (K3's plain version at bf16), put together:
    the unsharded bf16 B3 plain form (B3's sliced plan at N 512) and JAX's
    interpreted B3 on the whole horizon, within one bf16 ulp plus B3_TOL."""
    N, w = 512, 16
    lf = 0 if causal else 1
    rng = np.random.default_rng(ranks + 3 * causal)
    qkvj, qkvt = _bf16(rng.normal(size=(2, N, 3 * H3 * DH3)).astype(np.float32))
    n = N // ranks
    outs = []
    with torch.no_grad():
        for r in range(ranks):
            q0 = w if r > 0 else 0
            end = (r + 1) * n + (lf * w if r < ranks - 1 else 0)
            slab = qkvt[:, r * n - q0:end]
            outs.append(FK.local_attention_halo(slab, H3, DH3, w, q0, n, r * n - q0, causal))
    out = torch.cat(outs, dim=1)
    assert out.dtype == BF and FK.local_attention_halo_bf16_cuda.launches == 0
    with torch.no_grad():
        _within_one_ulp(out, FK.fused_qkv_local_attention_plain(qkvt, H3, DH3, w, causal)
                        .float().numpy(), B3_TOL)
    ref = _interpreted(JFK, lambda qkv: JFK.fused_qkv_local_attention(qkv, H3, DH3, w, causal,
                                                                        True, True), qkvj)
    _within_one_ulp(out, ref, B3_TOL)
