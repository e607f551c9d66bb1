"""B1 and B3 in their bf16 forms against the JAX package's kernels, and what
bf16 refuses, on the CPU.

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
The entries that a horizon split or the KV cache would need raise at bf16,
naming their ROADMAP.md item (their gradients, B3's keep mask and training
at bf16: tests/test_torch_bf16_backward.py and test_torch_bf16_train.py).
Inputs are numpy arrays from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.ops.pallas import conv_block_kernel as CK
from deepmimic_diffusion_mujoco_tpu.ops.pallas import fused_local_attention as JFK
from deepmimic_diffusion_mujoco_tpu_torch.models.local_attention import LocalTransformer
from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_block_kernel as TK
from deepmimic_diffusion_mujoco_tpu_torch.ops import fused_local_attention as FK

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


def _conv_tensors():
    x, w, b, g, be = (torch.from_numpy(a) for a in _conv_inputs(1, 8, 16, 16, 0))
    return x.to(BF), w.to(BF), b, g, be


def _refuse(case):
    if case == "b1_sharded":
        TK.conv_gn_mish_sharded(*_conv_tensors(), GROUPS, 1e-5, None)
    elif case == "k3":
        qkv = torch.zeros(1, 32, 3 * H3 * DH3, dtype=BF)
        FK.local_attention_halo(qkv, H3, DH3, 16, 0, 16, 0)
    elif case == "kv_decode":
        model = LocalTransformer(8, 32, dim=32, depth=1, heads=2, dim_head=16, causal=True,
                                 dtype=BF).eval()
        with torch.no_grad():
            model(torch.zeros(1, 1, 8), torch.zeros(1), cache=model.init_decode_cache(1),
                  decode_pos=0)


REFUSALS = {"b1_sharded": "sharded kernels", "k3": "sharded kernels",
            "kv_decode": "KV-cache decode at bf16"}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_bf16_refusals_name_their_roadmap_item(case):
    """The sharded kernels (K1/K2, K3) and the KV-cache decode raise at
    bf16."""
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue A, .*{REFUSALS[case]}"):
        _refuse(case)
