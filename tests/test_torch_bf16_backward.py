"""The backward of a bf16 model's kernels against the JAX package's, on the
CPU: B2's bf16 form (bf16 x and dy, float32 dW), B1's bf16 backward and B3's
bf16 form with the dropout keep mask and its gradient.

JAX's Pallas kernels run through the Pallas interpreter, as the JAX
package's own CPU tests run them; the port's plain versions stand for the
CUDA kernels (the card tests hold the kernels against them). Inputs are
numpy arrays from a seed, rounded to bf16 on the JAX side and handed to
both.

B1's oracle is the custom VJP JAX registers for ``conv_gn_mish``
(``_bwd``: the vjp of ``conv_gn_mish_reference``). The Pallas forward
returns bf16 while the reference returns float32, so ``jax.vjp`` of
``conv_gn_mish`` at bf16 refuses the bf16 cotangent (checked below); the
oracle is ``_bwd`` with that cotangent widened to float32, the one reading
under which it computes. Its types: the recomputed pre-norm value is the
bf16 conv output rounded before the float32 bias, the cotangent reaching
the conv is rounded to bf16, dx and dW come out bf16, db, dgamma and dbeta
float32. Measured at these shapes: dx and dW 99.6-100 % bit-equal to it
(at most 2.3e-3 of max |ref| apart: a flipped rounding), db, dgamma and
dbeta within 5.7e-7 of max |ref|; the float32 backward on the same values,
which rounds nowhere, parts from it by 1.5e-4 or more in the median of dx
and dW and 3.9e-4 or more in the largest of db, dgamma and dbeta.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.ops.pallas import conv_block_kernel as CK
from deepmimic_diffusion_mujoco_tpu.ops.pallas import conv_weight_grad as CW
from deepmimic_diffusion_mujoco_tpu.ops.pallas import fused_local_attention as JFK
from deepmimic_diffusion_mujoco_tpu_torch.models.temporal_unet import TemporalUnet, ValueFunction
from deepmimic_diffusion_mujoco_tpu_torch.models import temporal_unet as TU
from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_block_kernel as TK
from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_weight_grad as TW
from deepmimic_diffusion_mujoco_tpu_torch.ops import fused_local_attention as FK

torch.set_num_threads(2)

BF = torch.bfloat16
ULP = 2.0 ** -7      # one bf16 ulp of a value v is at most 2^-7 |v|
WGRAD_TOL = 1e-5     # B2: of max |dW|, float32 sums of the same exact products in another order
B1_BF16 = (ULP, 1e-5)  # dx, dW (bf16): (max, median) of |d| / max |ref|
B1_F32 = 1e-5        # db, dgamma, dbeta (float32): max |d| / max |ref|
B3_TOL = 1e-5        # B3's float32 CPU tolerance (tests/test_torch_local_attention.py)
B3_GRAD_TOL = 1e-4   # B3's float32 gradient tolerance, the same file
K, GROUPS = 5, 8
H100_SMS = 132


def _bf16(a: np.ndarray):
    """The bf16 values of a, as a JAX array and a torch tensor."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(BF)


def _rel(out: torch.Tensor, ref) -> np.ndarray:
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    return np.abs(out.detach().float().numpy() - ref) / np.abs(ref).max()


# ---------------------------------------------------------------------------
# B2's bf16 form


@pytest.mark.parametrize("B,H,cin,cout,k", [(3, 12, 35, 24, 5), (3, 20, 64, 32, 3),
                                            (4, 4, 128, 64, 5), (2, 16, 16, 48, 1)])
def test_b2_bf16_plain_matches_interpreted_kernel(B, H, cin, cout, k):
    """bf16 x and dy -> float32 dW: the sum of the exact products, as the
    Pallas kernel's ``preferred_element_type=float32`` takes it."""
    rng = np.random.default_rng(B * H + cin + k)
    xj, xt = _bf16(rng.normal(size=(B, H, cin)).astype(np.float32))
    dj, dt = _bf16(rng.normal(size=(B, H, cout)).astype(np.float32))
    old = CW.INTERPRET
    CW.INTERPRET = True
    try:
        ref = CW.conv1d_weight_grad(xj, dj, k, block_cin=cin, block_cout=cout)
    finally:
        CW.INTERPRET = old
    assert ref.dtype == jnp.float32
    launches = TW.conv1d_weight_grad_bf16_cuda.launches
    out = TW.conv1d_weight_grad(xt, dt, k)
    assert out.dtype == torch.float32 and out.shape == (k, cin, cout)
    assert TW.conv1d_weight_grad_bf16_cuda.launches == launches
    assert _rel(out, ref).max() <= WGRAD_TOL


def test_b2_bf16_wrapper_refuses_cpu_tensors():
    x, dy = torch.zeros(2, 8, 16, dtype=BF), torch.zeros(2, 8, 32, dtype=BF)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TW.conv1d_weight_grad_bf16_cuda(x, dy, 5)


def _block_shapes(model, B, H, D):
    """(B, H, Cin, Cout) of every conv block of one forward, on the meta
    device (no weights are made)."""
    seen, real = [], TU.conv_gn_mish

    def record(x, w, *args):
        seen.append((x.shape[0], x.shape[1], w.shape[1], w.shape[2]))
        return torch.empty(x.shape[0], x.shape[1], w.shape[2], dtype=x.dtype, device=x.device)

    TU.conv_gn_mish = record
    try:
        with torch.no_grad():
            model(torch.empty(B, H, D, device="meta"), torch.zeros(B, device="meta"))
    finally:
        TU.conv_gn_mish = real
    return sorted(set(seen))


def _training_shapes():
    """The dim-128 U-Net's training micro-step (B 32 x H 160) and the
    dim-32 ValueFunction's value step (B 16 x H 64), bf16."""
    with torch.device("meta"):
        unet = TemporalUnet(35, dim=128, dtype=BF)
        value = ValueFunction(35, 64, dim=32, dtype=BF)
    return _block_shapes(unet, 32, 160, 35) + _block_shapes(value, 16, 64, 35)


def test_training_shapes_have_bf16_plans():
    """Every conv block shape of a bf16 training micro-step and value step
    has B1's bf16 plan and B2's bf16 plan (k-steps of 16 rows, a 2-byte
    ring the kernel's layout mirrors) within 227 KB of shared memory."""
    shapes = _training_shapes()
    assert len(shapes) == 14 + 12
    for B, H, cin, cout in shapes:
        b1 = TK.bf16_plan(B, H, cin, cout, K, GROUPS)
        assert b1.smem_bytes == TK.bf16_smem_bytes(H, cout // GROUPS, K, b1.rows, b1.cluster,
                                                   b1.split, b1.stages, b1.mma, b1.wgs)
        assert b1.smem_bytes + TK.BF16_STATIC_SMEM <= TK.MAX_SMEM
        plan = TW.wgrad_plan(B, H, cin, cout, K, H100_SMS, bf16=True)
        assert plan.path == TW.BF16_PATH and plan.esize == 2
        assert plan.rows % TW.BF16_STEP == 0 and plan.rows <= TW.MAX_ROWS
        assert plan.smem_bytes == TW.smem_bytes(plan.tci, plan.tco, plan.rows, plan.stages,
                                                plan.cluster, plan.slices, K, esize=2)
        assert plan.smem_bytes + TW.STATIC_SMEM <= TW.MAX_SMEM
        # each slice keeps a k-step of a chunk, each rank a k-step of the rows
        assert TW.BF16_STEP * plan.slices <= plan.rows
        assert TW.BF16_STEP * plan.cluster <= B * H


def test_bf16_plans_stage_two_byte_elements_in_16_row_steps():
    """The bf16 ring takes half the bytes of the float32 one at the same
    plan, and a chunk's rows are a multiple of the bf16 k-step (16)."""
    f32 = TW.make_wgrad_plan(32, 160, 128, 128, K, H100_SMS, tci=64, tco=64, rows=64,
                             cluster=1, slices=1)
    b16 = TW.make_wgrad_plan(32, 160, 128, 128, K, H100_SMS, tci=64, tco=64, rows=64,
                             cluster=1, slices=1, bf16=True)
    assert b16.stages >= f32.stages and b16.smem_bytes < f32.smem_bytes
    with pytest.raises(ValueError, match="multiple of 16"):
        TW.make_wgrad_plan(4, 8, 16, 32, K, H100_SMS, rows=8, bf16=True)


# ---------------------------------------------------------------------------
# B1's bf16 backward


def _conv_inputs(B, H, cin, cout, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, cin)).astype(np.float32),
            (rng.normal(size=(K, cin, cout)) / np.sqrt(K * cin)).astype(np.float32),
            (0.1 * rng.normal(size=cout)).astype(np.float32),
            (1 + 0.1 * rng.normal(size=cout)).astype(np.float32),
            (0.1 * rng.normal(size=cout)).astype(np.float32),
            rng.normal(size=(B, H, cout)).astype(np.float32))


def _port_grads(x, w, affine, cot):
    leaves = [x.clone().requires_grad_(), w.clone().requires_grad_()] + [
        torch.from_numpy(a).requires_grad_() for a in affine]
    TK.conv_gn_mish(*leaves, GROUPS).backward(cot)
    return [t.grad for t in leaves]


@pytest.mark.parametrize("B,H,cin,cout", [(2, 16, 35, 64), (2, 8, 64, 64), (3, 4, 128, 256),
                                          (2, 24, 64, 128)])
def test_b1_bf16_backward_matches_jax_custom_vjp(B, H, cin, cout):
    """dx, dW (bf16) and db, dgamma, dbeta (float32) against JAX's ``_bwd``
    with the cotangent widened; the float32 backward on the same bf16
    values misses the bounds."""
    x, w, b, g, be, ct = _conv_inputs(B, H, cin, cout, H + cin)
    (xj, xt), (wj, wt), (cj, ctt) = _bf16(x), _bf16(w), _bf16(ct)
    ref = CK._bwd(GROUPS, 1e-5, (xj, wj, *map(jnp.asarray, (b, g, be))),
                  cj.astype(jnp.float32))
    assert [r.dtype for r in ref] == [jnp.bfloat16] * 2 + [jnp.float32] * 3
    ours = _port_grads(xt, wt, (b, g, be), ctt)
    assert [t.dtype for t in ours] == [BF, BF] + [torch.float32] * 3
    f32 = _port_grads(xt.float(), wt.float(), (b, g, be), ctt.float())
    for i, (o, o32, r) in enumerate(zip(ours, f32, ref)):
        d, d32 = _rel(o, r), _rel(o32, r)
        if i < 2:
            assert d.max() <= B1_BF16[0] and np.median(d) <= B1_BF16[1], (i, d.max())
            assert np.median(d32) > B1_BF16[1]
        else:
            assert d.max() <= B1_F32, (i, d.max())
            assert d32.max() > B1_F32


def test_jax_vjp_of_the_bf16_pallas_block_refuses_its_cotangent():
    """Why the oracle widens the cotangent: the Pallas forward returns bf16,
    its custom VJP's reference returns float32, and ``jax.vjp`` checks the
    cotangent's type against the reference's output."""
    x, w, b, g, be, ct = _conv_inputs(1, 8, 16, 16, 0)
    old = CK.INTERPRET
    CK.INTERPRET = True
    try:
        out, vjp = jax.vjp(lambda *a: CK.conv_gn_mish(*a, GROUPS), _bf16(x)[0], _bf16(w)[0],
                           *map(jnp.asarray, (b, g, be)))
        assert out.dtype == jnp.bfloat16
        with pytest.raises(ValueError, match="float32"):
            vjp(_bf16(ct)[0])
    finally:
        CK.INTERPRET = old


def test_b1_bf16_backward_takes_the_bf16_wgrad():
    """dW goes through ``conv1d_weight_grad`` on bf16 x and the bf16
    cotangent (B2's bf16 form on the card), rounded to w's dtype."""
    x, w, b, g, be, ct = _conv_inputs(2, 8, 16, 16, 1)
    calls, real = [], TK.conv1d_weight_grad

    def record(xx, dy, k):
        calls.append((xx.dtype, dy.dtype))
        return real(xx, dy, k)

    TK.conv1d_weight_grad = record
    try:
        grads = _port_grads(_bf16(x)[1], _bf16(w)[1], (b, g, be), _bf16(ct)[1])
    finally:
        TK.conv1d_weight_grad = real
    assert calls == [(BF, BF)] and grads[1].dtype == BF


# ---------------------------------------------------------------------------
# B3's bf16 form with the keep mask


H3, DH3 = 2, 16


def _b3_inputs(N, causal, masks, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(2, N, 3 * H3 * DH3)).astype(np.float32)
    km = None
    if "mask" in masks:
        km = (np.arange(N)[None, :] < np.array([N - 5, N // 3])[:, None]).astype(np.float32)
    p = FK.plan(N, 16, causal)
    keep = (rng.random((2, p["Np"], H3 * p["K"])) < 0.7).astype(np.float32)
    return qkv, km, keep, rng.normal(size=(2, N, H3 * DH3)).astype(np.float32)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(JFK, "INTERPRET", True)


def _jax_b3(qkvj, km, keep, causal):
    return JFK.fused_qkv_local_attention(qkvj, H3, DH3, 16, causal, True, True,
                                         None if km is None else jnp.asarray(km),
                                         jnp.asarray(keep), 0.7)


def _port_b3(qkvt, km, keep, causal):
    return FK.fused_qkv_local_attention(qkvt, H3, DH3, 16, causal, True, True,
                                        None if km is None else torch.from_numpy(km),
                                        torch.from_numpy(keep), 0.7)


@pytest.mark.parametrize("N,causal,masks", [(32, False, "keep"), (40, True, "mask+keep"),
                                            (384, False, "keep"), (128, True, "mask+keep")])
def test_b3_bf16_keep_mask_forward_matches_interpreted_kernel(interpret, N, causal, masks):
    """The single, autopad and sliced plans, a bf16 qkv with the float32
    keep mask: within one bf16 ulp of the value plus B3's float32 tolerance."""
    qkv, km, keep, _ = _b3_inputs(N, causal, masks, N + causal)
    qkvj, qkvt = _bf16(qkv)
    ref = _jax_b3(qkvj, km, keep, causal)
    assert ref.dtype == jnp.bfloat16
    with torch.no_grad():
        out = _port_b3(qkvt, km, keep, causal)
    assert out.dtype == BF and FK.fused_qkv_local_attention_bf16_cuda.launches == 0
    d = _rel(out, ref) * np.abs(np.asarray(ref.astype(jnp.float32))).max()
    assert (d <= ULP * np.abs(np.asarray(ref.astype(jnp.float32))) + B3_TOL).all(), d.max()


@pytest.mark.parametrize("N,masks", [(32, "keep"), (40, "mask+keep"), (384, "keep")])
def test_b3_bf16_keep_mask_gradient_matches_jax(interpret, N, masks):
    """The gradient of a bf16 qkv through the keep mask: bf16, as JAX's vjp
    of its chunk transcription returns it; within one bf16 ulp plus B3's
    float32 gradient tolerance of max |ref|."""
    qkv, km, keep, cot = _b3_inputs(N, False, masks, N + 7)
    qkvj, qkvt = _bf16(qkv)
    cj, ct = _bf16(cot)
    _, vjp = jax.vjp(lambda q: _jax_b3(q, km, keep, False), qkvj)
    (ref,) = vjp(cj)
    assert ref.dtype == jnp.bfloat16
    x = qkvt.clone().requires_grad_()
    _port_b3(x, km, keep, False).backward(ct)
    assert x.grad.dtype == BF
    r = np.abs(np.asarray(ref.astype(jnp.float32)))
    d = _rel(x.grad, ref) * r.max()
    assert (d <= ULP * r + B3_GRAD_TOL * r.max()).all(), d.max()
