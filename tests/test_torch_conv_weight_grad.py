"""The port's conv weight gradient (B2) against the JAX package's.

``conv1d_weight_grad_plain`` is held against the XLA oracle
(``conv1d_weight_grad_xla``, the vjp of the conv with respect to its
kernel) and against the Pallas kernel run through the Pallas interpreter,
at 1e-5 (the JAX package's own tolerance for the kernel against XLA).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.ops.pallas import conv_weight_grad as CW
from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_weight_grad as TW

torch.set_num_threads(2)

B, COUT = 3, 24
TOL = 1e-5


def _inputs(H, cin, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, cin)).astype(np.float32),
            rng.normal(size=(B, H, COUT)).astype(np.float32))


def _plain(x, dy, k):
    return TW.conv1d_weight_grad_plain(torch.from_numpy(x), torch.from_numpy(dy), k).numpy()


@pytest.mark.parametrize("H", [12, 20])
@pytest.mark.parametrize("cin", [35, 64])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_plain_matches_xla_oracle(k, cin, H):
    x, dy = _inputs(H, cin, seed=k * 100 + cin + H)
    ref = np.asarray(CW.conv1d_weight_grad_xla(jnp.asarray(x), jnp.asarray(dy), k))
    out = _plain(x, dy, k)
    assert out.shape == (k, cin, COUT) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("H", [12, 20])
@pytest.mark.parametrize("cin", [35, 64])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_plain_matches_interpreted_pallas_kernel(k, cin, H):
    x, dy = _inputs(H, cin, seed=k * 100 + cin + H + 1)
    old = CW.INTERPRET
    CW.INTERPRET = True
    try:
        ker = np.asarray(CW.conv1d_weight_grad(jnp.asarray(x), jnp.asarray(dy), k,
                                               block_cin=cin, block_cout=COUT))
    finally:
        CW.INTERPRET = old
    np.testing.assert_allclose(_plain(x, dy, k), ker, rtol=TOL, atol=TOL)


def test_dispatch_uses_plain_version_on_cpu():
    x, dy = map(torch.from_numpy, _inputs(12, 35, seed=7))
    launches = TW.conv1d_weight_grad_cuda.launches
    np.testing.assert_array_equal(TW.conv1d_weight_grad(x, dy, 5).numpy(),
                                  TW.conv1d_weight_grad_plain(x, dy, 5).numpy())
    assert TW.conv1d_weight_grad_cuda.launches == launches


def test_cuda_wrapper_refuses_cpu_tensors():
    x, dy = map(torch.from_numpy, _inputs(12, 35, seed=8))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        TW.conv1d_weight_grad_cuda(x, dy, 5)


@pytest.mark.parametrize("B_,H,cin,cout,sms,expected", [
    (32, 160, 35, 128, 132, 64),     # 2 tiles: split up to 4 chunks per split
    (32, 160, 128, 128, 132, 64),    # 4 tiles: 66 splits would fill 2 blocks per SM
    (32, 20, 1024, 1024, 132, 1),    # 256 tiles already fill the card
    (32, 20, 512, 1024, 132, 2),
    (1, 12, 35, 24, 132, 1),         # fewer than 4 chunks: one split
])
def test_split_count(B_, H, cin, cout, sms, expected):
    assert TW.split_count(B_, H, cin, cout, sms) == expected
