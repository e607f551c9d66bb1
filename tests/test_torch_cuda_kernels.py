"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where no CUDA device is present. This file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_block_kernel as TK


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Cin,Cout,k", [
    (16, 64, 35, 128, 5), (16, 8, 1024, 1024, 5), (3, 21, 37, 24, 3),
    (2, 5, 8, 16, 1), (1, 200, 70, 2048, 9), (2, 100, 64, 512, 5), (4, 8, 2048, 512, 5),
])
def test_conv_gn_mish_kernel_matches_plain(cuda, B, H, Cin, Cout, k):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(B, H, Cin, generator=g, device=cuda)
    w = torch.randn(k, Cin, Cout, generator=g, device=cuda) * (k * Cin) ** -0.5
    b, beta = (torch.randn(Cout, generator=g, device=cuda) * 0.1 for _ in range(2))
    gamma = 1 + 0.1 * torch.randn(Cout, generator=g, device=cuda)
    launches = TK.conv_gn_mish_cuda.launches
    out = TK.conv_gn_mish_cuda(x, w, b, gamma, beta, 8)
    torch.cuda.synchronize()
    assert TK.conv_gn_mish_cuda.launches == launches + 1
    ref = TK.conv_gn_mish_plain(x, w, b, gamma, beta, 8)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_conv_gn_mish_kernel_takes_unaligned_weights(cuda):
    """Weights that do not start on 16 bytes go through the scalar copies."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 16, 35, generator=g, device=cuda)
    w = (torch.randn(5 * 35 * 128 + 1, generator=g, device=cuda) * 0.05)[1:].view(5, 35, 128)
    assert w.is_contiguous() and w.data_ptr() % 16
    b, gamma, beta = torch.zeros(128, device=cuda), torch.ones(128, device=cuda), torch.zeros(
        128, device=cuda)
    out = TK.conv_gn_mish_cuda(x, w, b, gamma, beta, 8)
    torch.testing.assert_close(out, TK.conv_gn_mish_plain(x, w, b, gamma, beta, 8),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_conv_gn_mish_kernel_refuses_bad_inputs(cuda):
    x = torch.randn(2, 8, 16, device=cuda)
    w = torch.randn(5, 16, 12, device=cuda)
    b = torch.zeros(12, device=cuda)
    with pytest.raises(ValueError, match="multiple of groups"):
        TK.conv_gn_mish_cuda(x, w, b, b + 1, b, 8)
    with pytest.raises(ValueError, match="float32"):
        TK.conv_gn_mish_cuda(x.double(), w, b, b + 1, b, 4)
    with pytest.raises(ValueError, match="kernel size"):
        TK.conv_gn_mish_cuda(x, torch.randn(4, 16, 12, device=cuda), b, b + 1, b, 4)
