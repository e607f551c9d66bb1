"""The port's fused Conv1d + GroupNorm + Mish against the JAX package's.

The plain PyTorch version is held against both the jnp reference and the
Pallas kernel run through the Pallas interpreter (the JAX package's own
CPU route for it); the autograd entry's gradients (its backward takes dW
from ``ops/conv_weight_grad.py``) against ``jax.grad``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.ops.pallas import conv_block_kernel as CK
from deepmimic_diffusion_mujoco_tpu_torch.ops import _build
from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_block_kernel as TK
from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_weight_grad as TW

torch.set_num_threads(2)

B, COUT, K, GROUPS = 2, 64, 5, 8
SHAPES = [(16, 35), (24, 35), (16, 64), (24, 64)]  # (H, Cin)


def _inputs(H, Cin, seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(B, H, Cin)).astype(np.float32),
        (rng.normal(size=(K, Cin, COUT)) * 0.1).astype(np.float32),
        rng.normal(size=(COUT,)).astype(np.float32),
        (rng.normal(size=(COUT,)) * 0.5 + 1).astype(np.float32),
        (rng.normal(size=(COUT,)) * 0.1).astype(np.float32),
    ]


def _plain(arrays):
    with torch.no_grad():
        return TK.conv_gn_mish_plain(*map(torch.from_numpy, arrays), GROUPS).numpy()


@pytest.mark.parametrize("H,Cin", SHAPES)
def test_plain_matches_jnp_reference(H, Cin):
    arrays = _inputs(H, Cin)
    ref = np.asarray(CK.conv_gn_mish_reference(*map(jnp.asarray, arrays), GROUPS))
    np.testing.assert_allclose(_plain(arrays), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("H,Cin", SHAPES)
def test_plain_matches_interpreted_pallas_kernel(H, Cin):
    arrays = _inputs(H, Cin, seed=1)
    old = CK.INTERPRET
    CK.INTERPRET = True
    try:
        ker = np.asarray(CK.conv_gn_mish(*map(jnp.asarray, arrays), GROUPS))
    finally:
        CK.INTERPRET = old
    np.testing.assert_allclose(_plain(arrays), ker, atol=1e-4, rtol=0)


@pytest.mark.parametrize("H,Cin", [(16, 35), (24, 64)])
def test_autograd_matches_jax_grad(H, Cin):
    arrays = _inputs(H, Cin, seed=2)
    cot = np.random.default_rng(3).normal(size=(B, H, COUT)).astype(np.float32)

    def jloss(*args):
        return jnp.sum(CK.conv_gn_mish(*args, GROUPS) * cot)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays))
    tensors = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = TK.conv_gn_mish(*tensors, GROUPS)
    (out * torch.from_numpy(cot)).sum().backward()
    for t, g in zip(tensors, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=2e-3, rtol=0)


def test_autograd_entry_uses_plain_version_on_cpu():
    arrays = _inputs(16, 35, seed=4)
    launches = TK.conv_gn_mish_cuda.launches
    with torch.no_grad():
        out = TK.conv_gn_mish(*map(torch.from_numpy, arrays), GROUPS).numpy()
    np.testing.assert_array_equal(out, _plain(arrays))
    assert TK.conv_gn_mish_cuda.launches == launches


def test_backward_counts_no_launch_on_cpu():
    """On CPU tensors the backward's dW comes from B2's plain version: no
    launch of either kernel is counted."""
    tensors = [torch.from_numpy(a).requires_grad_() for a in _inputs(16, 64, seed=5)]
    counts = TK.conv_gn_mish_cuda.launches, TW.conv1d_weight_grad_cuda.launches
    TK.conv_gn_mish(*tensors, GROUPS).square().sum().backward()
    assert all(t.grad is not None for t in tensors)
    assert (TK.conv_gn_mish_cuda.launches, TW.conv1d_weight_grad_cuda.launches) == counts


def test_cuda_wrapper_refuses_cpu_tensors():
    tensors = list(map(torch.from_numpy, _inputs(16, 35)))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        TK.conv_gn_mish_cuda(*tensors, GROUPS)


def test_kernel_build_failure_raises(tmp_path, monkeypatch):
    """A compiler that fails makes the build raise with its output; no
    library is left behind."""
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'conv_gn_mish.cu(1): error: broken'\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(fake.parent))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "ext")
    with pytest.raises(RuntimeError, match="(?s)nvcc exited 2.*error: broken"):
        _build.build("conv_gn_mish")
    assert not list((tmp_path / "ext").glob("*.so"))


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_warm_build_dir_without_logs(tmp_path, monkeypatch):
    """Libraries already in the build directory are used as they are, with
    no compiler and no log beside them (chip_smoke.py reports no ptxas
    lines for them instead of failing)."""
    import chip_smoke

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))  # no nvcc
    for name in chip_smoke.SOURCES:
        _build.library_path(name).write_bytes(b"")
    assert chip_smoke.build_all() == {name: None for name in chip_smoke.SOURCES}
