"""K2 of the horizon split as one step: the ranks' statistics merge, the
normalise, affine and Mish, and the residual block's add.

- ``gn_merge_mish_plain`` (K2's plain version, the CPU path and the card
  kernel's oracle) equals ``chan_merge`` + ``gn_affine_mish_plain`` + the
  add to the bit, over R 1, 2 and 4 ranks' parts, for each addend (none,
  the time term's (B, C) row, the residual's (B, H, C)), float32 and bf16;
- ``conv_gn_mish_sharded`` with each addend, over 2 and 4 slices of the
  horizon, against the JAX package's ``conv_gn_mish_reference`` on the whole
  horizon plus the same add (float32), and against its interpreted Pallas
  kernel plus the bf16 add (bf16);
- ``ResidualTemporalBlock`` under a split hands the time term and the
  residual to its blocks' K2 and gives the unfused sequence's bits;
- the wrappers refuse a wrongly shaped addend or parts.

Inputs are numpy arrays from a seed. The card's side is in
tests/test_torch_seq_cuda_kernels.py and test_torch_bf16_seq_cuda_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepmimic_diffusion_mujoco_tpu.ops.pallas import conv_block_kernel as CK
from deepmimic_diffusion_mujoco_tpu_torch.models import precision as P
from deepmimic_diffusion_mujoco_tpu_torch.models.temporal_unet import (
    Conv1dBlock,
    ResidualTemporalBlock,
)
from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_block_kernel as CB

torch.set_num_threads(2)

BLOCK_TOL = 1e-4  # f32 sums in another order (tests/test_torch_seq_unet.py's sharded block)
ULP = 2.0 ** -7   # one bf16 ulp of a value v is at most 2^-7 |v|
BF = torch.bfloat16
GROUPS = 8
KINDS = ["none", "row", "full"]


def _addend(kind, B, H, C, dtype, seed):
    """None, a (B, C) row or a (B, H, C) tensor of ``dtype``."""
    if kind == "none":
        return None
    shape = (B, C) if kind == "row" else (B, H, C)
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(a).to(dtype)


def _added(out, add):
    """``out + add`` as the residual block adds it, unfused."""
    if add is None:
        return out
    return out + (add[:, None, :] if add.dim() == 2 else add)


def _parts(R, B, groups, count, seed):
    """(R, B, groups, 2) per-rank (mean, M2), each M2 over ``count`` values."""
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=0.3, size=(R, B, groups))
    m2 = count * rng.uniform(0.5, 2.0, size=(R, B, groups))
    return torch.from_numpy(np.stack([means, m2], -1).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("R", [1, 2, 4])
def test_k2_plain_is_the_unfused_chain(R, kind, dtype):
    B, H, C = 2, 12, 32
    rng = np.random.default_rng(R + len(kind))
    pre = torch.from_numpy(rng.normal(size=(B, H, C)).astype(np.float32))
    gamma = torch.from_numpy((1 + 0.1 * rng.normal(size=C)).astype(np.float32))
    beta = torch.from_numpy((0.1 * rng.normal(size=C)).astype(np.float32))
    count = H * (C // GROUPS)
    parts = _parts(R, B, GROUPS, count, R)
    add = _addend(kind, B, H, C, dtype, R + 1)
    out = CB.gn_merge_mish_plain(pre, parts, count, 1e-5, gamma, beta, GROUPS, add=add,
                                 dtype=dtype)
    merged = CB.chan_merge(parts, count, 1e-5)
    want = _added(CB.gn_affine_mish_plain(pre, merged, gamma, beta, GROUPS, dtype), add)
    assert out.dtype == dtype and out.shape == (B, H, C)
    assert torch.equal(out, want)


class _Slices:
    """The seq group of R slices of the horizon, in one process:
    ``all_gather`` returns every slice's statistics, taken beforehand by
    K1's plain version, in slice order."""

    def __init__(self, stats):
        self.stats = torch.stack(stats)

    def all_gather(self, t):
        assert any(torch.equal(t, s) for s in self.stats)
        return self.stats


def _sharded(x, w, b, gamma, beta, add, ranks):
    """``conv_gn_mish_sharded`` on each of ``ranks`` slices (its zero-padded
    halo; its rows of a (B, H, C) addend), put back together."""
    pad = w.shape[0] // 2
    n = x.shape[1] // ranks
    padded = F.pad(x, (0, 0, pad, pad))
    slabs = [padded[:, r * n:(r + 1) * n + 2 * pad] for r in range(ranks)]
    group = _Slices([CB.conv_gn_stats_plain(s, w, b, GROUPS)[1] for s in slabs])
    outs = []
    with torch.no_grad():
        for r, slab in enumerate(slabs):
            a = add if add is None or add.dim() == 2 else add[:, r * n:(r + 1) * n]
            outs.append(CB.conv_gn_mish_sharded(slab, w, b, gamma, beta, GROUPS, 1e-5, group,
                                                add=a))
    return torch.cat(outs, dim=1)


def _conv_inputs(B, H, Cin, Cout, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, Cin)).astype(np.float32),
            (rng.normal(size=(k, Cin, Cout)) / np.sqrt(k * Cin)).astype(np.float32),
            (0.5 * rng.normal(size=Cout)).astype(np.float32),
            (1 + 0.05 * rng.normal(size=Cout)).astype(np.float32),
            (0.05 * rng.normal(size=Cout)).astype(np.float32))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("H,k,cin,cout", [(32, 5, 35, 32), (64, 3, 64, 48)])
def test_sharded_block_with_addend_matches_whole_horizon(H, k, cin, cout, ranks, kind):
    x, w, b, gamma, beta = _conv_inputs(3, H, cin, cout, k, H + ranks + len(kind))
    add = _addend(kind, 3, H, cout, torch.float32, ranks)
    out = _sharded(*map(torch.from_numpy, (x, w, b, gamma, beta)), add, ranks)
    ref = np.asarray(conv_gn_mish_reference(x, w, b, gamma, beta))
    if add is not None:
        ref = ref + (add.numpy()[:, None, :] if add.dim() == 2 else add.numpy())
    assert out.dtype == torch.float32 and CB.gn_affine_mish_cuda.launches == 0
    np.testing.assert_allclose(out.numpy(), ref, atol=BLOCK_TOL, rtol=0)


def conv_gn_mish_reference(x, w, b, gamma, beta):
    return CK.conv_gn_mish_reference(*map(jnp.asarray, (x, w, b, gamma, beta)), GROUPS)


def _bf16(a: np.ndarray):
    """The bf16 values of a, as a JAX array and a torch tensor."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(BF)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ranks", [2, 4])
def test_bf16_sharded_block_with_addend_matches_the_interpreted_kernel(ranks, kind):
    """bf16 over 2 and 4 slices: the Pallas kernel's bf16 block (through the
    interpreter) on the whole horizon, then the bf16 add in JAX, within one
    bf16 ulp of the value plus the float32 block's tolerance
    (tests/test_torch_bf16_kernels.py's test_k1_k2_bf16_over_rank_slices)."""
    B, H, Cin, Cout = 2, 32, 35, 64
    x, w, b, g, be = _conv_inputs(B, H, Cin, Cout, 5, 11 * ranks + len(kind))
    xj, xt = _bf16(x)
    wj, wt = _bf16(w)
    add = _addend(kind, B, H, Cout, BF, ranks + 5)
    out = _sharded(xt, wt, *map(torch.from_numpy, (b, g, be)), add, ranks)
    assert out.dtype == BF and out.shape == (B, H, Cout)
    assert CB.gn_affine_mish_bf16_cuda.launches == 0
    old = CK.INTERPRET
    CK.INTERPRET = True
    try:
        ref = jax.jit(lambda x, w: CK.conv_gn_mish(x, w, jnp.asarray(b), jnp.asarray(g),
                                                   jnp.asarray(be), GROUPS))(xj, wj)
    finally:
        CK.INTERPRET = old
    assert ref.dtype == jnp.bfloat16
    if add is not None:
        aj = jnp.asarray(add.float().numpy(), jnp.bfloat16)
        ref = ref + (aj[:, None, :] if add.dim() == 2 else aj)
    ref = np.asarray(ref.astype(jnp.float32))
    d = np.abs(out.float().numpy() - ref)
    bound = ULP * np.abs(ref) + BLOCK_TOL
    assert (d <= bound).all(), f"max |d| {d.max()}, {(d > bound).sum()} beyond"


class _OneRankSeq:
    """A horizon split over one rank: zero halos, its own statistics."""

    @staticmethod
    def exchange_halo(x, before, after):
        return x.new_zeros(x.shape[0], before, x.shape[2]), x.new_zeros(
            x.shape[0], after, x.shape[2]), (False, False)

    @staticmethod
    def all_gather(t):
        return t[None]


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("cin", [16, 24])
def test_residual_block_hands_its_adds_to_k2(cin, dtype):
    """Under a split the block's time term goes to blocks[0]'s K2 and its
    residual (identity at cin 24, a Dense at cin 16) to blocks[1]'s: the
    same bits as the blocks without an addend and the adds after them."""
    torch.manual_seed(cin)
    block = ResidualTemporalBlock(cin, 24, 32, dtype=dtype).eval()
    rng = np.random.default_rng(cin)
    x = torch.from_numpy(rng.normal(size=(2, 16, cin)).astype(np.float32)).to(dtype)
    t_emb = torch.from_numpy(rng.normal(size=(2, 32)).astype(np.float32)).to(dtype)
    seq = _OneRankSeq()
    with torch.inference_mode():
        out = block(x, t_emb, seq)
        t = P.linear(P.mish(t_emb), block.time_dense, dtype)
        h = block.blocks[1](block.blocks[0](x, seq) + t[:, None, :], seq)
        want = h + (x if cin == 24 else P.linear(x, block.residual, dtype))
    assert out.dtype == dtype and torch.equal(out, want)


def test_conv_block_takes_an_addend_under_a_split_only():
    block = Conv1dBlock(8, 16)
    with pytest.raises(ValueError, match="horizon split only"):
        block(torch.zeros(1, 8, 8), add=torch.zeros(1, 16))


K2_FUNCTIONS = {
    "plain": lambda *a, dtype, **kw: CB.gn_merge_mish_plain(*a, dtype=dtype, **kw),
    "cuda": lambda *a, dtype, **kw: CB.gn_affine_mish_cuda(*a, **kw),
    "bf16_cuda": lambda *a, dtype, **kw: CB.gn_affine_mish_bf16_cuda(*a, **kw),
}


@pytest.mark.parametrize("case,match", [
    ("parts_width", "parts"), ("parts_batch", "parts"), ("parts_rank_axis", "parts"),
    ("add_rows", "add"), ("add_broadcast_row", "add"), ("add_dtype", "add is"),
])
@pytest.mark.parametrize("fn", list(K2_FUNCTIONS))
def test_k2_refuses_wrong_parts_or_addend(fn, case, match):
    """Shapes are checked before the device, so the card's wrappers refuse
    them on the CPU as well."""
    B, H, C = 2, 6, 16
    dtype = BF if fn == "bf16_cuda" else torch.float32
    pre, gamma, beta = torch.zeros(B, H, C), torch.ones(C), torch.zeros(C)
    parts, add = torch.zeros(2, B, GROUPS, 2), torch.zeros(B, H, C, dtype=dtype)
    if case == "parts_width":
        parts = torch.zeros(2, B, GROUPS, 3)
    elif case == "parts_batch":
        parts = torch.zeros(2, B + 1, GROUPS, 2)
    elif case == "parts_rank_axis":
        parts = torch.zeros(B, GROUPS, 2)
    elif case == "add_rows":
        add = torch.zeros(B, H + 1, C, dtype=dtype)
    elif case == "add_broadcast_row":
        add = torch.zeros(1, C, dtype=dtype)
    else:
        add = add.to(torch.float32 if dtype == BF else BF)
    with pytest.raises(ValueError, match=match):
        K2_FUNCTIONS[fn](pre, parts, H * (C // GROUPS), 1e-5, gamma, beta, GROUPS, add=add,
                         dtype=dtype)


@pytest.mark.parametrize("fn", ["cuda", "bf16_cuda"])
def test_k2_wrappers_take_cuda_tensors_only(fn):
    """On CPU tensors of the right shapes the card's wrappers raise (the
    plain version is ``conv_gn_mish_sharded``'s CPU path)."""
    B, H, C = 2, 6, 16
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        K2_FUNCTIONS[fn](torch.zeros(B, H, C), torch.zeros(1, B, GROUPS, 2), H * 2, 1e-5,
                         torch.ones(C), torch.zeros(C), GROUPS, dtype=None)
