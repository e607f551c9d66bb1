"""The port's MDM transformer against the JAX package's, with converted
weights: the forward for every ``conditioning`` mode with and without
classes (null label, out-of-range labels, a key mask with one all-masked
sample), dropout with the same keep masks on both sides, a parameter
gradient, the converter's refusal of unmapped paths and the flax-style
initialisation.

Inputs and parameters come from numpy seeds; the JAX side runs at "highest"
matmul precision (tests/conftest.py), the port on the CPU in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.models import transformer as JT
from deepmimic_diffusion_mujoco_tpu_torch.convert import transformer_from_flax
from deepmimic_diffusion_mujoco_tpu_torch.models import transformer as TM

torch.set_num_threads(2)

B, H, D = 4, 12, 8
SMALL = dict(latent_dim=32, n_heads=4, num_layers=2, dim_feedforward=64)
FWD_TOL = 2e-5       # f32 through 2 layers, sums in another order
# per parameter, relative to its largest gradient element, or to 1e-4 of the largest
# over all parameters where its own is ~0 (the key bias: softmax ignores it)
GRAD_TOL = 1e-4


def _draw(rng, path, shape):
    """Every parameter random (the adaLN modulations too, so that they
    matter): kernels N(0, 1/32), the position and class tables N(0, 1),
    norm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2)."""
    name = path[-1]
    if name == "kernel":
        a = rng.normal(size=shape) / np.sqrt(32)
    elif name in ("position_embed", "embedding"):
        a = rng.normal(size=shape)
    elif name == "scale":
        a = 1.0 + 0.1 * rng.normal(size=shape)
    else:
        a = 0.1 * rng.normal(size=shape)
    return a.astype(np.float32)


def make_pair(conditioning="adaln", num_classes=3, dropout=0.0, seed=0, **kw):
    """-> (flax module, random flax params, port model with the same weights)."""
    cfg = dict(SMALL, **kw)
    jm = JT.TransformerMotionModel(input_dim=D, dropout=dropout, max_sequence_length=16,
                                   num_classes=num_classes, conditioning=conditioning, **cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, H, D)),
                            jnp.zeros((1,)))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda p, s: _draw(rng, [k.key for k in p], s.shape), shapes)
    tm = TM.TransformerMotionModel(input_dim=D, dropout=dropout, max_sequence_length=16,
                                   num_classes=num_classes, conditioning=conditioning, **cfg)
    tm.load_state_dict(transformer_from_flax(jax.tree_util.tree_map(np.asarray, params)),
                       strict=True)
    return jm, params, tm.eval()


def _inputs(seed=1, num_classes=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, D)).astype(np.float32)
    t = np.array([0, 7, 311, 999], np.int32)
    # a real label, the null label, one above it and one below 0 (both clipped)
    y = np.array([1, num_classes, num_classes + 3, -2], np.int32)
    mask = np.ones((B, H), np.float32)
    mask[1, 9:] = 0.0
    mask[2, 3:] = 0.0
    mask[3] = 0.0  # every key masked: flax attends uniformly, no NaN
    return x, t, y, mask


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("num_classes", [0, 3])
@pytest.mark.parametrize("conditioning", ["add", "adaln", "both"])
def test_forward_matches_flax(conditioning, num_classes):
    jm, params, tm = make_pair(conditioning, num_classes)
    x, t, y, mask = _inputs(num_classes=num_classes)
    cases = [(None, None), (y, None), (y, mask), (None, mask)]
    with torch.no_grad():
        for yy, mm in cases:
            ref = jm.apply(params, jnp.asarray(x), jnp.asarray(t),
                           None if yy is None else jnp.asarray(yy),
                           None if mm is None else jnp.asarray(mm))
            out = tm(_t(x), _t(t), None if yy is None else _t(yy),
                     None if mm is None else _t(mm))
            assert torch.isfinite(out).all()
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=FWD_TOL, atol=FWD_TOL,
                                       err_msg=f"y={yy is not None} mask={mm is not None}")


def test_null_label_is_y_none_and_labels_are_clipped():
    _, _, tm = make_pair("both", 3)
    x, t, _, _ = _inputs()
    with torch.no_grad():
        null = tm(_t(x), _t(t), torch.full((B,), 3))
        np.testing.assert_array_equal(tm(_t(x), _t(t)).numpy(), null.numpy())
        np.testing.assert_array_equal(tm(_t(x), _t(t), torch.full((B,), 7)).numpy(), null.numpy())
        below = tm(_t(x), _t(t), torch.full((B,), -5))
        np.testing.assert_array_equal(below.numpy(), tm(_t(x), _t(t), torch.zeros(B)).numpy())


def test_all_masked_sample_attends_uniformly():
    """A sample whose keys are all masked gets flax's uniform attention: the
    same output as attending to every key with equal weight, not NaN."""
    _, _, tm = make_pair("add", 0, num_layers=1)
    x, t, _, mask = _inputs()
    attn = tm.layers[0].attn
    h = torch.randn(1, H, SMALL["latent_dim"], generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = attn(h, torch.zeros(1, H, dtype=torch.bool))
        v = attn.value(h).mean(dim=1, keepdim=True).expand(1, H, -1)
        np.testing.assert_allclose(out.numpy(), attn.out(v).numpy(), rtol=1e-5, atol=1e-6)
        assert torch.isfinite(tm(_t(x), _t(t), mask=_t(mask))).all()


@pytest.mark.parametrize("conditioning", ["add", "adaln"])
def test_dropout_matches_flax_with_the_same_keep_masks(monkeypatch, conditioning):
    """Training-mode dropout: flax's attention-weight mask (one (1, 1, N, N)
    mask broadcast over batch and heads) and its feed-forward mask, drawn
    here once and given to both sides in flax's draw order."""
    jm, params, tm = make_pair(conditioning, 3, dropout=0.3)
    x, t, y, _ = _inputs()
    rng = np.random.default_rng(5)
    masks = []

    def bernoulli(key, p=0.5, shape=None):
        masks.append(rng.random(shape) < p)
        return jnp.asarray(masks[-1])

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    ref = jm.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y),
                   deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
    assert [m.shape for m in masks] == [(1, 1, H, H), (B, H, 64)] * 2
    replay = iter(masks)

    def keep_mask(shape, keep_prob, generator, device, rows=True):
        m = next(replay)
        assert rows == (shape[0] != 1)  # the attention's mask is shared by the batch
        assert tuple(shape) == m.shape and keep_prob == pytest.approx(0.7)
        return torch.from_numpy(m)

    monkeypatch.setattr(TM, "keep_mask", keep_mask)
    tm.train()
    out = tm(_t(x), _t(t), _t(y), generator=torch.Generator())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=FWD_TOL,
                               atol=FWD_TOL)


def test_dropout_needs_a_generator():
    _, _, tm = make_pair("add", 0, dropout=0.1)
    x, t, _, _ = _inputs()
    with pytest.raises(ValueError, match="Generator"):
        tm.train()(_t(x), _t(t))
    g = torch.Generator().manual_seed(0)
    a = tm(_t(x), _t(t), generator=g)
    assert not torch.equal(a, tm.eval()(_t(x), _t(t)))


def test_gradient_matches_flax():
    """d/dparams of a masked squared output, every parameter."""
    jm, params, tm = make_pair("both", 3)
    x, t, y, mask = _inputs()

    def jloss(p):
        out = jm.apply(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y), jnp.asarray(mask))
        return (out ** 2 * jnp.asarray(mask)[..., None]).mean()

    ref = transformer_from_flax(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(jloss))(params)))
    out = tm(_t(x), _t(t), _t(y), _t(mask))
    (out ** 2 * _t(mask)[..., None]).mean().backward()
    grads = {k: p.grad for k, p in tm.named_parameters()}
    assert grads.keys() == ref.keys()
    floor = 1e-4 * max(g.abs().max() for g in ref.values())
    for k, g in ref.items():
        err = (grads[k] - g).abs().max() / g.abs().max().clamp_min(floor)
        assert err <= GRAD_TOL, (k, err.item())


def test_converter_refuses_unmapped_paths():
    _, params, _ = make_pair("adaln", 3)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tree["params"]["extra_head"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="extra_head"):
        transformer_from_flax(tree)


@pytest.mark.parametrize("conditioning", ["add", "adaln", "both"])
def test_initialisation_follows_flax(conditioning):
    """The same parameters and shapes as flax's init; adaLN-zero modulations
    and every bias zero; the position table N(0, 1), the class table
    N(0, 1/D), Dense kernels lecun-normal (std 1/sqrt(fan_in))."""
    jm = JT.TransformerMotionModel(input_dim=D, max_sequence_length=64, num_classes=3,
                                   conditioning=conditioning, **dict(SMALL, latent_dim=64))
    flax = transformer_from_flax(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, H, D)), jnp.zeros((1,)))))
    torch.manual_seed(0)
    tm = TM.TransformerMotionModel(input_dim=D, max_sequence_length=64, num_classes=3,
                                   conditioning=conditioning, **dict(SMALL, latent_dim=64))
    sd = tm.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape)
                                                         for k, v in flax.items()}
    for k, v in sd.items():
        if k.endswith(".bias") or "adaln_mod" in k or "final_mod" in k:
            assert (v == 0).all() == bool((flax[k] == 0).all()), k
            if "norm" not in k:
                assert (v == 0).all(), k
        elif "norm" in k:
            assert (v == 1).all(), k
        else:
            ours, theirs = v.std().item(), flax[k].std().item()
            assert abs(ours / theirs - 1) < 0.15, (k, ours, theirs)
    x, t, _, _ = _inputs()
    with torch.no_grad():
        assert torch.isfinite(tm.eval()(_t(x), _t(t))).all()
