"""The port's decoder denoiser (``models/transformer_decoder.py``) against
the JAX package's, with converted weights: the forward at horizons below
and at the query table's, the positional encoding, the strict converter,
and ``cli/train.py`` then ``cli/sample.py`` on the user config
``experiments/decoder10k`` cut to a tiny width."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.models import transformer_decoder as JDec
from deepmimic_diffusion_mujoco_tpu_torch import factory
from deepmimic_diffusion_mujoco_tpu_torch.cli import sample as sample_cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import train as train_cli
from deepmimic_diffusion_mujoco_tpu_torch.convert import decoder_from_flax
from deepmimic_diffusion_mujoco_tpu_torch.models import transformer_decoder as TDec
from deepmimic_diffusion_mujoco_tpu_torch.train.config import ExperimentConfig
from test_torch_local_transformer import random_flax_params

torch.set_num_threads(2)

D, HORIZON = 69, 24
SMALL = dict(dim=32, n_heads=2, num_layers=2)
FWD_TOL = 1e-5
ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIG = os.path.join(ROOT, "experiments", "decoder10k", "config.json")
TINY = ["model.latent_dim=32", "model.num_layers=2", "model.n_heads=2", "model.max_seq_len=24",
        "diffusion.noise_steps=8", "train.log_every=2", "train.save_every=2",
        "train.ema_start=2", "train.ema_every=2"]


def make_pair(seed=0):
    """-> (flax module, random flax params, jitted apply, port model)."""
    jm = JDec.TransformerDecoderMotionModel(horizon=HORIZON, transition_dim=D, **SMALL)
    params = random_flax_params(jm, (jnp.zeros((1, 8, D)), jnp.zeros((1,), jnp.int32)), seed)
    model = TDec.TransformerDecoderMotionModel(HORIZON, D, **SMALL)
    model.load_state_dict(decoder_from_flax(params), strict=True)
    return jm, params, jax.jit(jm.apply), model.eval()


def test_positional_encoding_matches():
    for length, dim in ((7, 32), (128, 256)):
        np.testing.assert_array_equal(TDec.fixed_positional_encoding(length, dim),
                                      JDec.fixed_positional_encoding(length, dim))


def test_converted_state_dict_loads_strict():
    _, params, _, model = make_pair()
    n_flax = sum(np.size(a) for a in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_flax
    tree = {**params["params"], "mystery": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(KeyError, match="mystery"):
        decoder_from_flax({"params": tree})


@pytest.mark.parametrize("L", [HORIZON, 17, 8])
def test_forward_matches_jax(L):
    """Below the query table's length the queries and the encoding are
    sliced to L; the causal self-attention mask is (L, L)."""
    _, params, apply, model = make_pair(seed=L)
    rng = np.random.default_rng(L)
    x = rng.normal(size=(3, L, D)).astype(np.float32)
    t = np.array([0, 411, 999], np.int32)
    ref = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert ours.shape == (3, L, D)
    np.testing.assert_allclose(ours, ref, atol=FWD_TOL, rtol=0)


def test_layers_pin_flax_eps_and_tanh_gelu():
    """flax's LayerNorm eps (1e-6) and tanh GELU, as the JAX layer has them."""
    _, _, _, model = make_pair()
    layer = model.layers[0]
    assert all(n.eps == 1e-6 for n in (layer.norm_0, layer.norm_1, layer.norm_2))
    assert layer.dense_0.out_features == 2 * SMALL["dim"]
    assert model.learned_time_embed.num_embeddings == 1000


def test_horizon_past_the_query_table_raises():
    _, _, _, model = make_pair()
    with pytest.raises(ValueError, match="max_seq_len"):
        model(torch.zeros(1, HORIZON + 1, D), torch.zeros(1, dtype=torch.long))


def test_factory_builds_the_config_decoder():
    cfg = ExperimentConfig.load(CONFIG)
    model = factory.build_model(cfg.model, device="cpu")
    assert isinstance(model, TDec.TransformerDecoderMotionModel)
    assert model.horizon == cfg.model.max_seq_len and len(model.layers) == cfg.model.num_layers
    assert model.seq_queries.shape == (cfg.model.max_seq_len, cfg.model.latent_dim)


def test_train_cli_trains_then_sample_cli_serves_the_decoder(tmp_path):
    """The angle + velocity loss through the CLI on the walk clip (cut to
    max_seq_len 24), then a request answered from the run."""
    trainer = train_cli.main(["--config", CONFIG, "--steps", "4", "--batch-size", "2",
                              "--out", str(tmp_path), "--device", "cpu", "--set", *TINY])
    assert isinstance(trainer.state.model, TDec.TransformerDecoderMotionModel)
    assert trainer.dataset.horizon == 24
    metrics = json.loads((tmp_path / "training_metrics.json").read_text())
    assert [r["step"] for r in metrics["metrics"]] == [2, 4]
    assert all(np.isfinite(r["loss"]) and {"loss_angle", "loss_velocity"} <= r.keys()
               for r in metrics["metrics"])
    names = sorted(p.name for p in (tmp_path / "checkpoints").glob("*.pt"))
    assert names == ["best_model.pt", "state_2.pt", "state_4.pt"]
    paths = sample_cli.main(["--run", str(tmp_path), "--num", "2", "--frames", "16",
                             "--conditioner", "holding_box", "--out", str(tmp_path / "s"),
                             "--device", "cpu"])
    assert len(paths) == 2
    for p in paths:
        m = np.load(p)
        assert m.shape == (16, 35) and np.isfinite(m).all()
        assert (m[:, [13, 14, 15, 17, 18, 19]] == 0).all()
        assert (m[:, [16, 20]] == np.float32(1.57)).all()
