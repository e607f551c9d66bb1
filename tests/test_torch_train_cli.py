"""The port's training CLI end to end on the CPU: a tiny run writes the
JAX package's run-directory contract, ``--resume`` continues it, and the
port's sampling CLI answers from it."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu_torch.cli import sample as sample_cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import train as train_cli
from deepmimic_diffusion_mujoco_tpu_torch.train.checkpoint import Checkpointer
from deepmimic_diffusion_mujoco_tpu_torch.train.config import ExperimentConfig

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIG = os.path.join(ROOT, "experiments", "unet_walk10k", "config.json")
CLIP = os.path.join(ROOT, "data", "motions", "humanoid3d_walk.txt")
TINY = ["model.channel_dim=16", "diffusion.noise_steps=8", "train.gradient_accumulate_every=2",
        "train.log_every=2", "train.save_every=2", "train.ema_start=2", "train.ema_every=2"]
# the record keys of deepmimic_diffusion_mujoco_tpu/train/loop.py Trainer._train_scanned: the
# user config's scan_chunk 50 logs one record per chunk (8 micro-steps: one ragged chunk)
RECORD_KEYS = {"step", "loss", "steps_per_s"}


def _train(out, *extra):
    return train_cli.main(["--config", CONFIG, "--data", CLIP, "--steps", "4",
                           "--batch-size", "2", "--out", str(out), "--device", "cpu",
                           "--set", *TINY, *extra])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("run")
    _train(out)
    return out


def test_run_directory_contract(run):
    cfg = ExperimentConfig.load(str(run / "config.json"))
    assert cfg.model.channel_dim == 16 and cfg.train.gradient_accumulate_every == 2
    metrics = json.loads((run / "training_metrics.json").read_text())
    assert metrics.keys() == {"metrics", "best_loss", "best_step"}
    assert cfg.train.scan_chunk == 50
    assert [r["step"] for r in metrics["metrics"]] == [4]
    for rec in metrics["metrics"]:
        assert rec.keys() == RECORD_KEYS and np.isfinite(rec["loss"])
    assert metrics["best_step"] >= 3  # the window opens at int(4 * 0.85)
    names = sorted(p.name for p in (run / "checkpoints").iterdir())
    # periodic saves every 2 optimizer steps are named by micro-step
    assert names == ["best_model.json", "best_model.pt", "state_4.json", "state_4.pt",
                     "state_8.json", "state_8.pt"]
    best = json.loads((run / "checkpoints" / "best_model.json").read_text())
    assert best["loss"] == best["best_loss"] == metrics["best_loss"]
    assert best["model"]["channel_dim"] == 16 and "git_rev" in best
    payload, meta = Checkpointer(str(run / "checkpoints")).restore()
    assert payload["step"] == meta["step"] == 8
    assert payload.keys() == {"step", "params", "ema_params", "opt_state"}
    assert payload["params"].keys() == payload["ema_params"].keys()


def test_resume_continues_the_run(run, tmp_path):
    resumed = tmp_path / "resumed"
    shutil.copytree(run, resumed)
    before, _ = Checkpointer(str(resumed / "checkpoints")).restore()
    trainer = train_cli.main(["--config", str(resumed / "config.json"), "--out", str(resumed),
                              "--resume", "--device", "cpu"])
    assert trainer.state.step == 16
    assert trainer.state.optimizer.state_dict()["state"][0]["step"].item() == 8
    assert [r["step"] for r in trainer.metrics] == [8]  # 8 micro-steps: one ragged chunk
    after, _ = Checkpointer(str(resumed / "checkpoints")).restore()
    assert after["step"] == 16
    assert any((after["params"][k] != v).any() for k, v in before["params"].items())


def test_sample_cli_answers_from_trained_run(run, tmp_path):
    paths = sample_cli.main(["--run", str(run), "--num", "2", "--frames", "16",
                             "--conditioner", "holding_box", "--out", str(tmp_path),
                             "--device", "cpu"])
    for p in paths:
        m = np.load(p)
        assert m.shape == (16, 35) and np.isfinite(m).all()
        assert (m[:, [13, 14, 15, 17, 18, 19]] == 0).all()
        assert (m[:, [16, 20]] == np.float32(1.57)).all()


DECODER = ["model.architecture=decoder", "model.latent_dim=32", "model.num_layers=1",
           "model.n_heads=2", "model.max_seq_len=16"]
LOCAL = ["model.architecture=local_attention", "model.latent_dim=32", "model.depth=1",
         "model.n_heads=2", "model.dim_head=16", "model.max_seq_len=16",
         "model.attn_dropout=0.3", "model.ff_dropout=0.3"]


@pytest.mark.parametrize("overrides,error,match", [
    (DECODER, None, "TransformerDecoderMotionModel"),
    (["train.timestep_sampler=loss_aware", "diffusion.loss=x0"], ValueError,
     "loss_aware requires diffusion.loss=v4"),
    (LOCAL, None, "LocalTransformer"),
])
def test_unported_training_paths_raise(tmp_path, overrides, error, match):
    """The options the trainer refuses raise; the decoder and the
    local-attention transformer, refused until they were ported, now train
    on this config (the data cut to max_seq_len) and write their
    checkpoints."""
    if error is not None:
        with pytest.raises(error, match=match):
            _train(tmp_path, *overrides)
        return
    trainer = _train(tmp_path, *overrides)
    assert type(trainer.state.model).__name__ == match and trainer.dataset.horizon == 16
    names = sorted(p.name for p in (tmp_path / "checkpoints").glob("*.pt"))
    assert names == ["best_model.pt", "state_4.pt", "state_8.pt"]
    metrics = json.loads((tmp_path / "training_metrics.json").read_text())
    assert len(metrics["metrics"]) == 1 and np.isfinite(metrics["best_loss"])
