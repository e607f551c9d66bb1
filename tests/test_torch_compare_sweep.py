"""The port's ``cli/compare.py`` and ``cli/sweep.py`` against the JAX
package's: compare's best-loss fallback, report keys, horizon clamp, CFG
and metrics (SiFID and inter-diversity against the JAX package's
``eval.metrics`` on the same saved samples, within ``METRIC_RTOL``); the
sweep's run and its three summary files, which equal the JAX CLI's for the
same results."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.cli import compare as JC
from deepmimic_diffusion_mujoco_tpu.cli import sweep as JSw
from deepmimic_diffusion_mujoco_tpu.eval import metrics as JM
from deepmimic_diffusion_mujoco_tpu.train.config import ExperimentConfig as JaxConfig
from deepmimic_diffusion_mujoco_tpu_torch.cli import compare as TC
from deepmimic_diffusion_mujoco_tpu_torch.cli import sweep as TSw
from deepmimic_diffusion_mujoco_tpu_torch.cli import train as train_cli
from deepmimic_diffusion_mujoco_tpu_torch.data.mocap import load_clip
from deepmimic_diffusion_mujoco_tpu_torch.models.transformer import TransformerMotionModel
from deepmimic_diffusion_mujoco_tpu_torch.train.config import ExperimentConfig

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "motions")
WALK = os.path.join(DATA, "humanoid3d_walk.txt")
# tests/test_cli.py's tiny transformer
TINY = ["model.latent_dim=32", "model.num_layers=1", "model.n_heads=2",
        "model.dim_feedforward=64", "model.max_seq_len=40", "model.num_classes=9",
        "diffusion.noise_steps=8", "train.log_every=5", "train.ema_start=5"]
# the keys of deepmimic_diffusion_mujoco_tpu/cli/compare.py's report entries
REPORT_KEYS = {"run", "architecture", "checkpoint_step", "best_loss", "motion_paths",
               "frames", "sifid", "inter_diversity"}
METRIC_RTOL = 1e-5   # f32 window statistics and one SVD square root, another library


def _train(out, *extra):
    train_cli.main(["--data", WALK, "--architecture", "transformer", "--steps", "10",
                    "--batch-size", "4", "--out", str(out), "--device", "cpu",
                    "--set", *TINY, *extra])
    return str(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 69-dim run of tests/test_cli.py, and a 35-dim one whose saved
    motions are the whole samples."""
    root = tmp_path_factory.mktemp("runs")
    return {69: _train(root / "run69"),
            35: _train(root / "run35", "model.input_dim=35", "data.include_velocity=false")}


@pytest.mark.parametrize("case", ["sidecar_best_loss", "sidecar_loss_only", "sidecar_null",
                                  "metrics_file", "no_meta_no_file"])
def test_best_loss_matches_jax(tmp_path, case):
    meta = {"sidecar_best_loss": {"best_loss": 0.25, "loss": 0.5, "step": 3},
            "sidecar_loss_only": {"loss": 0.5, "step": 3},
            "sidecar_null": {"best_loss": None, "loss": None, "step": 3},
            "metrics_file": None, "no_meta_no_file": {}}[case]
    if case in ("sidecar_null", "metrics_file"):
        (tmp_path / "training_metrics.json").write_text(json.dumps(
            {"metrics": [], "best_loss": 0.125, "best_step": 7}))
    ours = TC._best_loss(meta, str(tmp_path))
    assert ours == JC._best_loss(meta, str(tmp_path))
    assert ours == {"sidecar_best_loss": 0.25, "sidecar_loss_only": 0.5, "sidecar_null": 0.125,
                    "metrics_file": 0.125, "no_meta_no_file": None}[case]


def test_compare_cli_clamps_horizon_to_gt(runs, tmp_path):
    """tests/test_cli.py::test_compare_cli_clamps_horizon_to_gt on the port:
    the walk clip's 39 frames < max_seq_len 40, so the horizon is 39."""
    out = str(tmp_path / "cmp")
    TC.main(["--runs", runs[69], "--gt", WALK, "--num", "2", "--out", out, "--device", "cpu"])
    report = json.loads((tmp_path / "cmp" / "compare_report.json").read_text())
    entry = report["run69"]
    assert entry.keys() == REPORT_KEYS
    assert entry["frames"] == 39
    assert entry["architecture"] == "transformer" and entry["checkpoint_step"] > 0
    assert np.isfinite(entry["sifid"]) and np.isfinite(entry["inter_diversity"])
    assert entry["best_loss"] is not None
    assert np.load(entry["motion_paths"][0]).shape == (39, 35)


def test_compare_metrics_match_jax_on_the_saved_samples(runs, tmp_path):
    """Two runs in one report; each run's SiFID and inter-diversity equal
    the JAX package's metrics on the motions it saved (35 dims: the whole
    sample), and without --gt the horizon is max_seq_len."""
    report = TC.compare([runs[35], runs[69]], str(tmp_path / "a"), num=3, gt=WALK,
                        device="cpu")
    assert list(report) == ["run35", "run69"]
    entry = report["run35"]
    samples = np.stack([np.load(p) for p in entry["motion_paths"]])
    ref = load_clip(WALK).qpos[: samples.shape[1], :35].astype(np.float32)
    np.testing.assert_allclose(entry["sifid"], float(np.mean(JM.sifid(jnp.asarray(samples),
                                                                       jnp.asarray(ref)))),
                               rtol=METRIC_RTOL)
    np.testing.assert_allclose(entry["inter_diversity"],
                               float(JM.inter_diversity(jnp.asarray(samples))),
                               rtol=METRIC_RTOL)
    no_gt = TC.compare([runs[35]], str(tmp_path / "b"), num=1, frames=None, device="cpu")
    assert no_gt["run35"]["frames"] == 40 and "sifid" not in no_gt["run35"]


def test_compare_class_id_samples_with_cfg(runs, tmp_path, monkeypatch):
    """--class-id on a class-conditional run: every step one 2B forward
    with the class and the null label (num_classes)."""
    seen = []
    real = TransformerMotionModel.forward

    def counted(self, x, t, y=None, *a, **k):
        seen.append(None if y is None else y.tolist())
        return real(self, x, t, y, *a, **k)

    monkeypatch.setattr(TransformerMotionModel, "forward", counted)
    TC.main(["--runs", runs[69], "--num", "2", "--frames", "16", "--class-id", "4",
             "--out", str(tmp_path / "c"), "--device", "cpu"])
    cfg = ExperimentConfig.load(os.path.join(runs[69], "config.json"))
    assert len(seen) == cfg.diffusion.noise_steps - 1  # the v4 chain: t = T-1 .. 1
    assert all(y == [4, 4, 9, 9] for y in seen)


def test_sweep_cli(tmp_path):
    """tests/test_cli.py::test_sweep_cli on the port."""
    grid = tmp_path / "grid.json"
    grid.write_text(json.dumps({"train.lr": [1e-3, 1e-4]}))
    cfg = ExperimentConfig(name="tiny").override({
        "data.path": WALK, "model.latent_dim": 32, "model.num_layers": 1,
        "model.n_heads": 2, "model.dim_feedforward": 64,
        "model.max_seq_len": 40, "model.num_classes": 9,
        "diffusion.noise_steps": 8, "train.num_train_steps": 10,
        "train.batch_size": 4, "train.log_every": 5,
    })
    cfg.save(str(tmp_path / "base.json"))
    out = tmp_path / "sweep"
    TSw.main(["--config", str(tmp_path / "base.json"), "--grid", str(grid), "--out", str(out),
              "--device", "cpu"])
    summary = json.loads((out / "final_summary.json").read_text())
    assert len(summary["all"]) == 2
    assert summary["best"]["best_loss"] <= summary["all"][-1]["best_loss"]
    assert (out / "best_configs.txt").exists()
    for r in summary["all"]:
        metrics = json.loads((out / r["name"] / "training_metrics.json").read_text())
        assert r["final_loss"] == metrics["metrics"][-1]["loss"]
        assert r["best_loss"] == metrics["best_loss"] and r["best_step"] == metrics["best_step"]
        assert ExperimentConfig.load(str(out / r["name"] / "config.json")).name == r["name"]


class _StubTrainer:
    """What the sweep reads from a trainer, with a loss set by the config."""

    def __init__(self, cfg, *a, **k):
        self.best_loss = {1e-3: 0.5, 1e-4: 0.25, 1e-5: 0.75}[cfg.train.lr]
        self.best_step = int(cfg.model.latent_dim)
        self.metrics = [{"step": 1, "loss": 2 * self.best_loss}]

    def train(self):
        pass

    def save_metrics(self, path):
        with open(path, "w") as f:
            json.dump({"metrics": self.metrics}, f)


def test_sweep_files_match_jax(tmp_path, monkeypatch):
    """The same results give the same interim_summary.json,
    final_summary.json and best_configs.txt (keys, sort order, text)."""
    monkeypatch.setattr(JSw, "build_trainer", _StubTrainer)
    monkeypatch.setattr(TSw, "build_trainer", _StubTrainer)
    grid = {"train.lr": [1e-3, 1e-4, 1e-5], "model.latent_dim": [32, 64]}
    monkeypatch.chdir(tmp_path)
    ref = JSw.run_sweep(JaxConfig(name="base"), grid, "out")
    os.rename("out", "jax")
    ours = TSw.run_sweep(ExperimentConfig(name="base"), grid, "out", device="cpu")
    assert json.dumps(ours) == json.dumps(ref)
    for name in ("interim_summary.json", "final_summary.json", "best_configs.txt",
                 "base_lr0.0001_latent_dim32/config.json"):
        assert (tmp_path / "out" / name).read_text() == (tmp_path / "jax" / name).read_text()
