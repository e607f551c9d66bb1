"""The port's sampling CLI end to end on the CPU: a run directory with the
JAX package's config.json and a port checkpoint converted from flax params,
sampled through ``cli.sample.main``."""
import json

import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.train.config import ExperimentConfig as JaxConfig
from deepmimic_diffusion_mujoco_tpu_torch.cli import sample as cli
from deepmimic_diffusion_mujoco_tpu_torch.convert import temporal_unet_from_flax
from deepmimic_diffusion_mujoco_tpu_torch.train.checkpoint import Checkpointer, autodetect_metadata
from deepmimic_diffusion_mujoco_tpu_torch.train.config import ExperimentConfig
from test_torch_temporal_unet import jax_unet

torch.set_num_threads(2)

D = 35
BOX_ZERO, BOX_ELBOW = [13, 14, 15, 17, 18, 19], [16, 20]


def _make_run(tmp_path, best=True, **diffusion):
    cfg = JaxConfig.from_dict({
        "name": "port_cli",
        "model": {"architecture": "temporal", "input_dim": D, "channel_dim": 16,
                  "max_seq_len": 16},
        "diffusion": {"noise_steps": 8, "schedule_type": "cosine", "convention": "diffuser",
                      "predict_x0": False, "mode": "posterior", **diffusion},
    })
    cfg.save(str(tmp_path / "config.json"))
    _, params, _ = jax_unet(16, False)
    sd = temporal_unet_from_flax(params)
    ema = {k: v + 0.01 for k, v in sd.items()}
    ck = Checkpointer(str(tmp_path / "checkpoints"))
    if best:
        ck.save_best(7, sd, ema, loss=0.25)
    else:
        ck.save(3, sd, ema)
        ck.save(5, sd, ema)
    return tmp_path


def _check_box(paths, frames):
    for p in paths:
        m = np.load(p)
        assert m.shape == (frames, 35)
        assert np.isfinite(m).all()
        assert (m[:, BOX_ZERO] == 0).all()
        assert (m[:, BOX_ELBOW] == np.float32(1.57)).all()


@pytest.mark.parametrize("frames", [16, 24])
def test_sample_cli_holding_box(tmp_path, frames):
    run = _make_run(tmp_path)
    out = tmp_path / "out"
    paths = cli.main(["--run", str(run), "--num", "2", "--frames", str(frames),
                      "--conditioner", "holding_box", "--out", str(out), "--device", "cpu"])
    assert [p.split("/")[-1] for p in paths] == ["motion1.npy", "motion2.npy"]
    _check_box(paths, frames)


def test_sample_cli_turns_tf32_off(tmp_path, monkeypatch):
    """The sample CLI computes in float32: TF32 off in cuDNN and in cuBLAS's
    matmuls, whatever the caller had set."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    run = _make_run(tmp_path)
    cli.main(["--run", str(run), "--num", "1", "--frames", "16", "--conditioner",
              "holding_box", "--out", str(tmp_path / "out"), "--device", "cpu"])
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_sample_cli_is_seeded_and_reads_ema(tmp_path):
    run = _make_run(tmp_path, clip_denoised=True)
    base = ["--run", str(run), "--num", "1", "--device", "cpu", "--seed", "3"]
    a = np.load(cli.main(base + ["--out", str(tmp_path / "a")])[0])
    b = np.load(cli.main(base + ["--out", str(tmp_path / "b")])[0])
    c = np.load(cli.main(base + ["--out", str(tmp_path / "c"), "--ema"])[0])
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0


def test_sample_cli_cfg_sweep(tmp_path):
    run = _make_run(tmp_path, mode="ddim")
    out = tmp_path / "sweep"
    paths = cli.main(["--run", str(run), "--num", "2", "--cfg-sweep", "0,2.5",
                      "--conditioner", "holding_box", "--out", str(out), "--device", "cpu"])
    assert len(paths) == 4
    _check_box(paths, 16)
    meta = json.loads((out / "cfg_sweep.json").read_text())
    assert meta["scales"] == [0.0, 2.5] and meta["files"] == paths


def test_load_run_falls_back_to_latest_state(tmp_path):
    run = _make_run(tmp_path, best=False)
    cfg, model, sched, payload, meta = cli.load_run(str(run), device="cpu")
    assert payload["step"] == 5 and meta["step"] == 5
    assert sched.num_timesteps == 8 and cfg.model.channel_dim == 16
    model.load_state_dict(payload["params"], strict=True)


def test_checkpoint_metadata_contract(tmp_path):
    run = _make_run(tmp_path)
    meta = autodetect_metadata(str(run / "checkpoints"))
    assert meta["step"] == 7 and meta["loss"] == 0.25 and meta["best_loss"] == 0.25
    assert "git_rev" in meta
    assert Checkpointer(str(run / "checkpoints")).latest_step() is None


def test_config_json_round_trips_between_packages(tmp_path):
    cfg = JaxConfig().override({"model.architecture": "temporal", "diffusion.mode": "ddim"})
    cfg.save(str(tmp_path / "c.json"))
    ours = ExperimentConfig.load(str(tmp_path / "c.json"))
    assert json.loads(ours.to_json()) == json.loads(cfg.to_json())


def test_save_motions_pads_and_slices(tmp_path):
    narrow = cli.save_motions(np.ones((1, 4, 20), np.float32), str(tmp_path / "n"))
    wide = cli.save_motions(torch.ones(1, 4, 69), str(tmp_path / "w"))
    assert np.load(narrow[0]).shape == (4, 35) and (np.load(narrow[0])[:, 20:] == 0).all()
    assert np.load(wide[0]).shape == (4, 35)
