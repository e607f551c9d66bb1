"""The port's evaluation metrics against the JAX package's
``eval/metrics.py`` (window slicing, activation statistics, the SVD-sqrt
Frechet distance, motion-FID, inter/intra diversity, SiFID with its own
ground-truth stride, the sampling-rate clock and the ``evaluate`` harness),
then the port's ``cli/evaluate.py`` and ``cli/cfg_eval.py`` on a tiny
transformer run trained on the CPU, as tests/test_cli.py drives the JAX
CLIs."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.cli import cfg_eval as jax_cfg_eval
from deepmimic_diffusion_mujoco_tpu.eval import metrics as JM
from deepmimic_diffusion_mujoco_tpu_torch.cli import cfg_eval
from deepmimic_diffusion_mujoco_tpu_torch.cli import evaluate
from deepmimic_diffusion_mujoco_tpu_torch.cli import train as train_cli
from deepmimic_diffusion_mujoco_tpu_torch.eval import metrics as M
from deepmimic_diffusion_mujoco_tpu_torch.models import transformer as TM
from deepmimic_diffusion_mujoco_tpu_torch.physics import plausibility

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIG = os.path.join(ROOT, "experiments", "allclips12k_r5", "config.json")
MOTIONS = os.path.join(ROOT, "data", "motions")
WALK = os.path.join(MOTIONS, "humanoid3d_walk.txt")
TINY = ["model.latent_dim=32", "model.num_layers=1", "model.n_heads=2",
        "model.dim_feedforward=64", "model.max_seq_len=40", "diffusion.noise_steps=8",
        "data.max_files=2", "train.log_every=2"]
# f32 statistics; an SVD of a product of covariances: relative error of the distance
FID_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("T,window,step", [(64, 10, 10), (25, 10, 1), (40, 7, 3)])
def test_slice_windows_matches(T, window, step):
    x = _rng(0).normal(size=(T, 5)).astype(np.float32)
    np.testing.assert_array_equal(M.slice_windows(_t(x), window, step).numpy(),
                                  np.asarray(JM.slice_windows(jnp.asarray(x), window, step)))


def test_statistics_and_frechet_distance_match():
    a = _rng(1).normal(size=(60, 4, 3)).astype(np.float32)
    b = (_rng(2).normal(size=(50, 4, 3)) * 1.5 + 0.3).astype(np.float32)
    jmu1, js1 = JM.activation_statistics(jnp.asarray(a))
    jmu2, js2 = JM.activation_statistics(jnp.asarray(b))
    mu1, s1 = M.activation_statistics(_t(a))
    mu2, s2 = M.activation_statistics(_t(b))
    np.testing.assert_allclose(mu1.numpy(), np.asarray(jmu1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(M.frechet_distance(mu1, s1, mu2, s2)),
                               float(JM.frechet_distance(jmu1, js1, jmu2, js2)), rtol=FID_TOL)
    np.testing.assert_allclose(M.motion_fid(_t(a), _t(b)),
                               JM.motion_fid(jnp.asarray(a), jnp.asarray(b)), rtol=FID_TOL)


def test_frechet_distance_is_nan_on_non_finite_input():
    """JAX's SVD returns NaN on a non-finite product; torch's would raise."""
    a = _rng(3).normal(size=(20, 6)).astype(np.float32)
    b = a.copy()
    b[4, 2] = np.inf
    assert np.isnan(M.motion_fid(_t(a), _t(b)))
    assert np.isnan(JM.motion_fid(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("n", [6, 7])
def test_inter_diversity_matches(n):
    x = _rng(4).normal(size=(n, 16, 5)).astype(np.float32)
    np.testing.assert_allclose(M.inter_diversity(_t(x)), JM.inter_diversity(jnp.asarray(x)),
                               rtol=1e-6)


def test_intra_diversity_matches_on_the_same_windows():
    """JAX draws the window starts from a key; the port takes them from its
    generator: the same starts give the same distance, and the port's draws
    cover [0, T - window)."""
    x = _rng(5).normal(size=(5, 30, 4)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    offsets = np.asarray(jax.random.randint(key, (5, 2), 0, 30 - 10))
    np.testing.assert_allclose(M.window_pair_distance(_t(x), _t(offsets).long(), 10),
                               JM.intra_diversity(jnp.asarray(x), key, 10), rtol=1e-6)
    g = torch.Generator().manual_seed(0)
    draws = [M.intra_diversity(_t(x), g) for _ in range(3)]
    assert len(set(draws)) == 3 and all(np.isfinite(draws))


@pytest.mark.parametrize("gt_step_size", [None, 1])
@pytest.mark.parametrize("D", [3, 69])
def test_sifid_matches(D, gt_step_size):
    """D 3: covariances of full rank; D 69 at H 64 (the CLIs' shape): six
    windows in 690 dimensions, a product of rank 5 whose clamped singular
    values the two SVDs leave in other bases."""
    T = 200 if D == 3 else 64
    gen = _rng(6).normal(size=(4, T, D)).astype(np.float32)
    gt = _rng(7).normal(size=(150, D)).astype(np.float32)
    ref = JM.sifid(jnp.asarray(gen), jnp.asarray(gt), gt_step_size=gt_step_size)
    np.testing.assert_allclose(M.sifid(_t(gen), _t(gt), gt_step_size=gt_step_size), ref,
                               rtol=FID_TOL)


def test_evaluate_harness_matches():
    """The same samples every replication: inter-diversity and SiFID equal
    JAX's; the intra-diversity keys (another window draw) are consistent."""
    samples = _rng(8).normal(size=(6, 40, 3)).astype(np.float32)
    gt = _rng(9).normal(size=(40, 3)).astype(np.float32)
    ref = JM.evaluate(lambda n: jnp.asarray(samples[:n]), jnp.asarray(gt), num_samples=6,
                      replications=2)
    ours = M.evaluate(lambda n: _t(samples[:n]), _t(gt), num_samples=6, replications=2)
    assert ours.keys() == ref.keys()
    for k in ("inter_diversity", "sifid"):
        np.testing.assert_allclose(ours[k]["mean"], ref[k]["mean"], rtol=FID_TOL)
        assert ours[k]["std"] == pytest.approx(0.0, abs=1e-3)
    assert ours["sampling_rate"]["mean"] > 0
    assert all(np.isfinite(ours[k]["mean"]) for k in ours)


def test_timed_sampling_rate():
    samples, rate = M.timed_sampling_rate(lambda n: torch.zeros(n, 4, 2), 3)
    assert samples.shape == (3, 4, 2) and rate > 0


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("run")
    train_cli.main(["--config", CONFIG, "--steps", "2", "--batch-size", "2", "--out", str(out),
                    "--device", "cpu", "--set", *TINY])
    return out


def test_evaluate_cli(run, tmp_path, monkeypatch):
    """Every flag on a transformer run: the metrics, motion-FID, RMSE, the
    physics scores (``track_motions`` stubbed: the CPU's plain B5 takes
    minutes; here only its inputs are checked) and the --check gate."""
    tracked = []

    def track_motions(motions, horizon=None, device="cuda"):
        tracked.append((tuple(motions.shape), horizon, str(device)))
        return {"summary": {"physics_reward_mean": 0.5}}

    monkeypatch.setattr(plausibility, "track_motions", track_motions)
    out = tmp_path / "eval.json"
    res = evaluate.main(["--run", str(run), "--gt", WALK, "--num", "3", "--reps", "2",
                         "--frames", "24", "--json", str(out), "--fid", "--rmse", "--physics",
                         "--physics-horizon", "4", "--device", "cpu",
                         "--check", "sampling_rate.mean>0", "--check", "rmse.min>=0"])
    assert json.loads(out.read_text()) == res
    keys = {"sampling_rate", "inter_diversity", "intra_diversity", "gt_intra_diversity",
            "intra_diversity_gt_diff", "sifid", "motion_fid", "physics_tracking", "rmse"}
    assert res.keys() == keys
    assert res["rmse"]["min"] <= res["rmse"]["mean"]
    assert np.isfinite(res["sifid"]["mean"]) and np.isfinite(res["motion_fid"]["mean"])
    assert tracked == [((3, 24, 35), 4, "cpu"), ((1, 24, 35), 4, "cpu")]
    assert evaluate.check_results(res, ["sifid.mean<=1e12"]) == []
    with pytest.raises(SystemExit):
        evaluate.main(["--run", str(run), "--gt", WALK, "--num", "2", "--reps", "1",
                       "--frames", "24", "--device", "cpu", "--check", "sampling_rate.mean<=0"])


def test_cfg_eval_cli(run, tmp_path, monkeypatch):
    """The JAX CLI's JSON, every class of the data directory (three clips
    here) at every scale, each chain one 2B-batch forward per step (the
    conditional half, then the null label)."""
    data = tmp_path / "motions"
    data.mkdir()
    names = ("humanoid3d_walk", "humanoid3d_run", "humanoid3d_jump")
    for name in names:
        (data / f"{name}.txt").write_text(open(os.path.join(MOTIONS, f"{name}.txt")).read())
    calls = []
    real_forward = TM.TransformerMotionModel.forward

    def forward(self, x, t, y=None, *a, **k):
        calls.append(y.tolist())
        return real_forward(self, x, t, y, *a, **k)

    monkeypatch.setattr(TM.TransformerMotionModel, "forward", forward)
    out = tmp_path / "cfg.json"
    cfg_eval.main(["--run", str(run), "--scales", "0,3", "--num", "2", "--frames", "24",
                   "--data-dir", str(data), "--out", str(out), "--device", "cpu",
                   "--check-accuracy", "3.0:0.0"])
    report = json.loads(out.read_text())
    assert report.keys() == {"run", "num", "ema", "scales", "frames", "gt_tiled_to"}
    assert report["frames"] == 24 and report["gt_tiled_to"] == 120
    classes = {name.replace("humanoid3d_", "") for name in names}
    for s in ("0.0", "3.0"):
        r = report["scales"][s]
        assert r.keys() == {"per_class", "class_accuracy", "mean_sifid_own", "mean_rmse_min"}
        assert set(r["per_class"]) == classes
        for row in r["per_class"].values():
            assert row.keys() == {"sifid_own", "sifid_best", "sifid_best_value", "rmse_min",
                                  "rmse_mean", "intra_div"}
            assert row["sifid_best"] in classes and row["rmse_min"] <= row["rmse_mean"]
    assert len(calls) == 2 * 3 * 2 * 7  # scales x classes x (plain, frame 0) x (T - 1)
    assert all(len(y) == 4 and y[2:] == [9, 9] and y[0] == y[1] < 9 for y in calls)
    with pytest.raises(SystemExit):
        cfg_eval.main(["--run", str(run), "--scales", "3", "--num", "2", "--frames", "24",
                       "--data-dir", str(data), "--device", "cpu", "--check-accuracy",
                       "3.0:1.01"])


def test_tiled_ground_truth_matches_jax():
    for D in (35, 69):
        ours = cfg_eval._class_clips(MOTIONS, D, min_frames=120)
        ref = jax_cfg_eval._class_clips(MOTIONS, D, min_frames=120)
        assert ours.keys() == ref.keys()
        for cid, (name, arr) in ref.items():
            assert ours[cid][0] == name
            np.testing.assert_array_equal(ours[cid][1], arr)
