"""The port's playback stack against the JAX package's: the software
renderer (``physics/softrender.py``), the MuJoCo player
(``physics/player.py``), the video writer (``physics/video.py``), the play
CLI (``cli/play.py``, with ``--physics``), the end-to-end walk's sequence
of CLI calls, and the dataset leftovers (``data/datasets.py``).

Frames from the same body poses are bit-identical (the same numpy
rasterizer); the port's forward kinematics (float32 torch) give poses
within ``POSE_TOL`` of the JAX package's. The player drives the same MuJoCo
model, so its played qpos and body positions are equal. ``--physics``
agrees with JAX's ``track_motions`` within ``tests/test_torch_physics.py``'s
1e-4 (the same algebra on another engine, float32).
"""
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.cli import play as JPlay
from deepmimic_diffusion_mujoco_tpu.data import datasets as JD
from deepmimic_diffusion_mujoco_tpu.physics import kinematics as JK
from deepmimic_diffusion_mujoco_tpu.physics import player as JPl
from deepmimic_diffusion_mujoco_tpu.physics import plausibility as JPh
from deepmimic_diffusion_mujoco_tpu.physics import softrender as JR
from deepmimic_diffusion_mujoco_tpu.physics import video as JV
from deepmimic_diffusion_mujoco_tpu_torch.cli import play as TPlay
from deepmimic_diffusion_mujoco_tpu_torch.data import datasets as TD
from deepmimic_diffusion_mujoco_tpu_torch.data.mocap import load_clip
from deepmimic_diffusion_mujoco_tpu_torch.examples import end_to_end_walk as walk
from deepmimic_diffusion_mujoco_tpu_torch.physics import player as TPl
from deepmimic_diffusion_mujoco_tpu_torch.physics import plausibility as TPh
from deepmimic_diffusion_mujoco_tpu_torch.physics import softrender as TR
from deepmimic_diffusion_mujoco_tpu_torch.physics import video as TV

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "motions")
WALK = os.path.join(DATA, "humanoid3d_walk.txt")
POSE_TOL = 1e-5      # float32 FK through 13 bodies, torch against XLA
PHYSICS_TOL = 1e-4   # tests/test_torch_physics.py::test_track_motions_matches_jax


@pytest.fixture(scope="module")
def qpos():
    return load_clip(WALK).qpos[:6].astype(np.float32)


def _jax_poses(q):
    fk = JK.forward_kinematics_batch(jnp.asarray(q, jnp.float32))
    return np.asarray(fk.body_pos, np.float64), np.asarray(fk.body_quat, np.float64)


def test_geom_segments_match_jax():
    for ours, ref in zip(TR._geom_segments(), JR._geom_segments()):
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("size", [(640, 480), (96, 64)])
def test_render_frame_is_bit_identical(qpos, size):
    pos, quat = _jax_poses(qpos)
    for t in (0, 3, 5):
        ours = TR.render_frame(pos[t], quat[t], *size)
        assert ours.shape == (size[1], size[0], 3) and ours.dtype == np.uint8
        np.testing.assert_array_equal(ours, JR.render_frame(pos[t], quat[t], *size))
        assert (ours != 24).any()  # the character and the grid were drawn


@pytest.mark.parametrize("name", ["walk", "backflip", "cartwheel", "dance_a", "spinkick"])
def test_render_frame_is_bit_identical_on_every_frame_of_clips(name):
    q = load_clip(os.path.join(DATA, f"humanoid3d_{name}.txt")).qpos[::8].astype(np.float32)
    pos, quat = _jax_poses(q)
    for t in range(len(q)):
        np.testing.assert_array_equal(TR.render_frame(pos[t], quat[t], 96, 64),
                                      JR.render_frame(pos[t], quat[t], 96, 64))


def test_render_motion_bounds_poses_far_from_any_clip():
    """An untrained model's poses (qpos of order 1e2-1e4) put capsules at or
    behind the camera; the JAX package's renderer spends minutes on one such
    frame (segments millions of pixels thick), the port's skips them."""
    import time

    q = (np.random.default_rng(0).normal(size=(4, 35)) * 1e4).astype(np.float32)
    t0 = time.perf_counter()
    frames = TR.render_motion(q, width=160, height=120, device="cpu")
    assert time.perf_counter() - t0 < 20.0
    assert frames.shape == (4, 120, 160, 3) and frames.dtype == np.uint8


def test_render_frame_without_cv2_is_bit_identical(qpos, monkeypatch):
    """The numpy line stamps, when cv2 does not import."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    pos, quat = _jax_poses(qpos)
    np.testing.assert_array_equal(TR.render_frame(pos[2], quat[2], 96, 64),
                                  JR.render_frame(pos[2], quat[2], 96, 64))


def test_render_motion_poses_match_jax(qpos):
    """The port's FK (one read-back for the whole trajectory) within
    POSE_TOL of JAX's; its frames are render_frame of those poses."""
    pos, quat = TR.body_poses(qpos, device="cpu")
    ref_pos, ref_quat = _jax_poses(qpos)
    assert pos.dtype == np.float64 and pos.shape == ref_pos.shape
    np.testing.assert_allclose(pos, ref_pos, atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(quat, ref_quat, atol=POSE_TOL, rtol=0)
    frames = TR.render_motion(qpos, width=96, height=64, device="cpu")
    assert frames.shape == (len(qpos), 64, 96, 3) and frames.dtype == np.uint8
    for t in range(len(qpos)):
        np.testing.assert_array_equal(frames[t], TR.render_frame(pos[t], quat[t], 96, 64))


def _recorded_forwards(player, monkeypatch):
    seen = []
    real = player.forward

    def forward(q):
        seen.append(np.array(q, np.float64))
        return real(q)

    monkeypatch.setattr(player, "forward", forward)
    return seen


def test_player_matches_jax(qpos, monkeypatch):
    """Two loops with the root-xy phase carry: the same played qpos and,
    after each, the same MuJoCo body positions."""
    ours, ref = TPl.MocapPlayer(), JPl.MocapPlayer()
    seen_ours = _recorded_forwards(ours, monkeypatch)
    seen_ref = _recorded_forwards(ref, monkeypatch)
    assert ours.play(qpos, loops=2, render=False) == ref.play(qpos, loops=2, render=False) == []
    assert len(seen_ours) == len(seen_ref) == 2 * len(qpos)
    np.testing.assert_array_equal(np.stack(seen_ours), np.stack(seen_ref))
    assert seen_ours[len(qpos)][0] != qpos[0, 0]  # the second loop carried the root
    for q in seen_ours[::3]:
        a, b = ours.body_positions(q), ref.body_positions(q)
        assert a.keys() == b.keys()
        for name in a:
            np.testing.assert_array_equal(a[name], b[name])


def test_player_renders_through_the_software_renderer(qpos, tmp_path, monkeypatch):
    """Without a GL context (MuJoCo's renderer raises; the real one is never
    opened here, since a second attempt in one process aborts it) the frames
    are render_motion of the played qpos, as the JAX player's are, MuJoCo is
    not asked again, and the video is written."""
    attempts = []

    def no_gl(*a, **k):
        attempts.append(a)
        raise RuntimeError("no GL context")

    player = TPl.MocapPlayer()
    monkeypatch.setattr(player.mujoco, "Renderer", no_gl)
    monkeypatch.setattr(TPl, "_NO_GL", [])
    played = _recorded_forwards(player, monkeypatch)
    video = str(tmp_path / "v.avi")
    frames = player.play(qpos, loops=2, width=96, height=64, video_path=video, device="cpu")
    assert len(frames) == 2 * len(qpos) and frames[0].shape == (64, 96, 3)
    np.testing.assert_array_equal(
        np.stack(frames), TR.render_motion(np.stack(played), 96, 64, device="cpu"))
    assert os.path.exists(video) or os.path.exists(video + ".npy")
    assert len(player.play(qpos, width=96, height=64, device="cpu")) == len(qpos)
    assert len(attempts) == 1


def test_play_mocap_np_file_pads_like_jax(tmp_path, qpos, monkeypatch):
    path = str(tmp_path / "m.npy")
    np.save(path, qpos[:, :20])
    ours, ref = [], []
    monkeypatch.setattr(TPl.MocapPlayer, "play", lambda self, m, **k: ours.append(m) or [])
    monkeypatch.setattr(JPl.MocapPlayer, "play", lambda self, m, **k: ref.append(m) or [])
    TPl.play_mocap_np_file(path)
    JPl.play_mocap_np_file(path)
    np.testing.assert_array_equal(ours[0], ref[0])
    assert ours[0].shape == (len(qpos), 35)
    np.save(path, np.zeros((2, 3, 4)))
    with pytest.raises(ValueError, match="expected"):
        TPl.play_mocap_np_file(path)


@pytest.mark.parametrize("branch", ["avi", "npy"])
def test_video_saver_matches_jax(tmp_path, monkeypatch, branch):
    """cv2's MJPG .avi (the same bytes), or the .npy frame stack when cv2
    does not import."""
    if branch == "npy":
        monkeypatch.setitem(sys.modules, "cv2", None)
    frames = np.random.default_rng(0).integers(0, 255, (3, 32, 48, 3), dtype=np.uint8)
    for cls, name in ((TV.VideoSaver, "ours.avi"), (JV.VideoSaver, "ref.avi")):
        saver = cls(str(tmp_path / name), width=48, height=32, fps=10)
        for f in frames:
            saver.write(f)
        saver.close()
    if branch == "npy":
        np.testing.assert_array_equal(np.load(tmp_path / "ours.avi.npy"), frames)
        np.testing.assert_array_equal(np.load(tmp_path / "ours.avi.npy"),
                                      np.load(tmp_path / "ref.avi.npy"))
        assert not (tmp_path / "ours.avi").exists() or os.path.getsize(tmp_path / "ours.avi") == 0
    else:
        assert (tmp_path / "ours.avi").read_bytes() == (tmp_path / "ref.avi").read_bytes()
        assert os.path.getsize(tmp_path / "ours.avi") > 0


def test_play_cli_no_render_matches_jax(tmp_path, qpos, capsys):
    path = str(tmp_path / "m.npy")
    np.save(path, qpos)
    JPlay.main([path, "--no-render", "--loops", "2"])
    ref = capsys.readouterr().out
    frames, res = TPlay.main([path, "--no-render", "--loops", "2", "--device", "cpu"])
    assert capsys.readouterr().out == ref == "played; 0 frames rendered\n"
    assert frames == [] and res is None


def test_play_cli_physics_matches_jax(capsys, monkeypatch):
    """`--no-render --physics --physics-horizon 3` on the walk clip: the
    same two lines, the tracking summary within PHYSICS_TOL."""
    results = []
    real = JPh.track_motions

    def recorded(*a, **k):
        results.append(real(*a, **k))
        return results[-1]

    monkeypatch.setattr(JPh, "track_motions", recorded)
    JPlay.main([WALK, "--no-render", "--physics", "--physics-horizon", "3"])
    ref_out = capsys.readouterr().out.splitlines()
    frames, res = TPlay.main([WALK, "--no-render", "--physics", "--physics-horizon", "3",
                              "--device", "cpu"])
    ours_out = capsys.readouterr().out.splitlines()
    assert len(ours_out) == len(ref_out) == 2 and ours_out[0] == ref_out[0]
    ref = results[0]
    assert res["summary"].keys() == ref["summary"].keys()
    for key, val in ref["summary"].items():
        assert res["summary"][key] == pytest.approx(val, abs=PHYSICS_TOL), key
    np.testing.assert_allclose(res["reward_curve"], np.asarray(ref["reward_curve"]),
                               atol=PHYSICS_TOL, rtol=0)
    line = (r"physics tracking: reward -?\d+\.\d{3} \(auc -?\d+\.\d{3}\), survived \d+% "
            r"of 3 steps; per-step reward: (-?\d+\.\d{2} ){3}\.\.\.")
    assert re.fullmatch(line, ours_out[1]) and re.fullmatch(line, ref_out[1]), ours_out


def test_play_cli_physics_runs_track_motions_on_the_device(monkeypatch, capsys):
    seen = {}

    def fake(qpos, horizon, device):
        seen.update(shape=np.shape(qpos), horizon=horizon, device=device)
        return {"summary": {"physics_reward_mean": 0.5, "physics_reward_auc": 0.25,
                            "physics_survived_frac": 1.0}, "reward_curve": np.ones(2)}

    monkeypatch.setattr(TPh, "track_motions", fake)
    TPlay.main([WALK, "--no-render", "--physics", "--physics-horizon", "2", "--device", "cpu"])
    assert seen["horizon"] == 2 and seen["device"] == torch.device("cpu")
    assert seen["shape"] == load_clip(WALK).qpos.shape
    assert "reward 0.500 (auc 0.250), survived 100% of 2 steps" in capsys.readouterr().out


def test_end_to_end_walk_calls_the_clis_in_order(monkeypatch, tmp_path):
    """The walk's train -> sample -> play sequence and argv, with the CLIs'
    mains stubbed; --device is passed through to all three."""
    from deepmimic_diffusion_mujoco_tpu_torch.cli import play, sample, train

    calls = []
    out = str(tmp_path / "demo")

    def fake_sample(argv):
        calls.append(("sample", argv))
        d = argv[argv.index("--out") + 1]
        os.makedirs(d, exist_ok=True)
        for i in (2, 1):
            np.save(os.path.join(d, f"motion{i}.npy"), np.zeros((8, 35)))

    monkeypatch.setattr(train, "main", lambda argv: calls.append(("train", argv)))
    monkeypatch.setattr(sample, "main", fake_sample)
    monkeypatch.setattr(play, "main", lambda argv: calls.append(("play", argv)))
    walk.main(["--steps", "20", "--out", out, "--device", "cpu"])
    assert [c[0] for c in calls] == ["train", "sample", "play"]
    assert calls[0][1] == ["--data", walk.CLIP, "--steps", "20", "--out", out, "--device", "cpu",
                           "--set", "train.log_every=50", "train.save_every=10",
                           "train.scan_chunk=10"]
    assert os.path.exists(walk.CLIP)
    assert calls[1][1] == ["--run", out, "--num", "2", "--out", os.path.join(out, "samples"),
                           "--device", "cpu"]
    assert calls[2][1] == [os.path.join(out, "samples", "motion1.npy"), "--loops", "2",
                           "--video", os.path.join(out, "walk_demo.avi"), "--device", "cpu"]
    calls.clear()
    walk.main(["--skip-train", "--out", out, "--num-samples", "3"])
    assert [c[0] for c in calls] == ["sample", "play"] and calls[1][1][-1] == "cuda"


def test_dataset_leftovers_match_jax():
    q = load_clip(WALK).qpos
    flat, bounds = TD.flattened_normalized(q, frames=32)
    ref_flat, ref_bounds = JD.flattened_normalized(q, frames=32)
    np.testing.assert_array_equal(flat, ref_flat)
    assert flat.shape == (1, 32 * 35, 1) and bounds == ref_bounds
    np.testing.assert_array_equal(TD.unflatten_denormalized(flat, bounds),
                                  JD.unflatten_denormalized(ref_flat, ref_bounds))
    np.testing.assert_allclose(TD.unflatten_denormalized(flat, bounds), q[:32], atol=1e-5)
    ours = TD.MotionDataset.from_path(DATA, max_files=3, augment="none")
    ref = JD.MotionDataset.from_path(DATA, max_files=3, augment="none")
    assert ours.max_sequence_length == ref.max_sequence_length == int(ours.lengths.max())
    assert len(set(ours.lengths.tolist())) > 1  # clips of different lengths: real padding
    np.testing.assert_array_equal(ours.mask(), ref.mask())
    assert ours.mask().dtype == np.float32 and ours.mask().shape == (len(ours), ours.horizon)
    np.testing.assert_array_equal(ours.mask().sum(1), ours.lengths)
