"""The port's seven constrained-sampling workflows (``cli/workflows.py``)
against the JAX package's CLI, and ``make_sampler``.

Both CLIs run ``--untrained --dim 16 --steps 10 --num 2`` on the walk clip.
The port's U-Net gets the very parameters the JAX CLI initialised (captured
from its ``model.init`` and carried over with ``convert.py``), and both
chains get the same gaussians: the JAX chain runs under
``jax.disable_jit`` (its scan step by step, the U-Net forward still
compiled) with ``jax.random.normal`` drawing from a seeded numpy stream
and recording each draw, and the port's ``torch.randn`` replays them in
order. Saved motions agree within ``MOTION_TOL`` x max(1, max |JAX|): f32
chains of 10 steps through an untrained U-Net in another summation order.
The conditioned frames and dims are bit-identical (both overwrite with the
same float32 values), and the JAX package's own property checks
(``tests/test_workflows.py``) hold on the port's motions.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.cli import workflows as JW
from deepmimic_diffusion_mujoco_tpu.diffusion import sampling as JSam
from deepmimic_diffusion_mujoco_tpu_torch import factory as TF
from deepmimic_diffusion_mujoco_tpu_torch.cli import workflows as TW
from deepmimic_diffusion_mujoco_tpu_torch.convert import temporal_unet_from_flax
from deepmimic_diffusion_mujoco_tpu_torch.data.mocap import load_clip
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import sampling as TSam
from deepmimic_diffusion_mujoco_tpu_torch.diffusion.schedules import make_schedule
from deepmimic_diffusion_mujoco_tpu_torch.models.temporal_unet import TemporalUnet

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "motions")
WALK = os.path.join(DATA, "humanoid3d_walk.txt")
BACKFLIP = os.path.join(DATA, "humanoid3d_backflip.txt")
NUM, STEPS, DIM = 2, 10, 16
COMMON = ["--untrained", "--clip", WALK, "--clip2", BACKFLIP, "--num", str(NUM),
          "--steps", str(STEPS), "--dim", str(DIM)]
MOTION_TOL = 1e-4    # x max(1, max |JAX motion|)


def _walk():
    q = load_clip(WALK).qpos.astype(np.float32)
    return q[: len(q) - len(q) % 8]


def _conditioned(wf, shape):
    """Boolean (H, 35) mask of the frames and dims the workflow clamps."""
    H = shape[0]
    m = np.zeros(shape, bool)
    if wf == "editing":
        m[:, 13:21] = True
    elif wf == "long-projection":
        h = H // 3
        for kf in (0, h, 2 * h):
            m[max(kf - 2, 0):min(kf + 3, H), 3:35] = True
    elif wf == "inbetween":
        edge = H // 4
        m[:edge] = m[-edge:] = True
    elif wf == "blend":
        a = _walk().shape[0]
        b = load_clip(BACKFLIP).qpos.shape[0] // 8 * 8
        seam = a - (a + b) % 8  # the trimmed first clip's length
        assert H == seam + b
        m[:seam - 5] = True
        m[seam + 5:, 3:35] = True
    elif wf == "steer":
        m[:16, :2] = True
    return m


def _properties(wf, m):
    """tests/test_workflows.py's checks, on one saved motion."""
    clip = _walk()
    if wf == "editing":
        np.testing.assert_allclose(m[:, 13:16], 0.0)
        np.testing.assert_allclose(m[:, 16], 1.57, atol=1e-6)
    elif wf == "start-with-motion":
        assert np.abs(m - clip).mean() < 1.0
    elif wf == "short-projection":
        assert m.shape[0] == int(clip.shape[0] * 0.75) // 8 * 8
    elif wf == "long-projection":
        assert m.shape[0] == clip.shape[0] * 3
        np.testing.assert_allclose(m[0, 3:35], clip[0, 3:35], atol=1e-5)
    elif wf == "inbetween":
        edge = clip.shape[0] // 4
        np.testing.assert_allclose(m[:edge], clip[:edge], atol=1e-5)
        np.testing.assert_allclose(m[-edge:], clip[-edge:], atol=1e-5)
        assert np.abs(m[edge:-edge] - clip[edge:-edge]).max() > 1e-3
    elif wf == "blend":
        np.testing.assert_allclose(m[:5], clip[:5], atol=1e-5)
    elif wf == "steer":
        np.testing.assert_allclose(m[:16, 0], np.linspace(0, 2.0, 16), atol=1e-5)
        np.testing.assert_allclose(m[:16, 1], 0.0, atol=1e-5)


class _JitModel:
    """The flax U-Net with a compiled apply that stays compiled under
    ``jax.disable_jit``; records the parameters ``init`` returns."""

    def __init__(self, model, record):
        self.model, self.record = model, record

    def init(self, *a):
        with jax.disable_jit(False):
            params = jax.jit(self.model.init)(*a)
        self.record["params"] = params
        return params

    def apply(self, params, x, t, y=None):
        with jax.disable_jit(False):
            return _jitted_apply(self.model)(params, x, t)


@functools.lru_cache(maxsize=None)
def _jitted_apply(model):
    return jax.jit(model.apply)


def _run_jax(monkeypatch, wf, out, record):
    real_build = JW.factory.build_experiment
    real_normal = jax.random.normal
    rng = np.random.default_rng(sum(map(ord, wf)))
    draws = record["draws"] = []

    def build(cfg):
        model, sched = real_build(cfg)
        return _JitModel(model, record), sched

    def fake_normal(key, shape=(), dtype=jnp.float32):
        if "params" in record and len(shape) == 3 and shape[0] == NUM:
            a = rng.normal(size=tuple(shape)).astype(np.float32)
            draws.append(a)
            return jnp.asarray(a, dtype)
        return real_normal(key, shape, dtype)

    with monkeypatch.context() as m, jax.disable_jit():
        m.setattr(JW.factory, "build_experiment", build)
        m.setattr(JSam.jax.random, "normal", fake_normal)
        JW.main([wf, *COMMON, "--out", out])
    assert draws, "the JAX chain drew no gaussians"


def _run_port(monkeypatch, wf, out, record):
    real_build = TF.build_experiment
    sd = temporal_unet_from_flax(jax.tree_util.tree_map(np.asarray, record["params"]))
    queue = list(record["draws"])
    real_randn = torch.randn

    def build(cfg, device="cuda"):
        model, sched = real_build(cfg, device)
        model.load_state_dict(sd, strict=True)
        return model, sched

    def fake_randn(*shape, generator=None, device=None, dtype=None, **kw):
        if generator is None:  # the model's init, not the chain
            return real_randn(*shape, device=device, dtype=dtype, **kw)
        (shape,) = shape
        a = queue.pop(0)
        assert tuple(shape) == a.shape
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    with monkeypatch.context() as m:
        m.setattr(TW.factory, "build_experiment", build)
        m.setattr(TSam.torch, "randn", fake_randn)
        paths = TW.main([wf, *COMMON, "--out", out, "--device", "cpu"])
    assert not queue, "the port's chain drew fewer gaussians than JAX's"
    return paths


@pytest.mark.parametrize("wf", TW.WORKFLOWS)
def test_workflow_matches_jax(tmp_path, monkeypatch, wf):
    record = {}
    _run_jax(monkeypatch, wf, str(tmp_path / "jax"), record)
    paths = _run_port(monkeypatch, wf, str(tmp_path / "port"), record)
    assert [os.path.basename(p) for p in paths] == sorted(os.listdir(tmp_path / "jax"))
    for p in paths:
        ours = np.load(p)
        ref = np.load(tmp_path / "jax" / os.path.basename(p))
        assert ours.shape == ref.shape and ours.dtype == ref.dtype
        assert np.isfinite(ours).all()
        tol = MOTION_TOL * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(ours, ref, atol=tol, rtol=0)
        mask = _conditioned(wf, ours.shape)
        np.testing.assert_array_equal(ours[mask], ref[mask])
        _properties(wf, ours)


def test_untrained_init_is_seeded(tmp_path):
    a = TW.main(["editing", *COMMON, "--out", str(tmp_path / "a"), "--device", "cpu"])
    b = TW.main(["editing", *COMMON, "--out", str(tmp_path / "b"), "--device", "cpu"])
    for pa, pb in zip(a, b):
        np.testing.assert_array_equal(np.load(pa), np.load(pb))


def test_workflows_read_a_run_directory(tmp_path):
    """A port run directory instead of --untrained: the EMA weights with --ema."""
    from deepmimic_diffusion_mujoco_tpu_torch.train.checkpoint import Checkpointer
    from deepmimic_diffusion_mujoco_tpu_torch.train.config import ExperimentConfig

    cfg = ExperimentConfig.from_dict({
        "model": {"architecture": "temporal", "input_dim": 35, "channel_dim": DIM},
        "diffusion": {"noise_steps": 4, "convention": "diffuser", "predict_x0": False,
                      "mode": "posterior"}})
    run = tmp_path / "run"
    run.mkdir()
    cfg.save(str(run / "config.json"))
    torch.manual_seed(0)
    params = TemporalUnet(35, dim=DIM).state_dict()
    ema = TemporalUnet(35, dim=DIM).state_dict()
    Checkpointer(str(run / "checkpoints")).save_best(0, params, ema, loss=0.0)
    args = ["steer", "--run", str(run), "--clip", WALK, "--num", "1", "--device", "cpu"]
    plain = np.load(TW.main([*args, "--out", str(tmp_path / "p")])[0])
    with_ema = np.load(TW.main([*args, "--ema", "--out", str(tmp_path / "e")])[0])
    assert plain.shape == with_ema.shape == (_walk().shape[0], 35)
    assert np.abs(plain - with_ema).max() > 0
    _properties("steer", plain)


def test_make_sampler_matches_sample_loop():
    """The closure binds the model and the defaults; overrides win."""
    torch.manual_seed(0)
    model = TemporalUnet(35, dim=DIM).eval()
    sched = make_schedule("cosine", 8, convention="diffuser", device="cpu")
    sampler = TSam.make_sampler(sched, model, mode="ddim", ddim_steps=4)
    shape = (2, 16, 35)
    ours = sampler(shape, torch.Generator().manual_seed(3)).trajectories
    ref = TSam.sample_loop(sched, model, shape, torch.Generator().manual_seed(3), mode="ddim",
                           ddim_steps=4).trajectories
    torch.testing.assert_close(ours, ref, rtol=0, atol=0)
    over = sampler(shape, torch.Generator().manual_seed(3), mode="posterior",
                   return_chain=True)
    ref = TSam.sample_loop(sched, model, shape, torch.Generator().manual_seed(3),
                           mode="posterior", return_chain=True)
    torch.testing.assert_close(over.trajectories, ref.trajectories, rtol=0, atol=0)
    assert over.chain.shape == (8, *shape)
