"""The port stands alone: no module of it, and not chip_smoke.py, imports
JAX, flax, optax, orbax or the JAX package; and its entry points refuse to
drift to the CPU when no CUDA device is present."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu_torch import factory
from deepmimic_diffusion_mujoco_tpu_torch.cli import cfg_eval as cfg_eval_cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import compare as compare_cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import evaluate as evaluate_cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import play as play_cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import sample as cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import sweep as sweep_cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import train as train_cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import workflows as workflows_cli
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import conditioning, process, schedules
from deepmimic_diffusion_mujoco_tpu_torch.diffusion.timestep_sampling import LossSecondMomentState
from deepmimic_diffusion_mujoco_tpu_torch.examples import end_to_end_walk
from deepmimic_diffusion_mujoco_tpu_torch.physics import env as physics_env
from deepmimic_diffusion_mujoco_tpu_torch.physics.dynamics import DynamicsEnv
from deepmimic_diffusion_mujoco_tpu_torch.physics.plausibility import track_motions
from deepmimic_diffusion_mujoco_tpu_torch.physics.softrender import render_motion
from deepmimic_diffusion_mujoco_tpu_torch.train.config import ExperimentConfig, ModelConfig

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "deepmimic_diffusion_mujoco_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "deepmimic_diffusion_mujoco_tpu"}
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _temporal_cfg():
    return ExperimentConfig.from_dict({"model": {"architecture": "temporal", "channel_dim": 16}})


ENTRY_POINTS = {
    "build_experiment": lambda tmp: factory.build_experiment(_temporal_cfg()),
    "make_schedule": lambda tmp: schedules.make_schedule(),
    "holding_box": lambda tmp: conditioning.holding_box(),
    "load_run": lambda tmp: cli.load_run(str(tmp)),
    "cli_main": lambda tmp: cli.main(["--run", str(tmp)]),
    "train_main": lambda tmp: train_cli.main(["--out", str(tmp)]),
    "evaluate_main": lambda tmp: evaluate_cli.main(["--run", str(tmp), "--gt", "x.txt"]),
    "cfg_eval_main": lambda tmp: cfg_eval_cli.main(["--run", str(tmp)]),
    "build_trainer": lambda tmp: train_cli.build_trainer(_temporal_cfg()),
    "PhysicsTrackingEnv": lambda tmp: physics_env.PhysicsTrackingEnv(np.zeros((4, 35))),
    "KinematicEnv": lambda tmp: physics_env.KinematicEnv(np.zeros((4, 35))),
    "track_motions": lambda tmp: track_motions(np.zeros((4, 35))),
    "diffuser_loss_weights": lambda tmp: process.diffuser_loss_weights(8, 35),
    "LossSecondMomentState": lambda tmp: LossSecondMomentState.create(8),
    "workflows_main": lambda tmp: workflows_cli.main(["editing", "--untrained"]),
    "compare_main": lambda tmp: compare_cli.main(["--runs", str(tmp), "--out", str(tmp)]),
    "sweep_main": lambda tmp: sweep_cli.main(["--grid", "grid.json"]),
    "render_motion": lambda tmp: render_motion(np.zeros((2, 35))),
    "play_main": lambda tmp: play_cli.main(["motion.npy", "--no-render"]),
    "end_to_end_walk": lambda tmp: end_to_end_walk.main(["--out", str(tmp)]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_raises_without_cuda(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](tmp_path)


def test_bf16_config_is_refused():
    with pytest.raises(NotImplementedError, match="bf16"):
        factory.build_model(ModelConfig(architecture="temporal", bf16=True), device="cpu")


@pytest.mark.parametrize("arch", ["transformer", "decoder", "local_attention"])
def test_unported_architectures_name_their_slice(arch):
    """Every architecture is ported: each builds on the CPU when asked."""
    model = factory.build_model(ModelConfig(architecture=arch, latent_dim=32, depth=1,
                                            num_layers=1, n_heads=2, dim_head=16),
                                device="cpu")
    name = {"transformer": "TransformerMotionModel", "local_attention": "LocalTransformer",
            "decoder": "TransformerDecoderMotionModel"}
    assert type(model).__name__ == name[arch]
    assert not any(p.is_cuda for p in model.parameters())


def _tiny_local(**kw):
    return ModelConfig(architecture="local_attention", latent_dim=32, depth=1, n_heads=2,
                       dim_head=16, causal=True, **kw)


@pytest.mark.parametrize("case", ["global_attn", "decode_cache", "train_local_attention"])
def test_unported_local_attention_options_name_roadmap(case):
    """The options still to port raise naming ROADMAP.md; training, ported
    since, builds a trainer whose dropout is live as the JAX CLI sets it."""
    if case == "train_local_attention":
        cfg = ExperimentConfig.load(str(ROOT / "experiments" / "localattn5k_r3" / "config.json"))
        assert train_cli.has_dropout(cfg.model)
        assert not train_cli.has_dropout(cfg.override({"model.attn_dropout": 0.0,
                                                       "model.ff_dropout": 0.0}).model)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if case == "global_attn":
            factory.build_model(_tiny_local(use_global_attn=True), device="cpu")
        else:
            model = factory.build_model(_tiny_local(), device="cpu")
            model(torch.zeros(1, 1, 35), torch.zeros(1), cache=(), decode_pos=0)


@pytest.mark.parametrize("layout", ["aba", "lanes", "vmap"])
def test_unported_dynamics_layouts_name_roadmap(layout):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A, the other dynamics engines"):
        DynamicsEnv(layout=layout)
    assert DynamicsEnv(layout="pallas").layout == DynamicsEnv().layout == "pallas"


def test_rollout_sharded_names_roadmap():
    env = physics_env.PhysicsTrackingEnv(np.zeros((4, 35)), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        env.rollout_sharded(None, env.reset(2), 1)
