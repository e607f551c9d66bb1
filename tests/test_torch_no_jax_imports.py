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
from deepmimic_diffusion_mujoco_tpu_torch.cli import scaling as scaling_cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import sweep as sweep_cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import train as train_cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import workflows as workflows_cli
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import conditioning, process, schedules
from deepmimic_diffusion_mujoco_tpu_torch.diffusion.timestep_sampling import LossSecondMomentState
from deepmimic_diffusion_mujoco_tpu_torch.examples import end_to_end_walk
from deepmimic_diffusion_mujoco_tpu_torch.parallel import mesh as meshlib
from deepmimic_diffusion_mujoco_tpu_torch.parallel import multihost_check
from deepmimic_diffusion_mujoco_tpu_torch.physics import env as physics_env
from deepmimic_diffusion_mujoco_tpu_torch.physics.dynamics import DynamicsEnv
from deepmimic_diffusion_mujoco_tpu_torch.physics.plausibility import track_motions
from deepmimic_diffusion_mujoco_tpu_torch.physics.softrender import render_motion
from deepmimic_diffusion_mujoco_tpu_torch.train.config import ExperimentConfig, ModelConfig

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "deepmimic_diffusion_mujoco_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "deepmimic_diffusion_mujoco_tpu"}
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
NEW_MODULES = ["parallel/mesh.py", "parallel/tp.py", "parallel/multihost_check.py",
               "parallel/launch.py", "utils/profiling.py", "utils/rng.py", "cli/scaling.py",
               "utils/seq.py", "models/precision.py"]


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
    "multihost_check": lambda tmp: multihost_check.main([]),
    "scaling_main": lambda tmp: scaling_cli.main(["--widths", "1"]),
    "initialize_multihost": lambda tmp: meshlib.initialize_multihost(
        f"file://{tmp}/store", 1, 0),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_raises_without_cuda(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](tmp_path)


@pytest.mark.parametrize("arch", ["temporal", "transformer", "decoder", "local_attention"])
def test_bf16_config_builds(arch):
    """Each architecture builds at bf16 on the CPU: float32 parameters, a
    bf16 compute dtype, a float32 output."""
    cfg = ModelConfig(architecture=arch, bf16=True, channel_dim=16, latent_dim=32, depth=1,
                      num_layers=1, n_heads=2, dim_head=16, max_seq_len=16)
    model = factory.build_model(cfg, device="cpu").eval()
    assert model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 and not p.is_cuda for p in model.parameters())
    with torch.no_grad():
        out = model(torch.zeros(1, 16, cfg.input_dim), torch.zeros(1))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


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
    """Every local-attention option is ported: the global inserts build from
    a config and run, the KV-cache decode runs on a causal model, and
    training builds a trainer whose dropout is live as the JAX CLI sets it."""
    if case == "train_local_attention":
        cfg = ExperimentConfig.load(str(ROOT / "experiments" / "localattn5k_r3" / "config.json"))
        assert train_cli.has_dropout(cfg.model)
        assert not train_cli.has_dropout(cfg.override({"model.attn_dropout": 0.0,
                                                       "model.ff_dropout": 0.0}).model)
        return
    with torch.no_grad():
        if case == "global_attn":
            model = factory.build_model(_tiny_local(use_global_attn=True,
                                                    global_attn_layers=[1]), device="cpu")
            assert list(model.global_attn) == ["0"]
            out = model(torch.zeros(1, 16, model.input_dim), torch.zeros(1))
            assert out.shape == (1, 16, model.input_dim)
        else:
            model = factory.build_model(_tiny_local(), device="cpu").eval()
            out, cache = model(torch.zeros(1, 1, model.input_dim), torch.zeros(1),
                               cache=model.init_decode_cache(1), decode_pos=0)
            assert out.shape == (1, 1, model.input_dim) and len(cache) == 1
        assert torch.isfinite(out).all()


@pytest.mark.parametrize("layout", ["aba", "lanes", "vmap"])
def test_unported_dynamics_layouts_name_roadmap(layout):
    """Every dynamics layout is ported: each steps a 2-env batch to finite
    values on the CPU, and "auto" and "pallas" still mean the
    whole-control-step path."""
    from deepmimic_diffusion_mujoco_tpu_torch.data.mocap import load_clip

    clip = load_clip(str(ROOT / "data" / "motions" / "humanoid3d_walk.txt"))
    q = torch.tensor(clip.qpos[:2], dtype=torch.float32)
    v = torch.tensor(clip.qvel[:2], dtype=torch.float32)
    eng = DynamicsEnv(substeps=2, layout=layout)
    assert eng.layout == layout
    qp, qv = eng.step(q, v, torch.tensor(clip.qpos[1:3], dtype=torch.float32))
    assert qp.shape == (2, 35) and qv.shape == (2, 34)
    assert torch.isfinite(qp).all() and torch.isfinite(qv).all()
    assert DynamicsEnv(layout="pallas").layout == DynamicsEnv().layout == "pallas"


def test_rollout_sharded_names_roadmap(tmp_path):
    """rollout_sharded is ported: over a group of one it is rollout."""
    from _torch_dist_workers import WALK, one_rank_group
    from deepmimic_diffusion_mujoco_tpu_torch.data.mocap import load_clip

    clip = load_clip(str(WALK))
    env = physics_env.PhysicsTrackingEnv(clip.qpos, clip.qvel, substeps=2, device="cpu")
    state = env.reset(2)
    final, rewards = env.rollout(state, 1)
    with one_rank_group(tmp_path) as group:
        s_final, s_rewards = env.rollout_sharded(group, state, 1)
    assert torch.equal(s_rewards, rewards)
    assert all(torch.equal(a, b) for a, b in zip(s_final, final))


@pytest.mark.parametrize("module", NEW_MODULES)
def test_parallel_layer_modules_are_scanned(module):
    """The parallel layer, profiling and the scaling CLI are among the files
    test_no_jax_imports reads."""
    assert PORT / module in FILES


def _imported_modules(path: Path):
    pkg = path.relative_to(ROOT).with_suffix("").parts[:-1]
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = pkg[:len(pkg) - node.level + 1] if node.level else ()
            yield ".".join([*base, node.module or ""]).strip(".")


@pytest.mark.parametrize("layer", ["ops", "models", "utils"])
def test_lower_layers_do_not_import_the_parallel_layer(layer):
    """The kernels' wrappers, the models and the utilities (the batch-shaped
    draws of utils/rng.py among them) depend on neither parallel/ nor
    torch.distributed."""
    for path in sorted((PORT / layer).rglob("*.py")):
        bad = [m for m in _imported_modules(path)
               if m.startswith("torch.distributed") or ".parallel" in f".{m}"]
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
