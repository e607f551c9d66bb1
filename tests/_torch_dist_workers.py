"""Rank functions for the port's multi-process tests (gloo on the CPU).

``parallel.launch.spawn_ranks`` runs each in fresh processes that import
this module, not the test files, so it imports no JAX. Each returns numpy
arrays, which the test compares with the same function run in the test's
own process as one rank (``group`` None).
"""
from __future__ import annotations

import contextlib
import io
import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from deepmimic_diffusion_mujoco_tpu_torch.cli import train as train_cli
from deepmimic_diffusion_mujoco_tpu_torch.data.mocap import load_clip
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import timestep_sampling as ts
from deepmimic_diffusion_mujoco_tpu_torch.parallel import mesh as meshlib
from deepmimic_diffusion_mujoco_tpu_torch.physics.env import PhysicsTrackingEnv
from deepmimic_diffusion_mujoco_tpu_torch.train.config import ExperimentConfig

ROOT = Path(__file__).resolve().parents[1]
EXP = ROOT / "experiments"
MOTIONS = ROOT / "data" / "motions"
WALK = MOTIONS / "humanoid3d_walk.txt"


def world_group(world):
    return dist.group.WORLD if world > 1 else None


@contextlib.contextmanager
def one_rank_group(store_dir):
    """A gloo group of this process alone, rendezvous in a file store."""
    dist.init_process_group("gloo", init_method=f"file://{store_dir}/one_rank_store",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


# -- gathers, the loss-aware sampler and the sharded rollout -----------------

SAMPLER_T, SAMPLER_HIST, SAMPLER_B, SAMPLER_ROUNDS = 12, 4, 8, 6
ROLL_N, ROLL_T, ROLL_SUBSTEPS = 4, 2, 2


def sampler_batches():
    """Global (t, loss) batches with repeats of one t inside a batch."""
    rng = np.random.default_rng(11)
    return [(rng.integers(0, SAMPLER_T, SAMPLER_B), rng.gamma(2.0, size=SAMPLER_B)
             .astype(np.float32)) for _ in range(SAMPLER_ROUNDS)]


def gather_rollout_worker(rank, world):
    group = world_group(world)
    out = {}
    if group is not None:
        # each rank's rows hold values of every kind all_gather_rows promises back exactly
        rows = torch.stack([torch.arange(3, dtype=torch.float32) + rank, torch.full(
            (3,), float(np.float32(np.pi)) * (rank + 1))]).T.contiguous()
        ints = torch.tensor([2 ** 40 + rank, -rank, 7], dtype=torch.int64)
        flags = torch.tensor([rank == 0, rank == 1, True])
        g_rows, g_ints, g_flags = meshlib.all_gather_rows([rows, ints, flags], group)
        out.update(rows=g_rows.numpy(), ints=g_ints.numpy(), flags=g_flags.numpy())
    state = ts.LossSecondMomentState.create(SAMPLER_T, SAMPLER_HIST, device="cpu")
    for t, losses in sampler_batches():
        t, losses = meshlib.shard_batch(group, (torch.from_numpy(t), torch.from_numpy(losses)))
        ts.update_with_losses(state, t, losses, group)
    out.update(sampler_losses=state.losses.numpy(), sampler_counts=state.counts.numpy())

    clip = load_clip(str(WALK))
    env = PhysicsTrackingEnv(clip.qpos, clip.qvel, substeps=ROLL_SUBSTEPS, device="cpu")
    start = env.reset(ROLL_N)
    if group is None:
        final, rewards = env.rollout(start, ROLL_T)
    else:
        final, rewards = env.rollout_sharded(meshlib.make_mesh(device_type="cpu"), start,
                                             ROLL_T)
    out.update(rewards=rewards.numpy(), **{f"final_{k}": v.numpy()
                                           for k, v in final._asdict().items()})
    return out


# -- data-parallel training ---------------------------------------------------

def train_config(case: str) -> ExperimentConfig:
    """Small configs of the repo's experiments, with their losses, masks,
    label drop and dropout as the experiments set them."""
    common = {"diffusion.noise_steps": 20, "train.log_every": 1, "train.scan_chunk": 1,
              "train.lr": 1e-3}
    if case == "unet":
        cfg = ExperimentConfig.load(str(EXP / "unet_walk10k" / "config.json"))
        return cfg.override({**common, "data.path": str(WALK), "model.channel_dim": 8,
                             "train.batch_size": 4, "train.gradient_accumulate_every": 2})
    if case in ("b_x0", "b_loss_aware"):
        cfg = ExperimentConfig.load(str(EXP / "allclips12k_r5" / "config.json"))
        over = {**common, "data.path": str(MOTIONS), "model.latent_dim": 32,
                "model.num_layers": 1, "model.n_heads": 2, "model.dim_feedforward": 64,
                "model.max_seq_len": 40, "train.batch_size": 8, "train.class_balanced": True,
                "train.seed": 1}
        if case == "b_loss_aware":
            over.update({"diffusion.loss": "v4", "train.timestep_sampler": "loss_aware"})
        return cfg.override(over)
    if case == "local":
        cfg = ExperimentConfig.load(str(EXP / "localattn5k_r3" / "config.json"))
        return cfg.override({**common, "model.latent_dim": 32, "model.depth": 1,
                             "model.n_heads": 2, "model.dim_head": 16, "model.max_seq_len": 40,
                             "data.path": str(MOTIONS / "humanoid3d_dance_a.txt"),
                             "train.batch_size": 4})
    raise ValueError(case)


TRAIN_CASES = ("unet", "b_x0", "b_loss_aware", "local")
MORE_STEPS = 2


def _numpy(d):
    return {k: v.detach().numpy().copy() for k, v in d.items()}


def train_worker(rank, world, cli_out=None):
    """Per case: one optimizer step (its averaged gradients and loss), then
    MORE_STEPS more; the parameters, EMA and sampler state after them. With
    ``cli_out``, one ``cli.train.main`` run of the U-Net case too."""
    group = world_group(world)
    out = {}
    for case in TRAIN_CASES:
        cfg = train_config(case)
        trainer = train_cli.build_trainer(cfg, device="cpu", group=group)
        trainer.log_fn = lambda _: None
        model, state = trainer.state.model, trainer.state
        first = next(trainer.dataset.epochs(cfg.train.batch_size, seed=cfg.train.seed,
                                            class_balanced=cfg.train.class_balanced))
        grads, apply = [], state.apply_gradients

        def apply_and_keep():  # the gradients the update sees, averaged over the ranks
            grads.append({n: p.grad.numpy().copy() for n, p in model.named_parameters()})
            apply()

        state.apply_gradients = apply_and_keep
        trainer.train(1)
        res = {"grads": grads[0], "first_loss": trainer.metrics[0]["loss"],
               "first_params": _numpy(model.state_dict()),
               "valid_frames": first.mask.reshape(2, -1).sum(1)}
        trainer.train(MORE_STEPS)
        res.update(params=_numpy(model.state_dict()), ema=_numpy(trainer.state.ema_params),
                   losses=[m["loss"] for m in trainer.metrics])
        if trainer.sampler_state is not None:
            res.update(sampler_losses=trainer.sampler_state.losses.numpy(),
                       sampler_counts=trainer.sampler_state.counts.numpy())
        out[case] = res
    if cli_out is not None:
        out["cli"] = cli_train(cli_out)
    return out


def cli_train(out_dir):
    cfg = train_config("unet")
    cfg_path = os.path.join(out_dir, "base.json")
    if not dist.is_initialized() or dist.get_rank() == 0:
        os.makedirs(out_dir, exist_ok=True)
        cfg.save(cfg_path)
    if dist.is_initialized():
        dist.barrier()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        trainer = train_cli.main(["--config", cfg_path, "--steps", "2", "--out", out_dir,
                                  "--device", "cpu"])
    return {"params": _numpy(trainer.state.model.state_dict()),
            "printed_lines": len(printed.getvalue().splitlines()),
            "wrote_metrics": os.path.exists(os.path.join(out_dir, "training_metrics.json"))}


# -- tensor parallel ------------------------------------------------------------

TP_B, TP_H = 2, 24


def tp_model_and_inputs():
    from deepmimic_diffusion_mujoco_tpu_torch import factory

    cfg = ExperimentConfig.load(str(EXP / "allclips12k_r5" / "config.json")).override(
        {"model.latent_dim": 64, "model.n_heads": 4, "model.num_layers": 2,
         "model.dim_feedforward": 128, "model.max_seq_len": TP_H})
    torch.manual_seed(5)
    model = factory.build_model(cfg.model, "cpu").eval()
    with torch.no_grad():  # random everywhere: adaLN-zero would zero every branch
        for p in model.parameters():
            p.normal_(0.0, 0.3 / max(1, p.shape[-1]) ** 0.5)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(TP_B, TP_H, cfg.model.input_dim)).astype(np.float32))
    t = torch.tensor([3, 900])
    y = torch.tensor([1, 9])
    mask = torch.ones(TP_B, TP_H, dtype=torch.bool)
    mask[1, 17:] = False
    return model, (x, t, y, mask)


def tp_worker(rank, world):
    from deepmimic_diffusion_mujoco_tpu_torch.parallel import tp

    model, (x, t, y, mask) = tp_model_and_inputs()
    mesh = meshlib.make_mesh(data=1, seq=world, device_type="cpu")
    plan = tp.shard_params(model, mesh["seq"])
    with torch.no_grad():
        out = model(x, t, y, mask=mask)
    local = {n: tuple(p.to_local().shape) for n, p in model.named_parameters()
             if hasattr(p, "to_local")}
    return {"out": out.numpy(), "plan": sorted(plan), "local_shapes": local}
