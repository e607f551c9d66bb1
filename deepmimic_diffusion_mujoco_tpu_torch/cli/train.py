"""Training CLI of the PyTorch port.

    python -m deepmimic_diffusion_mujoco_tpu_torch.cli.train \
        --config cfg.json --data data/motions --steps 5000 --out experiments/run1 \
        [--resume] [--set train.lr=1e-4 ...] [--device cuda]

Counterpart of ``deepmimic_diffusion_mujoco_tpu/cli/train.py`` with the
same flags plus ``--device`` (default ``cuda``; it raises if no card is
present). The run directory gets ``config.json``, checkpoints
(``checkpoints/state_<step>.pt``, ``best_model.pt``, each with its JSON
sidecar; see ``train/checkpoint.py``) and ``training_metrics.json``, which
the port's ``cli/sample.py`` reads back.

As in the JAX CLI, ``train.gradient_accumulate_every = k`` averages k
micro-batches of ``train.batch_size`` per optimizer update, and the EMA
gates count micro-steps (``train/state.py``). It trains every architecture
of the port: the temporal U-Net, the MDM transformer
(``architecture="transformer"``), the local-attention transformer
(``local_attention``; its attention through B3 on the card, with the
dropout keep mask) and the decoder (``decoder``); for the three
transformers the dataset is cut to ``model.max_seq_len`` frames, the rows
of their position tables. Every loss kind (``diffusion.loss``: diffuser,
v4, x0, kl, angle_velocity), CFG label drop toward the null label
``num_classes``, dropout where the config turns it on (as the JAX CLI's
``has_dropout``: ``transformer`` with ``dropout``, ``local_attention`` with
``attn_dropout`` or ``ff_dropout`` > 0), and
``train.timestep_sampler="loss_aware"`` (v4 only, as in JAX).

Data-parallel: launched by ``torchrun`` (``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``), or given the JAX CLI's ``--coordinator host:port
--num-processes R --process-id r`` on each process, it trains over R ranks
(``train/loop.py``): ``train.batch_size`` is the global batch and must
split evenly over them, as the JAX CLI's data mesh requires. Each rank
takes ``cuda:LOCAL_RANK`` (rank modulo the cards when ranks share them;
the group then runs gloo, as NCCL refuses two ranks on one card:
``parallel.mesh.default_backend``). Rank 0
alone writes the config, checkpoints, ``training_metrics.json`` and logs;
every rank reads a checkpoint on ``--resume``.

    torchrun --nproc-per-node 8 -m deepmimic_diffusion_mujoco_tpu_torch.cli.train \
        --config cfg.json --out experiments/run1
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch
import torch.distributed as dist

from .. import factory
from ..data.datasets import MotionDataset
from ..device import resolve_device
from ..diffusion import process
from ..diffusion.timestep_sampling import LossSecondMomentState
from ..parallel import mesh as meshlib
from ..train.checkpoint import Checkpointer
from ..train.config import ExperimentConfig
from ..train.loop import Trainer, TrainerConfig, make_loss_fn
from ..train.state import EMAConfig, TrainState, make_optimizer


def has_dropout(m) -> bool:
    """Whether dropout is live in training: the architectures that define
    it, with a rate above 0 (the JAX CLI's ``has_dropout``)."""
    return ((m.architecture == "transformer" and m.dropout > 0)
            or (m.architecture == "local_attention"
                and (m.attn_dropout > 0 or m.ff_dropout > 0)))


def build_trainer(cfg: ExperimentConfig, out_dir: str | None = None, resume: bool = False,
                  device: str | torch.device = "cuda", group=None) -> Trainer:
    """``resume=True`` restores the latest periodic checkpoint in
    ``out_dir``. ``group``: train data-parallel over that process group;
    rank 0 alone checkpoints and logs."""
    dev = resolve_device(device)
    rank, _ = meshlib.rank_and_world(group)
    if cfg.train.timestep_sampler == "loss_aware" and cfg.diffusion.loss != "v4":
        raise ValueError("timestep_sampler=loss_aware requires diffusion.loss=v4")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.train.seed)
        model, sched = factory.build_experiment(cfg, dev)
    ds = MotionDataset.from_path(
        cfg.data.path,
        include_velocity=cfg.data.include_velocity,
        augment=cfg.data.augment,
        replicas=cfg.data.replicas,
        horizon_multiple=cfg.data.horizon_multiple,
        max_files=cfg.data.max_files,
    )
    if cfg.model.architecture != "temporal":
        # a learned position table has max_seq_len rows: longer batches would fail
        ds = ds.truncated(cfg.model.max_seq_len)
    t = cfg.train
    opt, lr_sched = make_optimizer(
        model.parameters(), t.optimizer_type, lr=t.lr, weight_decay=t.weight_decay,
        betas=tuple(t.betas), schedule=t.scheduler_type, num_train_steps=t.num_train_steps,
    )
    state = TrainState(model, opt, lr_sched, EMAConfig(t.ema_decay, t.ema_start, t.ema_every),
                       accum=t.gradient_accumulate_every)
    d = cfg.diffusion
    weights = None
    if d.loss == "diffuser":
        weights = process.diffuser_loss_weights(
            ds.horizon, cfg.model.input_dim, d.action_weight, d.loss_discount, device=dev)
    loss_fn = make_loss_fn(
        sched, model, kind=d.loss, predict_epsilon=not d.predict_x0,
        weights=weights, loss_kind=d.loss_kind, label_drop_prob=t.label_drop_prob,
        null_label=cfg.model.num_classes or None, smooth_loss_weight=d.smooth_loss_weight,
        use_mask=d.loss in ("v4", "x0"),
        dropout=has_dropout(cfg.model), group=group,
    )

    ckpt = None
    if out_dir:
        ckpt = Checkpointer(os.path.join(out_dir, "checkpoints"), metadata=dataclasses.asdict(cfg))
        if resume and ckpt.latest_step() is not None:
            payload, _ = ckpt.restore(map_location=dev)
            state.load(payload)
            print(f"resumed from step {state.step}")
        if rank:
            ckpt = None
    return Trainer(
        state, loss_fn, ds,
        TrainerConfig(
            num_train_steps=t.num_train_steps,
            batch_size=t.batch_size,
            gradient_accumulate_every=t.gradient_accumulate_every,
            log_every=t.log_every,
            save_every=t.save_every,
            seed=t.seed,
            scan_chunk=t.scan_chunk,
            class_balanced=t.class_balanced,
        ),
        checkpointer=ckpt,
        log_fn=print if rank == 0 else (lambda _: None),
        num_timesteps=sched.num_timesteps,
        sampler_state=(LossSecondMomentState.create(sched.num_timesteps, device=dev)
                       if t.timestep_sampler == "loss_aware" else None),
        group=group,
    )


def main(argv=None) -> Trainer:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", help="ExperimentConfig JSON")
    p.add_argument("--data", help="clip file or directory override")
    p.add_argument("--architecture", help="model override")
    p.add_argument("--steps", type=int)
    p.add_argument("--batch-size", type=int)
    p.add_argument("--out", default="experiments/run")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in --out")
    p.add_argument("--set", nargs="*", default=[],
                   help="dotted overrides, e.g. train.lr=1e-4")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain versions)")
    p.add_argument("--coordinator", default=None,
                   help="data-parallel: rendezvous address host:port (or a torch init method)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    started = False
    if args.coordinator or args.num_processes or "WORLD_SIZE" in os.environ:
        n = args.num_processes or int(os.environ["WORLD_SIZE"])
        r = args.process_id if args.process_id is not None else int(os.environ["RANK"])
        if dev.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", r))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        started = meshlib.initialize_multihost(args.coordinator or "env://", n, r, device=dev)
    try:
        return _train(args, dev, dist.group.WORLD if dist.is_initialized() else None)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, dev, group) -> Trainer:
    rank, _ = meshlib.rank_and_world(group)
    # float32 throughout: no TF32 in cuDNN's convolutions or cuBLAS's matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ExperimentConfig.load(args.config) if args.config else ExperimentConfig()
    if args.data:
        cfg = cfg.override({"data.path": args.data})
    if args.architecture:
        cfg = cfg.override({"model.architecture": args.architecture})
    if args.steps:
        cfg = cfg.override({"train.num_train_steps": args.steps})
    if args.batch_size:
        cfg = cfg.override({"train.batch_size": args.batch_size})
    for ov in args.set:
        key, _, val = ov.partition("=")
        try:
            parsed = json.loads(val)
        except json.JSONDecodeError:
            parsed = val  # bare string, e.g. data.augment=replicate
        cfg = cfg.override({key: parsed})

    os.makedirs(args.out, exist_ok=True)
    if rank == 0:
        cfg.save(os.path.join(args.out, "config.json"))
    trainer = build_trainer(cfg, args.out, resume=args.resume, device=dev, group=group)
    trainer.train()
    if rank == 0:
        trainer.save_metrics(os.path.join(args.out, "training_metrics.json"))
        print(f"done: best loss {trainer.best_loss:.6f} @ step {trainer.best_step}")
    return trainer


if __name__ == "__main__":
    main()
