"""Multi-process check: one real data-parallel train step across processes.

Counterpart of ``deepmimic_diffusion_mujoco_tpu/parallel/multihost_check.py``:
each of R processes joins the group (``parallel.mesh.initialize_multihost``),
takes its LOCAL rows of one deterministic global batch
(``parallel.mesh.shard_batch``) and runs ONE train step of the U-Net's
diffusion loss (``train.loop.train_step`` with the gradients averaged over
the ranks; t and noise drawn at the global batch and cut to the rank's
rows). It prints the loss and a parameter checksum, which must be
bit-identical across the processes and equal, to float32 tolerance, to the
single-process run of the same global batch that the flag-free command
computes: the SPMD contract.

    # each process (host), e.g. two on one machine:
    python -m deepmimic_diffusion_mujoco_tpu_torch.parallel.multihost_check \\
        --coordinator 127.0.0.1:29580 --num-processes 2 --process-id 0
    # the oracle: one process, no flags
    python -m deepmimic_diffusion_mujoco_tpu_torch.parallel.multihost_check

``--device`` is ``cuda`` by default (rank r takes card r modulo the cards;
NCCL, or gloo where ranks share a card: ``parallel.mesh.default_backend``)
and raises without a card; ``--device cpu`` runs on gloo.

``--seq S`` builds JAX's (data, seq) process grid: the R processes form an
(R / S) x S mesh (``parallel.mesh.make_mesh``), the rows are split over its
"data" dimension, and the S ranks of one seq group feed the same rows and
hold the same replicated step (the train step shards nothing over the
horizon). The loss and checksum are still the one-process run's:

    # four processes, a 2 x 2 (data, seq) grid
    python -m deepmimic_diffusion_mujoco_tpu_torch.parallel.multihost_check \
        --coordinator 127.0.0.1:29580 --num-processes 4 --process-id 0 --seq 2
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def run_check(coordinator: str | None = None, num_processes: int = 1, process_id: int = 0,
              batch_size: int = 16, horizon: int = 16, dim: int = 32,
              device: str | torch.device = "cuda", seq: int = 1) -> dict:
    """One step in this process; a group of ``num_processes`` > 1 is joined
    first unless one exists. ``seq`` > 1 runs the step on the (data, seq)
    mesh of the group's ranks. -> the loss, the checksum and launch counts."""
    import torch.distributed as dist

    from ..device import resolve_device
    from ..diffusion import process, schedules
    from ..models.temporal_unet import TemporalUnet
    from ..ops import conv_block_kernel as CB
    from ..ops import conv_weight_grad as CW
    from ..train.loop import make_loss_fn, train_step
    from ..train.state import TrainState, make_optimizer
    from ..utils import rng
    from . import mesh as meshlib

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    started = False
    if num_processes > 1:
        started = meshlib.initialize_multihost(coordinator, num_processes, process_id,
                                               device=dev)
    try:
        group = dist.group.WORLD if dist.is_initialized() else None
        if seq > 1:
            if group is None:
                raise ValueError(f"--seq {seq} needs a group of processes (the one-process "
                                 "oracle runs without flags)")
            group = meshlib.make_mesh(seq=seq, device_type=dev.type)
        rank, world = meshlib.rank_and_world(group)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        sched = schedules.make_schedule("cosine", 100, convention="diffuser", device=dev)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = TemporalUnet(35, dim=dim).to(dev)
        # the deterministic GLOBAL batch; this rank's equal slice of it
        global_x = np.random.default_rng(7).normal(size=(batch_size, horizon, 35))
        x0 = torch.from_numpy(meshlib.shard_batch(group, global_x).astype(np.float32)).to(dev)
        g = rng.ShardGenerator(dev, rank, world).manual_seed(3)
        n = x0.shape[0]
        t = rng.draw_rows(g, (n,), lambda s: torch.randint(0, 100, s, generator=g,
                                                               device=dev))
        noise = rng.draw_rows(g, x0.shape, lambda s: torch.randn(s, generator=g, device=dev))
        weights = process.diffuser_loss_weights(horizon, 35, device=dev)
        loss_fn = make_loss_fn(sched, model, "diffuser", weights=weights)
        opt, lr_sched = make_optimizer(model.parameters(), "adam", lr=1e-3)
        state = TrainState(model, opt, lr_sched)
        b1, b2 = CB.conv_gn_mish_cuda.launches, CW.conv1d_weight_grad_cuda.launches
        loss, _ = train_step(state, loss_fn, x0, t, noise, group=group)
        checksum = sum(float(p.detach().abs().double().sum()) for p in model.parameters())
        return {"process_id": dist.get_rank() if group is not None else 0,
                "process_count": dist.get_world_size() if group is not None else 1,
                "data_rank": rank, "data_ranks": world, "seq": seq, "device": str(dev),
                "backend": dist.get_backend() if group is not None else None,
                "loss": float(loss), "param_checksum": checksum,
                "conv_gn_mish_launches": CB.conv_gn_mish_cuda.launches - b1,
                "conv1d_weight_grad_launches": CW.conv1d_weight_grad_cuda.launches - b2}
    finally:
        if started:
            dist.destroy_process_group()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--coordinator", default=None,
                    help="host:port (or a torch init method) of the rendezvous")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seq", type=int, default=1,
                    help="the mesh's seq dimension (data = processes // seq)")
    args = ap.parse_args(argv)
    out = run_check(args.coordinator, args.num_processes, args.process_id,
                    device=args.device, seq=args.seq)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
