"""Kernels and device time of the horizon-split U-Net on one CUDA card.

Two gloo ranks on the card split the dim-128 U-Net (D 35, mults 1, 2, 4, 8;
float32, or bf16 with ``--bf16``) at B 4 x H 1024, 512 frames a rank, from a
seeded init. After a forward and a DDIM-10 chain to warm up, each rank
reports the device kernels (and the copies and sets) of one sharded forward
and their device ms (torch.profiler; the 8 kernels that take the most), the
device ms of a DDIM step (every device activity of a DDIM-10 chain summed,
over 10), and the wall ms of a step (host clock over a chain without the
profiler, ended by a sync).

``--tree DIR`` profiles the port package found in DIR (an earlier commit
unpacked by ``git archive``, say), so that two trees can be measured in one
run on one card:

    python scripts/seq_split_profile.py [--tree DIR] [--bf16] [--seed 0] [--out FILE]

It prints one JSON line, needs a CUDA card and imports nothing of JAX.
``chip_smoke.py`` phases 21 and 24 take ``profile_rank`` from here.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import torch

B, H, D, DIM, T, STEPS, RANKS = 4, 1024, 35, 128, 1000, 10, 2


def device_events(fn):
    """fn() under torch.profiler, ended by a sync -> (kernels, copies and
    sets, Counter of device ms by name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = copies = 0
    by_name = Counter()
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        if e.name.startswith(("Memcpy", "Memset")):
            copies += 1
        else:
            kernels += 1
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    return kernels, copies, by_name


def profile_rank(forward, chain, steps: int, warm: bool = True) -> dict:
    """One rank's numbers for a sharded ``forward()`` and a ``chain()`` of
    ``steps`` steps (both warmed up first unless ``warm`` is False)."""
    if warm:
        forward()
        chain()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chain()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    kernels, copies, forward_ms = device_events(forward)
    _, _, chain_ms = device_events(chain)
    return {"forward_kernels": kernels, "forward_copies": copies,
            "forward_device_ms": sum(forward_ms.values()),
            "forward_top_kernels": [[name[:60], ms] for name, ms in forward_ms.most_common(8)],
            "step_device_ms": sum(chain_ms.values()) / steps,
            "step_wall_ms": wall_s * 1e3 / steps}


def _rank(rank, world, seed, bf16):
    from deepmimic_diffusion_mujoco_tpu_torch.diffusion import conditioning
    from deepmimic_diffusion_mujoco_tpu_torch.diffusion.sampling import sample_loop
    from deepmimic_diffusion_mujoco_tpu_torch.diffusion.schedules import make_schedule
    from deepmimic_diffusion_mujoco_tpu_torch.models.temporal_unet import TemporalUnet
    from deepmimic_diffusion_mujoco_tpu_torch.parallel import mesh as meshlib
    from deepmimic_diffusion_mujoco_tpu_torch.utils import seq as seqlib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    shard = meshlib.seq_sharding(meshlib.make_mesh(data=1, seq=world, device_type="cuda"))
    torch.manual_seed(seed)
    model = TemporalUnet(D, dim=DIM, dtype=torch.bfloat16 if bf16 else torch.float32)
    model = model.to(dev).eval()
    g = torch.Generator().manual_seed(seed + 33)
    x = torch.randn(B, H, D, generator=g).to(dev)
    t = torch.randint(0, T, (B,), generator=g).to(dev)
    xs = shard.shard(x).contiguous()
    sched = make_schedule("cosine", T, convention="diffuser", device=dev)

    def forward():
        with torch.inference_mode(), seqlib.sharded(shard):
            return model(xs, t)

    def chain():
        return sample_loop(sched, model, (B, H, D),
                           torch.Generator(device=dev).manual_seed(seed + 30), mode="ddim",
                           ddim_steps=STEPS, prediction="x0",
                           conditioning_fn=conditioning.holding_box(D, device=dev),
                           x_sharding=shard).trajectories

    return profile_rank(forward, chain, STEPS)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                    help="directory holding the deepmimic_diffusion_mujoco_tpu_torch package")
    ap.add_argument("--bf16", action="store_true", help="build the U-Net at bf16")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("seq_split_profile: needs a CUDA card")
    tree = str(Path(args.tree).resolve())
    sys.path.insert(0, tree)  # the ranks inherit it
    from deepmimic_diffusion_mujoco_tpu_torch.parallel.launch import spawn_ranks

    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_ranks(_rank, RANKS, tmp, device="cuda", args=(args.seed, args.bf16),
                            timeout=600.0)
    row = {"tree": tree, "bf16": args.bf16, "B": B, "H": H, "ranks": RANKS, "steps": STEPS,
           "device": torch.cuda.get_device_name(0), "per_rank": ranks}
    line = json.dumps(row)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
