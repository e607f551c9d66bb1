"""Rank functions for the port's sequence-sharded sampling tests (gloo on
the CPU, the horizon split over the ranks of a (1, R) mesh).

``parallel.launch.spawn_ranks`` runs each in fresh processes that import
this module, not the test files, so it imports no JAX. Each rank returns
its own frames as numpy arrays; the tests put them together and compare
them with the one-process result and with JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from deepmimic_diffusion_mujoco_tpu_torch import factory
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import conditioning, sampling, schedules
from deepmimic_diffusion_mujoco_tpu_torch.models.local_attention import LocalTransformer
from deepmimic_diffusion_mujoco_tpu_torch.models.temporal_unet import TemporalUnet
from deepmimic_diffusion_mujoco_tpu_torch.ops import fused_local_attention as FK
from deepmimic_diffusion_mujoco_tpu_torch.parallel import mesh as meshlib
from deepmimic_diffusion_mujoco_tpu_torch.train.config import ModelConfig
from deepmimic_diffusion_mujoco_tpu_torch.utils import seq as seqlib

D = 35
CHAIN_SHAPE = (2, 512, D)   # tests/test_parallel.py:30-53's long-horizon chain
CHAIN_T = 5
GRID_SHAPE = (4, 128, D)    # a (2, 2) (data, seq) grid: 2 rows and 64 frames a rank
COND_SHAPE = (2, 64, D)     # the conditioned chains
COND_DIM = 8
COND_EDGE = 6               # inbetween's clamped frames at each end
LA = dict(max_seq_len=512, dim=32, depth=2, heads=2, dim_head=16, window_size=16)
LA_MASK_LENGTHS = (512, 300)
GLOBAL = dict(use_global_attn=True, global_attn_layers=(2,))


def unet(state: dict, dim: int, attention: bool = False) -> TemporalUnet:
    model = TemporalUnet(D, dim=dim, attention=attention)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model.eval()


def local_transformer(state: dict, **overrides) -> LocalTransformer:
    model = LocalTransformer(D, **{**LA, **overrides})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model.eval()


def conditioners(horizon: int):
    """name -> conditioner of the chains whose clamped frames must stay exact."""
    rng = np.random.default_rng(5)
    start, end = (rng.normal(size=(horizon, D)).astype(np.float32) for _ in range(2))
    return {
        "holding_box": conditioning.holding_box(D, device="cpu"),
        "inbetween": conditioning.chain(
            conditioning.holding_box(D, device="cpu"),
            conditioning.inbetween(start, end, horizon, COND_EDGE, device="cpu")),
    }


def chain(model, shape, generator_seed: int, x_sharding=None, conditioner=None,
          mode: str = "posterior"):
    sched = schedules.make_schedule("cosine", CHAIN_T, convention="diffuser", device="cpu")
    return sampling.sample_loop(sched, model, shape, torch.Generator().manual_seed(generator_seed),
                                mode=mode, conditioning_fn=conditioner, x_sharding=x_sharding,
                                ddim_steps=3 if mode == "ddim" else None).trajectories


def exact_parts(rank: int):
    """A rank's (B, n, 2) frames holding values all_reduce must bring back
    exactly: counters, pi times the rank, and large integers."""
    n = 8
    frames = torch.arange(n, dtype=torch.float32) + 100 * rank
    pi = torch.full((n,), float(np.float32(np.pi)) * (rank + 1))
    x = torch.stack([frames, pi], dim=-1)[None].repeat(2, 1, 1)
    ints = torch.arange(n, dtype=torch.int64)[None].repeat(2, 1) + 2 ** 40 + rank
    return x, ints


def seq_unet_worker(rank, world, states, forward_x, forward_t, chain_state, cond_state,
                    with_forwards=True):
    """The exact helpers, the dim-16 U-Net forwards (with and without
    attention) on this rank's frames, and the chains: the long posterior one
    and the conditioned ones."""
    mesh = meshlib.make_mesh(data=1, seq=world, device_type="cpu")
    shard = meshlib.seq_sharding(mesh)
    out = {}
    x, ints = exact_parts(rank)
    before, after, real = meshlib.exchange_halo(x, 3, 2, mesh)
    out.update(before=before.numpy(), after=after.numpy(), real=np.array(real),
               gathered=meshlib.gather_horizon(x, mesh).numpy(),
               gathered_ints=shard.gather_horizon(ints).numpy(),
               frames=np.array(shard.frames(x.shape[1] * world)))
    if with_forwards:
        xs = meshlib.shard_horizon(torch.from_numpy(forward_x), mesh)
        with torch.inference_mode(), seqlib.sharded(shard):
            for attention, state in states.items():
                y = unet(state, 16, attention)(xs, torch.from_numpy(forward_t))
                out[f"forward_attention_{attention}"] = y.numpy()
    out["chain"] = chain(unet(chain_state, 16), CHAIN_SHAPE, 1, shard).numpy()
    if world == 4:  # rows over "data", frames over "seq": this rank's block of the batch
        grid = meshlib.seq_sharding(meshlib.make_mesh(data=2, seq=2, device_type="cpu"))
        block = chain(unet(chain_state, 16), GRID_SHAPE, 1, grid)
        out["grid_chain"] = grid.gather(block).numpy()
        out["grid_block"] = (grid.data_rank, grid.rank, *block.shape)
    model = unet(cond_state, COND_DIM)
    for name, cond in conditioners(COND_SHAPE[1]).items():
        for mode in ("posterior", "ddim"):
            out[f"{name}_{mode}"] = chain(model, COND_SHAPE, 2, shard, cond, mode).numpy()
    return out


def seq_attention_worker(rank, world, qkv, state, global_state, x, t):
    """K3's plain version on this rank's QKV rows with one window of each
    neighbour's, and the LocalTransformer forward on this rank's frames:
    plain, with a prefix key mask, causal, with global inserts."""
    mesh = meshlib.make_mesh(data=1, seq=world, device_type="cpu")
    shard = meshlib.seq_sharding(mesh)
    heads, dh, w = 2, 16, 16
    out = {}
    with torch.inference_mode():
        rows = meshlib.shard_horizon(torch.from_numpy(qkv), mesh)
        slab, q0, pos0 = FK.halo_slab(rows, w, False, shard)
        out["attention"] = FK.local_attention_halo(slab, heads, dh, w, q0, rows.shape[1],
                                                   pos0).numpy()
        xs = meshlib.shard_horizon(torch.from_numpy(x), mesh)
        tt = torch.from_numpy(t)
        mask = (torch.arange(x.shape[1])[None] < torch.tensor(LA_MASK_LENGTHS)[:, None]).float()
        with seqlib.sharded(shard):
            out["model"] = local_transformer(state)(xs, tt).numpy()
            out["model_masked"] = local_transformer(state)(
                xs, tt, mask=meshlib.shard_horizon(mask, mesh)).numpy()
            out["model_causal"] = local_transformer(state, causal=True)(xs, tt).numpy()
            out["model_global"] = local_transformer(global_state, **GLOBAL)(xs, tt).numpy()
    return out


def built(cfg: dict, state: dict):
    """The model of a ``ModelConfig`` dict (bf16 or not) with ``state``."""
    model = factory.build_model(ModelConfig(**cfg), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model.eval()


def bf16_seq_worker(rank, world, models, chain_shape):
    """bf16 models on this rank's frames: ``models`` maps a name to (config
    dict, state, (x, t[, y])) for one forward each; the first is also run
    through a posterior chain of ``chain_shape`` with holding_box."""
    shard = meshlib.seq_sharding(meshlib.make_mesh(data=1, seq=world, device_type="cpu"))
    out = {}
    for name, (cfg, state, inputs) in models.items():
        model = built(cfg, state)
        x, *rest = (torch.from_numpy(a) for a in inputs)
        with torch.inference_mode(), seqlib.sharded(shard):
            out[name] = model(shard.shard(x).contiguous(), *rest).numpy()
    cfg, state, _ = next(iter(models.values()))
    out["chain"] = chain(built(cfg, state), chain_shape, 3, shard,
                         conditioning.holding_box(D, device="cpu")).numpy()
    return out
