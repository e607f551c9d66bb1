"""The port's parallel layer, part 1: the mesh helpers in one process, and
two gloo ranks against one process for the exact row gather, the
loss-aware sampler's update over a group and ``rollout_sharded``.

The two ranks run ``tests/_torch_dist_workers.py`` in fresh processes
(``parallel.launch.spawn_ranks``, a file store under ``tmp_path``); the
single-process reference is the same function run here as one rank.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dist_workers as W
from deepmimic_diffusion_mujoco_tpu_torch.parallel import mesh as meshlib
from deepmimic_diffusion_mujoco_tpu_torch.parallel.launch import spawn_ranks
from deepmimic_diffusion_mujoco_tpu_torch.utils import rng as rnglib

torch.set_num_threads(2)

SPAWN_TIMEOUT = 240.0


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """(rank 0's, rank 1's, one process's) results of gather_rollout_worker."""
    store = tmp_path_factory.mktemp("store")
    ranks = spawn_ranks(W.gather_rollout_worker, 2, str(store), device="cpu",
                        timeout=SPAWN_TIMEOUT, threads=1)
    return ranks[0], ranks[1], W.gather_rollout_worker(0, 1)


def test_all_gather_rows_is_exact_and_in_rank_order(two_ranks):
    r0, r1, _ = two_ranks
    for r in (r0, r1):
        np.testing.assert_array_equal(r["rows"][:, 0], [0, 1, 2, 1, 2, 3])
        np.testing.assert_array_equal(r["rows"][:, 1],
                                      np.float32(np.pi) * np.array([1, 1, 1, 2, 2, 2]))
        np.testing.assert_array_equal(r["ints"], [2 ** 40, 0, 7, 2 ** 40 + 1, -1, 7])
        np.testing.assert_array_equal(r["flags"], [True, False, True, False, True, True])
        assert r["rows"].dtype == np.float32 and r["ints"].dtype == np.int64


def test_update_with_losses_over_two_ranks_is_exact(two_ranks):
    """Each rank holds half of every (t, loss) batch; both end with the state
    one process gets from the whole batches, bit for bit."""
    r0, r1, one = two_ranks
    for r in (r0, r1):
        np.testing.assert_array_equal(r["sampler_losses"], one["sampler_losses"])
        np.testing.assert_array_equal(r["sampler_counts"], one["sampler_counts"])
    assert one["sampler_counts"].sum() > 0


def test_rollout_sharded_equals_rollout(two_ranks):
    """N envs split over two ranks (N/2 each): every rank returns the whole
    rollout's rewards and final state, exactly (the envs are independent)."""
    r0, r1, one = two_ranks
    keys = ["rewards", "final_frame", "final_qpos", "final_qvel", "final_done"]
    assert one["rewards"].shape == (W.ROLL_T, W.ROLL_N)
    for r in (r0, r1):
        for k in keys:
            assert r[k].dtype == one[k].dtype
            np.testing.assert_array_equal(r[k], one[k], err_msg=k)


def test_shard_batch_and_draw_rows():
    """shard_batch cuts rank r's equal rows out of a pytree; draw_rows draws
    at the global batch and keeps them, advancing the generator alike."""
    batch = {"x": np.arange(12).reshape(6, 2), "y": (np.arange(6), torch.arange(6))}

    full = torch.Generator().manual_seed(3)
    whole = torch.rand(6, 2, generator=full)
    for rank in range(3):
        g = rnglib.ShardGenerator("cpu", rank, 3).manual_seed(3)
        part = rnglib.draw_rows(g, (2, 2), lambda s: torch.rand(s, generator=g))
        torch.testing.assert_close(part, whole[2 * rank:2 * rank + 2], rtol=0, atol=0)
        assert torch.equal(g.get_state(), full.get_state())
    assert meshlib.shard_batch(None, batch) is batch
    assert meshlib.rank_and_world(None) == (0, 1)


@pytest.mark.parametrize("device, cards, ranks, local, backend", [
    ("cpu", 0, 2, None, "gloo"),
    ("cuda", 1, 1, None, "nccl"),
    ("cuda", 1, 2, None, "gloo"),      # two ranks share the one card
    ("cuda", 2, 2, None, "nccl"),
    ("cuda", 1, 2, "1", "nccl"),       # one rank a host, as torchrun says
    ("cuda", 8, 16, "8", "nccl"),
])
def test_initialize_multihost_picks_the_backend_from_cards_per_rank(
        monkeypatch, device, cards, ranks, local, backend):
    """The group's backend when none is named: NCCL where each rank on this
    host has a card, gloo on the CPU and where ranks share cards. cli.train
    and multihost_check start their groups through this call."""
    seen = {}
    monkeypatch.setattr(meshlib, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda b, **kw: seen.update(b=b, **kw))
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    dev = device if device == "cpu" else "cuda:0"
    assert meshlib.initialize_multihost("localhost:1", ranks, 0, device=dev) is True
    assert seen == {"b": backend, "init_method": "tcp://localhost:1", "world_size": ranks,
                    "rank": 0}
    assert meshlib.default_backend(torch.device(device), ranks if local is None
                                   else int(local)) == backend
    assert meshlib.initialize_multihost("localhost:1", ranks, 0, backend="gloo",
                                        device=dev) and seen["b"] == "gloo"


def test_one_rank_group_and_mesh(tmp_path):
    """In a group of one: initialize_multihost leaves an existing group and a
    flag-free call alone, make_mesh builds ("data", "seq") and checks its
    shape, the data group is found through the mesh, shard_batch keeps every
    row, the placements are DTensor's (seq_sharding's: rows over data,
    frames over seq)."""
    from torch.distributed.tensor import Replicate, Shard

    assert meshlib.initialize_multihost() is False
    with W.one_rank_group(tmp_path) as group:
        assert meshlib.initialize_multihost("localhost:1", 2, 0, device="cpu") is False
        mesh = meshlib.make_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == ("data", "seq") and tuple(mesh.shape) == (1, 1)
        assert meshlib.rank_and_world(mesh) == (0, 1)
        assert meshlib.batch_sharding(mesh) == (Shard(0), Replicate())
        assert meshlib.replicated(mesh) == (Replicate(), Replicate())
        x = np.arange(6)
        np.testing.assert_array_equal(meshlib.shard_batch(group, {"x": x})["x"], x)
        with pytest.raises(ValueError, match="mesh 2x1"):
            meshlib.make_mesh(data=2, device_type="cpu")
        sharding = meshlib.seq_sharding(mesh)
        assert sharding.placements == (Shard(0), Shard(1))
        assert (sharding.rank, sharding.world) == (0, 1)
        assert sharding.local_shape((4, 32, 35)) == (4, 32, 35)
        t = torch.tensor([1.0, 2.0])
        meshlib.all_reduce_mean([t], group)
        torch.testing.assert_close(t, torch.tensor([1.0, 2.0]), rtol=0, atol=0)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        meshlib.make_mesh(device_type="cpu")
