"""The lane groups of the humanoid kernels (B5, B6, B7) and their launch
plan (``physics/dynamics_kernel.py``: ``chains``, ``chain_tables``,
``lane_items``, ``dynamics_plan``), checked in Python against the link tree
and the plain version's order of sums.

The kernels run only on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``); which lane does what, and in which order the chains
meet, is generated here, so it is checked here: every link, contact point,
body, torque and reward item has exactly one lane, each chain walks its
links in tree order, and every join adds its children in the plain
version's order.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu_torch.physics import dynamics_kernel as DK
from deepmimic_diffusion_mujoco_tpu_torch.physics import dynamics_sweep as SW
from deepmimic_diffusion_mujoco_tpu_torch.physics.dynamics_aba import LINK_CARRIER, LINK_PARENT

SOURCE = Path(DK.__file__).resolve().parent.parent / "csrc" / "humanoid_dynamics.cu"
SMEM = 232448  # an H100 block's shared memory


@pytest.fixture(scope="module")
def ct():
    return DK.chain_tables()


def test_every_link_has_one_owning_chain():
    owners = [li for ch in DK.chains() for li, own in ch if own]
    assert sorted(owners) == list(range(DK.NJ))
    assert len(DK.chains()) == DK.NROLES == 5


@pytest.mark.parametrize("r", range(5))
def test_chains_walk_their_links_in_tree_order(r):
    path = [li for li, _ in DK.chains()[r]]
    assert LINK_PARENT[path[0]] == -1
    for a, b in zip(path, path[1:]):
        assert LINK_PARENT[b] == a
    # the owned links are a tail of the path: a chain walks its own links last
    owned = [own for _, own in DK.chains()[r]]
    assert owned == sorted(owned)


def test_chain_tables_follow_the_bodies(ct):
    """Body starts, carriers, axes and anchors per (chain, slot) are the
    link tables' own; a body starts where its first hinge is."""
    for r in range(DK.NROLES):
        for k in range(DK.N_CHAIN_SLOTS):
            li = ct["link"][r, k]
            if li < 0:
                assert (ct["link"][r, k:] < 0).all()
                continue
            assert ct["carrier"][r, k] == LINK_CARRIER[li]
            np.testing.assert_array_equal(ct["axis"][r, k], DK.JOINT_AXIS[li])
            assert ct["anchor"][r, k] == DK.JOINT_ANCHOR[li][0]
            b = ct["start"][r, k]
            if b >= 0:
                assert DK._first_links()[b] == li
                np.testing.assert_allclose(ct["offset"][r, k], DK.BODIES[b].offset)


def _chain_fk(ct, qpos):
    """The kernel's chain walk (FK only), in float64: each body's pose as the
    chain that owns its last link writes it."""
    qp = [torch.tensor([float(x)], dtype=torch.float64) for x in qpos]
    pos, quat, *_ = DK._fk(qp, want_dofs=False)
    out = {0: (pos[0], quat[0])}
    for r in range(DK.NROLES):
        ppar, qpar = pos[0], quat[0]
        ql, tl = (1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0)
        off, body, owned_last = tuple(ct["offset"][r, 0]), ct["start"][r, 0], False
        for k in range(DK.N_CHAIN_SLOTS):
            li = ct["link"][r, k]
            if li < 0:
                break
            if k > 0 and ct["start"][r, k] >= 0:
                pb = DK._add(ppar, DK._qrot(qpar, DK._add(off, tl)))
                qb = DK._qmul(qpar, ql)
                if owned_last:
                    out[body] = (pb, qb)
                ppar, qpar, ql, tl = pb, qb, (1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0)
                off, body = tuple(ct["offset"][r, k]), ct["start"][r, k]
            a = tuple(ct["axis"][r, k])
            pk = (float(ct["anchor"][r, k]), 0.0, 0.0)
            half = 0.5 * qp[7 + li]
            qk = (torch.cos(half), torch.sin(half) * a[0], torch.sin(half) * a[1],
                  torch.sin(half) * a[2])
            tl = DK._add(tl, DK._qrot(ql, DK._sub(pk, DK._qrot(qk, pk))))
            ql = DK._qmul(ql, qk)
            owned_last = bool(ct["owned"][r, k])
        if owned_last:
            out[body] = (DK._add(ppar, DK._qrot(qpar, DK._add(off, tl))), DK._qmul(qpar, ql))
    return out, pos, quat


def test_chain_walk_gives_every_body_pose(ct):
    rng = np.random.default_rng(0)
    qpos = np.concatenate([[0.1, -0.2, 0.9], [0.9, 0.1, -0.3, 0.2], rng.uniform(-1, 1, DK.NJ)])
    got, pos, quat = _chain_fk(ct, qpos)
    assert sorted(got) == list(range(DK.NB))
    for b in range(DK.NB):
        np.testing.assert_allclose(torch.cat(got[b][0]).numpy(), torch.cat(pos[b]).numpy(),
                                   atol=1e-12)
        np.testing.assert_allclose(torch.cat(got[b][1]).numpy(), torch.cat(quat[b]).numpy(),
                                   atol=1e-12)


def test_joins_add_children_in_the_plain_order(ct):
    """The backward sweep adds a link's children in descending link order
    (the plain version's loop): at the join, the listed chains and then the
    owner's own next link; at the root, the listed chains."""
    children = {p: sorted([i for i in range(DK.NJ) if LINK_PARENT[i] == p], reverse=True)
                for p in range(-1, DK.NJ)}
    first = {r: ct["link"][r, ct["first_owned"][r]] for r in range(DK.NROLES)}
    jl, owner, slot = ct["join_link"], ct["join_owner"], ct["join_slot"]
    assert ct["link"][owner, slot] == jl and ct["owned"][owner, slot]
    own_child = ct["link"][owner, slot + 1]
    assert [first[r] for r in ct["join_roles"]] + [own_child] == children[jl]
    assert [first[r] for r in ct["root_roles"]] == children[-1]
    # every link with more than one child, or hanging from another chain's link, is a join
    forks = [p for p, c in children.items() if p >= 0 and len(c) > 1]
    assert forks == [jl]
    for r in range(DK.NROLES):
        parent = LINK_PARENT[first[r]]
        assert r in (ct["root_roles"] if parent < 0 else ct["join_roles"] + [owner])


@pytest.mark.parametrize("lanes", DK.LANE_COUNTS)
def test_every_item_has_one_lane(lanes):
    it = DK.lane_items(lanes)
    assert len(it["bodies"]) == lanes
    assert sorted(b for lst in it["bodies"] for b in lst) == list(range(DK.NB))
    assert sorted(c for lst in it["contacts"] for c in lst) == list(range(DK.NC))
    assert sorted(j for lst in it["joints"] for j in lst) == list(range(len(DK.BODY_JOINTS)))
    assert sorted(e for lst in it["ees"] for e in lst) == list(range(len(DK._EE_BODIES)))
    assert sorted(g for lst in it["geoms"] for g in lst) == list(range(len(DK._GEOMS)))


@pytest.mark.parametrize("lanes", DK.LANE_COUNTS)
def test_leg_contacts_are_spread(lanes):
    """The legs' 24 contact points sit on more than two lanes, no lane
    computes more than its share of points, and no lane owns both feet."""
    it = DK.lane_items(lanes)
    leg_bodies = {7, 8, 9, 10, 11, 12}
    legs = [c for c in range(DK.NC) if DK._CBODY[c] in leg_bodies]
    assert len(legs) == 24
    assert len([lst for lst in it["contacts"] if set(legs) & set(lst)]) > 2
    assert max(len(lst) for lst in it["contacts"]) == -(-DK.NC // lanes)
    assert all(len({9, 12} & set(lst)) <= 1 for lst in it["bodies"])


def test_torques_belong_to_the_owning_chain():
    """A link's PD torque is computed by the chain that owns it, so the 28
    torques are spread over the five chains, each exactly once."""
    per_chain = [[li for li, own in ch if own] for ch in DK.chains()]
    assert sorted(sum(per_chain, [])) == list(range(DK.NJ))
    assert max(len(x) for x in per_chain) <= DK.N_CHAIN_SLOTS


def test_slot_layout_matches_the_source():
    """SLOT_FLOATS counts the floats of ``struct Slot`` as the source
    declares it (the source static_asserts the same size)."""
    text = SOURCE.read_text()
    body = re.search(r"struct Slot \{(.*?)\n\};", text, re.S).group(1)
    sizes = dict(NQ=DK.NQ, NV=DK.NV, NB=DK.NB, NJ=DK.NJ, WORK_FLOATS=DK.WORK_FLOATS,
                 MAX_LANES=max(DK.LANE_COUNTS))
    total = 0
    for decl in re.findall(r"float ([^;]*);", body):
        for var in decl.split(","):
            n = 1
            for dim in re.findall(r"\[(\w+)\]", var):
                n *= sizes[dim] if dim in sizes else int(dim)
            total += n
    assert total == DK.SLOT_FLOATS


@pytest.mark.parametrize("N", [1, 33, 4096, 4097, 65536])
@pytest.mark.parametrize("lanes", DK.LANE_COUNTS)
@pytest.mark.parametrize("threads", [32, 64, 128, 256])
def test_plans_fit_the_card(N, lanes, threads):
    plan = DK.dynamics_plan(N, lanes, threads // lanes)
    assert plan.threads == threads <= 1024 and plan.threads % 32 == 0
    assert plan.smem_bytes <= SMEM
    assert plan.blocks * plan.envs >= N > (plan.blocks - 1) * plan.envs


@pytest.mark.parametrize("N", [1, 33, 4096, 4097])
def test_default_plan(N):
    plan = DK.dynamics_plan(N)
    assert plan.lanes >= 4 and plan.blocks == -(-N // plan.envs)
    assert plan.smem_bytes <= SMEM and plan.threads <= 1024
    if N == 4096:  # the main path: at least 512 warps on the card (one thread per env: 128)
        assert plan.blocks * plan.threads // 32 >= 512


@pytest.mark.parametrize("kw", [dict(lanes=4), dict(lanes=32), dict(lanes=8, envs=3),
                                dict(lanes=8, envs=64), dict(lanes=16, envs=32),
                                dict(lanes=8, envs=0)])
def test_plans_the_card_cannot_take_raise(kw):
    with pytest.raises(ValueError):
        DK.dynamics_plan(4096, **kw)


def test_wrappers_take_a_plan_and_refuse_others():
    qpos = torch.zeros(4, DK.NQ)
    with pytest.raises(ValueError, match="CUDA tensor"):
        DK.control_step_cuda(qpos, torch.zeros(4, DK.NV), qpos, h=0.002, substeps=1,
                             plan=DK.dynamics_plan(4, 16))
    with pytest.raises(TypeError):
        DK._plan_for(4, (8, 8))


def test_step_params_are_made_once():
    a = DK._params(1 / 510, 17, 1.0, 1.0, True, True, 0.3)
    assert DK._params(1 / 510, 17, 1.0, 1.0, True, True, 0.3) is a
    assert a.substeps == 17 and abs(a.fall_height - 0.3) < 1e-7


def test_sweep_probe_hooks():
    """The sweep's probe build defines the source's phase hooks before
    including it; the source compiles them to nothing otherwise."""
    text = SOURCE.read_text()
    assert "#ifndef HUM_PHASE" in text and text.count("HUM_PHASE(") >= 6
    probe = SW.probe_current_source()
    assert probe.index("#define HUM_PHASE") < probe.index("#include")
    assert str(SOURCE) in probe
