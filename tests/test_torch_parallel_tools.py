"""The port's parallel layer, part 3: the tensor-parallel forward, the
multi-process check and the scaling CLI, each with two gloo ranks on the
CPU against one process.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_dist_workers as W
from deepmimic_diffusion_mujoco_tpu_torch.cli import scaling
from deepmimic_diffusion_mujoco_tpu_torch.parallel import multihost_check, tp
from deepmimic_diffusion_mujoco_tpu_torch.parallel.launch import spawn_ranks

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TP_TOL = 1e-5       # |TP forward - one process| / max |one process|: the same sums, split
CHECK_TOL = 1e-6    # relative: multihost_check's loss and checksum against one process
TIMEOUT = 240.0


def test_tensor_parallel_forward_matches_one_process(tmp_path):
    """A small stack-B transformer (adaLN, a key mask) column/row split over
    two ranks: every query/key/value, attention out and feed-forward Linear
    is split, each rank holds half the heads, and both give the one-process
    forward."""
    ranks = spawn_ranks(W.tp_worker, 2, str(tmp_path), device="cpu", timeout=TIMEOUT,
                        threads=1)
    model, (x, t, y, mask) = W.tp_model_and_inputs()
    with torch.no_grad():
        ref = model(x, t, y, mask=mask).numpy()
    layers = [f"layers.{i}.{m}" for i in range(2) for m in
              ("attn.query", "attn.key", "attn.value", "attn.out", "ff.dense_0", "ff.dense_1")]
    for r in ranks:
        assert r["plan"] == sorted(layers)
        assert r["local_shapes"]["layers.0.attn.query.weight"] == (32, 64)  # 2 of 4 heads
        assert r["local_shapes"]["layers.0.attn.out.weight"] == (64, 32)
        assert r["local_shapes"]["layers.0.ff.dense_1.bias"] == (64,)
        assert np.abs(r["out"] - ref).max() <= TP_TOL * np.abs(ref).max()
    np.testing.assert_array_equal(ranks[0]["out"], ranks[1]["out"])


def test_tp_rules_leave_what_does_not_split_replicated():
    """Rules match the port's names; a split that would cut a head, or a
    module no rule names, stays replicated."""
    model, _ = W.tp_model_and_inputs()
    names = [n for n, _ in model.named_modules()]
    matched = {n for n in names for p, _ in tp.default_tp_rules() if re.fullmatch(p, n)}
    assert "layers.1.attn.query" in matched and "pose_embed" not in matched
    attn = model.get_submodule("layers.0.attn")
    assert tp._splits(model, "layers.0.attn.query", attn.query, "colwise", 2)
    assert not tp._splits(model, "layers.0.attn.query", attn.query, "colwise", 8)  # 4 heads
    assert not tp._splits(model, "layers.0.attn.out", attn.out, "rowwise", 3)


def test_multihost_check_two_processes_match_one(tmp_path):
    """Two processes of the CLI (a file-store rendezvous, gloo): the loss and
    the parameter checksum are bit-identical across them and within
    CHECK_TOL of the flag-free single process."""
    store = f"file://{tmp_path}/store"
    cmd = [sys.executable, "-m", "deepmimic_diffusion_mujoco_tpu_torch.parallel.multihost_check",
           "--coordinator", store, "--num-processes", "2", "--device", "cpu"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(cmd + ["--process-id", str(i)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, stderr
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    one = multihost_check.run_check(device="cpu")
    assert [o["process_id"] for o in outs] == [0, 1]
    assert all(o["process_count"] == 2 and o["backend"] == "gloo" for o in outs)
    assert one["process_count"] == 1 and one["backend"] is None
    assert outs[0]["loss"] == outs[1]["loss"]
    assert outs[0]["param_checksum"] == outs[1]["param_checksum"]
    for key in ("loss", "param_checksum"):
        np.testing.assert_allclose(outs[0][key], one[key], rtol=CHECK_TOL)


def test_scaling_cli_records_an_invalid_measurement_on_the_cpu(tmp_path, capsys):
    """cli.scaling --widths 1,2 --device cpu: every width ran its ranks, the
    record keeps the JAX artifact's keys, and one device shared by two ranks
    is marked measurement_valid false, its gate recorded but not evaluated."""
    out = tmp_path / "scaling.json"
    report = scaling.main(["--widths", "1,2", "--device", "cpu", "--dim", "8",
                           "--batch-per-device", "2", "--steps", "2", "--gate", "0.8",
                           "--json", str(out)])
    assert json.loads(out.read_text()) == report
    assert report["n_hosts"] == 1 and report["n_devices"] == 1
    assert report["measurement_valid"] is False and "WARNING" in report
    assert report["gate"] == 0.8 and report["gate_evaluated"] is False
    assert report["gate_pass"] is None
    for w in ("1", "2"):
        assert report[w]["steps_per_s"] > 0 and report[w]["backend"] == "gloo"
        assert report[w]["samples_per_s"] == pytest.approx(
            report[w]["steps_per_s"] * 2 * int(w))
    assert report["1"]["efficiency"] == 1.0
    assert "efficiency" in capsys.readouterr().out
