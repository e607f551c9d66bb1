"""The port's profiling utilities and batch prefetch, against the behaviour
the JAX package's tests ask of theirs (tests/test_utils.py,
tests/test_cli.py::test_prefetch_to_device)."""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from deepmimic_diffusion_mujoco_tpu.data import datasets as JD
from deepmimic_diffusion_mujoco_tpu_torch.data import datasets as TD
from deepmimic_diffusion_mujoco_tpu_torch.utils import profiling as P

torch.set_num_threads(2)

WALK = os.path.join(os.path.dirname(__file__), "..", "data", "motions", "humanoid3d_walk.txt")


def test_timer():
    t = P.Timer()
    time.sleep(0.01)
    d = t()
    assert 0.005 < d < 1.0
    assert t(reset=False) < d  # was reset


def test_step_timer_counts_after_the_first_tick_and_syncs_only_a_card():
    st = P.StepTimer()
    assert st.device is None and st.steps_per_s == 0.0
    for _ in range(3):
        st.tick()
    assert st.count == 2 and st.steps_per_s > 0
    assert P.StepTimer("cpu").device is None  # nothing to synchronise on the CPU


def test_progress_meter():
    lines = []
    pm = P.ProgressMeter(total=10, every=5, log_fn=lines.append)
    for i in range(10):
        pm.update(loss=i)
    assert len(lines) == 2
    assert "loss" in lines[0] and "it/s" in lines[0]


def test_trace_and_annotate_write_a_chrome_trace(tmp_path):
    logdir = tmp_path / "prof"
    with P.trace(str(logdir), device="cpu") as prof:
        with P.annotate("step", device="cpu"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert "step" in {e.key for e in prof.key_averages()}
    trace = json.loads((logdir / "trace.json").read_text())
    assert any(e.get("name") == "step" for e in trace["traceEvents"])


def test_prefetch_matches_the_jax_batches():
    """The same batches as JAX's prefetch of the same iterator, as tensors on
    the device asked for (the CPU here), in order."""
    ds_t = TD.MotionDataset.from_path(WALK, augment="cyclic_rooted")
    ds_j = JD.MotionDataset.from_path(WALK, augment="cyclic_rooted")
    ours = TD.prefetch_to_device(ds_t.epochs(4, seed=0), size=2, device="cpu")
    ref = JD.prefetch_to_device(ds_j.epochs(4, seed=0), size=2)
    for _ in range(5):
        a, b = next(ours), next(ref)
        assert type(a) is TD.Batch
        for x, y in zip(a, b):
            assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    ours.close()
    ref.close()


def test_prefetch_raises_the_iterators_error_and_stops_its_thread():
    def batches():
        yield {"x": np.zeros(2)}
        raise KeyError("bad clip")

    it = TD.prefetch_to_device(batches(), device="cpu")
    assert torch.equal(next(it)["x"], torch.zeros(2, dtype=torch.float64))
    with pytest.raises(KeyError, match="bad clip"):
        next(it)

    before = threading.active_count()
    endless = TD.prefetch_to_device(({"x": np.ones(3)} for _ in iter(int, 1)), size=2,
                                    device="cpu")
    next(endless)
    endless.close()
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before
    finite = TD.prefetch_to_device(iter([{"x": np.ones(1)}] * 3), device="cpu")
    assert len(list(finite)) == 3


def test_prefetch_never_picks_the_cpu_itself():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(TD.prefetch_to_device(iter([{"x": np.ones(1)}])))
