"""Tracing, profiling and progress utilities.

Counterpart of ``deepmimic_diffusion_mujoco_tpu/utils/profiling.py``:

- ``Timer``: seconds since construction or the last call;
- ``StepTimer``: steps per second, synchronising the CUDA device it was
  given at every tick so that queued work cannot flatter the rate (it
  never picks a device itself; without one it reads the host clock only);
- ``trace(logdir, device)``: ``torch.profiler`` over the block, written to
  ``logdir/trace.json`` as a Chrome trace (chrome://tracing, Perfetto), with
  the device's kernels when ``device`` is CUDA; the profiler is yielded, so
  ``key_averages()`` reads it;
- ``annotate(name, device)``: a named region in such a trace
  (``record_function``), and an NVTX range when ``device`` is CUDA;
- ``ProgressMeter``: a print-based progress line every ``every`` updates.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


class Timer:
    """Elapsed seconds since construction or the last call."""

    def __init__(self):
        self._start = time.perf_counter()

    def __call__(self, reset: bool = True) -> float:
        now = time.perf_counter()
        diff = now - self._start
        if reset:
            self._start = now
        return diff


def _cuda(device) -> torch.device | None:
    dev = None if device is None else torch.device(device)
    return dev if dev is not None and dev.type == "cuda" else None


class StepTimer:
    """Throughput: call ``tick()`` after each step. The first tick starts
    the clock. Each tick first waits for ``device``'s queued work when it is
    a CUDA device."""

    def __init__(self, device=None):
        self.device = _cuda(device)
        self.count = 0
        self._t0 = None

    def tick(self) -> int:
        if self.device is not None:
            torch.cuda.synchronize(self.device)
        if self._t0 is None:
            self._t0 = time.perf_counter()
        else:
            self.count += 1
        return self.count

    @property
    def steps_per_s(self) -> float:
        if not self.count or self._t0 is None:
            return 0.0
        return self.count / (time.perf_counter() - self._t0)


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Profile the block: ``with trace("/tmp/profile", "cuda") as prof: step()``."""
    cuda = _cuda(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda is not None:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if cuda is not None:
            torch.cuda.synchronize(cuda)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str, device=None):
    """A named region inside a trace (and an NVTX range on a CUDA device)."""
    nvtx = _cuda(device) is not None
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class ProgressMeter:
    """print-based progress line (the reference's progress readout)."""

    def __init__(self, total: int, every: int = 100, log_fn=print):
        self.total = total
        self.every = every
        self.log_fn = log_fn
        self.timer = Timer()
        self._seen = 0

    def update(self, **fields):
        self._seen += 1
        if self._seen % self.every == 0:
            rate = self.every / max(self.timer(), 1e-9)
            msg = " | ".join(f"{k}: {v}" for k, v in fields.items())
            self.log_fn(f"[{self._seen}/{self.total}] {msg} ({rate:.1f} it/s)")
