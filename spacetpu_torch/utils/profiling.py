"""Profiling hooks: device sync, step timing on CUDA events, and
`torch.profiler` traces. The counterpart of `spacetpu/utils/profiling.py`.
"""

from __future__ import annotations

import contextlib
import os

import torch


def sync(x=None) -> None:
    """Wait until the card has finished the work queued so far (on the
    device of tensor `x` when given). A no-op for CPU tensors."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
    elif torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a `torch.profiler` trace (CPU and, where present, CUDA
    activity) around a block and write it to ``log_dir/trace.json``:

        with profiling.trace("traces"):
            state = sim.run(state, dt, 100)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Device time per call of `fn`, measured between CUDA events after
    `warmup` untimed calls. Needs a card: it does not time the CPU."""

    def __init__(self, fn, *, warmup: int = 1):
        self.fn = fn
        self.warmup = warmup

    def time(self, *args, reps: int = 5) -> float:
        """Run fn(*args) `reps` times; returns seconds per call."""
        for _ in range(self.warmup):
            self.fn(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            self.fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
