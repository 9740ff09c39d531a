"""Tracing / profiling helpers.

The reference's observability is an FPS deque and an on-screen substep meter
(nuclear_sim.py:60, 119-121; rendering.py:224-229) with no timers around
the kernel. Here: a wall-clock steps/sec counter that fences on the device
work it is handed (CUDA launches are asynchronous, so an unfenced host
timer measures the enqueue rate), and a ``torch.profiler`` trace context
that writes a Chrome trace viewable in Perfetto or ``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque

import torch


def fence(result) -> None:
    """Wait for the device work behind ``result``: a ``torch.cuda.Event``
    is synchronised; for tensors (alone, or in a dict, list or tuple) each
    CUDA device they lie on is synchronised once. CPU tensors need no
    fence."""
    if isinstance(result, torch.cuda.Event):
        result.synchronize()
        return
    if isinstance(result, torch.Tensor):
        result = (result,)
    elif isinstance(result, dict):
        result = result.values()
    devices = {
        t.device for t in result if isinstance(t, torch.Tensor) and t.is_cuda
    }
    for dev in devices:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Rolling steps/sec with device fencing.

    The reference's FPS deque (nuclear_sim.py:60) measures the host loop
    only; with asynchronous launches that would measure nothing, so
    ``lap`` fences on the result it is handed.
    """

    def __init__(self, window: int = 30):
        self.times: deque[float] = deque(maxlen=window)
        self._last = None

    def start(self):
        self._last = time.perf_counter()

    def reset(self):
        self.times.clear()
        self._last = None

    @property
    def primed(self) -> bool:
        """True once start() (or a lap) has set a reference timestamp."""
        return self._last is not None

    def lap(self, result=None, steps: int = 1) -> float:
        """Fence on ``result`` and record; returns the rolling steps/sec."""
        if result is not None:
            fence(result)
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            if dt > 0:
                self.times.append(steps / dt)
        self._last = now
        return self.steps_per_sec

    @property
    def steps_per_sec(self) -> float:
        if not self.times:
            return 0.0
        return sum(self.times) / len(self.times)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (host, and the card
    where there is one) and write it as ``log_dir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region inside a trace (shows up on the timeline)."""
    return torch.profiler.record_function(name)
