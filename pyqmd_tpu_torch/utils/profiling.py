"""Tracing / profiling helpers.

The reference's observability is an FPS deque and an on-screen substep meter
(nuclear_sim.py:60, 119-121; rendering.py:224-229) with no timers around
the kernel. Here: a wall-clock steps/sec counter that fences on the device
work it is handed (CUDA launches are asynchronous, so an unfenced host
timer measures the enqueue rate), a ``torch.profiler`` trace context
that writes a Chrome trace viewable in Perfetto or ``chrome://tracing``,
the program's spans and its counters.

**Spans.** :func:`annotate` is the one span of the program, named
``pyqmd.<layer>.<what>``: a ``torch.profiler.record_function`` while a
profiler runs, so the span lies in the profiler's own buffer, on the
clock of the device operations it launched, and leaves with its Chrome
trace; with no profiler running it is one shared no-op context, one flag
check. No span is opened inside a captured CUDA graph's body, where it
would record the capture only.

**Counters** (:func:`count`, :func:`counters`) are always on, one integer
add each: ``host.syncs`` (every blocking wait of the frame loop, the frame
reader and the statistics functions on the card), ``graph.captures`` and
``graph.replays`` (CUDA graph captures and replays), ``sim.chain_drains``
(``Simulation``'s chain-log drains); :func:`counters` adds the kernel
wrappers' launch counts as ``kernels.<wrapper>.<attribute>``. Like those
launch counts they take no lock: two threads that count at once may lose
an add (the live viewer steps and reads its simulation under one lock).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import deque

import torch
import torch.autograd.profiler as _autograd_profiler

_COUNTS = dict.fromkeys(("host.syncs", "graph.captures", "graph.replays", "sim.chain_drains"), 0)
_NO_SPAN = contextlib.nullcontext()


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
    where there is one) and write it as ``log_dir/trace.json``, the
    program's spans in it, and the counters' growth over the block as
    ``log_dir/counters.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    before = counters()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    grown = {k: v - before.get(k, 0) for k, v in counters().items()}
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump(grown, f, indent=1)


def annotate(name: str):
    """The span ``name`` on the profiler's timeline while a profiler runs;
    otherwise a shared no-op context, so that a span costs one flag check
    when nothing traces."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (one of the module's counters)."""
    _COUNTS[name] += n


def counters() -> dict:
    """A snapshot of the counters, with the kernel wrappers' launch counts
    as ``kernels.<wrapper>.<attribute>``."""
    from pyqmd_tpu_torch.kernels.decay import decay_stats_frame, decay_stats_substep
    from pyqmd_tpu_torch.kernels.forces import force_step
    from pyqmd_tpu_torch.kernels.overlap import overlap_step

    out = dict(_COUNTS)
    for wrapper in (force_step, overlap_step, decay_stats_frame, decay_stats_substep):
        for attr in ("launches", "small_launches"):
            if hasattr(wrapper, attr):
                out[f"kernels.{wrapper.__name__}.{attr}"] = getattr(wrapper, attr)
    return out
