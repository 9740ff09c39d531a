"""A traced window, read from ``torch.profiler``'s Chrome trace.

The drivers wrap each call into a layer of the program in a
``torch.profiler.record_function`` span named ``bench.<layer>``, and the
whole traced window in ``bench.window``. :func:`profiled` runs a window
under the profiler and reads back, from the exported trace:

* every device operation (kernels, copies, fills) with its start, end and
  the ``bench.*`` span the host was in when it launched it, through the
  correlation id that ties a kernel to its runtime call (a CUDA graph's
  kernels carry the id of its ``cudaGraphLaunch``);
* every ``bench.*`` span on the host;
* the window: the ``bench.window`` span, which ends on a fence.

The profiler starts before a lead-in of untimed calls without a fence, so
that the window opens on a full pipeline, as any window of the loop does.
The lead-in's spans are dropped, and the device operations it launched
count only for the device's busy time inside the window: the per-layer
metrics read the window's own calls.

Per-layer metrics read a :class:`Trace`; nothing here knows a metric.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


@dataclass
class Op:
    """A device operation: name, category, start and end (seconds on the
    trace's clock) and the ``bench.*`` span that launched it (None if
    none did)."""

    name: str
    cat: str
    start: float
    end: float
    span: str | None

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Trace:
    """One process's traced window. ``ops`` are the device operations the
    window's calls launched; ``lead`` those launched before the window
    opened (the lead-in's, still running). ``info`` holds the counts the
    driver took from the window's inputs (frames, members, pairs...)."""

    ops: list[Op]
    spans: list[tuple[str, float, float]]
    window: tuple[float, float]
    info: dict = field(default_factory=dict)
    lead: list[Op] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self, span: str | None = None, name: str | None = None) -> list[Op]:
        """Kernels launched under ``span`` (any span if None) whose name
        contains ``name`` (any if None)."""
        return [o for o in self.ops if o.cat == "kernel"
                and (span is None or o.span == span)
                and (name is None or name in o.name)]

    def kernel_ms(self, spans: tuple, exclude: tuple = ()) -> float:
        """Summed ms of the kernels launched under any of ``spans`` whose
        names contain none of ``exclude``."""
        return 1e3 * sum(o.seconds for o in self.ops if o.cat == "kernel" and o.span in spans
                         and not any(x in o.name for x in exclude))

    def idle_pct(self) -> float | None:
        """Share of the window in which no operation ran on the device."""
        if self.window_s <= 0 or not self.ops:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def span_seconds(self, name: str) -> list[float]:
        """Host durations of the spans called ``name``."""
        return [e - s for n, s, e in self.spans if n == name]

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals inside the window,
        the lead-in's included."""
        lo, hi = self.window
        ivs = sorted((max(o.start, lo), min(o.end, hi)) for o in self.ops + self.lead
                     if o.end > lo and o.start < hi)
        merged: list[list[float]] = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def host_span_at(self, t: float) -> str:
        """The innermost ``bench.*`` span the host was in at time ``t``."""
        inner = [(e - s, n) for n, s, e in self.spans if s <= t < e and n != WINDOW]
        return min(inner)[1] if inner else "outside any bench span"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (summed by name) and the
        longest idle gaps inside the window, each named by the span the
        host was in when the gap began."""
        by_name: dict[str, float] = {}
        for o in self.ops:
            by_name[o.name] = by_name.get(o.name, 0.0) + o.seconds
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        lo, hi = self.window
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {
            "device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[self.host_span_at(s), e - s] for s, e in gaps],
        }


def read_chrome_trace(path: str, info: dict | None = None) -> Trace:
    """A :class:`Trace` from a Chrome trace that ``torch.profiler`` wrote."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    us = 1e-6
    spans = sorted(
        (e["name"], e["ts"] * us, (e["ts"] + e.get("dur", 0)) * us)
        for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation"
        and str(e.get("name", "")).startswith("bench.")
    )
    windows = [(s, e) for n, s, e in spans if n == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} {WINDOW} spans, not one")
    lo, hi = windows[0]
    spans = [(n, s, e) for n, s, e in spans if lo <= s < hi or n == WINDOW]
    leaf = sorted((s, e, n) for n, s, e in spans if n != WINDOW)
    starts = [s for s, _, _ in leaf]

    def span_at(t: float) -> str | None:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and leaf[i][0] <= t < leaf[i][1]:
            return leaf[i][2]
        return None

    launch_at = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_at[corr] = e["ts"] * us
    ops, lead = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        corr = e.get("args", {}).get("correlation")
        t = launch_at.get(corr)
        start = e["ts"] * us
        op = Op(str(e.get("name", "")), e["cat"], start, start + e.get("dur", 0) * us,
                None if t is None else span_at(t))
        (lead if (start if t is None else t) < lo else ops).append(op)
    return Trace(ops, spans, windows[0], dict(info or {}), lead)


def profiled(window, device, lead=None, info: dict | None = None) -> Trace:
    """Run ``lead()`` (the lead-in: calls that fill the pipeline, with no
    fence after them) and then ``window()`` under ``torch.profiler``, the
    window inside a ``bench.window`` span that ends on a fence of
    ``device``, and read the trace back. The trace file goes to a temporary
    directory and is deleted."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        if lead is not None:
            lead()
        with record_function(WINDOW):
            window()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return read_chrome_trace(path, info)
