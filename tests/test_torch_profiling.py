"""The program's spans and counters (``utils/profiling.py``): a span is a
``record_function`` only while a profiler runs, the frame loop and the
statistics function emit their spans nested as the layers nest, and the
counters advance. The frame reader's spans are tested beside its ring in
``test_torch_interactive.py``, the graphs' in ``test_torch_graphs.py``."""

import ast
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_parity  # noqa: F401  (caps torch threads)
from pyqmd_tpu_torch import Simulation
from pyqmd_tpu_torch.analysis import survival_curve
from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.utils import profiling

KERNELS = Path(profiling.__file__).resolve().parent.parent / "kernels"


def program_spans(prof) -> list[tuple[str, str | None]]:
    """``(span, innermost enclosing pyqmd span or None)`` of every
    ``pyqmd.*`` span the profiler recorded, in order."""
    out = []
    for e in prof.events():
        if not e.name.startswith("pyqmd."):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("pyqmd."):
            parent = parent.cpu_parent
        out.append((e.name, None if parent is None else parent.name))
    return out


def test_a_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    calls = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name) or real(name))
    assert not torch.autograd.profiler._is_profiler_enabled
    span = profiling.annotate("pyqmd.test.off")
    assert span is profiling.annotate("pyqmd.test.other")
    with span:
        torch.ones(2).sum()
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.autograd.profiler._is_profiler_enabled
        with profiling.annotate("pyqmd.test.on"):
            torch.ones(2).sum()
    assert calls == ["pyqmd.test.on"]
    assert program_spans(prof) == [("pyqmd.test.on", None)]
    assert not torch.autograd.profiler._is_profiler_enabled


@pytest.fixture
def own_counters(monkeypatch):
    """The registry's counters, for this test alone."""
    monkeypatch.setattr(profiling, "_COUNTS", dict(profiling._COUNTS))


def test_counters_count_and_report_the_kernel_launches(own_counters):
    before = profiling.counters()
    assert {"host.syncs", "graph.captures", "graph.replays", "sim.chain_drains",
            "kernels.force_step.launches", "kernels.force_step.small_launches",
            "kernels.force_step.paired_launches",
            "kernels.overlap_step.launches", "kernels.decay_stats_frame.launches",
            "kernels.ejecta_decay_substep.launches"} == set(before)
    profiling.count("host.syncs")
    profiling.count("graph.replays", 3)
    profiling.count("kernels.force_step.launches", 5)
    after = profiling.counters()
    grown = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert grown == {"host.syncs": 1, "graph.replays": 3, "kernels.force_step.launches": 5}


def test_counting_an_undeclared_name_raises(own_counters):
    before = profiling.counters()
    for name in ("no.such.counter", "kernels.decay_stats_substep.launches",
                 "kernels.force_step"):
        with pytest.raises(KeyError):
            profiling.count(name)
    assert profiling.counters() == before


def test_restoring_a_snapshot_puts_back_every_counter(own_counters):
    snapshot = profiling.counters()
    for i, name in enumerate(snapshot):
        profiling.count(name, i + 1)
    assert all(v != snapshot[k] for k, v in profiling.counters().items())
    profiling.restore_counters(snapshot)
    assert profiling.counters() == snapshot
    snapshot["host.syncs"] += 1  # a snapshot is a copy: changing it changes no counter
    assert profiling.counters()["host.syncs"] == snapshot["host.syncs"] - 1


def test_restoring_part_of_a_snapshot_leaves_the_other_counters(own_counters):
    """A capture puts back the kernels' counters alone: a count elsewhere
    in the meantime stays, and a name the registry lacks raises."""
    kernels = {k: v for k, v in profiling.counters().items() if k.startswith("kernels.")}
    profiling.count("kernels.force_step.launches", 5)
    profiling.count("host.syncs", 2)
    before = profiling.counters()
    profiling.restore_counters(kernels)
    assert profiling.counters() == {**before, **kernels}
    assert profiling.counters()["host.syncs"] == before["host.syncs"]
    with pytest.raises(KeyError):
        profiling.restore_counters({"no.such.counter": 0})


def _counted_names(fn: ast.FunctionDef) -> set:
    return {node.args[0].value for node in ast.walk(fn)
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "count"}


def _launches(fn: ast.FunctionDef) -> bool:
    """Whether ``fn`` launches a kernel: every launch is followed by
    ``_build.raise_on_error``."""
    return any(isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "raise_on_error"
               for node in ast.walk(fn))


@pytest.mark.parametrize("module", sorted(p.stem for p in KERNELS.glob("[!_]*.py")))
def test_every_kernel_wrapper_counts_under_its_declared_names(module):
    """Each wrapper that launches a kernel counts its launches as
    ``kernels.<wrapper>.launches``, and the registry declares exactly the
    ``kernels.<wrapper>.*`` names the wrapper counts."""
    tree = ast.parse((KERNELS / f"{module}.py").read_text())
    wrappers = [f for f in tree.body if isinstance(f, ast.FunctionDef) and _launches(f)]
    assert wrappers, module
    declared = set(profiling.counters())
    for fn in wrappers:
        counted = _counted_names(fn)
        assert f"kernels.{fn.name}.launches" in counted, fn.name
        assert counted == {k for k in declared if k.startswith(f"kernels.{fn.name}.")}, fn.name


def test_trace_writes_the_counters_grown_over_the_block(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("pyqmd.test.span"):
            profiling.count("sim.chain_drains", 2)
    grown = json.loads((tmp_path / "counters.json").read_text())
    assert grown["sim.chain_drains"] == 2 and grown["host.syncs"] == 0
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())[
        "traceEvents"]}
    assert "pyqmd.test.span" in names


def test_simulation_frame_spans_nest_in_the_frame():
    """A lone nucleus with an 8-slot chain ring (a drain every few frames)
    and a NaN guard every other frame: the waits and the drain are spans
    inside ``pyqmd.sim.frame``; the drains are counted. On the CPU a frame
    has no event, so nothing waits and ``host.syncs`` stays."""
    sim = Simulation(SimConfig.for_isotope(6, 8, pad_to=16, max_chain_log=8), device="cpu")
    sim.nan_check_interval = 2
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(6):
            sim.frame()
    spans = program_spans(prof)
    grown = {k: v - before[k] for k, v in profiling.counters().items()}
    assert spans.count(("pyqmd.sim.frame", None)) == 6
    assert spans.count(("pyqmd.sim.retire", "pyqmd.sim.frame")) == 3  # from the 4th frame
    assert spans.count(("pyqmd.sim.nan_guard", "pyqmd.sim.frame")) == 3
    drains = spans.count(("pyqmd.sim.chain_drain", "pyqmd.sim.frame"))
    assert drains >= 1 and grown["sim.chain_drains"] == drains
    assert {s for s in spans if s[0] != "pyqmd.sim.frame"} <= {
        ("pyqmd.sim.retire", "pyqmd.sim.frame"), ("pyqmd.sim.nan_guard", "pyqmd.sim.frame"),
        ("pyqmd.sim.chain_drain", "pyqmd.sim.frame")}
    assert grown["host.syncs"] == 0
    assert isinstance(sim.decay_log, list)  # a drain outside a frame
    assert profiling.counters()["sim.chain_drains"] == before["sim.chain_drains"] + drains + 1


def test_survival_curve_spans_set_up_frames_and_readbacks():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        survival_curve(6, 8, batch=64, frames=3, substeps=2, device="cpu")
    assert program_spans(prof) == (
        [("pyqmd.survival.setup", None), ("pyqmd.init.ensemble", "pyqmd.survival.setup")]
        + [("pyqmd.survival.frame", None), ("pyqmd.survival.readback", None)] * 3
        + [("pyqmd.survival.readback", None)])
