"""The harness: files found by name, a new cell and metric picked up without
an edit, the names and bounds of ``BENCHMARK.json``, the roofline
arithmetic, the refusal without a card, and whole runs of each cell on the
CPU at tiny sizes, where the program takes its plain path and has to agree
with the reference."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness, roofline

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2**31 + 977

# Tiny sizes at which a cell runs on the CPU in seconds.
TINY = {
    "u238.ensemble.b10240": {"members": 4, "warmup_frames": 1, "sample_within": 2},
    "c14.survival.b2m": {"batch": 1024, "sample_within": 2},
    "u238.view.b1": {"warmup_frames": 4, "warmup_seconds": 0, "sample_within": 2, "width": 240,
                     "height": 160},
    "u238-dp4.ensemble.b40960": {"members": 8, "warmup_frames": 1, "sample_within": 1},
}


def test_benchmark_json_has_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells = BENCH["workloads"]
    assert sum(c["chips"] == 4 for c in cells) <= max(1, len(cells) // 4)
    # A full check of 24 cells fits its time.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units_use_the_allowed_characters(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])


def test_metrics_name_only_cells_that_report_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {c["name"] for c in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["workloads"], m["name"]
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for c in cells:
        assert len(harness.end_to_end_metrics(BENCH, c)) >= 2
        assert harness.per_layer_metrics(BENCH, c)


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_every_cell_finds_its_files_by_name(cell):
    entry, workload, config, config_file = harness.cell(cell, BENCH)
    assert Path(ROOT / config["file"]).is_file()
    assert config_file["name"] == config["name"]
    assert callable(harness.driver(workload["driver"]).run)
    for m in harness.per_layer_metrics(BENCH, cell):
        assert callable(harness.metric_reader(m["name"]))
    assert set(workload["limits"]) and all(v >= 0 for v in workload["limits"].values())


def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    """A copy of the benchmark with one more workload file, one more metric
    file and their entries in BENCHMARK.json: the harness picks both up
    without an edit to any file it had."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = json.loads((ROOT / "benchmark/workloads/u238.ensemble.b10240.json").read_text())
    (tmp_path / "benchmark/workloads/u238.ensemble.b1024.json").write_text(
        json.dumps(dict(base, members=1024)))
    (tmp_path / "benchmark/metrics/frames_traced.py").write_text(
        "def read(trace):\n    return trace.info.get('frames')\n")
    bench["workloads"].append({"name": "u238.ensemble.b1024", "config": "u238",
                               "traffic": "ensemble.b1024", "chips": 1, "why": "smaller"})
    bench["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "full_nucleus_substeps_per_s",
                               "workloads": ["u238.ensemble.b1024"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = (
        "from benchmark import harness\n"
        "from benchmark.traces import Trace\n"
        "e, w, c, f = harness.cell('u238.ensemble.b1024')\n"
        "names = [m['name'] for m in harness.per_layer_metrics(harness.spec(), e['name'])]\n"
        "read = harness.metric_reader('frames_traced')\n"
        "print(w['members'], harness.driver(w['driver']).__name__, names,"
        " read(Trace([], [], (0.0, 1.0), {'frames': 7})))\n"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "1024"
    assert "benchmark.drivers.sim_frames" in out.stdout
    assert "'frames_traced'" in out.stdout and out.stdout.strip().endswith("7")


def test_the_roofline_gives_the_recorded_bounds():
    # The force kernel at U-238 B=10240: 2.88e8 alive pairs, SFU-bound.
    ms, by = roofline.force_ms(2.88e8, 10240 * 256)
    assert by == "sfu" and ms == pytest.approx(0.207, abs=5e-4)
    # The decay frame at C-14 B=2,097,152, 10 substeps, ~80,000 decays.
    ms, by = roofline.decay_frame_ms(2_097_152, 10, 80_000, 1)
    assert by == "int32" and ms == pytest.approx(0.1108, rel=5e-3)


def test_a_share_is_never_clipped():
    assert roofline.share_pct(2.0, 1.0) == 200.0


def test_without_a_card_the_command_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "u238.ensemble.b10240", "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_the_program_the_command_exits_nonzero(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "u238.view.b1",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _run(cell, trace=False, **kw):
    from benchmark.run import run_cell

    return run_cell(cell, SEED, 0.5, trace, device="cpu", overrides=TINY[cell], **kw)


@pytest.mark.parametrize("cell", ["u238.ensemble.b10240", "u238.view.b1"])
def test_each_frame_cell_agrees_with_the_reference_on_the_cpu(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["checks"]["ints_differing"]["value"] == 0
    assert out["checks"]["pos_gap"]["value"] == 0.0  # the same plain path on both sides
    assert all(v["value"] > 0 for v in out["metrics"].values())


def test_the_survival_cell_agrees_with_the_reference_on_the_cpu():
    out = _run("c14.survival.b2m")
    # 1,024 nuclei fit the half-life only to a few percent: the 1% bar is
    # for the cell's 2,097,152.
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert checks["survivors_differing"] == 0 and checks["decay_counts_differing"] == 0
    assert checks["halflife_rel_err"] < 0.1
    assert out["metrics"]["halflife_fit_s"]["value"] > 0


def test_the_sharded_cell_agrees_with_the_reference_on_four_gloo_ranks():
    out = _run("u238-dp4.ensemble.b40960")
    assert out["correct"], out["checks"]
    assert out["checks"]["aggregates_differing"]["value"] == 0
    assert out["device"]["count"] == 4


def test_a_traced_run_reads_its_window():
    out = _run("u238.ensemble.b10240", trace=True)
    assert out["correct"]
    assert out["device"]["window_s"] > 0 and out["device"]["busy_s"] == 0.0  # no device ops
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_trace_with_device_operations_is_read():
    """Spans, kernels by the span that launched them, idle share and the
    breakdown from a hand-written Chrome trace."""
    from benchmark.traces import read_chrome_trace

    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench.frame", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 5, "dur": 2,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "void force_step_kernel<true>()", "ts": 20,
         "dur": 30, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllReduce", "ts": 60, "dur": 10,
         "args": {"correlation": 2}},
    ]
    path = Path(__file__).parent / "_trace_probe.json"
    try:
        path.write_text(json.dumps({"traceEvents": ev}))
        t = read_chrome_trace(str(path), {"frames": 1})
    finally:
        path.unlink()
    assert [k.span for k in t.kernels()] == ["bench.frame", None]
    assert t.busy_s == pytest.approx(40e-6) and t.window_s == pytest.approx(100e-6)
    assert t.idle_pct() == pytest.approx(60.0)
    b = t.breakdown()
    assert b["device_ops"][0][0].startswith("void force_step_kernel")
    assert b["idle_gaps"][0][1] == pytest.approx(30e-6)


def test_the_lead_in_counts_only_for_the_busy_time():
    """A kernel launched before the window opened, still running inside it,
    and the lead-in's span: the window's busy time holds the kernel's part
    inside the window; the spans and kernels that metrics read do not."""
    from benchmark.traces import read_chrome_trace

    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.frame", "ts": -30, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": -25, "dur": 2,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "void force_step_kernel<true>()", "ts": -5,
         "dur": 15, "args": {"correlation": 3}},
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench.frame", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 5, "dur": 2,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "void force_step_kernel<true>()", "ts": 20,
         "dur": 30, "args": {"correlation": 1}},
    ]
    path = Path(__file__).parent / "_trace_lead_probe.json"
    try:
        path.write_text(json.dumps({"traceEvents": ev}))
        t = read_chrome_trace(str(path), {"frames": 1})
    finally:
        path.unlink()
    assert [k.span for k in t.kernels()] == ["bench.frame"] and len(t.lead) == 1
    assert t.span_seconds("bench.frame") == [pytest.approx(10e-6)]
    assert t.busy_s == pytest.approx(40e-6) and t.idle_pct() == pytest.approx(60.0)
    assert t.breakdown()["idle_gaps"][0][1] == pytest.approx(50e-6)
