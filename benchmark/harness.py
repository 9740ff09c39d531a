"""What every cell shares: the benchmark's files, a run's context and
result, the card's name and power limit, the per-layer metric readers and
the result line.

Everything that belongs to one configuration, cell, loop or per-layer
metric lives in a file of its own, found by the name ``BENCHMARK.json``
gives it:

* ``benchmark/workloads/<cell>.json``: the cell's driver, traffic
  parameters and limits;
* the configuration's file, named in ``BENCHMARK.json``;
* ``benchmark/drivers/<driver>.py``: a loop, with ``run(ctx) -> Result``;
* ``benchmark/metrics/<metric>.py``: a reader, with ``read(trace)``,
  which returns the metric or None when the trace holds nothing to read.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "benchmark"

# Modules a run may not hold once its window has closed: JAX and the JAX
# package the port was made from (compared by whole top-level names).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pyqmd_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: dict | None = None) -> tuple[dict, dict, dict, dict]:
    """``(cell entry, workload file, configuration entry, configuration
    file)`` of the cell called ``name``."""
    bench = bench or spec()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = configs[entry["config"]]
    return entry, load_json(HERE / "workloads" / f"{name}.json"), config, load_json(
        ROOT / config["file"])


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def metric_reader(name: str):
    """The ``read`` function of ``benchmark/metrics/<name>.py`` (names may
    hold dots, so the file is loaded by its path)."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def per_layer_metrics(bench: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics a cell reports: those whose ``workloads`` list
    it (every per-layer entry names its cells)."""
    return [m for m in bench["per_layer"] if cell_name in m["workloads"]]


def end_to_end_metrics(bench: dict, cell_name: str) -> list[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, its configuration and traffic, the
    run's seed, window and trace switch, the device kind, and the time at
    which the process started (set-up runs from there)."""

    cell: str
    seed: int
    seconds: float
    trace: bool
    device: str
    chips: int
    config: dict
    workload: dict
    t_start: float


@dataclasses.dataclass
class Result:
    """What a driver returns. ``e2e`` maps end-to-end metric names to
    values; ``numbers`` are the compared numbers (the workload file gives
    their limits); ``traces`` the traced windows, one per process, the
    first being the one the per-layer metrics read."""

    attempted: int
    failed: int
    setup_s: float
    e2e: dict
    numbers: dict
    memory_peak_bytes: int
    traces: list = dataclasses.field(default_factory=list)


@functools.cache
def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    first = out[0].split(",") if out else ["unknown", "unknown"]
    return {"nvidia_smi_name": first[0].strip(),
            "power_limit": first[1].strip() if len(first) > 1 else "unknown"}


def forbidden_loaded() -> list[str]:
    """Top-level names among ``sys.modules`` that a run may not hold."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def quarters(done: list[float], t0: float, t1: float) -> list[float]:
    """Completions per second in each quarter of the window ``[t0, t1]``,
    from the host times at which calls returned: a run whose rate moves
    within the window shows it here."""
    q = (t1 - t0) / 4
    return [sum(t0 + i * q <= t < t0 + (i + 1) * q + (i == 3) for t in done) / q
            for i in range(4)]
