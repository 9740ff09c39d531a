#!/usr/bin/env python3
"""Run one cell of the pyqmd_tpu_torch benchmark once, on the CUDA cards of
this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads, warms up every shape the cell's traffic uses (set-up), measures
closed-loop for ``--seconds`` (``--trace 1``: a short window under
``torch.profiler``), compares what the timed path produced with the plain
reference under ``benchmark/reference/``, and prints as the last line of
standard output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each compared number beside its limit, which also close
standard error. The card's name and power limit come on standard error
first.

Exits nonzero, and prints no result, without the CUDA cards the cell asks
for, or if JAX or the JAX package was loaded. Build and kernel caches stay
at fixed paths inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# The checkout's root, not this script's directory, heads the import path:
# the benchmark's modules are imported as ``benchmark.*``.
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
CACHE = ROOT / ".bench_cache"


def pin_caches() -> None:
    """Every build and kernel cache at a fixed directory of the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None, bench: dict | None = None,
             overrides: dict | None = None, **driver_kw) -> dict:
    """One run of cell ``name``, as the result line's object. ``device`` is
    the kind of device the program runs on; ``overrides`` replace workload
    keys and ``driver_kw`` go to the driver (both for tests on the CPU)."""
    from benchmark import compare, harness

    bench = bench or harness.spec()
    entry, workload, _, config = harness.cell(name, bench)
    workload = dict(workload, **(overrides or {}))
    ctx = harness.Context(cell=name, seed=seed, seconds=seconds, trace=trace, device=device,
                          chips=entry["chips"], config=config, workload=workload,
                          t_start=T_START if t_start is None else t_start)
    result = harness.driver(workload["driver"]).run(ctx, **driver_kw)
    ok, checks = compare.judge(result.numbers, workload["limits"])
    metrics = {}
    if trace:
        for m in harness.per_layer_metrics(bench, name):
            value = harness.metric_reader(m["name"])(result.traces[0])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(result.e2e, setup_s=result.setup_s)
        for m in harness.end_to_end_metrics(bench, name):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    out = {"correct": bool(ok and result.failed == 0), "attempted": result.attempted,
           "failed": result.failed, "metrics": metrics,
           "device": device_info(device, entry["chips"], result.memory_peak_bytes)}
    if trace:
        # The busy share averaged over the ranks' own windows, on the window
        # of the trace the per-layer metrics read.
        window = result.traces[0].window_s
        out["device"]["busy_s"] = window * statistics.fmean(
            t.busy_s / t.window_s for t in result.traces)
        out["device"]["window_s"] = window
        out["breakdown"] = result.traces[0].breakdown()
    out["checks"] = checks
    return out


def device_info(device: str, count: int, peak: int) -> dict:
    import torch

    from benchmark import harness

    if device != "cuda":
        return {"platform": device, "kind": device, "count": count, "memory_peak_bytes": peak}
    card = harness.card()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": peak, "power_limit": card["power_limit"]}


def main(argv=None) -> int:
    pin_caches()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    from benchmark import harness

    entry, *_ = harness.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        harness.log(f"cell {args.workload} needs {entry['chips']} CUDA card(s); "
                    f"this machine has {torch.cuda.device_count()}: no result")
        return 3
    card = harness.card()
    harness.log(f"card: {torch.cuda.get_device_name(0)} (nvidia-smi: "
                f"{card['nvidia_smi_name']}, power.limit {card['power_limit']}), "
                f"{torch.cuda.device_count()} visible, torch {torch.__version__}")
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = harness.forbidden_loaded()
    if bad:
        harness.log(f"the run loaded {bad}: the benchmark may not load JAX or the JAX "
                    "package; no result")
        return 4
    for k, v in out["checks"].items():
        harness.log(f"check {k}: {v['value']} (limit {v['limit']})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
