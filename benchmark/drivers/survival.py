"""Half-life fits back to back: ``analysis.survival_curve`` in a closed
loop, each call a fresh ensemble (its own ``ensemble_init``), its frames
through the decay-statistics frame and one survivor readback per frame,
ending in the endpoint fit. Call ``i`` of a run with seed ``s`` uses seed
``1000 s + i``.

Workload keys: ``batch``, ``frames``, ``half_lives``, ``substeps``,
``trace_fits`` (fits in the window of a traced run, after a lead-in of
one fit), ``sample_within`` and ``limits``.

``correct``: every fit of the window within the configuration's 1% of the
tabulated half-life; for two calls (one drawn from the seed and the last)
the reference's survival curve from the same seed, survivors after every
frame and decay totals exact.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import Context, Result, log, quarters
from benchmark.traces import profiled

# SimConfig fields that survival_curve sets itself from its arguments.
_OWN_FIELDS = ("z", "n", "max_particles", "max_chain_log")
_WARMUP_CALL = 999  # seed offset of the set-up call, never one of the window's
_LEAD_CALL = 998  # and of a traced run's lead-in


def run(ctx: Context) -> Result:
    import torch
    from torch.profiler import record_function

    from pyqmd_tpu_torch.analysis import survival_curve

    w, sim = ctx.workload, ctx.config["sim_config"]
    dev = torch.device(ctx.device, 0) if ctx.device == "cuda" else torch.device(ctx.device)
    cuda = dev.type == "cuda"
    overrides = {k: v for k, v in sim.items() if k not in _OWN_FIELDS}

    def fit(i: int):
        return survival_curve(
            sim["z"], sim["n"], batch=w["batch"], frames=w["frames"],
            half_lives=w["half_lives"], substeps=w["substeps"], seed=1000 * ctx.seed + i,
            pad_to=ctx.config["pad_to"], max_chain_log=sim["max_chain_log"],
            overrides=overrides, device=dev)

    fit(_WARMUP_CALL)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - ctx.t_start

    results, done = [], []

    def window(deadline=None, fits=None):
        while (fits is not None and len(results) < fits) or (
                deadline is not None and time.perf_counter() < deadline):
            with record_function("bench.fit"):
                results.append(fit(len(results)))
            done.append(time.perf_counter())
        if cuda:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    traces = []
    if ctx.trace:
        traces.append(profiled(lambda: window(fits=w["trace_fits"]), dev,
                               lambda: fit(_LEAD_CALL)))
    else:
        window(deadline=t0 + ctx.seconds)
    elapsed = time.perf_counter() - t0
    calls = len(results)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if ctx.trace:
        traces[0].info.update(
            fits=calls, nuclei=w["batch"], substeps=w["substeps"],
            decays=float(sum(r.decay_counts.sum() for r in results)),
            words=-(-sim["max_particles"] // 32))
    if cuda:
        torch.cuda.empty_cache()

    limit = min(calls, w["trace_fits"] if ctx.trace else w["sample_within"])
    sample = sorted({int(np.random.default_rng(ctx.seed).integers(0, limit)), calls - 1})
    from benchmark.reference.data.tables import half_life_host

    tabulated = half_life_host(sim["z"], sim["n"])
    errors = [abs(r.fitted_half_life - tabulated) / tabulated for r in results]
    log(f"survival: {calls} fits of {w['batch']} nuclei in {elapsed:.6f} s; fitted half-lives "
        f"{min(r.fitted_half_life for r in results)}-{max(r.fitted_half_life for r in results)} s"
        f"; checked calls {sample}; fits/s by quarter {quarters(done, t0, t0 + elapsed)}")
    numbers = check_calls(ctx, {i: results[i] for i in sample}, dev)
    numbers["halflife_rel_err"] = max(errors)
    bad = sum(int(not np.isfinite(e)) for e in errors)
    return Result(attempted=calls, failed=bad, setup_s=setup_s,
                  e2e={"halflife_fit_s": elapsed / calls}, numbers=numbers,
                  memory_peak_bytes=int(peak), traces=traces)


def check_calls(ctx: Context, calls: dict, dev) -> dict:
    """``survivors_differing`` (survivor counts after each frame) and
    ``decay_counts_differing`` (decay totals by type) of the given calls
    against the reference's curves from the same seeds."""
    from benchmark.reference import frame as ref
    from benchmark.reference.data.tables import half_life_host

    w, sim = ctx.workload, ctx.config["sim_config"]
    rcfg = ref.config_from_file(ctx.config, "ensemble")
    hl = half_life_host(sim["z"], sim["n"])
    surv = counts = 0
    for i, r in calls.items():
        want = ref.survival_curve(rcfg, w["batch"], w["frames"], w["half_lives"], w["substeps"],
                                  1000 * ctx.seed + i, hl, dev)
        got = np.rint(np.asarray(r.survival) * w["batch"]).astype(np.int64)
        surv += int((got != want["survivors"]).sum()) if got.shape == want["survivors"].shape \
            else got.size
        counts += int((np.asarray(r.decay_counts) != want["decay_counts"]).sum())
    return {"survivors_differing": surv, "decay_counts_differing": counts}
