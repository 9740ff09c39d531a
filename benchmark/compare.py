"""The comparisons that decide ``correct``: what the program produced
against what the plain reference works out from the same inputs.

Each function returns named numbers, every one of which a cell's workload
file gives a limit (``limits``); a number above its limit makes the run
not correct. Integer fields, RNG streams and counts are compared exactly
(their limit is 0). Floats are compared by their widest gap where the
program's kernels round unlike the plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

# Fields a frame writes that are integers (RNG words included): equal or wrong.
INT_FIELDS = ("z", "n", "ptype", "alive", "decay_counts", "chain_z0", "chain_n0",
              "chain_dtype", "chain_z1", "chain_n1", "chain_cursor", "rng", "ej_type",
              "ej_alive", "ej_cursor")
# Floats that only the decay engine and the clock write, in the same f32
# operations on both sides.
CLOCK_FIELDS = ("half_life", "time_passed", "last_decay_time", "chain_time", "ej_age",
                "ej_life")
INT_METRICS = ("alive", "z", "n", "decay_counts", "chain_cursor", "nan", "total_decay_counts",
               "total_alive")
FLOAT_METRICS = ("kinetic", "rms_radius", "com")


def differing(a: torch.Tensor, b: torch.Tensor) -> int:
    """Entries that differ (all of them if the shapes do)."""
    a, b = a.to(b.device), b
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a != b).sum())


def _rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest ``|a - b| / max(|b|, 1e-30)``; equal values (inf and NaN
    included) count 0, a shape mismatch inf."""
    a, b = a.to(b.device).double(), b.double()
    if a.shape != b.shape:
        return float("inf")
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    rel = (a - b).abs() / b.abs().clamp(min=1e-30)
    rel = torch.where(same, torch.zeros_like(rel), torch.nan_to_num(rel, nan=float("inf")))
    return float(rel.max()) if rel.numel() else 0.0


def _abs_gap(a: torch.Tensor, b: torch.Tensor, where: torch.Tensor) -> float:
    """Largest ``|a - b|`` over the entries ``where`` selects (NaN: inf)."""
    a = a.to(b.device)
    if a.shape != b.shape:
        return float("inf")
    d = torch.nan_to_num((a.double() - b.double()).abs(), nan=float("inf"))
    d = torch.where(where, d, torch.zeros_like(d))
    return float(d.max()) if d.numel() else 0.0


def frame_numbers(prog, ref, prog_metrics: dict | None = None,
                  ref_metrics: dict | None = None) -> dict:
    """The numbers of one frame: ``ints_differing`` (integer fields, RNG
    words and integer metrics), ``clock_rel_gap`` (the decay engine's and
    the clock's floats), ``pos_gap`` and ``vel_gap`` (nucleons the
    reference keeps alive, and live ejecta, in world units) and
    ``metrics_rel_gap`` (kinetic energy, RMS radius, centre of mass)."""
    ints = sum(differing(getattr(prog, f), getattr(ref, f)) for f in INT_FIELDS)
    clock = max(_rel_gap(getattr(prog, f), getattr(ref, f)) for f in CLOCK_FIELDS)
    alive = ref.alive[..., None].expand_as(ref.pos)
    ej = ref.ej_alive[..., None].expand_as(ref.ej_pos)
    pos = max(_abs_gap(prog.pos, ref.pos, alive), _abs_gap(prog.ej_pos, ref.ej_pos, ej))
    vel = max(_abs_gap(prog.vel, ref.vel, alive), _abs_gap(prog.ej_vel, ref.ej_vel, ej))
    out = {"ints_differing": ints, "clock_rel_gap": clock, "pos_gap": pos, "vel_gap": vel}
    if ref_metrics is not None:
        out["ints_differing"] += sum(
            differing(prog_metrics[k], ref_metrics[k]) for k in INT_METRICS if k in ref_metrics)
        out["metrics_rel_gap"] = max(
            _rel_gap(prog_metrics[k], ref_metrics[k]) for k in FLOAT_METRICS)
    return out


def init_numbers(prog, ref) -> dict:
    """The program's initial state against the reference's from the same
    seed: ``init_differing`` (entries of every field but the positions,
    compared exactly) and ``init_pos_gap``."""
    fields = INT_FIELDS + CLOCK_FIELDS + ("vel", "ej_pos", "ej_vel")
    return {"init_differing": sum(differing(getattr(prog, f), getattr(ref, f)) for f in fields),
            "init_pos_gap": frame_numbers(prog, ref)["pos_gap"]}


def worst(numbers: list[dict]) -> dict:
    """Each number's worst (largest) reading over several comparisons."""
    out: dict = {}
    for d in numbers:
        for k, v in d.items():
            out[k] = max(out.get(k, v), v)
    return out


def pixels_differing_share(prog: np.ndarray | None, ref: np.ndarray) -> float:
    """Share of pixels whose colour differs; a frame that never arrived
    (None) differs everywhere."""
    if prog is None or prog.shape != ref.shape:
        return 1.0
    return float(np.any(prog != ref, axis=-1).mean())


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(all within their limits, {name: {"value", "limit"}})``. A number
    without a limit, or a limit without a number, is a fault of the
    harness and raises."""
    if set(numbers) != set(limits):
        raise KeyError(f"numbers {sorted(numbers)} and limits {sorted(limits)} differ")
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in sorted(numbers)}
    ok = all(float(v["value"]) <= float(v["limit"]) for v in checks.values())
    return ok, checks
