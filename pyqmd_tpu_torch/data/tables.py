"""Dense (Z, N)-indexed nuclear-data tables for on-device lookups.

A decay happens inside the batched step, so the half-life DB, the branch
DB (tabulated entries plus the N/Z-ratio predictor on every other grid
cell) and the semi-empirical estimator's bucket bounds are densified once
into numpy arrays (:data:`_T`) and one packed row table (:data:`_ROWS`).
Lookups are then a row gather plus ``where`` chains. The numpy tables are
built exactly as ``pyqmd_tpu.data.tables`` builds them (the tests pin them
bitwise); the tensor copy of ``_ROWS`` lives on the device of the state
that reads it.

Grid: Z in [0, 128), N in [0, 192).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pyqmd_tpu_torch.data import chains as _chains
from pyqmd_tpu_torch.data import estimator as _est
from pyqmd_tpu_torch.data.halflives import HALF_LIVES
from pyqmd_tpu_torch.state import DECAY_NONE

Z_DIM = 128
N_DIM = 192
_CELLS = Z_DIM * N_DIM

# log2(10) and ln(2) rounded to f32, as the JAX package's f32 math has them.
_LOG2_10 = float(np.float32(math.log2(10.0)))
_LN2 = float(np.float32(math.log(2.0)))


def exp2(x: torch.Tensor) -> torch.Tensor:
    """``2**x`` rounded as the JAX package computes it: XLA lowers exp2 to
    ``exp(x * f32(ln 2))``, which differs from ``torch.exp2`` by a few ULP."""
    return torch.exp(x * _LN2)


def _build() -> dict[str, np.ndarray]:
    hl_tab = np.full((_CELLS,), np.nan, np.float32)
    est_stable = np.zeros((_CELLS,), bool)
    est_lo = np.zeros((_CELLS,), np.float32)
    est_span = np.zeros((_CELLS,), np.float32)
    est_scale = np.ones((_CELLS,), np.float32)
    br_z = np.zeros((_CELLS, 2), np.int32)
    br_n = np.zeros((_CELLS, 2), np.int32)
    br_t = np.full((_CELLS, 2), DECAY_NONE, np.int32)
    br_p0 = np.ones((_CELLS,), np.float32)

    for z in range(Z_DIM):
        for n in range(N_DIM):
            i = z * N_DIM + n
            # Half-life: tabulated value (inf = stable) or NaN = "estimate".
            if (z, n) in HALF_LIVES:
                hl_tab[i] = np.float32(HALF_LIVES[(z, n)])
            score = _est.stability_score(z, n)
            est_stable[i] = score >= _est.STABLE_THRESHOLD
            lo, hi, scale = _est.bucket_params(score)
            est_lo[i] = lo
            est_span[i] = hi - lo
            est_scale[i] = scale
            # Single-branch entries are duplicated into slot 1 so the rule
            # "branch 1 iff r > p0" can never select a wrong daughter
            # (decay_chains.py:223-229).
            branches = _chains.decay_branches(z, n)
            b0 = branches[0]
            b1 = branches[1] if len(branches) > 1 else b0
            br_z[i] = (b0[0], b1[0])
            br_n[i] = (b0[1], b1[1])
            br_t[i] = (b0[2], b1[2])
            br_p0[i] = b0[3] if len(branches) > 1 else 1.0

    return dict(
        hl_tab=hl_tab, est_stable=est_stable, est_lo=est_lo,
        est_span=est_span, est_scale=est_scale,
        br_z=br_z, br_n=br_n, br_t=br_t, br_p0=br_p0,
    )


_T = _build()

# Packed row table: every per-cell field in one (CELLS, 16) f32 row, so a
# decay event costs two row gathers (parent cell, daughter cell). Integer
# fields ride as exact f32 (all values << 2^24); rows pad to 16.
# Layout: 0 hl_tab, 1 est_lo, 2 est_span, 3 est_scale, 4 est_stable,
#         5 br_p0, 6-8 br_z0/br_n0/br_t0, 9-11 br_z1/br_n1/br_t1.
_ROWS = np.zeros((_CELLS, 16), np.float32)
_ROWS[:, 0] = _T["hl_tab"]
_ROWS[:, 1] = _T["est_lo"]
_ROWS[:, 2] = _T["est_span"]
_ROWS[:, 3] = _T["est_scale"]
_ROWS[:, 4] = _T["est_stable"].astype(np.float32)
_ROWS[:, 5] = _T["br_p0"]
_ROWS[:, 6] = _T["br_z"][:, 0]
_ROWS[:, 7] = _T["br_n"][:, 0]
_ROWS[:, 8] = _T["br_t"][:, 0]
_ROWS[:, 9] = _T["br_z"][:, 1]
_ROWS[:, 10] = _T["br_n"][:, 1]
_ROWS[:, 11] = _T["br_t"][:, 1]

# Tensor copies of constant numpy tables, one per (table, device), made on
# first use so a substep copies nothing from the host. Each entry keeps its
# table alive, so an id is never reused for another array.
_ON_DEVICE: dict = {}


def on_device(table: np.ndarray, device) -> torch.Tensor:
    """The tensor copy of the constant ``table`` on ``device``."""
    key = (id(table), torch.device(device))
    entry = _ON_DEVICE.get(key)
    if entry is None:
        entry = _ON_DEVICE[key] = (table, torch.from_numpy(table).to(device))
    return entry[1]


def rows_on(device) -> torch.Tensor:
    """The packed row table as a tensor on ``device``."""
    return on_device(_ROWS, device)


def _flat_index(z: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    zc = torch.clamp(z, 0, Z_DIM - 1).to(torch.int64)
    nc = torch.clamp(n, 0, N_DIM - 1).to(torch.int64)
    return zc * N_DIM + nc


def lookup_row(z: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """(..., 16) packed data rows for isotopes (z, n) — layout above."""
    return rows_on(z.device)[_flat_index(z, n)]


def half_life_from_row(row: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Half-life in seconds over a pre-gathered packed row; ``u`` is a
    U(0,1) draw. Tabulated isotopes are deterministic; untabulated ones
    get the keyed semi-empirical estimate (decay_chains.py:247-328)."""
    est = exp2(_LOG2_10 * (row[..., 1] + u * row[..., 2])) * row[..., 3]
    est = torch.where(row[..., 4] > 0.5, math.inf, est)
    return torch.where(torch.isnan(row[..., 0]), est, row[..., 0])


def sample_branch_from_row(row: torch.Tensor, r: torch.Tensor):
    """Decay branch over a pre-gathered packed row: branch 1 iff
    ``r > p0`` (decay_chains.py:218-229). Returns (new_z, new_n, dtype)."""
    pick1 = r > row[..., 5]
    new_z = torch.where(pick1, row[..., 9], row[..., 6]).to(torch.int32)
    new_n = torch.where(pick1, row[..., 10], row[..., 7]).to(torch.int32)
    dtype = torch.where(pick1, row[..., 11], row[..., 8]).to(torch.int32)
    return new_z, new_n, dtype


def half_life(z: torch.Tensor, n: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Half-life of isotopes (z, n) with estimate draw ``u``."""
    return half_life_from_row(lookup_row(z, n), u)


def sample_branch(z: torch.Tensor, n: torch.Tensor, r: torch.Tensor):
    """Sample a decay branch of isotopes (z, n) with draw ``r``."""
    return sample_branch_from_row(lookup_row(z, n), r)


def half_life_host(z: int, n: int, u: float = 0.5) -> float:
    """Host-side half-life of isotope (z, n) in seconds: the tabulated
    value, else the semi-empirical estimate at draw ``u``."""
    if (z, n) in HALF_LIVES:
        return float(HALF_LIVES[(z, n)])
    return _est.estimate_half_life(z, n, u)
