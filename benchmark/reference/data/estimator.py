"""Semi-empirical half-life estimator for untabulated isotopes.

Behavioral twin of the reference estimator (reference decay_chains.py:264-328):
a stability score built from N/Z-band deviation, magic-number bonuses,
even-even/odd-odd parity and a Z > 83 penalty, mapped through a 9-bucket
log-uniform table from "essentially stable" down to microseconds.

The reference draws ``random.uniform`` *inside the lookup*, making every
call non-deterministic (SURVEY §2 C9). Here the deterministic part
(stability score -> bucket bounds) is separated from the random part
(one U(0,1) draw), so the estimate becomes a pure function of
``(z, n, key)`` and can run on the device from prebuilt tables.
"""

from __future__ import annotations

import math

from benchmark.reference.data.halflives import DAY, HOUR, MINUTE, YEAR

MAGIC_NUMBERS = (2, 8, 20, 28, 50, 82, 126)

# (min_stability, log10_lo, log10_hi, unit_scale); scanned top-down
# (decay_chains.py:309-328). A draw u in [0,1) yields
# half_life = 10 ** (lo + u * (hi - lo)) * scale seconds.
_BUCKETS: tuple[tuple[float, float, float, float], ...] = (
    (0.85, 15.0, 17.0, YEAR),
    (0.75, 9.0, 14.0, YEAR),
    (0.65, 6.0, 9.0, YEAR),
    (0.50, 3.0, 6.0, YEAR),
    (0.40, 0.0, 3.0, YEAR),
    (0.30, 0.0, 2.0, DAY),
    (0.20, 0.0, 4.0, HOUR),
    (0.10, -1.0, 3.0, MINUTE),
    (-1.0, -6.0, 1.0, 1.0),
)

STABLE_THRESHOLD = 0.95  # score >= this -> half-life = +inf


def stability_score(z: int, n: int) -> float:
    """Deterministic stability score in [0, 1] (decay_chains.py:277-306)."""
    n_to_z = n / max(1, z)
    stable_ratio = 1.0 if z < 20 else 1.0 + 0.015 * z**1.3
    deviation = abs(n_to_z - stable_ratio)

    magic_bonus = 0.0
    if z in MAGIC_NUMBERS:
        magic_bonus += 0.2
    if n in MAGIC_NUMBERS:
        magic_bonus += 0.2

    if z % 2 == 0 and n % 2 == 0:
        parity_factor = 0.5  # even-even: more stable
    elif z % 2 == 1 and n % 2 == 1:
        parity_factor = 2.0  # odd-odd: less stable
    else:
        parity_factor = 1.0

    score = max(0.0, 1.0 - deviation * 2.0 - parity_factor * 0.1 + magic_bonus)
    if z > 83:
        score *= 0.5
    return score


def bucket_params(score: float) -> tuple[float, float, float]:
    """(log10_lo, log10_hi, unit_scale) for a stability score.

    Scores >= STABLE_THRESHOLD are handled by the caller (half-life = inf);
    this returns the log-uniform draw bounds for the unstable buckets.
    """
    for min_score, lo, hi, scale in _BUCKETS:
        if score >= min_score:
            return lo, hi, scale
    return _BUCKETS[-1][1:]  # unreachable: last bucket catches everything


def estimate_half_life(z: int, n: int, u: float) -> float:
    """Pure keyed estimate: ``u`` is a U(0,1) draw supplied by the caller."""
    score = stability_score(z, n)
    if score >= STABLE_THRESHOLD:
        return math.inf
    lo, hi, scale = bucket_params(score)
    return 10.0 ** (lo + u * (hi - lo)) * scale
