"""Human-readable time / time-scale formatting.

Behavioral ports of the reference formatters: time values with unit
autoscaling from attoseconds to years (nuclear_sim.py:561-587,
rendering.py:450-478), time-scale labels (rendering.py:394-429), and the
coarse sim-clock units (rendering.py:431-448).
"""

from __future__ import annotations

YEAR = 31557600.0
_MONTH = 2592000.0


def format_time_value_with_unit(seconds: float) -> str:
    """`1.23 ms`-style label across 24 orders of magnitude
    (nuclear_sim.py:561-587)."""
    s = abs(seconds)
    if s == 0:
        return "0 s"
    if s < 1e-15:
        return f"{seconds * 1e18:.2f} as"
    if s < 1e-12:
        return f"{seconds * 1e15:.2f} fs"
    if s < 1e-9:
        return f"{seconds * 1e12:.2f} ps"
    if s < 1e-6:
        return f"{seconds * 1e9:.2f} ns"
    if s < 1e-3:
        return f"{seconds * 1e6:.2f} μs"
    if s < 1:
        return f"{seconds * 1e3:.2f} ms"
    if s < 60:
        return f"{seconds:.2f} s"
    if s < 3600:
        return f"{seconds / 60:.2f} min"
    if s < 86400:
        return f"{seconds / 3600:.2f} h"
    if s < YEAR:
        return f"{seconds / 86400:.2f} days"
    return f"{seconds / YEAR:.2f} years"


def format_time_scale(time_scale: float) -> str:
    """Time-scale label (rendering.py:394-429)."""
    if time_scale == 1.0:
        return "x1.0 (real-time)"
    if time_scale > 1.0:
        if time_scale >= 1e9 * YEAR:
            return f"{time_scale / (1e9 * YEAR):.1f} billion years/s"
        if time_scale >= 1e6 * YEAR:
            return f"{time_scale / (1e6 * YEAR):.1f} million years/s"
        if time_scale >= 1e3 * YEAR:
            return f"{time_scale / (1e3 * YEAR):.1f} millennia/s"
        if time_scale >= YEAR:
            return f"{time_scale / YEAR:.1f} years/s"
        if time_scale >= 86400.0:
            return f"{time_scale / 86400.0:.1f} days/s"
        if time_scale >= 3600.0:
            return f"{time_scale / 3600.0:.1f} hours/s"
        if time_scale >= 60.0:
            return f"{time_scale / 60.0:.1f} min/s"
        return f"x{time_scale:.1f}"
    if time_scale <= 1e-15:
        return f"{time_scale / 1e-18:.3g} as/s"
    if time_scale <= 1e-12:
        return f"{time_scale / 1e-15:.3g} fs/s"
    if time_scale <= 1e-9:
        return f"{time_scale / 1e-12:.3g} ps/s"
    if time_scale <= 1e-6:
        return f"{time_scale / 1e-9:.3g} ns/s"
    if time_scale <= 1e-3:
        return f"{time_scale / 1e-6:.3g} μs/s"
    if time_scale < 1:
        return f"{time_scale * 1000:.3g} ms/s"
    return f"x{time_scale:.3g}"


def format_time_value(seconds: float) -> tuple[float, str]:
    """Coarse sim-clock (value, unit) pair (rendering.py:431-448)."""
    if seconds < 60:
        return seconds, "seconds"
    if seconds < 3600:
        return seconds / 60, "minutes"
    if seconds < 86400:
        return seconds / 3600, "hours"
    if seconds < _MONTH:
        return seconds / 86400, "days"
    if seconds < YEAR:
        return seconds / _MONTH, "months"
    if seconds < 1e3 * YEAR:
        return seconds / YEAR, "years"
    if seconds < 1e6 * YEAR:
        return seconds / (1e3 * YEAR), "millennia"
    return seconds / (1e6 * YEAR), "million years"


def format_half_life(half_life: float) -> tuple[str, str]:
    """(label, severity) pair matching the info panel's half-life buckets
    (rendering.py:169-192); severity is one of stable/long/medium/short."""
    if half_life == float("inf"):
        return "Stable", "stable"
    if half_life > 1e6 * YEAR:
        return f"{half_life / (1e6 * YEAR):.2e} million years", "stable"
    if half_life > 1e3 * YEAR:
        return f"{half_life / (1e3 * YEAR):.2e} millennia", "long"
    if half_life > YEAR:
        return f"{half_life / YEAR:.2f} years", "long"
    if half_life > 86400.0:
        return f"{half_life / 86400.0:.2f} days", "medium"
    if half_life > 3600.0:
        return f"{half_life / 3600.0:.2f} hours", "medium"
    return f"{half_life:.2f} seconds", "short"


def parse_time_scale(text: str) -> float:
    """Parse CLI time-scale strings: a float, or value+unit like
    '1e9yr', '5day', '2h', '30min' (the preset surface of
    nuclear_sim.py:78-87)."""
    text = text.strip().lower()
    units = {
        "yr": YEAR, "year": YEAR, "years": YEAR,
        "day": 86400.0, "days": 86400.0, "d": 86400.0,
        "h": 3600.0, "hr": 3600.0, "hour": 3600.0, "hours": 3600.0,
        "min": 60.0, "minute": 60.0, "minutes": 60.0,
        "s": 1.0, "sec": 1.0,
        "ms": 1e-3, "us": 1e-6, "ns": 1e-9, "ps": 1e-12, "fs": 1e-15,
    }
    for suffix in sorted(units, key=len, reverse=True):
        if text.endswith(suffix):
            head = text[: -len(suffix)]
            if head in ("", "+", "-"):
                head += "1"
            try:
                return float(head) * units[suffix]
            except ValueError:
                break
    return float(text)
