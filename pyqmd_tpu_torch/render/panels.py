"""Host-side info + decay-chain panel overlays.

Behavioral port of the reference's PyGame panels: the info panel
(rendering.py:135-246 — acceleration badge, zoom,
element/isotope, Z/N, color-coded half-life, decay-type counters, sim time,
time scale, substep meter, physics dt, controls help) and the decay-chain
panel (rendering.py:248-380 — right-side column with title,
scroll window math, per-step ``X-A → Y-B (sym)`` lines and durations).

Panel text changes at most once per frame, so the overlay is composed on
host with the 5x7 bitmap font and burned over the device-rendered frame as
one vectorized masked write: particles/ruler rasterize on the device,
text overlays on the host.
"""

from __future__ import annotations

import numpy as np

from pyqmd_tpu_torch.data.elements import element_name, isotope_label
from pyqmd_tpu_torch.render.font import render_text, text_width
from pyqmd_tpu_torch.state import DECAY_TYPE_NAMES
from pyqmd_tpu_torch.utils.format import (
    format_half_life,
    format_time_scale,
    format_time_value,
    format_time_value_with_unit,
)

YEAR = 31557600.0

# Info-panel item colors (rendering.py:149-246).
WHITE = (255, 255, 255)
GREY = (200, 200, 200)
ACCEL_ON = (100, 255, 100)
ZOOM_COLOR = (200, 200, 255)
PROTON_COLOR = (255, 100, 100)
NEUTRON_COLOR = (100, 100, 255)
CONTROLS_HEADING = (255, 255, 150)
DT_COLOR = (200, 200, 255)

# Per-decay-type counter colors (rendering.py:199-207), indexed like
# DECAY_TYPE_NAMES.
DECAY_COLORS = {
    "ALPHA": (255, 200, 0),
    "BETA_MINUS": (0, 255, 255),
    "BETA_PLUS": (255, 0, 255),
    "GAMMA": (0, 255, 0),
    "NEUTRON_EMISSION": (100, 100, 255),
    "PROTON_EMISSION": (255, 100, 100),
    "SPONTANEOUS_FISSION": (255, 128, 0),
}

# Decay-chain panel colors (rendering.py:255-369).
CHAIN_BG = (30, 30, 40)
CHAIN_TITLE = (255, 220, 150)
CHAIN_COUNT = (180, 180, 180)
CHAIN_HELP = (150, 150, 150)
CHAIN_ENTRY = (200, 200, 200)
CHAIN_CURRENT = (255, 255, 100)
CHAIN_TIME = (180, 180, 200)


def half_life_color(half_life: float) -> tuple[int, int, int]:
    """Half-life bucket color (rendering.py:169-192)."""
    if half_life == float("inf") or half_life > 1e6 * YEAR:
        return (100, 255, 100)
    if half_life > 1e3 * YEAR:
        return (180, 255, 100)
    if half_life > YEAR:
        return (255, 255, 0)
    if half_life > 86400.0:
        return (255, 150, 0)
    if half_life > 3600.0:
        return (255, 100, 0)
    return (255, 80, 80)


def substeps_color(substeps: int, max_substeps: int) -> tuple[int, int, int]:
    """Substep-meter thresholds (rendering.py:224-229)."""
    ratio = substeps / max_substeps if max_substeps > 0 else 0.0
    if ratio > 0.95:
        return (255, 100, 100)
    if ratio > 0.75:
        return (255, 200, 100)
    return (100, 255, 100)


class OverlayCanvas:
    """An RGB + coverage-mask pair the panels draw into."""

    def __init__(self, width: int, height: int, scale: int = 2):
        self.w, self.h = width, height
        self.scale = scale
        self.line_height = 9 * scale  # 7px glyphs + 2px leading, scaled
        self.rgb = np.zeros((height, width, 3), np.uint8)
        self.mask = np.zeros((height, width), bool)

    def fill_rect(self, x: int, y: int, w: int, h: int, color):
        x0, y0 = max(0, x), max(0, y)
        x1, y1 = min(self.w, x + w), min(self.h, y + h)
        if x1 > x0 and y1 > y0:
            self.rgb[y0:y1, x0:x1] = color
            self.mask[y0:y1, x0:x1] = True

    def text(self, x: int, y: int, s: str, color=WHITE) -> int:
        """Draw ``s`` at (x, y); returns the next line's y (the reference's
        add_item y-tracking, rendering.py:142-146)."""
        if 0 <= y <= self.h:  # cull like the reference's in-view check
            m = render_text(s, self.scale) > 0
            gh, gw = m.shape
            x1, y1 = min(self.w, x + gw), min(self.h, y + gh)
            if x1 > x and y1 > y and x >= 0 and y >= 0:
                sub = m[: y1 - y, : x1 - x]
                region_rgb = self.rgb[y:y1, x:x1]
                region_rgb[sub] = color
                self.mask[y:y1, x:x1] |= sub
        return y + self.line_height

    def text_centered(self, cx: int, y: int, s: str, color=WHITE) -> int:
        return self.text(cx - text_width(s, self.scale) // 2, y, s, color)


# The headless controls column mirrors the reference's keyboard help
# (rendering.py:233-246) with the REPL command surface (cli.py).
CONTROLS = (
    ("Controls:", CONTROLS_HEADING),
    ("pan dx dy: Move camera", GREY),
    ("zoom in/out: Zoom", GREY),
    ("faster/slower: Time x10", GREY),
    ("ff/rew: Fine tune time", GREY),
    ("auto: Toggle auto-substeps", GREY),
    ("substeps N: Max substeps", GREY),
    ("dt VALUE: Physics timestep", GREY),
    ("decay: Force decay", GREY),
    ("iso 1-9: Select isotopes", GREY),
    ("preset NAME: Time presets", GREY),
    ("scroll N: Scroll decay chain", GREY),
)


def draw_info_panel(
    canvas: OverlayCanvas,
    status: dict,
    max_substeps: int,
    controls: bool = True,
    scroll: int = 0,
):
    """Info panel, top-left (rendering.py:135-246). ``scroll`` shifts the
    column up by that many lines (the reference's ``info_panel_scroll``,
    rendering.py:140, 534-536); off-screen lines are culled by text()."""
    lh = canvas.line_height
    x, y = 5 * canvas.scale, 5 * canvas.scale - max(0, scroll) * lh
    # The badge names the device the frames run on (``status()["backend"]``).
    backend = status.get("backend", "cuda")
    y = canvas.text(x, y, f"Acceleration: {backend.upper()}", ACCEL_ON)
    if "zoom" in status:
        y = canvas.text(x, y, f"Zoom: {status['zoom']:.1f}x", ZOOM_COLOR)
    if "z" in status:
        z, n = status["z"], status["n"]
        name, sym = element_name(z)
        y = canvas.text(x, y, f"Element: {name} ({sym})", WHITE)
        y = canvas.text(x, y, f"Isotope: {sym}-{z + n}", WHITE)
        y = canvas.text(x, y, f"Protons: {z}", PROTON_COLOR)
        y = canvas.text(x, y, f"Neutrons: {n}", NEUTRON_COLOR)
        hl = status["half_life"]
        label, _ = format_half_life(hl)
        y = canvas.text(x, y, f"Half-life: {label}", half_life_color(hl))
    else:  # ensemble summary (no single-nucleus identity)
        y = canvas.text(x, y, f"Ensemble: {status.get('isotope', '?')}", WHITE)
        if "alive" in status:
            y = canvas.text(x, y, f"Nucleons alive: {status['alive']}", WHITE)

    counts = status.get("decay_counts", [])
    shown = [
        (DECAY_TYPE_NAMES[i], c)
        for i, c in enumerate(counts)
        if i > 0 and c > 0  # the reference shows only non-zero counters
    ]
    y += lh
    y = canvas.text(x, y, "Decay Statistics:", WHITE)
    for tname, c in shown:
        y = canvas.text(x, y, f"{tname}: {c}", DECAY_COLORS.get(tname, GREY))

    y += lh
    if "time_passed" in status:
        val, unit = format_time_value(status["time_passed"])
        y = canvas.text(x, y, f"Simulation Time: {val:.2f} {unit}", WHITE)
    y = canvas.text(
        x, y, f"Time Scale: {format_time_scale(status['time_scale'])}", WHITE
    )
    substeps = status.get("substeps", 0)
    if substeps > 0:
        ratio = substeps / max_substeps if max_substeps > 0 else 0.0
        y = canvas.text(
            x, y,
            f"Physics substeps: {substeps}/{max_substeps} ({ratio:.0%})",
            substeps_color(substeps, max_substeps),
        )
        if "physics_dt" in status:
            y = canvas.text(
                x, y, f"Physics dt: {status['physics_dt']:.6f}s", DT_COLOR
            )
    if status.get("fps"):
        y = canvas.text(x, y, f"FPS: {status['fps']:.1f}", ZOOM_COLOR)

    if controls:
        y += lh
        for line, color in CONTROLS:
            y = canvas.text(x, y, line, color)
    return y


def chain_scroll_limit(
    width: int, height: int, n_steps: int, scale: int | None = None
) -> int:
    """Max useful decay-chain scroll for a (width x height) frame — the
    reference's ``max_decay_scroll`` (rendering.py:283-292). Shares the
    window math AND the scale rule with :func:`compose_panels` /
    :func:`draw_decay_chain`."""
    if scale is None:
        scale = 2 if min(width, height) >= 400 else 1
    lh = 9 * scale
    header_y = 5 * scale + lh + lh // 2  # title + half-line gap
    _, max_scroll = _chain_window(height, header_y, lh, scale, n_steps)
    return max_scroll


def _chain_window(height: int, y: int, lh: int, scale: int, n_steps: int):
    """(visible_items, max_scroll) for the entry area below header ``y``
    (each entry takes ~2.5 lines, rendering.py:283-292)."""
    area = height - y - 5 * scale
    visible = max(1, int(area / (lh * 2.5)))
    return visible, max(0, n_steps - visible)


def draw_decay_chain(canvas: OverlayCanvas, chain: list[dict], scroll: int = 0):
    """Right-side decay-chain panel (rendering.py:248-380).

    ``chain`` is ``Simulation.chain_entries()`` output (oldest first, the
    initial-state record at index 0). Returns the clamped scroll value.
    """
    lh = canvas.line_height
    panel_w = 150 * canvas.scale  # the reference's 300px column (rendering.py:251)
    x = canvas.w - panel_w - 5 * canvas.scale
    cx = x + panel_w // 2
    canvas.fill_rect(
        x - 3 * canvas.scale, 3 * canvas.scale,
        panel_w, canvas.h - 6 * canvas.scale, CHAIN_BG,
    )
    y = 5 * canvas.scale
    y = canvas.text_centered(cx, y, "Decay Chain", CHAIN_TITLE)
    y += lh // 2

    steps = [e for e in chain if e["index"] > 0]  # skip the initial record
    if not steps:
        if chain:
            lab = isotope_label(*chain[0]["child"])
            canvas.text_centered(cx, y, f"Current: {lab}", ZOOM_COLOR)
        return 0

    visible, max_scroll = _chain_window(canvas.h, y, lh, canvas.scale, len(steps))
    scroll = max(0, min(scroll, max_scroll))
    end = min(len(steps), scroll + visible)

    y = canvas.text_centered(
        cx, y, f"({scroll + 1}-{end} of {len(steps)})", CHAIN_COUNT
    )
    if scroll > 0:
        canvas.text_centered(cx, y, "↑ More ↑", CHAIN_COUNT)
    y += lh // 2

    for i, e in enumerate(steps[scroll:end]):
        is_current = scroll + i == len(steps) - 1
        color = CHAIN_CURRENT if is_current else CHAIN_ENTRY
        head = f"{scroll + i + 1}. "
        text = (
            f"{head}{isotope_label(*e['parent'])} → "
            f"{isotope_label(*e['child'])} ({e['symbol']})"
        )
        y = canvas.text(x, y, text, color)
        dur = e["duration"]
        time_text = "[<1 fs]" if dur == 0 else format_time_value_with_unit(dur)
        y = canvas.text(x + 5 * canvas.scale, y, f"Time: {time_text}", CHAIN_TIME)
        y += 2 * canvas.scale  # inter-entry gap
    if scroll < max_scroll:
        canvas.text_centered(
            cx, canvas.h - 5 * canvas.scale - 7 * canvas.scale,
            "↓ More ↓", CHAIN_COUNT,
        )
    return scroll


def compose_panels(
    width: int,
    height: int,
    status: dict,
    chain: list[dict] | None = None,
    *,
    max_substeps: int = 20,
    chain_scroll: int = 0,
    info_scroll: int = 0,
    controls: bool = True,
    scale: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Compose both panels; returns ``(rgb, mask)`` overlay arrays."""
    if scale is None:
        scale = 2 if min(width, height) >= 400 else 1
    canvas = OverlayCanvas(width, height, scale)
    draw_info_panel(
        canvas, status, max_substeps, controls=controls, scroll=info_scroll
    )
    if chain is not None:
        draw_decay_chain(canvas, chain, scroll=chain_scroll)
    return canvas.rgb, canvas.mask


def burn_overlay(img: np.ndarray, rgb: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Burn a composed overlay into a rendered frame (vectorized)."""
    return np.where(mask[..., None], rgb, img)
