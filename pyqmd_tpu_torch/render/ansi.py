"""ANSI terminal rendering of framebuffers.

Turns an (H, W, 3) uint8 image into truecolor escape sequences using the
upper-half-block glyph (two pixels per character cell) — the terminal
analog of the reference's PyGame window for the REPL's ``show``/``watch``
commands. H is rounded down to an even number of rows.
"""

from __future__ import annotations

import numpy as np

_RESET = "\x1b[0m"


def ansi_render(img: np.ndarray) -> str:
    """Encode an RGB image as truecolor half-block text."""
    img = np.asarray(img, np.uint8)
    h = (img.shape[0] // 2) * 2
    top = img[0:h:2]
    bottom = img[1:h:2]
    lines = []
    for t_row, b_row in zip(top, bottom):
        parts = []
        last = None
        for (tr, tg, tb), (br, bg, bb) in zip(t_row.astype(int), b_row.astype(int)):
            key = (tr, tg, tb, br, bg, bb)
            if key != last:
                parts.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m")
                last = key
            parts.append("▀")
        parts.append(_RESET)
        lines.append("".join(parts))
    return "\n".join(lines)
