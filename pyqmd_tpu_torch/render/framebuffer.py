"""Headless framebuffer rasterizer.

The replacement for the PyGame renderer (rendering.py:32-127): one pass of
tensor code rasterizes the scene into an (H, W, 3) uint8 image on the
state's device, with the reference's visual semantics:

  * world->screen transform with camera + zoom (rendering.py:121-127),
  * nucleons y-sorted (painter's order: larger y wins, rendering.py:42-44),
  * per-type colors (particles.py:41-50), proton highlight and neutron ring
    (rendering.py:72-85),
  * ejecta drawn on top in append order (most recent ring slot wins) with
    age/lifetime fade (rendering.py:46-48, 66-68),
  * the femtometer scale ruler burned in (rendering.py:87-119).

One path: the winner of each pixel by a reduction over particles. A
nucleon's painter rank is its place in the stable sort by world y (dead
first), so among the alive nucleons covering a pixel the largest
``(y, index)`` wins; among live ejecta the most recent ring slot. The
coverage tensors are (chunk, H, W), built in chunks of particles so they
stay small at any frame size; colours, highlight, ring, fade, ruler and
label are per-pixel passes over the winners. Nothing is read back to the
host: camera and zoom may be Python floats or tensors on the device.

The coverage math is f32 and rounds as the JAX package's compiled
rasterizer does on the CPU, so the images are equal bitwise there, down to
edge pixels whose distance lies within an ULP of a radius. That compiler
rounds the squared distance one way in the reference's windowed path and
another in its full-frame path (:func:`_reference_fuses`), contracts the
ruler's inner ticks into fused multiply-adds (:func:`_fma` here), and
leaves the world-to-screen transform and the bar's end as a rounded
product and a sum.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pyqmd_tpu_torch.data.tables import on_device
from pyqmd_tpu_torch.render.font import label_stack as _label_stack
from pyqmd_tpu_torch.state import (
    EJECTA_RADIUS,
    NEUTRON,
    NUCLEON_RADIUS,
    PARTICLE_COLORS,
    PROTON,
    NucleusState,
)

RULER_COLOR = np.array([200.0, 200.0, 200.0], np.float32)
PROTON_HIGHLIGHT = np.array([255.0, 150.0, 150.0], np.float32)
NEUTRON_RING = np.array([150.0, 150.0, 200.0], np.float32)
FM_PER_UNIT = 0.5  # rendering.py:15
NICE_FM = np.array([0.5, 1, 2, 5, 10, 20, 50, 100, 200, 500], np.float32)

# Pre-rendered "<nice> fm" labels (rendering.py:115-116); the rasterizer
# picks one with a single gather.
_FM_LABELS = np.ascontiguousarray(
    _label_stack([f"{v:g} fm" for v in NICE_FM.tolist()], scale=2)
)
_COLORS_F32 = PARTICLE_COLORS.astype(np.float32)

# Particles per coverage chunk: (chunk, H, W) f64 is 123 MB at 800x600.
_CHUNK = 32

_F32 = torch.float32


def _fma(a, b, c):
    """``a * b + c`` rounded once, as a fused multiply-add: the product of
    two f32 values is exact in f64."""
    return (a.double() * b.double() + c.double()).to(_F32)


# Host scalars reach the device as fills, never as tensors built from Python
# values: such a tensor is a host-to-device copy that waits for the stream.


def _scalar(v, device) -> torch.Tensor:
    """A Python float or a 0-d tensor as an f32 0-d tensor on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=_F32)
    return torch.full((), float(v), dtype=_F32, device=device)


def pair_on(device, x, y) -> torch.Tensor:
    """``[x, y]`` as a (2,) f32 tensor on ``device`` (two fills)."""
    out = torch.full((2,), float(x), dtype=_F32, device=device)
    out[1:].fill_(float(y))  # an item assignment would copy from the host
    return out


def _world_to_screen(p, camera, zoom, width, height):
    """rendering.py:121-127."""
    center = pair_on(p.device, width / 2.0, height / 2.0)
    return center + (p - camera) * zoom


def _dist2(lx, ly, sx, sy, fused: bool):
    """Squared pixel distance ``(lx - sx)**2 + (ly - sy)**2``: both
    products rounded, or with ``fused`` the x product contracted into the
    sum (see :func:`_reference_fuses`)."""
    dx = lx - sx
    dy = ly - sy
    if fused:
        return _fma(dx, dx, dy * dy)
    return dx * dx + dy * dy


def _nucleon_patch_masks(lx, ly, sx, sy, r_nuc, fused: bool):
    """Disc / highlight / ring coverage at absolute pixel coords (lx, ly)
    for a nucleon at screen (sx, sy) (rendering.py:60-85)."""
    d2 = _dist2(lx, ly, sx, sy, fused)
    cover = d2 <= r_nuc * r_nuc
    hi_r = torch.clamp(torch.floor(r_nuc * 0.3), min=1.0)
    hi_off = torch.clamp(torch.floor(r_nuc * 0.2), min=1.0)
    hd2 = _dist2(lx, ly, sx - hi_off, sy - hi_off, fused)
    highlight = (r_nuc > 3) & (hd2 <= hi_r * hi_r)
    ring = (r_nuc > 2) & (torch.abs(torch.sqrt(d2) - (r_nuc - 1.0)) <= 0.5)
    return cover, highlight, ring


def _winner(screen, radius, live, score, xs, ys, fused: bool):
    """Per pixel, the largest ``score`` (a distinct int per particle,
    >= 0) among the ``live`` particles whose disc of ``radius`` at
    ``screen`` covers it; -1 where none does."""
    r2 = radius * radius
    best = torch.full((ys.shape[0], xs.shape[1]), -1, dtype=torch.int64, device=xs.device)
    for s in range(0, screen.shape[0], _CHUNK):
        sx = screen[s:s + _CHUNK, 0, None, None]
        sy = screen[s:s + _CHUNK, 1, None, None]
        cover = (_dist2(xs, ys, sx, sy, fused) <= r2) & live[s:s + _CHUNK, None, None]
        cand = torch.where(cover, score[s:s + _CHUNK, None, None], -1).amax(0)
        best = torch.maximum(best, cand)
    return best


def _window_size(radius_px: float, width: int, height: int) -> int | None:
    """The reference's window bucket for a disc: the smallest power of two
    covering it with a 2px margin, or None when no window fits the frame."""
    need = int(2 * math.ceil(radius_px) + 6)
    win = 16
    while win < need:
        win *= 2
    return win if win <= min(width, height) else None


def _reference_fuses(zoom, width: int, height: int) -> bool:
    """Whether the reference's compiled code contracts the squared
    distance into a fused multiply-add for this call.

    The reference has two compiled paths with the same arithmetic on
    paper: a painter's loop over small windows, taken when the zoom is a
    host value and the discs fit a window, and a full-frame reduction
    otherwise (huge zoom, or a zoom that is only known on the device).
    Its compiler rounds both products of ``dx*dx + dy*dy`` in the first and
    fuses the x product into the sum in the second, which decides edge
    pixels whose distance lies within an ULP of the radius."""
    if isinstance(zoom, torch.Tensor):
        return True
    z = max(float(zoom), 0.1)
    win_n = _window_size(max(1.0, math.floor(NUCLEON_RADIUS * z)), width, height)
    win_e = _window_size(max(1.0, math.floor(EJECTA_RADIUS * z)), width, height)
    return win_n is None or win_e is None


def ejecta_colors(ej_type, ej_age, ej_life) -> torch.Tensor:
    """(E, 3) f32 colours of the ejecta slots, faded by age over lifetime
    (rendering.py:47, 66-68). The packed frame's palette is built from the
    same values, so a drawn ejecta pixel always matches an entry."""
    fade = torch.where(
        torch.isinf(ej_life), 0.0, ej_age / torch.clamp(ej_life, min=1e-9)
    )
    colors = on_device(_COLORS_F32, ej_type.device)
    return colors[ej_type.long()] * (1.0 - torch.clamp(fade, max=1.0))[:, None]


def to_rgb8(img: torch.Tensor) -> torch.Tensor:
    """f32 colours as uint8, the rasterizer's final cast."""
    return torch.clamp(img, 0, 255).to(torch.uint8)


def render_frame(
    state: NucleusState,
    camera,
    zoom,
    width: int = 800,
    height: int = 600,
    ruler: bool = True,
    index: int = 0,
) -> torch.Tensor:
    """Rasterize member ``index`` of ``state`` and its ejecta to an
    (H, W, 3) uint8 image on the state's device.

    ``camera`` is an (x, y) pair of floats or a (2,) tensor; ``zoom`` a
    float or a 0-d tensor. Neither is read back.
    """
    dev = state.pos.device
    fused = _reference_fuses(zoom, width, height)
    pos, alive, ptype = state.pos[index], state.alive[index], state.ptype[index]
    if isinstance(camera, torch.Tensor):
        camera = camera.to(device=dev, dtype=_F32)
    else:
        camera = pair_on(dev, camera[0], camera[1])
    zoom = torch.clamp(_scalar(zoom, dev), min=0.1)  # rendering.py:39

    xs = torch.arange(width, dtype=_F32, device=dev)[None, :]
    ys = torch.arange(height, dtype=_F32, device=dev)[:, None]
    colors = on_device(_COLORS_F32, dev)

    # Nucleon pass: winner = covering alive nucleon with the largest
    # (world y, index), i.e. the last drawn of a stable y-sort.
    n_screen = _world_to_screen(pos, camera, zoom, width, height)
    r_nuc = torch.clamp(torch.floor(NUCLEON_RADIUS * zoom), min=1.0)  # rendering.py:65
    sort_y = torch.where(alive, pos[:, 1], -torch.inf)
    order = torch.sort(sort_y, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=dev)
    # A NaN y never wins in the painter's comparison.
    best_rank = _winner(n_screen, r_nuc, alive & ~torch.isnan(pos[:, 1]), rank, xs, ys, fused)
    has_nucleon = best_rank >= 0
    best_i = order[torch.clamp(best_rank, min=0)]

    w_type = ptype[best_i]
    w_center = n_screen[best_i]  # (H, W, 2) screen center of the winner
    _, highlight, ring = _nucleon_patch_masks(
        xs, ys, w_center[..., 0], w_center[..., 1], r_nuc, fused
    )
    img = torch.where(has_nucleon[..., None], colors[w_type.long()], 0.0)
    hi = has_nucleon & (w_type == PROTON) & highlight
    img = torch.where(hi[..., None], on_device(PROTON_HIGHLIGHT, dev), img)
    ring_m = has_nucleon & (w_type == NEUTRON) & ring
    img = torch.where(ring_m[..., None], on_device(NEUTRON_RING, dev), img)

    # Ejecta pass: the most recently written ring slot wins
    # (rendering.py:46-48), faded by age/lifetime (rendering.py:47, 66-68).
    e_screen = _world_to_screen(state.ej_pos[index], camera, zoom, width, height)
    r_ej = torch.clamp(torch.floor(EJECTA_RADIUS * zoom), min=1.0)
    e_cap = e_screen.shape[0]
    cursor = state.ej_cursor[index].long()
    recency = (torch.arange(e_cap, device=dev) - cursor) % e_cap
    best_r = _winner(e_screen, r_ej, state.ej_alive[index], recency, xs, ys, fused)
    has_ej = best_r >= 0
    best_ei = (torch.clamp(best_r, min=0) + cursor) % e_cap
    e_col = ejecta_colors(state.ej_type[index], state.ej_age[index], state.ej_life[index])
    img = torch.where(has_ej[..., None], e_col[best_ei], img)

    if ruler:
        img = _burn_ruler(img, zoom, width, height)
    return to_rgb8(img)


def _burn_ruler(img, zoom, width: int, height: int):
    """Femtometer scale bar (rendering.py:87-113) + bitmap label."""
    dev = img.device
    ruler_width = width * 0.25
    fm_length = (_scalar(ruler_width, dev) / zoom) * FM_PER_UNIT
    nice = on_device(NICE_FM, dev)
    # First nice value >= fm_length, then step one down (rendering.py:92-98).
    ge = nice >= fm_length
    first = torch.argmax(ge.to(torch.int8))  # 0 if none (handled below)
    idx = torch.where(ge.any(), torch.clamp(first - 1, min=0), len(NICE_FM) - 1)
    idx = idx.reshape(1)  # gathers below: indexing with a 0-d tensor would read it back
    nice_fm = nice.index_select(0, idx)[0]
    ruler_len = (nice_fm / FM_PER_UNIT) * zoom

    x0, y0 = 50.0, height - 50.0
    xs = torch.arange(width, dtype=_F32, device=dev)[None, :]
    ys = torch.arange(height, dtype=_F32, device=dev)[:, None]

    # The reference's compiled code rounds ruler_len once and adds x0 to it
    # for the bar's end and the last tick, and contracts tick i into
    # ruler_len * (i / 5) + x0 with one rounding.
    x0_t = _scalar(x0, dev)
    bar_end = x0_t + ruler_len
    mask = (torch.abs(ys - y0) <= 1.0) & (xs >= x0) & (xs <= bar_end)
    for i in range(6):
        if i == 0:
            tick_x = x0_t
        elif i == 5:
            tick_x = bar_end
        else:
            tick_x = _fma(ruler_len, _scalar(np.float32(i) / np.float32(5.0), dev), x0_t)
        tick_h = 10.0 if i % 5 == 0 else 5.0
        mask = mask | ((torch.abs(xs - tick_x) <= 0.5) & (ys <= y0) & (ys >= y0 - tick_h))
    img = torch.where(mask[..., None], on_device(RULER_COLOR, dev), img)

    # "<nice> fm" label above the bar (rendering.py:115-116), statically
    # placed; the label bitmap is chosen on the device by the nice-value
    # index.
    label = on_device(_FM_LABELS, dev).index_select(0, idx)[0]  # (lh, lw) mask
    lh, lw = label.shape
    ly = int(y0) - 25
    lx = int(x0)
    if 0 <= ly and ly + lh <= height and lx + lw <= width:
        region = img[ly:ly + lh, lx:lx + lw]
        img = img.clone()
        img[ly:ly + lh, lx:lx + lw] = torch.where(
            label[..., None] > 0, on_device(RULER_COLOR, dev), region
        )
    return img


def render_to_host(state, camera, zoom, width=800, height=600, ruler=True, index=0):
    """Render and pull the frame to host memory as a numpy array (one
    transfer, which waits for the frame)."""
    return render_frame(state, camera, zoom, width, height, ruler, index).cpu().numpy()
