"""Interactive frame readback: indexed (packed) frames and a pipelined reader.

The reference displays through an in-process PyGame window
(nuclear_sim.py:589-606). Here the frame is drawn on the state's device and
every shown frame has to cross to the host. Two tools keep that crossing
small and off the frame loop's critical path:

* **Packed frames.** The rasterizer paints from a small closed set of
  colours: the per-type particle colours, the proton highlight, the neutron
  ring, the ruler, black, and one faded colour per ejecta ring slot, at
  most ``10 + max_ejecta`` distinct RGBs. :func:`render_frame_packed` maps
  the drawn RGB frame to uint8 palette indices on the device (exact match,
  no quantization) and returns ONE uint8 tensor: H index rows, one palette
  row, one flags row. That is a third of the RGB frame's bytes in a single
  transfer. :func:`unpack_frame` expands it on the host with one numpy
  gather; the result is the RGB frame byte for byte. A flag computed on the
  device says that every pixel matched an entry, so a pixel outside the
  palette (which the shared colour helper rules out) makes the caller draw
  the RGB frame instead of showing a wrong one.

* **Pipelined copies.** :class:`PipelinedFrameReader` starts the copy of
  frame t to the host without waiting for it and hands out frame
  t - depth, whose copy has had ``depth`` frames of time to land. On a CUDA
  tensor the copy goes into pinned host memory on the current stream and is
  marked by an event; the reader waits on that one event only, never on the
  stream, so the host goes on issuing the next frames' launches while
  copies are in flight. On a CPU tensor there is nothing to copy and the
  queue discipline is the same. The price is ``depth`` frames of display
  latency.

The measured times are in PERF.md. RGB export paths (PNG / APNG / GIF) do
not come through here.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from pyqmd_tpu_torch.data.tables import on_device
from pyqmd_tpu_torch.render.framebuffer import (
    NEUTRON_RING,
    PROTON_HIGHLIGHT,
    RULER_COLOR,
    ejecta_colors,
    render_frame,
    to_rgb8,
)
from pyqmd_tpu_torch.state import PARTICLE_COLORS, NucleusState
from pyqmd_tpu_torch.utils.profiling import annotate, count

# Palette layout: 0 background, 1-6 particle colours, 7 proton highlight,
# 8 neutron ring, 9 ruler, 10.. one entry per ejecta ring slot.
_BASE_PALETTE = np.concatenate(
    [
        np.zeros((1, 3), np.uint8),
        PARTICLE_COLORS,
        np.array([PROTON_HIGHLIGHT, NEUTRON_RING, RULER_COLOR], np.uint8),
    ]
)
N_BASE = _BASE_PALETTE.shape[0]  # 10


def palette_size(ejecta_capacity: int) -> int:
    return N_BASE + ejecta_capacity


def _pack_rgb(c: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 colours as one int32 each (``r << 16 | g << 8 | b``)."""
    c = c.to(torch.int32)
    return (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]


def _palettize(img, ej_type, ej_age, ej_life) -> torch.Tensor:
    """(H, W, 3) RGB -> (H+2, W) packed uint8: indices, palette, flags.

    The ejecta entries come from the rasterizer's own colour helpers
    (:func:`ejecta_colors`, :func:`to_rgb8`), so every painted pixel matches
    an entry bit for bit; among equal entries the first wins. The flags row
    carries the all-pixels-matched bit and the palette length less one (so
    256 entries still fit a byte).
    """
    h, w, _ = img.shape
    dev = img.device
    e_col = to_rgb8(ejecta_colors(ej_type, ej_age, ej_life))
    pal = torch.cat([on_device(_BASE_PALETTE, dev), e_col])  # (K, 3)
    k = pal.shape[0]

    eq = _pack_rgb(img)[:, :, None] == _pack_rgb(pal)  # (H, W, K)
    idx = eq.view(torch.uint8).argmax(-1).to(torch.uint8)  # the first match
    ok = eq.any(-1).all()

    def pad(n):
        return torch.zeros(n, dtype=torch.uint8, device=dev)

    pal_row = torch.cat([pal.reshape(-1), pad(w - 3 * k)])
    flag_row = torch.cat([
        ok.to(torch.uint8).reshape(1),
        torch.full((1,), k - 1, dtype=torch.uint8, device=dev),
        pad(w - 2),
    ])
    return torch.cat([idx, pal_row[None], flag_row[None]])


def render_frame_packed(
    state: NucleusState,
    camera,
    zoom,
    width: int = 800,
    height: int = 600,
    ruler: bool = True,
    index: int = 0,
) -> torch.Tensor:
    """Rasterize and palettize member ``index`` into a single (H+2, W) uint8
    tensor on the state's device (see the module docstring for the layout).
    Raises ``ValueError`` when the palette cannot fit (ejecta capacity over
    246, or 3*K > width): callers then use :func:`render_frame`.
    """
    k = palette_size(state.ejecta_capacity)
    if k > 256 or 3 * k > width:
        raise ValueError(
            f"palette of {k} entries does not fit (width {width}); "
            "use the RGB path"
        )
    img = render_frame(state, camera, zoom, width, height, ruler, index)
    return _palettize(img, state.ej_type[index], state.ej_age[index], state.ej_life[index])


def unpack_frame(packed: np.ndarray) -> np.ndarray | None:
    """Expand a host-side packed frame to (H, W, 3) uint8 RGB.

    Returns None when the device-side exactness flag is unset (some pixel
    matched no palette entry): the caller should draw the frame again by
    the RGB path. One numpy gather; the result is a new array.
    """
    h = packed.shape[0] - 2
    flags = packed[h + 1]
    if not flags[0]:
        return None
    k = int(flags[1]) + 1
    pal = packed[h, : 3 * k].reshape(k, 3)
    return pal[packed[:h]]


class _Landing:
    """A frame on its way to the host: the host-side tensor it lands in
    and, on the card, the event that marks the end of its copy."""

    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor, event):
        self.host = host
        self.event = event

    def array(self) -> np.ndarray:
        if self.event is not None:
            with annotate("pyqmd.reader.wait"):
                count("host.syncs")
                self.event.synchronize()  # this frame's copy only, not the stream
        return self.host.numpy()


class PipelinedFrameReader:
    """Depth-N frame queue between the device and the host: submit frame
    t's tensor, receive frame t - depth's decoded array once the queue is
    full.

    For a CUDA tensor, ``submit`` copies into pinned host memory without
    blocking and records an event; a frame is handed out after waiting on
    its own event only. There are ``depth + 1`` pinned buffers per (shape,
    dtype), allocated at first use and reused in ring order, so a buffer is
    written again only after its frame was handed out.

    **How long a frame is valid.** The array handed to ``decode`` (and so
    the array an identity ``decode`` returns) is a view of such a buffer:
    it is valid until the next ``submit``, which may start a copy into that
    buffer. The default decoder, :func:`unpack_frame`, gathers into a new
    array, which stays valid. A caller that keeps raw frames past the next
    ``submit`` copies them (``decode=np.copy``). Frames from ``flush`` are
    valid until the next ``submit`` too.

    For a CPU tensor there is no copy and no event: the frame is the
    tensor's own memory, and the same queue discipline holds.

    Spans: ``pyqmd.reader.wait`` (the wait on a frame's event, one
    ``host.syncs`` each) and ``pyqmd.reader.decode`` (``decode``).
    """

    def __init__(self, depth: int = 6, decode=unpack_frame) -> None:
        """``decode`` maps the landed host array to the frame handed back
        (default: :func:`unpack_frame` for packed frames; pass an identity
        for raw RGB device frames, as the CLI ``watch`` loop does).
        Returning None from decode drops that frame."""
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._depth = depth
        self._decode = decode
        self._queue: collections.deque = collections.deque()
        # (shape, dtype) -> [pinned buffers, submissions so far]
        self._rings: dict = {}

    def _land(self, frame: torch.Tensor) -> _Landing:
        if not frame.is_cuda:
            return _Landing(frame.detach(), None)
        key = (tuple(frame.shape), frame.dtype)
        ring = self._rings.get(key)
        if ring is None:
            buffers = [torch.empty(frame.shape, dtype=frame.dtype, pin_memory=True)
                       for _ in range(self._depth + 1)]
            ring = self._rings[key] = [buffers, 0]
        host = ring[0][ring[1] % len(ring[0])]
        ring[1] += 1
        host.copy_(frame, non_blocking=True)
        event = torch.cuda.Event()  # after everything queued so far on the frame's stream
        event.record(torch.cuda.current_stream(frame.device))
        return _Landing(host, event)

    def submit(self, frame: torch.Tensor) -> np.ndarray | None:
        """Start the host copy of ``frame``; once ``depth`` frames are in
        flight, return the OLDEST frame decoded (None while the pipeline
        fills, or when decode drops the frame)."""
        self._queue.append(self._land(frame))
        if len(self._queue) > self._depth:
            landed = self._queue.popleft().array()
            with annotate("pyqmd.reader.decode"):
                return self._decode(landed)
        return None

    def flush(self) -> list[np.ndarray]:
        """Drain every in-flight frame (end of the loop), oldest first.
        Frames the decoder drops (None) are skipped."""
        out = []
        while self._queue:
            landed = self._queue.popleft().array()
            with annotate("pyqmd.reader.decode"):
                rgb = self._decode(landed)
            if rgb is not None:
                out.append(rgb)
        return out
