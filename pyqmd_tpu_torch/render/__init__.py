"""Headless rendering: device rasterizer + host panel overlays + PNG/GIF export
+ packed frames and the pipelined frame reader of the live views."""

from pyqmd_tpu_torch.render.framebuffer import render_frame, render_to_host
from pyqmd_tpu_torch.render.gif import gif_bytes, write_gif
from pyqmd_tpu_torch.render.interactive import (
    PipelinedFrameReader,
    render_frame_packed,
    unpack_frame,
)
from pyqmd_tpu_torch.render.panels import burn_overlay, compose_panels
from pyqmd_tpu_torch.render.png import png_bytes, write_apng, write_png

__all__ = [
    "render_frame",
    "render_to_host",
    "render_frame_packed",
    "unpack_frame",
    "PipelinedFrameReader",
    "compose_panels",
    "burn_overlay",
    "gif_bytes",
    "png_bytes",
    "write_apng",
    "write_gif",
    "write_png",
]
