"""Wrapper of the CUDA overlap kernel (``csrc/overlap.cu``).

:func:`overlap_step` has the contract of
:func:`pyqmd_tpu_torch.core.overlap.resolve_overlaps` (one Jacobi pass).
CPU tensors take that plain version; CUDA tensors launch the kernel, or
the call raises. The kernel replaces
``pyqmd_tpu/kernels/overlap_pallas.py`` ``_overlap_kernel``.
"""

from __future__ import annotations

import torch

from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core import overlap as _plain
from pyqmd_tpu_torch.kernels import _build
from pyqmd_tpu_torch.utils.profiling import count

# The kernel takes up to 64 tiles of 32 slots (csrc/pair_tiles.cuh).
MAX_PARTICLES = 2048


def overlap_step(pos, alive, u, cfg: SimConfig):
    """One overlap projection: pos (B, P, 2) f32, alive (B, P) bool or
    uint8, u (B, P) f32 separation angles. Returns new pos."""
    if pos.device.type == "cpu":
        return _plain.resolve_overlaps(pos, alive, u, cfg)
    if pos.device.type != "cuda":
        raise ValueError(f"overlap_step runs on CPU or CUDA tensors, not {pos.device}")
    b, p = alive.shape[:2]
    if p > MAX_PARTICLES:
        raise ValueError(f"P={p} exceeds the kernel's {MAX_PARTICLES} particles")
    f32 = (torch.float32,)
    _build.check_tensor(pos, "pos", f32, (b, p, 2), pos.device)
    _build.check_tensor(alive, "alive", (torch.bool, torch.uint8), (b, p), pos.device)
    _build.check_tensor(u, "u", f32, (b, p), pos.device)
    lib = _build.library()
    out = torch.empty_like(pos)
    md = cfg.overlap_min_dist
    with torch.cuda.device(pos.device):
        err = lib.pyqmd_overlap_step(
            pos.data_ptr(), alive.data_ptr(), u.data_ptr(), out.data_ptr(), b, p,
            md, md * md, md * 0.5, torch.cuda.current_stream().cuda_stream,
        )
    _build.raise_on_error(err, "overlap")
    count("kernels.overlap_step.launches")
    return out
