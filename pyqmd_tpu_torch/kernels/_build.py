"""Build the CUDA sources under ``pyqmd_tpu_torch/csrc`` and load them.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface for Hopper (``sm_90a``), at first use, into
``pyqmd_tpu_torch/_build/`` under a name keyed by a hash of the sources and
flags; the library is loaded with ctypes. Importing this module builds
nothing. A failed build raises: there is no path that carries on without
the kernels. The compiler's output, with ``ptxas``'s register and shared
memory report, is kept beside the library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from pyqmd_tpu_torch.utils.profiling import annotate

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# Built without --use_fast_math: SimConfig.fast_math selects approximate
# division inside the kernels only.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_PTR = ctypes.c_void_p


def _find_nvcc() -> str:
    for candidate in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    """Path of the library for the current sources (built or not)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    return BUILD_DIR / f"libpyqmd_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    sources = [str(f) for f in sorted(CSRC.glob("*.cu"))]
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *sources]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call (span
    ``pyqmd.build``: the nvcc build or the load)."""
    with annotate("pyqmd.build"):
        lib = ctypes.CDLL(str(build()))
    lib.pyqmd_force_step.argtypes = [_PTR] * 6 + [ctypes.c_int, ctypes.c_int] + [_PTR] * 3
    lib.pyqmd_force_step.restype = ctypes.c_int
    lib.pyqmd_force_step_small.argtypes = lib.pyqmd_force_step.argtypes
    lib.pyqmd_force_step_small.restype = ctypes.c_int
    lib.pyqmd_force_schedule.argtypes = [ctypes.c_int] + [_PTR] * 3
    lib.pyqmd_force_schedule.restype = ctypes.c_int
    lib.pyqmd_overlap_step.argtypes = [_PTR] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float, _PTR,
    ]
    lib.pyqmd_overlap_step.restype = ctypes.c_int
    lib.pyqmd_decay_stats_frame.argtypes = [_PTR] * 18 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, _PTR,
    ]
    lib.pyqmd_decay_stats_frame.restype = ctypes.c_int
    lib.pyqmd_ejecta_decay_substep.argtypes = [_PTR, _PTR]
    lib.pyqmd_ejecta_decay_substep.restype = ctypes.c_int
    lib.pyqmd_error_string.argtypes = [ctypes.c_int]
    lib.pyqmd_error_string.restype = ctypes.c_char_p
    return lib


def raise_on_error(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err:
        msg = library().pyqmd_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def check_tensor(t: torch.Tensor, name: str, dtypes: tuple, shape: tuple, device) -> None:
    """Raise unless ``t`` lies on ``device`` with one of ``dtypes``, the
    given ``shape`` and a contiguous layout."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
