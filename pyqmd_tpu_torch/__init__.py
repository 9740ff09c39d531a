"""pyqmd_tpu_torch — the PyTorch / CUDA port of ``pyqmd_tpu``.

The batched full-physics ensemble frame and the decay-statistics frame of
the JAX package, in PyTorch, with the ensemble analysis built on them
(:mod:`pyqmd_tpu_torch.analysis`), the host loop (:class:`Simulation`:
substep scheduling, frames in flight, fused runs, decay log, status,
checkpoints, still rendering) and the command line
(``python -m pyqmd_tpu_torch``). Plain tensor code for the frames and the
rasterizer, and hand-written CUDA kernels for the force + integrate step
(a tiled kernel and a sub-warp one for nuclei of up to 32 slots), the
overlap projection and the statistics decay frame
(:mod:`pyqmd_tpu_torch.kernels`). The tensor's device picks the path: CPU
tensors run the plain PyTorch versions, CUDA tensors the kernels. This
package imports no JAX; the JAX package is the reference the tests hold it
against.
"""

from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.state import NucleusState, empty_state
from pyqmd_tpu_torch.core.init import ensemble_init, init_state, mixed_ensemble_init
from pyqmd_tpu_torch.core.step import (
    decay_ensemble_step,
    ensemble_step,
    make_decay_frame_fn,
    make_frame_fn,
    make_run_fn,
    simulate_frame,
)
from pyqmd_tpu_torch.render import render_frame
from pyqmd_tpu_torch.sim import Simulation
from pyqmd_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

__version__ = "0.1.0"

__all__ = [
    "SimConfig",
    "NucleusState",
    "Simulation",
    "empty_state",
    "init_state",
    "ensemble_init",
    "mixed_ensemble_init",
    "simulate_frame",
    "ensemble_step",
    "make_frame_fn",
    "decay_ensemble_step",
    "make_decay_frame_fn",
    "make_run_fn",
    "save_checkpoint",
    "load_checkpoint",
    "render_frame",
    "__version__",
]
