"""The port stands without JAX: every module imports with ``jax`` blocked,
importing builds nothing and pulls in no ``triton``, and the kernel
wrappers take their plain versions on CPU tensors without launching."""

import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = textwrap.dedent(
    """
    import importlib, pkgutil, subprocess, sys
    sys.modules["jax"] = None  # any import of jax now raises ImportError

    def no_build(*a, **k):
        raise AssertionError(f"a subprocess was started at import: {a}")
    subprocess.run = subprocess.Popen = no_build

    import pyqmd_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(pyqmd_tpu_torch.__path__, "pyqmd_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    assert "pyqmd_tpu" not in sys.modules and "triton" not in sys.modules
    assert not any(m == "jax" or m.startswith(("jax.", "jaxlib")) for m in sys.modules
                   if sys.modules[m] is not None)

    from pyqmd_tpu_torch.kernels import _build
    assert _build.library.cache_info().currsize == 0  # nothing built or loaded

    import torch
    from pyqmd_tpu_torch import SimConfig
    from pyqmd_tpu_torch.kernels.forces import force_step
    from pyqmd_tpu_torch.kernels.overlap import overlap_step
    from pyqmd_tpu_torch.kernels.decay import decay_stats_frame, decay_stats_substep
    from pyqmd_tpu_torch import analysis, make_decay_frame_fn, ensemble_init
    cfg = SimConfig.for_isotope(2, 2, pad_to=8)
    pos = torch.full((3, 8, 2), 400.0) + torch.arange(16.0).reshape(1, 8, 2)
    alive = torch.ones(3, 8, dtype=torch.bool)
    force_step(pos, torch.zeros_like(pos), torch.zeros(3, 8, dtype=torch.int32), alive, 0.01, cfg)
    overlap_step(pos, alive, torch.zeros(3, 8), cfg)
    states, _ = make_decay_frame_fn(SimConfig.for_isotope(6, 8), 2)(
        ensemble_init(SimConfig.for_isotope(6, 8), 4, device="cpu"), 1e11, 1.0)
    assert analysis.half_life_host(6, 8) > 0 and states.z.shape == (4,)
    assert force_step.launches == 0 and overlap_step.launches == 0
    assert decay_stats_substep.launches == 0 and decay_stats_frame.launches == 0
    assert force_step.small_launches == 0
    assert _build.library.cache_info().currsize == 0

    # The Simulation class, the CLI, checkpoints and the still renderer, on the CPU.
    import os, tempfile
    from pyqmd_tpu_torch import Simulation, cli, load_checkpoint, render_frame
    for needed in ("sim", "cli", "__main__", "utils.checkpoint", "utils.format", "utils.profiling",
                   "data.elements", "render.framebuffer", "render.panels", "render.font",
                   "render.png", "render.gif", "render.ansi"):
        assert "pyqmd_tpu_torch." + needed in names, needed
    for later in ("render.interactive", "render.httpview", "parallel"):
        assert "pyqmd_tpu_torch." + later not in names, later
    with tempfile.TemporaryDirectory() as tmp:
        ck, png = os.path.join(tmp, "c.npz"), os.path.join(tmp, "c.png")
        assert cli.main(["--device", "cpu", "--isotope", "C-14", "--frames", "2", "-q", "--save", ck,
                         "--render", png, "--width", "64", "--height", "48"]) == 0
        sim = Simulation.load(ck, device="cpu")
        sim.run(2, fused=True)
        assert load_checkpoint(ck, device="cpu")[0].batch == 1
        assert render_frame(sim.state, (400.0, 400.0), 5.0, 32, 24).shape == (24, 32, 3)
    assert "pyqmd_tpu" not in sys.modules and "triton" not in sys.modules
    assert not any(m == "jax" or m.startswith(("jax.", "jaxlib")) for m in sys.modules
                   if sys.modules[m] is not None)
    assert force_step.launches == 0 and overlap_step.launches == 0
    assert _build.library.cache_info().currsize == 0
    print("MODULES", len(names))
    """
)


def test_port_imports_without_jax_and_builds_nothing():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split("MODULES")[1])
    # config, state, prng, analysis, data/*, core/*, kernels/*, sim, cli, utils/*, render/*
    assert n_modules >= 35
