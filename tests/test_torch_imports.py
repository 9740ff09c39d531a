"""The port stands without JAX: every module imports with ``jax`` blocked,
importing builds nothing and pulls in no ``triton``, and the kernel
wrappers take their plain versions on CPU tensors without launching; the
graph capturer and the counter registry know no kernel."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

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
    from pyqmd_tpu_torch import analysis, make_decay_frame_fn, ensemble_init
    from pyqmd_tpu_torch.utils.profiling import counters
    cfg = SimConfig.for_isotope(2, 2, pad_to=8)
    pos = torch.full((3, 8, 2), 400.0) + torch.arange(16.0).reshape(1, 8, 2)
    alive = torch.ones(3, 8, dtype=torch.bool)
    force_step(pos, torch.zeros_like(pos), torch.zeros(3, 8, dtype=torch.int32), alive, 0.01, cfg)
    overlap_step(pos, alive, torch.zeros(3, 8), cfg)
    states, _ = make_decay_frame_fn(SimConfig.for_isotope(6, 8), 2)(
        ensemble_init(SimConfig.for_isotope(6, 8), 4, device="cpu"), 1e11, 1.0)
    assert analysis.half_life_host(6, 8) > 0 and states.z.shape == (4,)
    assert not any(v for k, v in counters().items() if k.startswith("kernels."))
    assert _build.library.cache_info().currsize == 0

    # The compiled frame buckets: on CPU tensors the factories run eagerly,
    # capture nothing and touch no CUDA state.
    assert "pyqmd_tpu_torch.core.graphs" in names and "pyqmd_tpu_torch.core.dynamics" in names
    from pyqmd_tpu_torch import make_frame_fn, make_run_fn
    from pyqmd_tpu_torch.core import graphs
    he4 = SimConfig.for_isotope(2, 2, pad_to=8)
    frame, run = make_frame_fn(he4, 2, batched=True), make_run_fn(he4, 2, 2, batched=True)
    st, _ = frame(ensemble_init(he4, 3, device="cpu"), 1e9, 1 / 60)
    st, _ = run(st, 1e9, 1 / 60)
    assert st.pos.shape == (3, 8, 2) and frame.graphs.captures == run.graphs.captures == 0
    assert not frame.graphs.graphs and not graphs._DEVICES
    assert not torch.cuda.is_initialized()

    # The Simulation class, the CLI, checkpoints and the still renderer, on the CPU.
    import os, tempfile
    from pyqmd_tpu_torch import Simulation, cli, load_checkpoint, render_frame
    for needed in ("sim", "cli", "__main__", "utils.checkpoint", "utils.format", "utils.profiling",
                   "data.elements", "render.framebuffer", "render.panels", "render.font",
                   "render.png", "render.gif", "render.ansi", "render.interactive",
                   "render.httpview"):
        assert "pyqmd_tpu_torch." + needed in names, needed
    with tempfile.TemporaryDirectory() as tmp:
        ck, png = os.path.join(tmp, "c.npz"), os.path.join(tmp, "c.png")
        assert cli.main(["--device", "cpu", "--isotope", "C-14", "--frames", "2", "-q", "--save", ck,
                         "--render", png, "--width", "64", "--height", "48"]) == 0
        sim = Simulation.load(ck, device="cpu")
        sim.run(2, fused=True)
        assert load_checkpoint(ck, device="cpu")[0].batch == 1
        assert render_frame(sim.state, (400.0, 400.0), 5.0, 32, 24).shape == (24, 32, 3)

    # The live views on the CPU: one frame through the reader, one /frame
    # and one /status from the viewer.
    import json, urllib.request
    from pyqmd_tpu_torch.render import PipelinedFrameReader, render_frame_packed
    from pyqmd_tpu_torch.render.httpview import LiveViewServer
    reader = PipelinedFrameReader(depth=1)
    packed = render_frame_packed(sim.state, (400.0, 400.0), 5.0, 240, 60)
    assert reader.submit(packed) is None and reader.flush()[0].shape == (60, 240, 3)
    server = LiveViewServer(sim, port=0, fps=20, width=80, height=60)
    server.start_background()
    try:
        url = f"http://127.0.0.1:{server.port}"
        assert urllib.request.urlopen(url + "/frame", timeout=60).read()[1:4] == b"PNG"
        assert json.loads(urllib.request.urlopen(url + "/status", timeout=60).read())["z"] == 6
    finally:
        server.close()
    assert "pyqmd_tpu" not in sys.modules and "triton" not in sys.modules
    assert not any(m == "jax" or m.startswith(("jax.", "jaxlib")) for m in sys.modules
                   if sys.modules[m] is not None)
    assert not any(v for k, v in counters().items() if k.startswith("kernels."))
    assert _build.library.cache_info().currsize == 0

    # The sharded path in a world of one on the CPU: a fused run, the ring
    # frame and a sharded checkpoint, with jax still blocked.
    for needed in ("parallel", "parallel.mesh", "parallel.multihost", "parallel.ensemble",
                   "parallel.ring", "parallel.hybrid"):
        assert "pyqmd_tpu_torch." + needed in names, needed
    import torch.distributed as dist
    from pyqmd_tpu_torch import init_state, parallel
    from pyqmd_tpu_torch.utils.checkpoint import load_checkpoint_sharded, save_checkpoint_sharded
    assert len(parallel.__all__) == 15 and not dist.is_initialized()
    c14 = SimConfig.for_isotope(6, 8, pad_to=8)
    mesh = parallel.make_mesh(device="cpu")
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    part = parallel.shard_ensemble(ensemble_init(c14, 8, device="cpu"), mesh)
    part, m = parallel.make_sharded_run_fn(c14, 2, 2, mesh)(part, 1e11, 1.0)
    assert int(m["survivors"]) <= 8 and int(m["total_alive"]) == int(part.alive.sum())
    ring = parallel.make_ring_frame_fn(c14, 2, parallel.make_mesh((1,), ("model",), device="cpu"))
    assert ring(init_state(c14, device="cpu"), 1e11, 1.0)[0].pos.shape == (1, 16, 2)
    # The sharded and hybrid frames too run eagerly on CPU tensors: nothing
    # captured, no CUDA state.
    frame = parallel.make_sharded_frame_fn(c14, 2, mesh)
    hybrid = parallel.make_hybrid_frame_fn(
        c14, 2, parallel.make_mesh((1, 1), ("data", "model"), device="cpu"))
    for fn in (frame, hybrid):
        st, m = fn(part, 1e11, 1.0)
        assert st.pos.shape == (8, 16, 2) and int(m["survivors"]) <= 8
    assert frame.graphs.captures == ring.graphs.captures == hybrid.graphs.captures == 0
    assert not graphs._DEVICES and not torch.cuda.is_initialized()
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint_sharded(tmp, part, c14, mesh)
        back, _ = load_checkpoint_sharded(tmp, part, mesh)
        assert torch.equal(back.rng, part.rng) and torch.equal(back.alive, part.alive)
    dist.destroy_process_group()
    assert "pyqmd_tpu" not in sys.modules and "triton" not in sys.modules
    assert not any(m == "jax" or m.startswith(("jax.", "jaxlib")) for m in sys.modules
                   if sys.modules[m] is not None)
    assert not any(v for k, v in counters().items() if k.startswith("kernels."))
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
    # config, state, prng, analysis, data/*, core/*, kernels/*, sim, cli, utils/*, render/*,
    # parallel/*
    assert n_modules >= 46


@pytest.mark.parametrize("module", ["core/graphs.py", "utils/profiling.py"])
def test_layer_below_the_kernels_imports_no_kernel_module(module):
    """The graph capturer and the counters registry sit below the kernel
    wrappers: their sources (read, not imported, since importing runs the
    package's ``__init__``) import no ``pyqmd_tpu_torch.kernels`` module,
    at the top or inside a function."""
    tree = ast.parse((REPO / "pyqmd_tpu_torch" / module).read_text())
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{module}: a relative import"
            imported += [node.module] + [f"{node.module}.{a.name}" for a in node.names]
    assert "torch" in imported
    assert not [m for m in imported if m.startswith("pyqmd_tpu_torch.kernels")], imported
