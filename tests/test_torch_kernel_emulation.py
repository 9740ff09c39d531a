"""The force and overlap kernels' CUDA source, run on the CPU.

``csrc/forces.cu`` and ``csrc/overlap.cu`` are compiled with g++ against
``tests/cuda_emulation.h``, which runs each CUDA thread as a std::thread
and meets a warp's shuffles and votes at a barrier, so the tile schedule,
the shuffles and the per-warp sums run as written. The results are held to
the plain PyTorch versions at the kernel bars (rtol = atol = 1e-4 exact,
2e-4 for the dense cluster, atol 5e-3 fast-math; the host build has no
``rcp.approx``/``ex2.approx``, so fast-math here checks the reciprocal form),
dead slots pass through bitwise, and two launches agree bitwise. Small
sizes only: one host thread per CUDA thread. The card runs the same
sources built by nvcc (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import ctypes
import dataclasses
import math
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (caps torch threads)
from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core import forces, overlap
from pyqmd_tpu_torch.kernels.forces import force_params

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "pyqmd_tpu_torch" / "csrc"
DT = 1 / 240.0

# name: (P, B, spread, alive fraction)
CASES = {
    "he4": (8, 3, 12.0, 0.7),
    "p33": (33, 2, 30.0, 0.9),
    "p100_dead_tile": (100, 2, 30.0, 0.8),
    "one_alive_and_none": (40, 2, 30.0, 0.0),
    "dense": (64, 2, 4.0, 0.5),
}


def _emulated_source(path: Path) -> str:
    src = path.read_text()
    src = src.replace("extern __shared__ float4 smem[];",
                      "float4* smem = reinterpret_cast<float4*>(g_smem.data());")
    return re.sub(r"(\w+)<<<(.*?)>>>\(", r"pq_launch(\1, \2, ", src, flags=re.S)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("emulation")
    (d / "cuda_runtime.h").write_text(f'#include "{HERE / "cuda_emulation.h"}"\n')
    sources = []
    for name in ("forces", "overlap"):
        (d / f"{name}.cpp").write_text(_emulated_source(CSRC / f"{name}.cu"))
        sources.append(str(d / f"{name}.cpp"))
    out = d / "libemulated.so"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", f"-I{d}",
         f"-I{CSRC}", "-include", str(HERE / "cuda_emulation.h"), *sources, "-o", str(out),
         "-lpthread"],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    ptr = ctypes.c_void_p
    lib.pyqmd_force_step.argtypes = [ptr] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                                 ptr, ptr]
    lib.pyqmd_overlap_step.argtypes = [ptr] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                                   ctypes.c_float, ctypes.c_float, ptr]
    return lib


def _batch(name):
    p, b, spread, frac = CASES[name]
    g = np.random.default_rng(p + b)
    pos = g.uniform(400 - spread / 2, 400 + spread / 2, (b, p, 2)).astype(np.float32)
    vel = g.normal(0, 2, (b, p, 2)).astype(np.float32)
    ptype = g.integers(0, 2, (b, p)).astype(np.int32)
    alive = g.uniform(size=(b, p)) < frac
    u = g.uniform(0, 2 * math.pi, (b, p)).astype(np.float32)
    if name == "one_alive_and_none":
        alive[0, 5] = True  # member 1 has no alive slot
    if name == "p100_dead_tile":
        alive[:, 32:64] = False
    if name == "dense":
        pos[:, :3] = 400.0  # a coincident triple
        alive[:, :3] = True
    return [torch.from_numpy(a) for a in (pos, vel, ptype, alive, u)]


def _force(lib, pos, vel, ptype, alive, cfg):
    b, p = ptype.shape
    out_pos, out_vel = torch.empty_like(pos), torch.empty_like(vel)
    alive8 = alive.to(torch.uint8)
    params = force_params(cfg)
    err = lib.pyqmd_force_step(pos.data_ptr(), vel.data_ptr(), ptype.data_ptr(),
                               alive8.data_ptr(), out_pos.data_ptr(), out_vel.data_ptr(), b, p,
                               DT, ctypes.addressof(params), None)
    assert err == 0
    return out_pos, out_vel


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_force_kernel_source_matches_plain(lib, name, integrator):
    pos, vel, ptype, alive, _ = _batch(name)
    p = pos.shape[1]
    exact = SimConfig.for_isotope(2, 2, pad_to=p, integrator=integrator, fast_math=False)
    ref = forces.force_step(pos, vel, ptype, alive, DT, exact)
    got = _force(lib, pos, vel, ptype, alive, exact)
    fast = _force(lib, pos, vel, ptype, alive, dataclasses.replace(exact, fast_math=True))
    tol = 2e-4 if name == "dense" else 1e-4
    for g, f, r in zip(got, fast, ref):
        torch.testing.assert_close(g, r, rtol=tol, atol=tol)
        torch.testing.assert_close(f, r, rtol=0, atol=5e-3)
    dead = ~alive
    assert torch.equal(got[0][dead], pos[dead]) and torch.equal(got[1][dead], vel[dead])
    again = _force(lib, pos, vel, ptype, alive, exact)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    assert not torch.equal(got[1][alive], vel[alive]) or not alive.any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_overlap_kernel_source_matches_plain(lib, name):
    pos, _, _, alive, u = _batch(name)
    b, p = alive.shape
    cfg = SimConfig.for_isotope(2, 2, pad_to=p)
    pos = 400 + (pos - 400) * (8.0 / CASES[name][2])  # most nucleons within md of another
    if name == "dense":
        pos[:, :3] = 400.0
    md = cfg.overlap_min_dist
    alive8 = alive.to(torch.uint8)

    def run():
        out = torch.empty_like(pos)
        err = lib.pyqmd_overlap_step(pos.data_ptr(), alive8.data_ptr(), u.data_ptr(),
                                     out.data_ptr(), b, p, md, md * md, md * 0.5, None)
        assert err == 0
        return out

    got = run()
    torch.testing.assert_close(got, overlap.resolve_overlaps(pos, alive, u, cfg),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got[~alive], pos[~alive])
    assert torch.equal(run(), got)
    if alive.sum() > 1:
        assert not torch.equal(got[alive], pos[alive])
