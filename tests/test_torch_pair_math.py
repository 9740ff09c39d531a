"""The CUDA kernels' per-pair arithmetic (``csrc/pair_math.cuh``), compiled
for the CPU with g++ through a small C shim, against the port's plain
PyTorch functions. A wrong sign or branch in the header shows up here
without a GPU.

Tolerances: the overlap push has no transcendental (sqrt and division are
correctly rounded in both), so it is exact. The force magnitude and the
CoM spring go through exp and a cube root, which differ in the last bit
between libraries: 1e-6 relative, with an absolute floor of 1e-6 times the
±12 clamp where the force's terms cancel.
"""

import ctypes
import math
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (caps torch threads)
from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core import forces, overlap
from pyqmd_tpu_torch.kernels.forces import ForceParams, force_params

CSRC = Path(__file__).resolve().parent.parent / "pyqmd_tpu_torch" / "csrc"

SHIM = r"""
#include <stddef.h>
#include "pair_math.cuh"

extern "C" {
int shim_params_size(void) { return (int)sizeof(PqForceParams); }
int shim_offset_damping(void) { return (int)offsetof(PqForceParams, damping); }
int shim_offset_inv_min_allowed(void) { return (int)offsetof(PqForceParams, inv_min_allowed); }
int shim_offset_inv_strong_range(void) { return (int)offsetof(PqForceParams, inv_strong_range); }
int shim_offset_inv_pauli_range(void) { return (int)offsetof(PqForceParams, inv_pauli_range); }
int shim_offset_leapfrog(void) { return (int)offsetof(PqForceParams, leapfrog); }
int shim_offset_fast_math(void) { return (int)offsetof(PqForceParams, fast_math); }

void shim_pair_force(const float* dist2, const int* pp, const int* same, int n,
                     const PqForceParams* c, float* out) {
  for (int i = 0; i < n; ++i) {
    const float dist = sqrtf(fmaxf(dist2[i], 1e-12f));
    out[i] = pq_pair_force(dist, dist2[i], pp[i], same[i], *c, c->fast_math);
  }
}

void shim_com_force(const float* cx, const float* cy, const float* px, const float* py,
                    const float* count, int n, float com_spring, float* fx, float* fy) {
  for (int i = 0; i < n; ++i) {
    const float cdx = cx[i] - px[i], cdy = cy[i] - py[i];
    const float cdist = sqrtf(pq_dist2(cdx, cdy));
    const float s = pq_com_spring_scale(cdist, pq_nuclear_radius(count[i]), com_spring);
    fx[i] = cdx * s;
    fy[i] = cdy * s;
  }
}

void shim_overlap(const float* dx, const float* dy, const float* cui, const float* sui,
                  const float* cuj, const float* suj, const float* sign, int n, float md,
                  float* px, float* py) {
  for (int i = 0; i < n; ++i) {
    float cs, ss;
    pq_overlap_rand_dir(cui[i], sui[i], cuj[i], suj[i], sign[i], &cs, &ss);
    pq_overlap_push(dx[i], dy[i], pq_dist2(dx[i], dy[i]), cs, ss, md, px + i, py + i);
  }
}
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("pair_math")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run(
        [gxx, "-O2", "-shared", "-fPIC", f"-I{CSRC}", str(d / "shim.cpp"), "-o", str(lib), "-lm"],
        check=True, capture_output=True, text=True,
    )
    return ctypes.CDLL(str(lib))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _distances(rng) -> np.ndarray:
    """~10^4 distances: random ones plus every threshold of the force law
    and the overlap pass, and their f32 neighbours."""
    marks = [0.001, 0.1, 2.8, 4.25, 5.0, 8.0, 9.0, 12.0]
    edges = []
    for m in marks:
        f = np.float32(m)
        edges += [np.nextafter(f, np.float32(0)), f, np.nextafter(f, np.float32(100))]
    return np.concatenate([
        rng.uniform(0.0, 1.0, 2000), rng.uniform(0.0, 20.0, 8000), np.array(edges)
    ]).astype(np.float32)


def test_struct_layout_matches_ctypes(shim):
    assert shim.shim_params_size() == ctypes.sizeof(ForceParams)
    for field in ("damping", "inv_min_allowed", "inv_strong_range", "inv_pauli_range",
                  "leapfrog", "fast_math"):
        assert getattr(shim, f"shim_offset_{field}")() == getattr(ForceParams, field).offset
    params = force_params(SimConfig())
    assert params.inv_min_allowed == np.float32(1 / (2.5 * 1.7))
    assert params.inv_pauli_range == np.float32(1 / 8.0)


@pytest.mark.parametrize("pp,same", [(0, 0), (0, 1), (1, 1)])
def test_pair_force_matches_plain(shim, pp, same):
    cfg = SimConfig(fast_math=False)
    rng = np.random.default_rng(pp * 2 + same)
    dist = _distances(rng)
    dist2 = (dist * dist).astype(np.float32)
    n = dist2.size
    out = np.empty(n, np.float32)
    ppa = np.full(n, pp, np.int32)
    samea = np.full(n, same, np.int32)
    params = force_params(cfg)
    shim.shim_pair_force(_ptr(dist2), _ptr(ppa), _ptr(samea), n, ctypes.byref(params), _ptr(out))
    d2 = torch.from_numpy(dist2)
    ref = forces.pair_net_force(
        forces.sqrt_rn(torch.clamp(d2, min=1e-12)), d2,
        torch.full((n,), bool(pp)), torch.full((n,), bool(same)), cfg,
    ).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6 * cfg.max_pair_force)
    # Both branches of every cut are exercised.
    assert (np.abs(ref) == cfg.max_pair_force).any() and (np.abs(ref) < 1.0).any()


def test_com_spring_matches_plain(shim):
    cfg = SimConfig()
    rng = np.random.default_rng(3)
    n = 10000
    count = rng.integers(1, 257, n).astype(np.float32)
    radius = 1.2 * count ** (1.0 / 3.0) * 2.0
    r = rng.uniform(0.0, 3.0, n) * radius
    # Keep clear of the activation edge at 1.5 R, where the two cube roots'
    # last bit could decide differently.
    r = np.where(np.abs(r - 1.5 * radius) < 1e-3, r + 2e-3, r)
    ang = rng.uniform(0, 2 * math.pi, n)
    cx = rng.uniform(390, 410, n).astype(np.float32)
    cy = rng.uniform(390, 410, n).astype(np.float32)
    px = (cx + r * np.cos(ang)).astype(np.float32)
    py = (cy + r * np.sin(ang)).astype(np.float32)
    fx = np.empty(n, np.float32)
    fy = np.empty(n, np.float32)
    shim.shim_com_force(_ptr(cx), _ptr(cy), _ptr(px), _ptr(py), _ptr(count), n,
                        ctypes.c_float(cfg.com_spring), _ptr(fx), _ptr(fy))
    pos = torch.from_numpy(np.stack([px, py], -1))[:, None, :]
    center = torch.from_numpy(np.stack([cx, cy], -1))
    ref = forces.com_force(pos, center, torch.from_numpy(count), cfg)[:, 0].numpy()
    np.testing.assert_allclose(fx, ref[:, 0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(fy, ref[:, 1], rtol=1e-6, atol=1e-7)
    assert (fx != 0).any() and (fx == 0).any()


def test_overlap_push_matches_plain_exactly(shim):
    md = SimConfig().overlap_min_dist
    rng = np.random.default_rng(4)
    dist = _distances(rng)
    n = dist.size
    ang = rng.uniform(0, 2 * math.pi, n)
    dx = (dist * np.cos(ang)).astype(np.float32)
    dy = (dist * np.sin(ang)).astype(np.float32)
    dx[:50] = dy[:50] = 0.0  # coincident pairs take the random direction
    ui, uj = (rng.uniform(0, 2 * math.pi, (2, n))).astype(np.float32)
    cui, sui, cuj, suj = (np.cos(ui).astype(np.float32), np.sin(ui).astype(np.float32),
                          np.cos(uj).astype(np.float32), np.sin(uj).astype(np.float32))
    sign = np.where(rng.uniform(size=n) < 0.5, 1.0, -1.0).astype(np.float32)
    px = np.empty(n, np.float32)
    py = np.empty(n, np.float32)
    shim.shim_overlap(*map(_ptr, (dx, dy, cui, sui, cuj, suj, sign)), n, ctypes.c_float(md),
                      _ptr(px), _ptr(py))
    t = {k: torch.from_numpy(v) for k, v in
         dict(dx=dx, dy=dy, cui=cui, sui=sui, cuj=cuj, suj=suj, sign=sign).items()}
    cs = t["sign"] * (t["cui"] * t["cuj"] - t["sui"] * t["suj"])
    ss = t["sign"] * (t["sui"] * t["cuj"] + t["cui"] * t["suj"])
    rx, ry = overlap.overlap_push(t["dx"], t["dy"], t["dx"] * t["dx"] + t["dy"] * t["dy"],
                                  cs, ss, md)
    np.testing.assert_array_equal(px, rx.numpy())
    np.testing.assert_array_equal(py, ry.numpy())
