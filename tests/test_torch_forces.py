"""The port's plain force step against the JAX package's jnp force step and
its Pallas kernel in interpret mode, on the cases of tests/test_kernel.py.

Tolerance rtol = atol = 1e-4 (2e-4 for the dense cluster), the bars the
reference holds its own kernel to: the pair sums run in another order and
exp/pow differ in the last bit between libraries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from pyqmd_tpu.config import SimConfig as JaxConfig
from pyqmd_tpu.core.forces import force_step as jax_force_step
from pyqmd_tpu.kernels.forces_pallas import force_step_pallas
from pyqmd_tpu_torch.core import forces
from pyqmd_tpu_torch.kernels.forces import force_step as wrapped_force_step
from pyqmd_tpu_torch.utils import profiling

DT = 1 / 240.0
U238 = JaxConfig.for_isotope(92, 146, pad_to=128, fast_math=False)


def _random_batch(p, n_alive, seeds, spread=40.0):
    """(B, P) numpy state, one member per seed, as tests/test_kernel.py
    draws it."""
    out = {"pos": [], "vel": [], "ptype": [], "alive": []}
    for seed, na in zip(seeds, n_alive):
        rng = np.random.default_rng(seed)
        out["pos"].append(rng.uniform(400 - spread / 2, 400 + spread / 2, (p, 2)).astype(np.float32))
        out["vel"].append(rng.normal(0, 2, (p, 2)).astype(np.float32))
        out["ptype"].append(rng.integers(0, 2, p).astype(np.int32))
        out["alive"].append(np.arange(p) < na)
    return tuple(np.stack(out[k]) for k in ("pos", "vel", "ptype", "alive"))


def _assert_matches_reference(arrays, cfg, tol=1e-4, pallas=True):
    pos, vel, ptype, alive = arrays
    got_p, got_v = forces.force_step(
        *map(torch.from_numpy, arrays), DT, tp.port_cfg(cfg)
    )
    refs = [jax_force_step(*map(jnp.asarray, arrays), DT, cfg)]
    if pallas:
        refs.append(force_step_pallas(*map(jnp.asarray, arrays), DT, cfg, interpret=True))
    for ref_p, ref_v in refs:
        np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), rtol=tol, atol=tol)
        np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), rtol=tol, atol=tol)
    # Dead slots pass through unchanged, bit for bit.
    dead = ~alive
    np.testing.assert_array_equal(got_p.numpy()[dead], pos[dead])
    np.testing.assert_array_equal(got_v.numpy()[dead], vel[dead])


@pytest.mark.parametrize("n_alive", [4, 56, 238, 256])
def test_force_step_u238_capacity(n_alive):
    _assert_matches_reference(_random_batch(256, [n_alive], [n_alive]), U238)


def test_force_step_batch_not_divisible_by_tile():
    b = 11
    _assert_matches_reference(_random_batch(128, [100] * b, range(b)), U238)


def test_force_step_dense_cluster():
    """Hard-core regime: everything overlapping (a post-init state)."""
    _assert_matches_reference(_random_batch(128, [64], [7], spread=4.0), U238, tol=2e-4)


def test_force_step_unaligned_capacity():
    _assert_matches_reference(_random_batch(100, [50], [0]), U238)


@pytest.mark.parametrize("p,batch", [(8, 1), (8, 37), (16, 19), (6, 21)])
def test_force_step_small_nuclei(p, batch):
    """The capacities the Pallas kernel packs several nuclei per row for,
    with mixed alive counts (fully dead members included)."""
    cfg = JaxConfig.for_isotope(2, 2, pad_to=p, fast_math=False)
    rng = np.random.default_rng(p * 100 + batch)
    n_alive = [int(rng.integers(0, p + 1)) for _ in range(batch)]
    _assert_matches_reference(_random_batch(p, n_alive, range(batch), spread=12.0), cfg)


@pytest.mark.parametrize("p,n_alive", [(256, 238), (8, 4)])
def test_force_step_leapfrog(p, n_alive):
    cfg = JaxConfig.for_isotope(92, 146, pad_to=p, fast_math=False, integrator="leapfrog")
    _assert_matches_reference(_random_batch(p, [n_alive], [p]), cfg)


def test_force_step_chunks_large_batches():
    """Chunked batches equal the unchunked step bitwise."""
    cfg = tp.port_cfg(JaxConfig.for_isotope(2, 2, pad_to=8))
    arrays = [torch.from_numpy(a) for a in _random_batch(8, [8] * 10, range(10), spread=12.0)]
    whole = forces.force_step(*arrays, DT, cfg)
    chunked = forces.force_step(*arrays, DT, cfg, max_chunk=3)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert forces.chunk_plan(10240, 8192) == (2, 5120, 0)
    assert forces.chunk_plan(8209, 8192) == (2, 4105, 1)


def test_wrapper_takes_the_plain_version_on_cpu():
    cfg = tp.port_cfg(U238)
    arrays = [torch.from_numpy(a) for a in _random_batch(256, [238], [3])]
    before = profiling.counters()["kernels.force_step.launches"]
    got = wrapped_force_step(*arrays, DT, cfg)
    ref = forces.force_step(*arrays, DT, cfg)
    assert profiling.counters()["kernels.force_step.launches"] == before
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
