"""The port's plain overlap step against the JAX package's ``_resolve_once``
and its Pallas kernel in interpret mode, with the same angles ``u``, on the
cases of tests/test_kernel.py. Tolerance rtol = atol = 1e-4: the pair sums
run in another order and cos/sin differ in the last bit between libraries.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from pyqmd_tpu.config import SimConfig as JaxConfig
from pyqmd_tpu.core.overlap import _resolve_once as jax_resolve_once
from pyqmd_tpu.core.overlap import resolve_overlaps as jax_resolve_overlaps
from pyqmd_tpu.kernels.overlap_pallas import overlap_step_pallas
from pyqmd_tpu_torch import prng
from pyqmd_tpu_torch.core import overlap
from pyqmd_tpu_torch.kernels.overlap import overlap_step as wrapped_overlap_step

U238 = JaxConfig.for_isotope(92, 146, pad_to=128, fast_math=False)


def _assert_matches_reference(pos, alive, u, cfg):
    got = overlap.resolve_overlaps(
        torch.from_numpy(pos), torch.from_numpy(alive), torch.from_numpy(u), tp.port_cfg(cfg)
    ).numpy()
    ref = jax.vmap(lambda p, a, uu: jax_resolve_once(p, a, uu, cfg))(pos, alive, u)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4)
    ker = overlap_step_pallas(jnp.asarray(pos), jnp.asarray(alive), jnp.asarray(u), cfg,
                              interpret=True)
    np.testing.assert_allclose(got, np.asarray(ker), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[~alive], pos[~alive])
    return got


@pytest.mark.parametrize("n_alive", [4, 100, 238, 256])
def test_overlap_u238_capacity(n_alive):
    rng = np.random.default_rng(n_alive)
    p = 256
    pos = rng.uniform(395, 405, (1, p, 2)).astype(np.float32)
    alive = (np.arange(p) < n_alive)[None]
    u = rng.uniform(0, 2 * np.pi, (1, p)).astype(np.float32)
    _assert_matches_reference(pos, alive, u, U238)


@pytest.mark.parametrize("p", [128, 8])
def test_overlap_degenerate_pairs(p):
    """Coincident nucleons separate along the angle-sum direction."""
    pos = np.full((1, p, 2), 400.0, np.float32)
    alive = (np.arange(p) < 3)[None]
    u = np.linspace(0.1, 6.0, p).astype(np.float32)[None]
    cfg = JaxConfig.for_isotope(2, 2, pad_to=p, fast_math=False)
    got = _assert_matches_reference(pos, alive, u, cfg)
    assert np.linalg.norm(got[0, 0] - got[0, 1]) > 1.0


@pytest.mark.parametrize("b,p,n", [(10, 128, (26, 30)), (37, 8, (2, 2)), (19, 16, (6, 8))])
def test_overlap_batched(b, p, n):
    rng = np.random.default_rng(7)
    spread = 10.0 if p >= 128 else 4.0
    pos = rng.uniform(400 - spread / 2, 400 + spread / 2, (b, p, 2)).astype(np.float32)
    alive = rng.uniform(size=(b, p)) < 0.8
    u = rng.uniform(0, 2 * np.pi, (b, p)).astype(np.float32)
    cfg = JaxConfig.for_isotope(*n, pad_to=p, fast_math=False)
    _assert_matches_reference(pos, alive, u, cfg)


def test_overlap_with_drawn_angles_matches_resolve_overlaps():
    """The frame's pass: angles from fold_in(key, 0), as the JAX package's
    resolve_overlaps draws them."""
    cfg = JaxConfig.for_isotope(6, 8, pad_to=16)
    rng = np.random.default_rng(3)
    b, p = 6, 16
    pos = rng.uniform(397, 403, (b, p, 2)).astype(np.float32)
    alive = rng.uniform(size=(b, p)) < 0.9
    raw = np.stack([np.asarray(jax.random.key_data(jax.random.PRNGKey(s))) for s in range(b)])
    keys = jax.vmap(jax.random.wrap_key_data)(jnp.asarray(raw))
    ref = jax.vmap(lambda pp, a, k: jax_resolve_overlaps(pp, a, k, cfg))(pos, alive, keys)
    u = overlap._rand_u(prng.fold_in(torch.from_numpy(raw.astype(np.int64)), 0), p)
    got = overlap.resolve_overlaps(torch.from_numpy(pos), torch.from_numpy(alive), u,
                                   tp.port_cfg(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    assert 0.0 <= float(u.min()) and float(u.max()) < 2 * math.pi


def test_overlap_chunks_large_batches():
    cfg = tp.port_cfg(JaxConfig.for_isotope(2, 2, pad_to=8))
    rng = np.random.default_rng(1)
    pos = torch.from_numpy(rng.uniform(398, 402, (9, 8, 2)).astype(np.float32))
    alive = torch.ones(9, 8, dtype=torch.bool)
    u = torch.from_numpy(rng.uniform(0, 6, (9, 8)).astype(np.float32))
    whole = overlap.resolve_overlaps(pos, alive, u, cfg)
    chunked = overlap.resolve_overlaps(pos, alive, u, cfg, max_chunk=4)
    np.testing.assert_array_equal(whole.numpy(), chunked.numpy())


def test_wrapper_takes_the_plain_version_on_cpu():
    cfg = tp.port_cfg(U238)
    rng = np.random.default_rng(5)
    pos = torch.from_numpy(rng.uniform(395, 405, (2, 256, 2)).astype(np.float32))
    alive = torch.from_numpy(rng.uniform(size=(2, 256)) < 0.9)
    u = torch.from_numpy(rng.uniform(0, 6, (2, 256)).astype(np.float32))
    before = wrapped_overlap_step.launches
    got = wrapped_overlap_step(pos, alive, u, cfg)
    assert wrapped_overlap_step.launches == before
    np.testing.assert_array_equal(got.numpy(), overlap.resolve_overlaps(pos, alive, u, cfg).numpy())
