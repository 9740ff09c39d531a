"""The port's threefry draws equal ``jax.random``'s bit for bit."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (caps torch threads)
from pyqmd_tpu_torch import prng

SEEDS = [0, 1, 2, 7, 42, 123, 2**31 - 1, 2**31 + 5, 2**32 - 1, 2**40 + 7]


def _jax_keys(seeds):
    """(len(seeds), 2) uint32 raw keys from the JAX package's PRNGKey."""
    return np.stack([np.asarray(jax.random.key_data(jax.random.PRNGKey(s))) for s in seeds])


def _port_keys(raw: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(raw.astype(np.int64))


def _wrap(raw: np.ndarray):
    return jax.vmap(jax.random.wrap_key_data)(jnp.asarray(raw, jnp.uint32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def test_prng_key_matches_jax():
    for s in SEEDS:
        np.testing.assert_array_equal(
            _u32(prng.prng_key(s, device="cpu")), _jax_keys([s])[0], err_msg=str(s)
        )


@pytest.mark.parametrize("num", [2, 3, 4, 20])
def test_split_matches_jax(num):
    raw = _jax_keys(SEEDS)
    ref = jax.vmap(lambda k: jax.random.key_data(jax.random.split(k, num)))(_wrap(raw))
    got = prng.split(_port_keys(raw), num)
    assert got.shape == (len(SEEDS), num, 2)
    np.testing.assert_array_equal(_u32(got), np.asarray(ref))


def test_split_tree_of_the_frame_matches_jax():
    """The frame's key tree: 3-way split, then num_steps substep keys,
    swapped to (S, B) — step.py:286-289 of the JAX package."""
    raw = _jax_keys(range(16))
    base = _wrap(raw)
    k3 = jax.vmap(lambda k: jax.random.split(k, 3))(base)
    steps = jnp.swapaxes(jax.vmap(lambda k: jax.random.split(k, 20))(k3[:, 0]), 0, 1)
    ref = np.asarray(jax.random.key_data(steps))
    p3 = prng.split(_port_keys(raw), 3)
    got = prng.split(p3[:, 0], 20).transpose(0, 1)
    np.testing.assert_array_equal(_u32(got), ref)


@pytest.mark.parametrize("data", [0, 1, 5, 2**31 + 3])
def test_fold_in_matches_jax(data):
    raw = _jax_keys(SEEDS)
    ref = jax.vmap(lambda k: jax.random.key_data(jax.random.fold_in(k, data)))(_wrap(raw))
    np.testing.assert_array_equal(_u32(prng.fold_in(_port_keys(raw), data)), np.asarray(ref))


@pytest.mark.parametrize(
    "shape,maxval",
    [((), 1.0), ((12,), 1.0), ((11,), 1.0), ((20,), 2.0 * math.pi), ((256,), 2.0 * math.pi),
     ((100,), 2.0 * math.pi), ((3, 5), 1.0)],
)
def test_uniform_matches_jax(shape, maxval):
    raw = _jax_keys(range(64))
    ref = jax.vmap(lambda k: jax.random.uniform(k, shape, maxval=maxval))(_wrap(raw))
    got = prng.uniform(_port_keys(raw), shape, maxval=maxval)
    assert got.dtype == torch.float32 and got.shape == (64, *shape)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(ref).view(np.uint32))


def test_uniform_with_minval_matches_jax():
    raw = _jax_keys(range(32))
    ref = jax.vmap(lambda k: jax.random.uniform(k, (9,), minval=-3.0, maxval=2.5))(_wrap(raw))
    got = prng.uniform(_port_keys(raw), (9,), minval=-3.0, maxval=2.5)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(ref).view(np.uint32))


@pytest.mark.parametrize("lo,hi", [(0, 4), (0, 7), (0, 256), (3, 1000), (0, 2**31 - 1)])
def test_randint_matches_jax(lo, hi):
    raw = _jax_keys(range(64))
    ref = jax.vmap(lambda k: jax.random.randint(k, (), lo, hi))(_wrap(raw))
    got = prng.randint(_port_keys(raw), (), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_threefry_known_answer():
    """Random123's published threefry2x32_20 vector (key 0, counter 0)."""
    z = torch.zeros(1, dtype=torch.int64)
    b1, b2 = prng.threefry2x32(z, z, z, z)
    assert (int(b1), int(b2)) == (0x6B200159, 0x99BA4EFE)
