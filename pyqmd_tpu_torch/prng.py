"""Threefry-2x32 keys and draws, bit for bit as ``jax.random`` gives them.

The JAX package draws all of a frame's randomness through ``jax.random``
with the threefry2x32 generator in its partitionable mode
(``jax_threefry_partitionable=True``). This module writes that generator
and the few draws the frame uses as plain tensor ops, batched over keys,
so the port's integer trajectories equal the reference's.

A key is the raw ``(..., 2)`` key data. uint32 words ride as ``int64``
masked to 32 bits, because torch's CPU ``uint32`` has no ``+``, ``<<`` or
``>>``. Every function takes a batch of keys ``(..., 2)`` and returns a
leading ``...`` batch in front of the draw's own shape.

Correspondence with jax 0.9.0 (``jax/_src/prng.py``, ``random.py``):

* :func:`threefry2x32` — ``_threefry2x32_lowering`` (20 rounds, key
  schedule with the 0x1BD11BDA parity word);
* :func:`prng_key` — ``PRNGKey`` / ``threefry_seed`` in 32-bit mode: the
  seed is cut to 32 bits and the high word is 0;
* :func:`split` — ``_threefry_split_foldlike``: hash counters (0, i);
* :func:`fold_in` — ``threefry_fold_in``: hash counter (0, data);
* :func:`random_bits` — ``_threefry_random_bits_partitionable``: the
  flattened draw index i is the counter (0, i), the bits are ``b1 ^ b2``;
* :func:`uniform` — ``_uniform``: mantissa trick, scale, then
  ``max(minval, ·)``;
* :func:`randint` — ``_randint`` for int32: two draws combined by a
  multiply-mod that wraps in 32 bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of counter words (x1, x2) under key words
    (k1, k2); all int64 tensors holding uint32 values, broadcast together.
    Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def prng_key(seed: int, device="cuda") -> torch.Tensor:
    """Raw key data of ``jax.random.PRNGKey(seed)``: ``(2,)`` int64, on
    ``device`` (the card unless the caller names another)."""
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def _hash_counters(keys: torch.Tensor, counters: torch.Tensor):
    """Hash counters (0, c) under every key: ``(..., 2)`` keys and a
    counter tensor of shape ``C`` give two ``(..., *C)`` words."""
    lead = keys.shape[:-1]
    shape = lead + (1,) * counters.dim()
    k1 = keys[..., 0].reshape(shape)
    k2 = keys[..., 1].reshape(shape)
    return threefry2x32(k1, k2, torch.zeros_like(counters), counters)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` keys to ``(..., num, 2)``."""
    counters = torch.arange(num, dtype=torch.int64, device=keys.device)
    b1, b2 = _hash_counters(keys, counters)
    return torch.stack([b1, b2], dim=-1)


def fold_in(keys: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` of the 32-bit integer ``data``."""
    # A fill on the device: a tensor built from a Python list would be a
    # host-to-device copy that waits for the stream, once per frame.
    counters = torch.full((1,), data & _MASK, dtype=torch.int64, device=keys.device)
    b1, b2 = _hash_counters(keys, counters)
    return torch.stack([b1[..., 0], b2[..., 0]], dim=-1)


def random_bits(keys: torch.Tensor, shape: tuple = ()) -> torch.Tensor:
    """32 random bits per element, ``(..., *shape)`` int64."""
    counters = torch.arange(math.prod(shape), dtype=torch.int64, device=keys.device)
    b1, b2 = _hash_counters(keys, counters)
    return (b1 ^ b2).reshape(keys.shape[:-1] + tuple(shape))


def uniform(
    keys: torch.Tensor, shape: tuple = (), minval: float = 0.0, maxval: float = 1.0
) -> torch.Tensor:
    """``jax.random.uniform`` in float32 over ``[minval, maxval)``."""
    bits = random_bits(keys, shape)
    # Random mantissa under the exponent of 1.0: a float in [1, 2).
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # The bounds rounded to f32 on the host, with no tensor read back.
    lo, hi = np.float32(minval), np.float32(maxval)
    lo, span = float(lo), float(hi - lo)
    # XLA fuses the scale and shift into one fused multiply-add (one
    # rounding); the f32 product is exact in f64, so this rounds alike.
    return torch.clamp((floats.double() * span + lo).float(), min=lo)


def randint(keys: torch.Tensor, shape: tuple, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` for int32 results in ``[minval, maxval)``."""
    k = split(keys, 2)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    multiplier = ((2**16 % span) ** 2 & _MASK) % span  # uint32 product wraps
    offset = ((higher % span) * multiplier + (lower % span)) & _MASK
    offset = offset % span
    return (minval + offset).to(torch.int32)
