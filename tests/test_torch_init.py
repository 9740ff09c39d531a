"""The port's ensemble initialiser against the JAX package's.

Identity fields and RNG streams are bitwise. Positions go through cos/sin
and a norm, so they agree to ULPs, within 1e-4; a near-tie in the
best-of-20 argmax could flip one placement, and the seeds below are ones
where none does.
"""

import numpy as np
import pytest

import _torch_parity as tp
from pyqmd_tpu.config import SimConfig as JaxConfig
from pyqmd_tpu.core.init import ensemble_init as jax_ensemble_init
from pyqmd_tpu.core.init import init_state as jax_init_state
from pyqmd_tpu.core.init import placement_order as jax_placement_order
from pyqmd_tpu_torch.core import init
from pyqmd_tpu_torch.state import state_to_numpy

BITWISE = ("ptype", "alive", "z", "n", "half_life", "rng", "chain_z0", "chain_n0",
           "chain_dtype", "chain_z1", "chain_n1", "chain_time", "chain_cursor",
           "decay_counts", "ej_cursor", "ej_alive", "time_passed", "last_decay_time")


def _assert_matches(ref_state, got):
    ref = tp.jax_to_numpy(ref_state)
    tp.assert_fields_equal(ref, got, BITWISE)
    got = state_to_numpy(got)
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got["vel"], ref["vel"])


@pytest.mark.parametrize("zn,pad_to,batch,seed", [
    ((92, 146), 128, 3, 0),
    ((6, 8), 8, 16, 1),
    ((2, 2), 8, 5, 4),
])
def test_exact_init_matches_the_reference(zn, pad_to, batch, seed):
    cfg = JaxConfig.for_isotope(*zn, pad_to=pad_to)
    ref = jax_ensemble_init(cfg, batch, seed=seed, method="exact")
    _assert_matches(ref, init.ensemble_init(tp.port_cfg(cfg), batch, seed=seed, method="exact",
                                               device="cpu"))


@pytest.mark.parametrize("zn,batch,pool,seed", [((6, 8), 12, 4, 0), ((92, 146), 6, 2, 3)])
def test_pool_init_matches_the_reference(zn, batch, pool, seed):
    cfg = JaxConfig.for_isotope(*zn, pad_to=8)
    ref = jax_ensemble_init(cfg, batch, seed=seed, pool=pool)
    _assert_matches(ref, init.ensemble_init(tp.port_cfg(cfg), batch, seed=seed, pool=pool,
                                               device="cpu"))


def test_init_state_is_a_batch_of_one():
    cfg = JaxConfig.for_isotope(6, 8, pad_to=8)
    ref = jax_init_state(cfg, seed=7)
    got = init.init_state(tp.port_cfg(cfg), seed=7, device="cpu")
    assert got.batch == 1
    expanded = {k: v[None] for k, v in tp.jax_to_numpy(ref).items()}
    tp.assert_fields_equal(expanded, got, BITWISE)
    np.testing.assert_allclose(state_to_numpy(got)["pos"], expanded["pos"], atol=1e-4)


def test_placement_order_matches_the_reference():
    for z, n in ((92, 146), (6, 8), (2, 2), (1, 0), (0, 3), (82, 126)):
        for a, b in zip(init.placement_order(z, n), jax_placement_order(z, n)):
            np.testing.assert_array_equal(a, b)


def test_unknown_method_raises():
    with pytest.raises(ValueError):
        init.ensemble_init(tp.port_cfg(JaxConfig.for_isotope(2, 2)), 4, method="bogus",
                           device="cpu")


@pytest.mark.parametrize("species,pad_to,seed", [
    ([(92, 146, 3), (6, 8, 5)], 8, 0),
    ([(82, 132, 2), (6, 8, 4), (2, 2, 3)], 8, 7),
])
def test_mixed_ensemble_init_matches_the_reference(species, pad_to, seed):
    from pyqmd_tpu.core.init import mixed_ensemble_init as jax_mixed

    cfg = JaxConfig.for_isotope(*species[0][:2], pad_to=pad_to)
    ref = jax_mixed(cfg, species, seed=seed)
    got = init.mixed_ensemble_init(tp.port_cfg(cfg), species, seed=seed, device="cpu")
    assert got.batch == sum(c for _, _, c in species)
    _assert_matches(ref, got)


def test_mixed_ensemble_init_rejects_a_species_that_does_not_fit():
    cfg = tp.port_cfg(JaxConfig.for_isotope(6, 8, pad_to=8))
    with pytest.raises(ValueError):
        init.mixed_ensemble_init(cfg, [(6, 8, 2), (92, 146, 1)], device="cpu")
