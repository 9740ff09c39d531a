"""State, config and nuclear-data tables of the port against the JAX package."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_parity as tp
from pyqmd_tpu.config import SimConfig as JaxConfig
from pyqmd_tpu.core.init import ensemble_init as jax_ensemble_init
from pyqmd_tpu.data import tables as jax_tables
from pyqmd_tpu.state import empty_state as jax_empty_state
from pyqmd_tpu_torch.config import SimConfig, config_from_dict
from pyqmd_tpu_torch.data import tables
from pyqmd_tpu_torch.state import NucleusState, empty_state, state_from_numpy, state_to_numpy


def test_state_has_the_reference_fields():
    names = [f.name for f in dataclasses.fields(NucleusState)]
    ref = [f.name for f in dataclasses.fields(jax_empty_state(JaxConfig()))]
    assert names == ref and len(names) == 25


def test_numpy_round_trip_is_bitwise():
    cfg = JaxConfig.for_isotope(6, 8, pad_to=8)
    ref = {k: np.array(v) for k, v in tp.jax_to_numpy(jax_ensemble_init(cfg, 5, seed=3)).items()}
    # Exercise every value a field can hold: rng words above 2^31, NaN and
    # inf floats, negative zero.
    ref["rng"][0] = [0xFFFFFFFF, 0x80000001]
    ref["chain_time"][1, :3] = [np.nan, np.inf, -0.0]
    back = state_to_numpy(state_from_numpy(ref, device="cpu"))
    assert back.keys() == ref.keys()
    for k in ref:
        assert back[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(back[k].view(np.uint8), ref[k].view(np.uint8), err_msg=k)


def test_empty_state_matches_jax():
    cfg = JaxConfig.for_isotope(2, 2, pad_to=8)
    ref = tp.jax_to_numpy(jax.vmap(lambda _: jax_empty_state(cfg, seed=9))(np.arange(3)))
    got = state_to_numpy(empty_state(tp.port_cfg(cfg), seed=9, batch=3, device="cpu"))
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_state_to_device_and_helpers():
    cfg = JaxConfig.for_isotope(6, 8, pad_to=8)
    st = jax_ensemble_init(cfg, 4, seed=1)
    port = tp.to_port(st).to("cpu")
    np.testing.assert_array_equal(port.alive_count().numpy(), np.asarray(st.alive_count()))
    np.testing.assert_allclose(
        port.center_of_mass().numpy(), np.asarray(st.center_of_mass()), rtol=1e-6
    )
    np.testing.assert_allclose(port.rms_radius().numpy(), np.asarray(st.rms_radius()), rtol=1e-5)
    np.testing.assert_allclose(
        port.kinetic_energy().numpy(), np.asarray(st.kinetic_energy()), rtol=1e-6
    )


@pytest.mark.parametrize(
    "kw",
    [{}, dict(z=6, n=8, max_particles=16, fast_math=False, integrator="leapfrog"),
     dict(force_backend="pallas", decay_backend="jnp", overlap_iterations=2)],
)
def test_config_from_dict(kw):
    ref = JaxConfig(**kw)
    cfg = config_from_dict(dataclasses.asdict(ref))
    d = dataclasses.asdict(ref)
    del d["force_backend"], d["decay_backend"]
    assert dataclasses.asdict(cfg) == d
    assert cfg.effective_dt() == ref.effective_dt()
    assert cfg.num_substeps(1 / 60, 3.15576e16) == ref.num_substeps(1 / 60, 3.15576e16)


def test_config_checks_and_for_isotope():
    assert SimConfig.for_isotope(92, 146, pad_to=128).max_particles == 256
    assert SimConfig.for_isotope(2, 2).max_particles == 8
    for bad in (dict(z=92, n=146, max_particles=16), dict(integrator="rk4"),
                dict(physics_dt=0.0), dict(accuracy=2.0), dict(max_substeps=0)):
        with pytest.raises(ValueError):
            SimConfig(**bad)


def test_tables_equal_the_reference():
    """The port's numpy tables are the reference's, NaN cells included."""
    assert np.array_equal(tables._ROWS, jax_tables._ROWS, equal_nan=True)
    assert tables._T.keys() == jax_tables._T.keys()
    for k in tables._T:
        assert tables._T[k].dtype == jax_tables._T[k].dtype, k
        assert np.array_equal(tables._T[k], jax_tables._T[k], equal_nan=True), k


def test_table_lookups_match_the_reference():
    """Row lookups, branch picks and half-lives over random isotopes
    (out-of-grid cells clamp). Half-life estimates go through exp2, whose
    last bit may differ between libraries: relative 1e-6."""
    rng = np.random.default_rng(0)
    z = rng.integers(-3, 131, 4000).astype(np.int32)
    n = rng.integers(-3, 195, 4000).astype(np.int32)
    u = rng.uniform(size=4000).astype(np.float32)
    zt, nt, ut = map(torch.from_numpy, (z, n, u))
    row = tables.lookup_row(zt, nt)
    ref_row = np.asarray(jax_tables.lookup_row(z, n))
    assert np.array_equal(row.numpy(), ref_row, equal_nan=True)
    for got, ref in zip(tables.sample_branch(zt, nt, ut), jax_tables.sample_branch(z, n, u)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    tp.assert_rel_close(
        tables.half_life(zt, nt, ut).numpy(), np.asarray(jax_tables.half_life(z, n, u)), 1e-6
    )
    tp.assert_rel_close(
        tables.half_life_from_row(row, ut).numpy(),
        np.asarray(jax_tables.half_life_from_row(ref_row, u)), 1e-6,
    )
