"""Checkpoints both packages read: the port writes the JAX package's npz
format (version 1), a lone nucleus without its batch axis and ``rng`` as
uint32, and reads the JAX package's files. Every field crosses bitwise."""

import dataclasses
import json

import numpy as np
import pytest

import _torch_parity as tp
from pyqmd_tpu import Simulation as JaxSimulation
from pyqmd_tpu.config import SimConfig as JaxConfig
from pyqmd_tpu.utils.checkpoint import load_checkpoint as jax_load
from pyqmd_tpu.utils.checkpoint import save_checkpoint as jax_save
from pyqmd_tpu_torch import Simulation, load_checkpoint, save_checkpoint
from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.state import NucleusState, state_to_numpy
from pyqmd_tpu_torch.utils.checkpoint import read_checkpoint

FIELDS = [f.name for f in dataclasses.fields(NucleusState)]


def _evolved(ensemble):
    sim = Simulation(z=6, n=8, seed=3, pad_to=8, ensemble=ensemble, device="cpu")
    sim.set_time_scale(3.15576e11)
    for _ in range(3):
        sim.frame()
    if not ensemble:
        sim.force_decay()
    return sim


def _jax_evolved(ensemble):
    sim = JaxSimulation(z=6, n=8, seed=3, pad_to=8, ensemble=ensemble)
    sim.set_time_scale(3.15576e11)
    for _ in range(3):
        sim.frame()
    if not ensemble:
        sim.force_decay()
    return sim


@pytest.mark.parametrize("ensemble", [None, 5])
def test_port_to_port_roundtrip_is_bitwise(tmp_path, ensemble):
    sim = _evolved(ensemble)
    path = str(tmp_path / "ck.npz")
    sim.save(path)
    state, cfg, single = read_checkpoint(path, device="cpu")
    assert cfg == sim.cfg and single == (ensemble is None)
    want, got = state_to_numpy(sim.state), state_to_numpy(state)
    for f in FIELDS:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    state2, cfg2 = load_checkpoint(path, device="cpu")
    assert cfg2 == cfg and state2.batch == (ensemble or 1)


@pytest.mark.parametrize("ensemble", [None, 5])
def test_the_reference_reads_the_ports_file(tmp_path, ensemble):
    sim = _evolved(ensemble)
    path = str(tmp_path / "ck.npz")
    sim.save(path)
    jst, jcfg = jax_load(path)
    assert isinstance(jcfg, JaxConfig)
    assert jcfg.force_backend == "jnp" and jcfg.decay_backend == JaxConfig().decay_backend
    assert tp.port_cfg(jcfg) == sim.cfg
    want = state_to_numpy(sim.state)
    got = tp.jax_to_numpy(jst)
    assert got["pos"].ndim == (2 if ensemble is None else 3)
    for f in FIELDS:
        w = want[f][0] if ensemble is None else want[f]
        assert got[f].dtype == w.dtype, f
        np.testing.assert_array_equal(got[f], w, err_msg=f)
    # and it resumes there
    resumed = JaxSimulation.load(path)
    resumed.frame()
    assert np.isfinite(np.asarray(resumed.state.pos)).all()


@pytest.mark.parametrize("ensemble", [None, 5])
def test_the_port_reads_the_references_file(tmp_path, ensemble):
    jsim = _jax_evolved(ensemble)
    path = str(tmp_path / "ck.npz")
    jax_save(path, jsim.state, jsim.cfg)
    state, cfg, single = read_checkpoint(path, device="cpu")
    assert single == (ensemble is None)
    assert cfg == tp.port_cfg(jsim.cfg)  # the two backend fields dropped
    assert not hasattr(cfg, "force_backend") and not hasattr(cfg, "decay_backend")
    want = tp.jax_to_numpy(jsim.state)
    if ensemble is None:
        want = tp.batch_of_one(want)
    got = state_to_numpy(state)
    for f in FIELDS:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    sim = Simulation.load(path, device="cpu")
    assert sim.ensemble == ensemble and sim.batched == bool(ensemble)
    assert sim.isotope == jsim.isotope
    if ensemble is None:
        assert sim._chain_seen == int(jsim.state.chain_cursor)
        assert sim.decay_log == []  # the loaded log starts at the file's cursor
    sim.frame()
    assert np.isfinite(state_to_numpy(sim.state)["pos"]).all()


def test_both_packages_write_the_same_archive_members(tmp_path):
    """Same member names, shapes and dtypes, and the same config keys."""
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    _evolved(None).save(a)
    jsim = _jax_evolved(None)
    jax_save(b, jsim.state, jsim.cfg)
    with np.load(a) as pa, np.load(b) as pb:
        assert sorted(pa.files) == sorted(pb.files)
        for k in pa.files:
            if k != "__meta__":
                assert pa[k].shape == pb[k].shape and pa[k].dtype == pb[k].dtype, k
        ma = json.loads(bytes(pa["__meta__"]).decode())
        mb = json.loads(bytes(pb["__meta__"]).decode())
    assert ma["version"] == mb["version"] == 1
    assert sorted(ma["config"]) == sorted(mb["config"])


def test_save_single_refuses_a_batch(tmp_path):
    sim = _evolved(5)
    with pytest.raises(ValueError):
        save_checkpoint(str(tmp_path / "x.npz"), sim.state, sim.cfg, single=True)


def test_garbage_is_refused(tmp_path):
    p = tmp_path / "bad.npz"
    np.savez(p, foo=np.zeros(3))
    with pytest.raises(Exception):
        load_checkpoint(str(p), device="cpu")
    with pytest.raises(Exception):
        jax_load(str(p))


def test_a_wrong_version_is_refused(tmp_path):
    meta = json.dumps({"version": 2, "config": dataclasses.asdict(SimConfig())})
    p = tmp_path / "v2.npz"
    np.savez(p, __meta__=np.frombuffer(meta.encode(), np.uint8))
    with pytest.raises(ValueError, match="unsupported checkpoint version 2"):
        load_checkpoint(str(p), device="cpu")
    with pytest.raises(ValueError, match="unsupported checkpoint version 2"):
        jax_load(str(p))


def test_missing_fields_are_named(tmp_path):
    sim = _evolved(None)
    good = tmp_path / "good.npz"
    sim.save(str(good))
    with np.load(good) as data:
        kept = {k: data[k] for k in data.files if k not in ("vel", "chain_time")}
    bad = tmp_path / "bad.npz"
    np.savez(bad, **kept)
    with pytest.raises(ValueError, match=r"missing fields: \['chain_time', 'vel'\]"):
        load_checkpoint(str(bad), device="cpu")
