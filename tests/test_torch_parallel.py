"""The port's sharded frames, ring and hybrid on gloo groups of CPU ranks,
held to the JAX package's own sharded functions on the 8-virtual-device
mesh: the counterparts of ``tests/test_parallel.py``.

The ranks run in processes of their own (``tests/_torch_dist_worker.py``,
worlds of 1, 2 and 4, started once per module), never in the pytest
process, so no process group outlives a test. Integer fields, RNG streams
and aggregates must be bitwise; pos/vel within the reference tests' own
bars (1e-5 sharded against unsharded, 1e-4 ring and hybrid against the
dense force).
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_parity as tp
from _torch_dist_worker import _two_d, gather
from pyqmd_tpu.config import SimConfig as JaxConfig
from pyqmd_tpu.core.forces import force_step as jax_force_step
from pyqmd_tpu.core.init import ensemble_init as jax_ensemble_init
from pyqmd_tpu.core.init import init_state as jax_init_state
from pyqmd_tpu.core.step import ensemble_step as jax_ensemble_step
from pyqmd_tpu.core.step import simulate_frame as jax_simulate_frame
from pyqmd_tpu.parallel import DATA_AXIS, MODEL_AXIS
from pyqmd_tpu.parallel import make_hybrid_frame_fn as jax_hybrid
from pyqmd_tpu.parallel import make_mesh as jax_mesh
from pyqmd_tpu.parallel import make_ring_force_step as jax_ring
from pyqmd_tpu.parallel import make_sharded_decay_fn as jax_sharded_decay
from pyqmd_tpu.parallel import make_sharded_frame_fn as jax_sharded_frame
from pyqmd_tpu.parallel import make_sharded_run_fn as jax_sharded_run
from pyqmd_tpu.parallel import shard_ensemble as jax_shard
from pyqmd_tpu_torch.core.init import ensemble_init
from pyqmd_tpu_torch.core.step import ensemble_step
from pyqmd_tpu_torch.parallel import initialize_multihost, local_batch_slice, make_mesh
from pyqmd_tpu_torch.state import state_from_numpy, state_to_numpy
from pyqmd_tpu_torch.utils.checkpoint import load_checkpoint_sharded, save_checkpoint_sharded

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_dist_worker.py")
WORLDS = (1, 2, 4)
U238_TS = 3.15576e16
SHARD_TOL = 1e-5  # tests/test_parallel.py: sharded against unsharded
RING_TOL = 1e-4  # tests/test_parallel.py: ring and hybrid against dense


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(world) -> [result of rank 0, rank 1, ...]``. The three
    worlds start together when the module starts and are waited for on
    first use, while the JAX side computes."""
    procs, done = {}, {}
    for world in WORLDS:
        out = tmp_path_factory.mktemp(f"world{world}")
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        procs[world] = (out, subprocess.Popen(
            [sys.executable, _WORKER, "--world", str(world), "--out", str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env))

    def get(world):
        if world not in done:
            out, proc = procs[world]
            log, _ = proc.communicate(timeout=300)
            assert proc.returncode == 0, f"world {world}:\n{log[-4000:]}"
            done[world] = []
            for r in range(world):
                with open(out / f"rank{r}.pkl", "rb") as f:
                    done[world].append(pickle.load(f))
            done[world][0]["out"] = out
        return done[world]

    yield get
    for _, proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)


def agree(results, key):
    """A value every rank must return alike: the aggregates, and the
    full-width results of the ring."""
    first = results[0][key]
    for res in results[1:]:
        for k in first:
            np.testing.assert_array_equal(res[key][k], first[k], err_msg=k)
    return first


def assert_state(ref: dict, got: dict, tol: float | None, fields=tp.INT_FIELDS):
    """Integer fields bitwise, pos/vel within ``tol`` (None: bitwise)."""
    for f in fields:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    for f in ("pos", "vel"):
        if tol is None:
            np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
        else:
            np.testing.assert_allclose(got[f], ref[f], rtol=tol, atol=tol, err_msg=f)


def assert_aggregates(ref, got):
    np.testing.assert_array_equal(got["total_decay_counts"], np.asarray(ref["total_decay_counts"]))
    assert int(got["total_alive"]) == int(ref["total_alive"])
    assert int(got["survivors"]) == int(ref["survivors"])


@pytest.fixture(scope="module")
def jax_refs(eight_devices):
    """The JAX package's results, each computed once per module."""
    cache = {}

    def get(name, fn):
        if name not in cache:
            cache[name] = fn()
        return cache[name]

    return get


# --- sharded ensemble frames ----------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_ensemble_matches_unsharded(ranks, jax_refs, world):
    """Against the JAX sharded frame (8 devices) and the port's own
    unsharded frame: integer fields, rng and aggregates bitwise."""

    def jax_frame():
        cfg = JaxConfig.for_isotope(6, 8, pad_to=8)
        st, m = jax_sharded_frame(cfg, 2, jax_mesh())(
            jax_shard(jax_ensemble_init(cfg, 32, seed=0), jax_mesh()), 1.0, 1 / 60.0)
        return tp.jax_to_numpy(st), m

    ref, ref_m = jax_refs("c14_frame", jax_frame)
    res = ranks(world)
    got = gather([r["sharded_frame"] for r in res], "state")
    assert_state(ref, got, SHARD_TOL)
    for r in res:
        assert_aggregates(ref_m, r["sharded_frame"])

    cfg = tp.port_cfg(JaxConfig.for_isotope(6, 8, pad_to=8))
    whole, m = ensemble_step(ensemble_init(cfg, 32, seed=0, device="cpu"), cfg, 1.0, 1 / 60.0, 2)
    assert_state(state_to_numpy(whole), got, SHARD_TOL)
    assert int(m["total_alive"]) == int(got["alive"].sum())


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_frame_runs_many_frames(ranks, world):
    for res in ranks(world):
        got = res["many_frames"]
        assert got["finite"]
        assert int(got["survivors"]) == 16  # He-4 stable
        assert int(got["total_alive"]) == 64


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_run_matches_frame_loop(ranks, jax_refs, world):
    """The fused sharded run equals the sharded frame loop, and the JAX
    package's sharded run."""

    def jax_run():
        cfg = JaxConfig.for_isotope(6, 8, pad_to=8)
        st, m = jax_sharded_run(cfg, 2, 3, jax_mesh())(
            jax_shard(jax_ensemble_init(cfg, 16, seed=0), jax_mesh()), U238_TS, 1 / 60.0)
        return tp.jax_to_numpy(st), m

    ref, ref_m = jax_refs("c14_run", jax_run)
    res = [r["run"] for r in ranks(world)]
    loop, run = gather(res, "loop"), gather(res, "run")
    assert_state(loop, run, SHARD_TOL)
    assert_state(ref, run, SHARD_TOL)
    for r in res:
        assert_aggregates(r["loop_agg"], r["run_agg"])
        assert_aggregates(ref_m, r["run_agg"])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_decay_frame_matches_unsharded(ranks, jax_refs, world):
    """Sharded decay-only frame: isotope trajectories and summed
    aggregates bitwise the JAX package's sharded decay frame."""

    def jax_decay():
        cfg = JaxConfig.for_isotope(82, 132, pad_to=8)
        st, m = jax_sharded_decay(cfg, 4, jax_mesh())(
            jax_shard(jax_ensemble_init(cfg, 32, seed=0), jax_mesh()), 400.0, 1.0)
        return tp.jax_to_numpy(st), m

    ref, ref_m = jax_refs("pb214_decay", jax_decay)
    res = [r["decay"] for r in ranks(world)]
    got = gather(res, "state")
    for f in ("z", "n", "half_life", "decay_counts", "rng", "alive", "ptype",
              "chain_z1", "chain_n1", "chain_dtype", "chain_cursor"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    for r in res:
        assert_aggregates(ref_m, r)
    assert int(res[0]["survivors"]) == int(((got["z"] == 82) & (got["n"] == 132)).sum())
    assert 0 < int(res[0]["survivors"]) < 32


# --- meshes and process start ---------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_make_mesh_shapes(ranks, world):
    got = ranks(world)[0]["mesh"]
    assert got["names"] == (DATA_AXIS,) and got["shape"] == (world,)
    assert got["names2"] == (DATA_AXIS, MODEL_AXIS)
    assert got["shape2"] == {1: (1, 1), 2: (1, 2), 4: (2, 2)}[world]
    assert got["too_big"] == f"mesh shape ({2 * world},) needs {2 * world} devices, have {world}"
    if world > 1:
        assert "spans the world" in got["too_small"]
        assert "not divisible" in got["indivisible_batch"]
    assert got["batch_sharding"] == ["Shard(dim=0)", "Replicate()"]
    assert got["replicated"] == ["Replicate()", "Replicate()"]
    assert (got["backend"], got["world"]) == ("gloo", world)


def test_world_of_one_started_by_make_mesh(ranks):
    """A process with no group: ``make_mesh`` starts rank 0 of 1 itself,
    with the CPU's backend, and every sharded path runs on it."""
    res = ranks(1)[0]
    assert res["world_started"] == (1, "gloo")
    assert res["mesh"]["world"] == 1


def test_multihost_single_process_noop():
    assert initialize_multihost() is False  # single process: guarded no-op
    assert initialize_multihost(num_processes=1) is False
    assert local_batch_slice(64) == (0, 64)  # one process owns the whole batch
    assert not dist.is_initialized()


@pytest.mark.parametrize("world", (2, 4))
def test_multihost_inside_a_group(ranks, world):
    """In a running group with no launcher in the environment, the start is
    a no-op; each rank's slice of the batch is its own."""
    for rank, res in enumerate(ranks(world)):
        got = res["multihost"]
        assert got["init"] is False and got["init_one"] is False
        assert got["slice"] == (rank * 64 // world, 64 // world)
        assert "not divisible" in got["indivisible"]


def test_cluster_detection_env_gated(monkeypatch):
    """Detection reads the launchers' world sizes only, and a world of one
    is no cluster."""
    from pyqmd_tpu_torch.parallel.multihost import cluster_detected

    for v in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "SLURM_NTASKS", "SLURM_PROCID",
              "SLURM_LOCALID", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
              "OMPI_COMM_WORLD_LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(v, raising=False)
    assert cluster_detected() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert cluster_detected() is False  # torchrun --nproc-per-node 1
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert cluster_detected() is True
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    assert cluster_detected() is False
    monkeypatch.setenv("SLURM_NTASKS", "8")
    assert cluster_detected() is True
    monkeypatch.delenv("SLURM_NTASKS")
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "2")
    assert cluster_detected() is True
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "not a number")
    assert cluster_detected() is False


def test_a_cluster_start_needs_its_coordinator_and_a_card(monkeypatch):
    """A detected world with no coordinator is refused, and a start on the
    card without one raises: neither starts a group, nothing falls back to
    gloo."""
    for v in ("MASTER_ADDR", "MASTER_PORT", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(ValueError, match="coordinator"):
        initialize_multihost(device="cpu")
    if torch.cuda.is_available():
        pytest.skip("holds the start without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_multihost("localhost:1", 2, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    assert not dist.is_initialized()


# --- the ring and the hybrid ----------------------------------------------------


def _jax_force(cfg, seed, steps=1, n_shards=None):
    st = jax_init_state(cfg, seed=seed)
    if n_shards is None:
        fn = jax.jit(lambda *a: jax_force_step(*a, 1 / 240.0, cfg))
    else:
        ring = jax_ring(cfg, jax_mesh((n_shards,), (MODEL_AXIS,), devices=jax.devices()[:n_shards]))
        fn = lambda *a: ring(*a, 1 / 240.0)  # noqa: E731
    pos, vel = st.pos, st.vel
    for _ in range(steps):
        pos, vel = fn(pos, vel, st.ptype, st.alive)
    return np.asarray(pos), np.asarray(vel)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_force_matches_dense(ranks, jax_refs, world):
    """The port's ring on ``world`` ranks against the dense force and the
    JAX package's ring on as many devices (a ring of one sends nothing)."""
    cfg = JaxConfig.for_isotope(26, 30, pad_to=8)
    dense = jax_refs("fe56_dense", lambda: _jax_force(cfg, 0))
    ring = jax_refs(f"fe56_ring{world}", lambda: _jax_force(cfg, 0, n_shards=world))
    got = agree([r for r in ranks(world)], "ring_force")
    for ref in (dense, ring):
        np.testing.assert_allclose(got["pos"], ref[0], rtol=RING_TOL, atol=RING_TOL)
        np.testing.assert_allclose(got["vel"], ref[1], rtol=RING_TOL, atol=RING_TOL)


@pytest.mark.parametrize("world", (2, 4))
def test_ring_force_leapfrog_matches_dense(ranks, jax_refs, world):
    """Leapfrog: two ring sweeps per step, the centre reduced again at the
    drifted positions, against the dense velocity-Verlet step."""
    cfg = JaxConfig.for_isotope(26, 30, pad_to=8, integrator="leapfrog")
    dense = jax_refs("fe56_leapfrog", lambda: _jax_force(cfg, 0))
    got = agree(ranks(world), "ring_leapfrog")
    np.testing.assert_allclose(got["pos"], dense[0], rtol=RING_TOL, atol=RING_TOL)
    np.testing.assert_allclose(got["vel"], dense[1], rtol=RING_TOL, atol=RING_TOL)
    plain = agree(ranks(world), "ring_force")
    assert not np.array_equal(plain["vel"], got["vel"])  # the integrator was taken


@pytest.mark.parametrize("world", (2, 4))
def test_ring_force_multiple_steps_stay_bound(ranks, jax_refs, world):
    cfg = JaxConfig.for_isotope(26, 30, pad_to=8)
    got = agree(ranks(world), "ring_steps")
    assert np.isfinite(got["pos"]).all()
    ref = jax_refs("fe56_20_steps", lambda: _jax_force(cfg, 2, steps=20))
    np.testing.assert_allclose(got["pos"], ref[0], rtol=RING_TOL, atol=RING_TOL)


@pytest.mark.parametrize("world", (2, 4))
def test_2d_mesh_data_times_model(ranks, jax_refs, world):
    """Data x model: each replica's rows of the batch, the ring over
    ``model`` on them, against the dense force on the whole batch."""
    cfg = JaxConfig.for_isotope(8, 8, pad_to=8)

    def dense():
        b = jax_ensemble_init(cfg, 8, seed=3)
        out = jax.vmap(lambda p, v, t, a: jax_force_step(p, v, t, a, 1 / 240.0, cfg))(
            b.pos, b.vel, b.ptype, b.alive)
        return np.asarray(out[0]), np.asarray(out[1])

    ref = jax_refs("o16_dense_batch", dense)
    got = gather([r["ring_2d"] for r in ranks(world)], "out")
    np.testing.assert_allclose(got["pos"], ref[0], rtol=RING_TOL, atol=RING_TOL)
    np.testing.assert_allclose(got["vel"], ref[1], rtol=RING_TOL, atol=RING_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_frame_matches_dense_frame(ranks, jax_refs, world):
    """A COMPLETE frame with the force step over the ring equals the dense
    frame of the JAX package: the same draws, so every integer field and
    the rng bitwise, positions to the order of the sums."""

    def dense():
        cfg = JaxConfig.for_isotope(92, 146, pad_to=8)
        st, _ = jax.jit(lambda s: jax_simulate_frame(s, cfg, U238_TS, 1 / 60.0, 4))(
            jax_init_state(cfg, seed=0))
        return tp.batch_of_one(tp.jax_to_numpy(st))

    ref = jax_refs("u238_frame", dense)
    res = [r["ring_frame"] for r in ranks(world)]
    for r in res:
        assert_state(ref, r["state"], RING_TOL)
        assert r["finite"]
        if world > 1:
            assert "not divisible" in r["indivisible"]


HYBRID_SHAPES = [(1, (1, 1)), (2, (2, 1)), (2, (1, 2)), (4, (4, 1)), (4, (2, 2)), (4, (1, 4))]


@pytest.mark.parametrize("world,shape", HYBRID_SHAPES)
def test_hybrid_frame_matches_dense_ensemble(ranks, jax_refs, world, shape):
    """Batch over ``data``, the force ring over ``model``: the dense
    ensemble step's draws bitwise, positions within the ring's bar, the
    aggregates summed over ``data`` only; and at 2 x 2 the JAX package's
    own hybrid frame, integers bitwise."""
    cfg = JaxConfig.for_isotope(92, 146, pad_to=32)

    def dense():
        st, m = jax.jit(lambda s: jax_ensemble_step(s, cfg, U238_TS, 1 / 60.0, 2))(
            jax_ensemble_init(cfg, 8, seed=0))
        return tp.jax_to_numpy(st), m

    ref, ref_m = jax_refs("u238_ensemble", dense)
    res = [r["hybrid"][shape] for r in ranks(world)]
    got = gather(res, "state")
    assert_state(ref, got, RING_TOL)
    ref_m = dict(ref_m, survivors=((ref["z"] == 92) & (ref["n"] == 146)).sum())
    for r in res:
        assert_aggregates(ref_m, r)
        if shape[1] > 1:
            assert "not divisible" in r["indivisible"]
    if shape == (2, 2):
        def hybrid():
            st, _ = jax_hybrid(cfg, 2, jax_mesh(shape, (DATA_AXIS, MODEL_AXIS)))(
                jax_ensemble_init(cfg, 8, seed=0), U238_TS, 1 / 60.0)
            return tp.jax_to_numpy(st)

        assert_state(jax_refs("u238_hybrid", hybrid), got, RING_TOL)


# --- the factories' frames: eager here, graph replays on the card ----------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ("sharded", "ring", "hybrid"))
def test_frame_factories_are_their_bare_eager_forms(ranks, world, kind):
    """``make_sharded_frame_fn``, ``make_ring_frame_fn`` and
    ``make_hybrid_frame_fn`` on CPU tensors, over the calls of one graph
    bucket (a change of time scale, then of frame interval): every field
    and metric bitwise the bare eager forms (``sharded_frame`` around
    ``ensemble_step``; ``simulate_frame`` / ``ensemble_step`` with the
    ring step), no capture and no kernel launch; ranks that hold the same
    rows end alike. A ring or hybrid bucket's name gives its group."""
    res = [r["graph_frames"][kind] for r in ranks(world)]
    model = world if kind == "ring" else _two_d(world)[1]
    for rank, r in enumerate(res):
        assert r["differ"] == []
        assert r["captures"] == r["buckets"] == 0
        assert r["launches"] == [([0, 0, 0, 0], [0, 0, 0, 0])] * 4
        group = list(range(rank - rank % model, rank - rank % model + model))
        assert r["bucket"].endswith(
            "time_scale > 1)" if kind == "sharded" else f", model group of ranks {group} (gloo))"
        ), r["bucket"]
    whole = gather(res, "state")
    assert whole["pos"].shape[0] == (1 if kind == "ring" else 8)


@pytest.mark.parametrize("world", (1, 2))
@pytest.mark.parametrize("kind", ("ring", "hybrid"))
def test_ring_and_hybrid_frame_bodies_are_capture_safe(ranks, world, kind):
    """What a ring or hybrid graph captures, the frame body with the ring
    step and its metrics, runs the same ops with the same non-tensor
    arguments, the ring's collectives among them, at 1e9 and 1e7 years per
    second and at frame intervals of 1/60 and 1/30 s, and reads no tensor
    to the host: so the graph captured at a bucket's first call replays
    the later ones."""
    steps = 2
    for r in ranks(world):
        got = r["capture_safety"][kind]
        assert got["first_difference"] is None, got["first_difference"]
        assert len(set(got["lengths"])) == 1 and got["lengths"][0] > 100 * steps
        assert got["host_reads"] == 0
        # Per substep: the alive count and the centre reduced, D - 1
        # exchanges, one gather of the blocks.
        want = {"c10d.allreduce_.default": 2 * steps, "c10d.allgather_.default": steps}
        if world > 1:
            want.update({"c10d.send.default": (world - 1) * steps,
                         "c10d.recv_.default": (world - 1) * steps})
        assert got["collectives"] == want


# --- sharded checkpoints --------------------------------------------------------


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("layout", ("1d", "2d"))
def test_sharded_checkpoint_roundtrip(ranks, world, layout):
    """Saved sharded (over ``data``, and data x model), restored on the
    same world into each rank's rows: every field bitwise, and the next
    frame bitwise. Each rank can also read the whole state."""
    res = [r["checkpoint"][layout] for r in ranks(world)]
    saved = gather(res, "saved")
    for r in res:
        assert r["cfg_equal"]
        for f in r["saved"]:
            np.testing.assert_array_equal(r["restored"][f], r["saved"][f], err_msg=f)
            np.testing.assert_array_equal(r["next_restored"][f], r["next_saved"][f], err_msg=f)
            np.testing.assert_array_equal(r["whole"][f], saved[f], err_msg=f)
    assert saved["pos"].shape[0] == 16


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("layout", ("1d", "2d"))
def test_sharded_checkpoint_loads_in_one_process(ranks, world, layout):
    """The same directory in a process with no group and no template: the
    whole state, every field bitwise the ranks' rows put together, and a
    frame of the unsharded port from it continues the sharded trajectory
    bitwise."""
    res = ranks(world)
    path = res[0]["out"] / f"ck_{layout}"
    state, cfg = load_checkpoint_sharded(str(path), device="cpu")
    parts = [r["checkpoint"][layout] for r in res]
    saved = gather(parts, "saved")
    got = state_to_numpy(state)
    assert got.keys() == saved.keys()
    for f in saved:
        np.testing.assert_array_equal(got[f], saved[f], err_msg=f)
    nxt, _ = ensemble_step(state, cfg, U238_TS, 1 / 60.0, 2)
    assert_state(gather(parts, "next_saved"), state_to_numpy(nxt), None,
                 fields=tuple(saved))
    assert not dist.is_initialized()


def test_sharded_checkpoint_version_mismatch(tmp_path):
    cfg = tp.port_cfg(JaxConfig.for_isotope(6, 8, pad_to=8))
    state = ensemble_init(cfg, 4, seed=0, device="cpu")
    save_checkpoint_sharded(str(tmp_path / "ck"), state, cfg)
    meta = json.loads((tmp_path / "ck" / "config.json").read_text())
    assert meta["version"] == 1
    meta["version"] = 2
    (tmp_path / "ck" / "config.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="version 2"):
        load_checkpoint_sharded(str(tmp_path / "ck"), device="cpu")
    assert not dist.is_initialized()


def test_sharded_load_defaults_to_the_card(tmp_path):
    """With no template the state comes back on the card unless the caller
    names another device; without a card that raises."""
    cfg = tp.port_cfg(JaxConfig.for_isotope(6, 8, pad_to=8))
    state = ensemble_init(cfg, 4, seed=0, device="cpu")
    save_checkpoint_sharded(str(tmp_path / "ck"), state, cfg)
    if torch.cuda.is_available():
        assert load_checkpoint_sharded(str(tmp_path / "ck"))[0].pos.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_checkpoint_sharded(str(tmp_path / "ck"))
    back, _ = load_checkpoint_sharded(str(tmp_path / "ck"), device="cpu")
    assert torch.equal(back.rng, state.rng) and not dist.is_initialized()


def test_orbax_and_sharded_pairs_give_equal_fields(eight_devices, tmp_path):
    """One state through the JAX package's Orbax pair (sharded over 8
    devices) and through the port's sharded pair: equal fields, equal
    configs, and the reference's loader accepts the port's config."""
    from pyqmd_tpu.utils.checkpoint import load_checkpoint_orbax, save_checkpoint_orbax

    jcfg = JaxConfig.for_isotope(6, 8, pad_to=8)
    mesh = jax_mesh()
    states, _ = jax_sharded_frame(jcfg, 2, mesh)(
        jax_shard(jax_ensemble_init(jcfg, 16, seed=0), mesh), 1.0, 1 / 60.0)
    save_checkpoint_orbax(str(tmp_path / "orbax"), states, jcfg)
    via_orbax, jcfg2 = load_checkpoint_orbax(str(tmp_path / "orbax"), sharding_state=states)

    port_state = state_from_numpy(tp.jax_to_numpy(states), device="cpu")
    save_checkpoint_sharded(str(tmp_path / "port"), port_state, tp.port_cfg(jcfg))
    via_port, cfg2 = load_checkpoint_sharded(str(tmp_path / "port"), device="cpu")

    a, b = tp.jax_to_numpy(via_orbax), state_to_numpy(via_port)
    assert a.keys() == b.keys()
    for f in a:
        np.testing.assert_array_equal(b[f], a[f], err_msg=f)
    assert cfg2 == tp.port_cfg(jcfg2)
    port_meta = json.loads((tmp_path / "port" / "config.json").read_text())
    assert JaxConfig(**port_meta["config"]) == dataclasses.replace(
        jcfg, force_backend="jnp", decay_backend="auto")
