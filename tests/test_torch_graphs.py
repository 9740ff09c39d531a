"""The compiled frame buckets (``pyqmd_tpu_torch/core/graphs.py``) on the
CPU, where no graph can be captured.

A CUDA graph replays the kernels its capture recorded, with the arguments
they had then. So the capture is only valid if no value of a frame's
scalars (time scale, frame interval, physics dt) reaches an op as anything
but a tensor: the op sequence of the frame body, with every non-tensor
argument, must be the same at every time scale of one bucket. That is
checked here under a ``TorchDispatchMode``, for U-238 (P=256), He-4 and a
lone nucleus. Beside it: the scalar vector holds the host's f32 values
bitwise, frames that read it equal the JAX package's frames (integers and
rng bitwise, floats at the bars of ``tests/test_torch_step.py``), the plain
force step takes a 0-d dt, the factories cache as the JAX package's do and
run the bare frames bitwise on the CPU, and the capture/replay plumbing
(copy in, copy back, clone out, aliasing) runs on a stand-in that replays
the captured aten ops with their captured arguments. The card's own checks
are in ``tests/test_torch_cuda.py``.
"""

import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import _torch_parity as tp
from pyqmd_tpu.config import SimConfig as JaxConfig
from pyqmd_tpu.core.init import ensemble_init as jax_ensemble_init
from pyqmd_tpu.core.step import make_frame_fn as jax_make_frame_fn
from pyqmd_tpu.core.step import make_run_fn as jax_make_run_fn
from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core import forces, graphs, step
from pyqmd_tpu_torch.core.dynamics import (
    SCALAR_NAMES,
    FrameDynamics,
    FrameScalars,
    frame_dynamics,
    frame_scalars,
    scalar_values,
)
from pyqmd_tpu_torch.core.init import ensemble_init
from pyqmd_tpu_torch.state import state_to_numpy
from pyqmd_tpu_torch.utils import profiling

F32 = np.float32
YEAR = 3.15576e7

# (isotope, pad_to, batch, substeps): U-238 at its full capacity of 256.
CASES = {
    "u238": ((92, 146), 128, 4, 3),
    "he4": ((2, 2), 8, 4, 4),
    "one_nucleus": ((92, 146), 128, 1, 3),
}
# Two calls of one bucket each: (time_scale, frame_dt, physics_dt).
REGIMES = {
    "fast": ((1e9 * YEAR, 1 / 60, None), (1e7 * YEAR, 1 / 24, 0.003)),
    "slow": ((0.5, 1 / 60, None), (0.125, 1 / 24, 0.003)),
}


def _state(case, seed=0):
    (z, n), pad_to, b, steps = CASES[case]
    cfg = SimConfig.for_isotope(z, n, pad_to=pad_to)
    return cfg, ensemble_init(cfg, b, seed=seed, device="cpu"), steps


def _captured_part(states, cfg, values, fast, steps, batched):
    """What a graph captures: the frame body and its metrics, reading the
    scalars from views of one vector."""
    out = step.frame_body(states, cfg, FrameScalars.views(torch.from_numpy(values), fast),
                          steps)
    return out, step._metrics(out, batched)


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_frame_body_ops_do_not_depend_on_the_frame_scalars(case, regime):
    """The capture-safety check: two calls of one bucket at different time
    scales, frame intervals and physics dts run the same aten ops with the
    same non-tensor arguments, so a graph captured at one replays the
    other. A scalar that still reached an op as a number fails here."""
    cfg, states, steps = _state(case)
    batched = states.batch > 1
    calls = []
    for ts, fdt, pdt in REGIMES[regime]:
        dyn = frame_dynamics(cfg, ts, fdt, steps, pdt, cfg.physics_dt)
        values, fast = scalar_values(dyn, cfg)
        calls.append((values, fast))
    assert calls[0][1] == calls[1][1] == (regime == "fast")
    assert not np.array_equal(calls[0][0], calls[1][0])
    _captured_part(states, cfg, *calls[0], steps, batched)  # the warm-up: tables on the device
    logs = []
    for values, fast in calls:
        with tp.OpLog() as log:
            _captured_part(states, cfg, values, fast, steps, batched)
        logs.append(log)
    assert len(logs[0].ops) > 100 * steps
    for i, (a, b) in enumerate(zip(logs[0].ops, logs[1].ops)):
        assert a == b, f"op {i} differs between the two calls:\n{a}\n{b}"
    assert len(logs[0].ops) == len(logs[1].ops)
    # The frame reads every field of its input state: a graph copies them all in.
    for f in graphs.FIELDS:
        assert getattr(states, f).untyped_storage().data_ptr() in logs[0].storages, f


def _old_host_scalars(cfg, ts, fdt, steps, pdt, raw):
    """The f32 values as the frame computed them on the host before they
    moved to the device (``core/step.py`` and ``core/decay.py``), each as
    the Python float that entered its op."""
    ts, fdt = F32(ts), F32(fdt)
    pdt = F32(cfg.effective_dt() if pdt is None else pdt)
    ss = F32(steps)
    desired = fdt * ts
    step_time = desired / ss
    substep_factor = F32(10.0) / np.maximum(F32(1.0), ss)
    anim_step = (cfg.animation_dt * cfg.ejecta_speed_scale) * substep_factor
    nucleon_step = pdt * np.sqrt(ts)
    aging = np.minimum(F32(1.0), F32(1.0) / (np.sqrt(np.maximum(F32(1.0), ts / F32(100.0)))
                                             * np.sqrt(np.maximum(F32(1.0), ss / F32(10.0)))))
    base = cfg.base_ejecta_lifetime
    lpdt = F32(raw) if raw is not None else pdt
    if ts > 1.0:
        tf = np.maximum(F32(1.0), ts / F32(100.0))
        sf = np.maximum(F32(1.0), np.sqrt(ss))
        df = np.maximum(F32(1.0), F32(0.016) / lpdt)
        life = np.maximum(base * sf, base * tf * sf * df)
        if ss > 15.0:
            life = life * (ss / F32(15.0))
    else:
        life = base * np.maximum(F32(1.0), ss / F32(5.0))
    return [float(v) for v in (desired, pdt, step_time, anim_step, nucleon_step,
                               step_time * aging, life)]


@pytest.mark.parametrize("ts,fdt,steps,pdt,raw", [
    (1e9 * YEAR, 1 / 60, 20, None, 1 / 240),
    (1e9 * YEAR, 1 / 60, 16, 0.002, None),
    (40.0, 1 / 30, 7, None, 1 / 240),
    (1.0, 1 / 60, 1, None, 1 / 240),
    (0.5, 1 / 60, 3, 0.01, None),
    (0.0, 1 / 60, 4, None, 1 / 240),
])
def test_scalar_vector_holds_the_host_float32_values(ts, fdt, steps, pdt, raw):
    cfg = SimConfig.for_isotope(92, 146, pad_to=128)
    dyn = frame_dynamics(cfg, ts, fdt, steps, pdt, raw)
    values, fast = scalar_values(dyn, cfg)
    want = np.array(_old_host_scalars(cfg, ts, fdt, steps, pdt, raw), dtype=np.float32)
    assert values.dtype == np.float32 and fast == (ts > 1.0)
    np.testing.assert_array_equal(values.view(np.uint32), want.view(np.uint32))
    sc = frame_scalars(dyn, cfg, "cpu")
    for i, name in enumerate(SCALAR_NAMES):
        got = getattr(sc, name)
        assert got.dim() == 0 and got.dtype == torch.float32
        assert got.untyped_storage().data_ptr() == sc.vec.untyped_storage().data_ptr()
        assert np.float32(got.item()).view(np.uint32) == want[i].view(np.uint32), name
    # Dynamics without a clock leave its slot NaN: only the clock reads it.
    no_clock = FrameDynamics(*dyn[:5])
    assert np.isnan(scalar_values(no_clock, cfg)[0][0])


def _compare(ref_st, ref_m, got_st, got_m, floats):
    ref = tp.jax_to_numpy(ref_st)
    tp.assert_fields_equal(ref, got_st, tp.INT_FIELDS)
    got = state_to_numpy(got_st)
    for f in ("half_life", "ej_life"):
        tp.assert_rel_close(got[f], ref[f], 1e-6, f)
    # log() rounds per library: test_torch_sim.py's bar for the chain times.
    np.testing.assert_allclose(got["chain_time"], ref["chain_time"], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got["time_passed"], ref["time_passed"])
    for k in ("alive", "z", "n", "decay_counts", "chain_cursor", "total_decay_counts"):
        np.testing.assert_array_equal(got_m[k].numpy(), np.asarray(ref_m[k]), err_msg=k)
    if floats:
        for f in ("pos", "vel", "ej_pos", "ej_age"):
            np.testing.assert_allclose(got[f], ref[f], rtol=1e-3, atol=1e-3, err_msg=f)


@pytest.mark.parametrize("zn,pad_to,batch,steps,calls", [
    # U-238 in the fast lifetime regime, two time scales and frame intervals.
    ((92, 146), 128, 4, 3, ((3.15576e18, 1 / 60), (1e19, 1 / 30))),
    # Po-212 (0.3 us) decays at a time scale below 1: the per-type floor.
    ((84, 128), 8, 4, 3, ((0.5, 1 / 60), (0.25, 1 / 30))),
])
def test_frames_on_device_scalars_match_the_reference(zn, pad_to, batch, steps, calls):
    """The factories' frames and fused runs against the JAX package's,
    from one state: integers and rng bitwise, lifetimes and half-lives to
    1e-6 relative, chain times to 1e-6, pos/vel within 1e-3 after the
    first frame."""
    cfg = JaxConfig.for_isotope(*zn, pad_to=pad_to)
    jst = jax_ensemble_init(cfg, batch, seed=0)
    pst = tp.to_port(jst)
    pcfg = tp.port_cfg(cfg)
    jfn, pfn = jax_make_frame_fn(cfg, steps, batched=True), step.make_frame_fn(pcfg, steps, True)
    decays = 0
    for i, (ts, fdt) in enumerate(calls):
        jst, jm = jfn(jst, ts, fdt)
        pst, pm = pfn(pst, ts, fdt)
        _compare(jst, jm, pst, pm, floats=i == 0)
        decays = int(np.asarray(jm["total_decay_counts"]).sum())
    assert decays > 0
    ts, fdt = calls[-1]
    jst, jm = jax_make_run_fn(cfg, steps, 2, batched=True)(jst, ts, fdt)
    pst, pm = step.make_run_fn(pcfg, steps, 2, True)(pst, ts, fdt)
    _compare(jst, jm, pst, pm, floats=False)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("max_chunk", [8192, 3])
def test_plain_force_step_takes_a_0d_dt(integrator, max_chunk):
    cfg = SimConfig.for_isotope(26, 30, pad_to=64, integrator=integrator)
    g = np.random.default_rng(4)
    pos = torch.from_numpy(g.uniform(385, 415, (7, 64, 2)).astype(np.float32))
    vel = torch.from_numpy(g.normal(0, 2, (7, 64, 2)).astype(np.float32))
    ptype = torch.from_numpy(g.integers(0, 2, (7, 64)).astype(np.int32))
    alive = torch.from_numpy(g.uniform(size=(7, 64)) < 0.9)
    dt = F32(1 / 240)
    want = forces.force_step(pos, vel, ptype, alive, float(dt), cfg, max_chunk=max_chunk)
    vec = torch.tensor([7.0, dt, 3.0])  # a 0-d view, as the frame passes it
    got = forces.force_step(pos, vel, ptype, alive, vec[1], cfg, max_chunk=max_chunk)
    for w, o in zip(want, got):
        assert torch.equal(w, o)
    assert not torch.equal(got[0], pos)


def test_factories_are_cached_per_bucket():
    cfg = SimConfig.for_isotope(2, 2, pad_to=8)
    assert step.make_frame_fn(cfg, 4, True) is step.make_frame_fn(cfg, 4, True)
    assert step.make_frame_fn(cfg, 4, True) is not step.make_frame_fn(cfg, 5, True)
    assert step.make_frame_fn(cfg, 4, True) is not step.make_frame_fn(cfg, 4, False)
    assert step.make_run_fn(cfg, 4, 3, True) is step.make_run_fn(cfg, 4, 3, True)
    assert step.make_run_fn(cfg, 4, 3, True) is not step.make_run_fn(cfg, 4, 2, True)
    assert step.make_frame_fn.cache_info().maxsize == 128
    assert step.make_run_fn.cache_info().maxsize == 64
    fn = step.make_frame_fn(cfg, 4, True)
    st = ensemble_init(cfg, 3, device="cpu")

    def key(s, ts, raw=cfg.physics_dt):
        dyn = frame_dynamics(cfg, ts, 1 / 60, 4, None, raw)
        return fn.graphs.bucket(s, raw, scalar_values(dyn, cfg)[1])

    # A new time scale in one regime replays; the regimes, the batch and a
    # raw physics dt of None are buckets of their own.
    assert key(st, 1e9 * YEAR) == key(st, 1e7 * YEAR) == key(st, 1.5)
    assert key(st, 1.0) == key(st, 0.5) == key(st, 0.0)
    assert key(st, 1.0) != key(st, 1.5)
    assert key(st, 2.0) != key(ensemble_init(cfg, 1, device="cpu"), 2.0)
    assert key(st, 2.0) != key(st, 2.0, raw=None)
    with pytest.raises(ValueError):
        step.make_run_fn(cfg, 4, -1, True)


@pytest.mark.parametrize("batched", [True, False])
def test_factories_run_the_bare_frames_on_the_cpu(batched):
    (z, n), pad_to = (6, 8), 8
    cfg = SimConfig.for_isotope(z, n, pad_to=pad_to)
    st0 = ensemble_init(cfg, 8 if batched else 1, seed=3, device="cpu")
    bare = step.ensemble_step if batched else step.simulate_frame
    ts, fdt = 3.0e12, 1.0  # C-14 (1.8e11 s) decays within the first frame
    want, wm = st0, None
    for _ in range(3):
        want, wm = bare(want, cfg, ts, fdt, 3, cfg.effective_dt(), cfg.physics_dt)
    got, gm = st0, None
    fn = step.make_frame_fn(cfg, 3, batched)
    for _ in range(3):
        got, gm = fn(got, ts, fdt)
    run, rm = step.make_run_fn(cfg, 3, 3, batched)(st0, ts, fdt)
    assert int(want.decay_counts.sum()) > 0
    for f in graphs.FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert torch.equal(getattr(run, f), getattr(want, f)), f
    assert set(gm) == set(rm) == set(wm)
    for k in wm:
        assert torch.equal(gm[k], wm[k]) and torch.equal(rm[k], wm[k]), k
    st, m = step.make_run_fn(cfg, 3, 0, batched)(st0, ts, fdt)
    assert st is st0 and torch.equal(m["z"], st0.z)


class _CpuGraph(TorchDispatchMode):
    """A CUDA graph's semantics on the CPU. At capture the Python runs once
    and every aten op is recorded with its arguments and its result; a
    replay runs the recorded ops again with those same arguments and writes
    each result into the tensor the capture returned, as a graph's kernels
    write their captured addresses. Non-tensor arguments stay as captured,
    so a scalar baked into an op would replay its captured value. Views
    and in-place ops (results that share memory with an argument) need no
    write."""

    def __init__(self, fn):
        super().__init__()
        self.ops = []
        with self:
            fn()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out

    @staticmethod
    def _tensors(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, (list, tuple)):
            return [t for a in x for t in _CpuGraph._tensors(a)]
        return []

    def replay(self):
        for func, args, kwargs, out in self.ops:
            new = func(*args, **kwargs)
            inputs = {t.untyped_storage().data_ptr()
                      for t in self._tensors(args) + self._tensors(list(kwargs.values()))}
            for o, n in zip(self._tensors(out), self._tensors(new)):
                if o.untyped_storage().data_ptr() not in inputs:
                    o.copy_(n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_capture_and_replay_plumbing(monkeypatch, case):
    """Static input, copy-back, clone-out and metric aliases: replays equal
    eager frames bitwise across a change of time scale and frame interval,
    a fused run of three replays equals three eager frames, returned states
    share no memory with the graph and keep their values after later
    replays."""
    monkeypatch.setattr(graphs, "_record", lambda fn, dev: _CpuGraph(fn))
    cfg, st0, steps = _state(case, seed=1)
    batched = st0.batch > 1
    metrics = functools.partial(step._metrics, batched=batched)
    frame = graphs.FrameGraphs(cfg, steps, step.frame_body, metrics, 1, graph_metrics=True)
    run = graphs.FrameGraphs(cfg, steps, step.frame_body, metrics, 3, graph_metrics=False)
    bare = step.ensemble_step if batched else step.simulate_frame
    (ts1, fdt1, _), (ts2, fdt2, _) = REGIMES["fast"]

    def values(ts, fdt):
        return scalar_values(frame_dynamics(cfg, ts, fdt, steps, None, cfg.physics_dt), cfg)

    v1, fast = values(ts1, fdt1)
    g = frame._capture(st0, fast, frame.bucket(st0, cfg.physics_dt, fast), None)
    assert frame.captures == 1 and set(g.written) == set(graphs.FIELDS)
    statics = {t.untyped_storage().data_ptr() for t in g.static.values()}
    want, got, kept = st0, st0, []
    for ts, fdt in ((ts1, fdt1), (ts1, fdt1), (ts2, fdt2)):
        want, wm = bare(want, cfg, ts, fdt, steps, None, cfg.physics_dt)
        got, gm = g.replay(got, values(ts, fdt)[0], 1)
        for f in graphs.FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
            assert getattr(got, f).untyped_storage().data_ptr() not in statics, f
        for k in wm:
            assert torch.equal(gm[k], wm[k]), k
        assert gm["z"] is got.z and gm["decay_counts"] is got.decay_counts
        kept.append((got, {f: getattr(got, f).clone() for f in graphs.FIELDS}))
    for st, copy in kept:  # earlier results survive the later replays
        for f in graphs.FIELDS:
            assert torch.equal(getattr(st, f), copy[f]), f

    r = run._capture(st0, fast, run.bucket(st0, cfg.physics_dt, fast), None)
    assert r.metrics is None
    got, none = r.replay(st0, v1, 3)
    assert none is None
    want = st0
    for _ in range(3):
        want, _ = bare(want, cfg, ts1, fdt1, steps, None, cfg.physics_dt)
    for f in graphs.FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    with pytest.raises(ValueError, match="bucket"):
        g.replay(ensemble_init(cfg, st0.batch + 1, device="cpu"), v1, 1)


def test_capture_and_replay_spans_and_counters(monkeypatch):
    """A capture counts once in ``graph.captures`` inside the span
    ``pyqmd.graph.capture``; each replay call is the spans ``copy_in``,
    ``replay`` and ``copy_out`` side by side and counts each of its
    replays in ``graph.replays``, never a capture."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(graphs, "_record", lambda fn, dev: _CpuGraph(fn))
    cfg, st0, steps = _state("he4")
    metrics = functools.partial(step._metrics, batched=True)
    run = graphs.FrameGraphs(cfg, steps, step.frame_body, metrics, 3, graph_metrics=False)
    values, fast = scalar_values(
        frame_dynamics(cfg, *REGIMES["fast"][0][:2], steps, None, cfg.physics_dt), cfg)
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        g = run._capture(st0, fast, run.bucket(st0, cfg.physics_dt, fast), None)
        st, _ = g.replay(st0, values, 3)
        g.replay(st, values, 3)
    grown = {k: v - before[k] for k, v in profiling.counters().items()}
    assert grown["graph.captures"] == 1 and grown["graph.replays"] == 6
    spans = [(e.name, e.cpu_parent.name if e.cpu_parent else None)
             for e in prof.events() if e.name.startswith("pyqmd.graph.")]
    assert spans == [("pyqmd.graph.capture", None)] + [
        ("pyqmd.graph.copy_in", None), ("pyqmd.graph.replay", None),
        ("pyqmd.graph.copy_out", None)] * 2


def test_a_capture_gives_back_its_counts_and_each_replay_counts_them(monkeypatch):
    """What the captured body counts (the kernel wrappers' launches on the
    card) is put back after the capture, kept as the graph's ``launches``
    and counted again by every replay; nothing else moves but
    ``graph.captures`` and ``graph.replays``."""
    monkeypatch.setattr(graphs, "_record", lambda fn, dev: _CpuGraph(fn))
    cfg, st0, steps = _state("he4")

    def body(states, cfg, sc, num_steps):
        profiling.count("kernels.force_step.launches", num_steps)
        profiling.count("kernels.overlap_step.launches")
        return step.frame_body(states, cfg, sc, num_steps)

    run = graphs.FrameGraphs(cfg, steps, body, functools.partial(step._metrics, batched=True),
                             2, graph_metrics=False)
    values, fast = scalar_values(
        frame_dynamics(cfg, *REGIMES["fast"][0][:2], steps, None, cfg.physics_dt), cfg)
    before = profiling.counters()
    g = run._capture(st0, fast, run.bucket(st0, cfg.physics_dt, fast), None)
    assert g.launches == {"kernels.force_step.launches": steps,
                          "kernels.overlap_step.launches": 1}
    assert profiling.counters() == {**before, "graph.captures": before["graph.captures"] + 1}
    g.replay(st0, values, 2)
    after = profiling.counters()
    assert {k: v - before[k] for k, v in after.items() if v != before[k]} == {
        "graph.captures": 1, "graph.replays": 2, "kernels.force_step.launches": 2 * steps,
        "kernels.overlap_step.launches": 2}


def test_a_count_beside_the_capture_stays_and_no_replay_repeats_it(monkeypatch):
    """A counter outside ``kernels.*`` that moves while a graph is captured
    (another thread's sync or drain; here the body's own) keeps its count,
    and is no part of what a replay counts."""
    monkeypatch.setattr(graphs, "_record", lambda fn, dev: _CpuGraph(fn))
    cfg, st0, steps = _state("he4")

    def body(states, cfg, sc, num_steps):
        profiling.count("kernels.force_step.launches", num_steps)
        profiling.count("host.syncs")
        profiling.count("sim.chain_drains", 2)
        return step.frame_body(states, cfg, sc, num_steps)

    run = graphs.FrameGraphs(cfg, steps, body, functools.partial(step._metrics, batched=True),
                             2, graph_metrics=False)
    values, fast = scalar_values(
        frame_dynamics(cfg, *REGIMES["fast"][0][:2], steps, None, cfg.physics_dt), cfg)
    before = profiling.counters()
    g = run._capture(st0, fast, run.bucket(st0, cfg.physics_dt, fast), None)
    assert g.launches == {"kernels.force_step.launches": steps}
    captured = profiling.counters()
    assert {k: v - before[k] for k, v in captured.items() if v != before[k]} == {
        "graph.captures": 1, "host.syncs": 1, "sim.chain_drains": 2}
    g.replay(st0, values, 3)
    assert {k: v - captured[k] for k, v in profiling.counters().items() if v != captured[k]} == {
        "graph.replays": 3, "kernels.force_step.launches": 3 * steps}


def test_a_failed_capture_names_the_bucket(monkeypatch):
    def refuse(fn, dev):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(graphs, "_record", refuse)
    cfg, st0, steps = _state("he4")
    fg = graphs.FrameGraphs(cfg, steps, step.frame_body,
                            functools.partial(step._metrics, batched=True), 1, True)
    before = profiling.counters()
    with pytest.raises(RuntimeError, match=r"bucket \(Z=2, N=2, P=8, num_steps=4.*B=4"):
        fg._capture(st0, True, fg.bucket(st0, cfg.physics_dt, True), None)
    assert profiling.counters() == before and fg.captures == 0

