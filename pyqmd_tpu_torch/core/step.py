"""The batched frames: substeps as a Python loop over batched tensor ops.

In the full-physics frame each substep advances the ejecta, runs the decay
check, and calls the force + integrate step; the frame ends with one
overlap projection and the metrics (reference nuclear_sim.py:118-176). The
decay-statistics frame runs only the decay checks, all of a frame's
substeps in one kernel call. The ejecta and decay of a substep, the force,
overlap and decay passes go through the kernel wrappers, which take the
plain PyTorch version for CPU tensors and the CUDA kernel for CUDA tensors.

The frame's scalars are computed in f32 in the JAX package's order
(:mod:`pyqmd_tpu_torch.core.dynamics`) and reach the ops as 0-d tensors on
the state's device, and every draw follows its key tree
(``core/step.py:268-289`` there), so integer fields and RNG streams equal
the reference's bitwise. :func:`make_frame_fn` and :func:`make_run_fn`
replay a CUDA graph of :func:`frame_body` per bucket on the card
(:mod:`pyqmd_tpu_torch.core.graphs`) and run it eagerly on the CPU.
"""

from __future__ import annotations

import functools

import torch

from pyqmd_tpu_torch import prng
from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core.decay import pack_nucleon_bits, unpack_alive_ptype
from pyqmd_tpu_torch.core.dynamics import (
    FrameDynamics,
    FrameScalars,
    frame_dynamics,
    frame_scalars,
)
from pyqmd_tpu_torch.core.graphs import FrameGraphs
from pyqmd_tpu_torch.core.overlap import _rand_u
from pyqmd_tpu_torch.kernels.decay import DECAY_FIELDS, decay_stats_frame
from pyqmd_tpu_torch.kernels.forces import force_step
from pyqmd_tpu_torch.kernels.overlap import overlap_step
from pyqmd_tpu_torch.kernels.substep import SUBSTEP_FIELDS, ejecta_decay_substep
from pyqmd_tpu_torch.state import NucleusState


# Per-nucleus metric keys produced by state_metrics.
METRIC_KEYS = (
    "nan", "alive", "kinetic", "z", "n", "half_life", "decay_counts",
    "time_passed", "com", "chain_cursor", "rms_radius",
)

# Ensemble aggregates. ``survivors`` is added only by the sharded frames of
# :mod:`pyqmd_tpu_torch.parallel`, which sum all three over the data group.
AGGREGATE_METRIC_KEYS = ("total_decay_counts", "total_alive", "survivors")


def state_metrics(state: NucleusState) -> dict:
    """Observable per-nucleus metrics, including the NaN guard that
    surfaces numerical blow-up."""
    return {
        "nan": ~torch.all(
            (torch.isfinite(state.pos) & torch.isfinite(state.vel)).flatten(-2), dim=-1
        ),
        "alive": state.alive_count(),
        "kinetic": state.kinetic_energy(),
        "z": state.z,
        "n": state.n,
        "half_life": state.half_life,
        "decay_counts": state.decay_counts,
        "time_passed": state.time_passed,
        "com": state.center_of_mass(),
        "chain_cursor": state.chain_cursor,
        "rms_radius": state.rms_radius(),
    }


def _ensemble_metrics(states: NucleusState) -> dict:
    """Per-nucleus metrics plus the aggregate decay statistics, summed on
    the device."""
    metrics = state_metrics(states)
    metrics["total_decay_counts"] = metrics["decay_counts"].sum(0, dtype=torch.int32)
    metrics["total_alive"] = metrics["alive"].sum(dtype=torch.int32)
    return metrics


def _batched_overlap(pos, alive, keys, cfg: SimConfig):
    """``cfg.overlap_iterations`` overlap passes over the batch; pass i
    draws its angles from ``fold_in(key, i)`` of each member's key."""
    p = pos.shape[-2]
    for i in range(cfg.overlap_iterations):
        u = _rand_u(prng.fold_in(keys, i), p)
        pos = overlap_step(pos, alive, u, cfg)
    return pos


def _advance_clock(states: NucleusState, sc: FrameScalars) -> NucleusState:
    """time_passed advances at frame start (nuclear_sim.py:124), so every
    substep's decay record sees the same frame clock."""
    return states.replace(time_passed=states.time_passed + sc.desired_dt)


def _frame_clock(
    states: NucleusState,
    cfg: SimConfig,
    time_scale,
    frame_dt,
    num_steps: int,
    physics_dt,
    raw_physics_dt,
) -> tuple[NucleusState, FrameDynamics]:
    """Clock advance and the frame's :class:`FrameDynamics` (host f32)."""
    dyn = frame_dynamics(cfg, time_scale, frame_dt, num_steps, physics_dt, raw_physics_dt)
    return _advance_clock(states, frame_scalars(dyn, cfg, states.time_passed.device)), dyn


def frame_body(
    states: NucleusState,
    cfg: SimConfig,
    sc: FrameScalars,
    num_steps: int,
    force_step_fn=None,
) -> NucleusState:
    """The full-physics frame without its metrics: clock, key split,
    ``num_steps`` substeps and the overlap projection, every scalar read
    from ``sc``. No op depends on a value of the frame's scalars, so a
    CUDA graph of it replays at any time scale (:mod:`.graphs`). A
    substep's ejecta and decay are one
    :func:`~pyqmd_tpu_torch.kernels.substep.ejecta_decay_substep` call,
    which takes its key from ``k3 = split(rng, 3)`` and the substep index
    and, on the card, updates the frame's own copies of the fields it
    writes in place (cloned once, so the caller's state stays as it was).

    ``force_step_fn`` replaces the force + integrate step, with the
    signature of :func:`pyqmd_tpu_torch.kernels.forces.force_step`
    ``(pos, vel, ptype, alive, dt, cfg)``, ``dt`` a 0-d tensor; the
    particle-axis ring of :mod:`pyqmd_tpu_torch.parallel.ring` runs through
    it while the rest of the frame stays replicated. ``None`` is the kernel
    wrapper."""
    fstep = force_step_fn or force_step
    states = _advance_clock(states, sc)
    states = states.replace(**{f: getattr(states, f).clone() for f in SUBSTEP_FIELDS})
    k3 = prng.split(states.rng, 3)  # (B, 3, 2): substeps, overlap, next
    for s in range(num_steps):
        states = ejecta_decay_substep(states, cfg, sc, k3, s)
        pos, vel = fstep(
            states.pos, states.vel, states.ptype, states.alive, sc.physics_dt, cfg
        )
        states = states.replace(pos=pos, vel=vel)

    pos = _batched_overlap(states.pos, states.alive, k3[:, 1], cfg)
    return states.replace(pos=pos, rng=k3[:, 2].contiguous())


def _frame_body(
    states: NucleusState,
    cfg: SimConfig,
    time_scale,
    frame_dt,
    num_steps: int,
    physics_dt=None,
    raw_physics_dt=None,
    force_step_fn=None,
) -> NucleusState:
    """:func:`frame_body` at the given time scale and frame interval."""
    dyn = frame_dynamics(cfg, time_scale, frame_dt, num_steps, physics_dt, raw_physics_dt)
    sc = frame_scalars(dyn, cfg, states.pos.device)
    return frame_body(states, cfg, sc, num_steps, force_step_fn)


def ensemble_step(
    states: NucleusState,
    cfg: SimConfig,
    time_scale,
    frame_dt,
    num_steps: int,
    physics_dt=None,
    raw_physics_dt=None,
    force_step_fn=None,
) -> tuple[NucleusState, dict]:
    """One frame of ``num_steps`` substeps over a batch of nuclei.

    Per-nucleus metrics keep their batch axis; the aggregate decay
    statistics are summed on the device. ``force_step_fn`` as in
    :func:`_frame_body`.
    """
    states = _frame_body(
        states, cfg, time_scale, frame_dt, num_steps, physics_dt, raw_physics_dt,
        force_step_fn,
    )
    return states, _ensemble_metrics(states)


def decay_ensemble_step(
    states: NucleusState,
    cfg: SimConfig,
    time_scale,
    frame_dt,
    num_steps: int,
    physics_dt=None,
    raw_physics_dt=None,
) -> tuple[NucleusState, dict]:
    """Decay-statistics-only frame over a batch: Bernoulli decay, branch
    sampling and the nucleon adjustment, without ejecta, forces or the
    overlap pass, none of which can change which isotope a nucleus is.

    The key tree is :func:`ensemble_step`'s (the force step draws nothing;
    the overlap key is split but unused), so z, n, half_life, decay_counts,
    the chain log and rng equal the full-physics frame's bitwise; positions,
    velocities and ejecta are left as they were. The substeps are one
    :func:`decay_stats_frame` call on a carry cloned once per frame, with
    alive/ptype packed into bitfields once per frame; on the card the
    kernel derives the key tree itself, so none is built here.
    """
    states, dyn = _frame_clock(
        states, cfg, time_scale, frame_dt, num_steps, physics_dt, raw_physics_dt
    )
    carry = states.replace(**{f: getattr(states, f).clone() for f in DECAY_FIELDS})
    bits = pack_nucleon_bits(states.alive, states.ptype)
    rng = decay_stats_frame(carry, bits, states.rng, cfg, dyn, num_steps)
    alive, ptype = unpack_alive_ptype(*bits, states.alive.shape[-1])
    states = carry.replace(alive=alive, ptype=ptype, rng=rng)

    return states, _ensemble_metrics(states)


def make_decay_frame_fn(cfg: SimConfig, num_steps: int):
    """:func:`decay_ensemble_step` for a (config, substep-count) bucket,
    with the frame signature of :func:`make_frame_fn`."""

    def frame(state, time_scale, frame_dt, physics_dt=cfg.effective_dt(),
              raw_physics_dt=cfg.physics_dt):
        return decay_ensemble_step(state, cfg, time_scale, frame_dt, num_steps,
                                   physics_dt, raw_physics_dt)

    return frame


def simulate_frame(
    state: NucleusState,
    cfg: SimConfig,
    time_scale,
    frame_dt,
    num_steps: int,
    physics_dt=None,
    raw_physics_dt=None,
    force_step_fn=None,
) -> tuple[NucleusState, dict]:
    """One frame of a single nucleus: the ``B = 1`` case of
    :func:`ensemble_step`, with per-nucleus metrics only."""
    if state.batch != 1:
        raise ValueError(f"simulate_frame takes a batch of 1, got {state.batch}")
    state = _frame_body(
        state, cfg, time_scale, frame_dt, num_steps, physics_dt, raw_physics_dt,
        force_step_fn,
    )
    return state, state_metrics(state)


def _metrics(states: NucleusState, batched: bool) -> dict:
    return _ensemble_metrics(states) if batched else state_metrics(states)


def frame_graphs(cfg: SimConfig, num_steps: int, batched: bool, force_step_fn=None,
                 group: str = "") -> FrameGraphs:
    """The :class:`~pyqmd_tpu_torch.core.graphs.FrameGraphs` of a frame
    function: :func:`frame_body` with ``force_step_fn``, and its metrics
    (batched or one nucleus's) inside the graph; ``group`` names the
    process groups of ``force_step_fn``'s collectives."""
    body = frame_body if force_step_fn is None else functools.partial(
        frame_body, force_step_fn=force_step_fn)
    return FrameGraphs(cfg, num_steps, body, functools.partial(_metrics, batched=batched),
                       frames=1, graph_metrics=True, group=group)


@functools.lru_cache(maxsize=128)
def make_frame_fn(cfg: SimConfig, num_steps: int, batched: bool = False):
    """Frame function for a (config, substep-count) bucket, with the
    JAX package's call signature ``frame(state, time_scale, frame_dt,
    physics_dt=..., raw_physics_dt=...)``, cached as the JAX package caches
    its jitted frame (128 buckets).

    On the card the first call of each graph bucket (batch size, device,
    whether ``raw_physics_dt`` is None, the ``time_scale > 1`` lifetime
    regime) runs the frame eagerly and captures it in a CUDA graph; later
    calls replay that graph at any time scale and frame interval, into
    fresh tensors. On the CPU the frame runs eagerly. Either way the
    result is bitwise :func:`ensemble_step`'s (or :func:`simulate_frame`'s).
    The callable's ``graphs`` attribute is its
    :class:`~pyqmd_tpu_torch.core.graphs.FrameGraphs`.
    """
    graphs = frame_graphs(cfg, num_steps, batched)

    def frame(state, time_scale, frame_dt, physics_dt=cfg.effective_dt(),
              raw_physics_dt=cfg.physics_dt):
        if not batched and state.batch != 1:
            raise ValueError(f"simulate_frame takes a batch of 1, got {state.batch}")
        return graphs(state, time_scale, frame_dt, physics_dt, raw_physics_dt)

    frame.graphs = graphs
    return frame


@functools.lru_cache(maxsize=64)
def make_run_fn(cfg: SimConfig, num_steps: int, num_frames: int, batched: bool = False):
    """Fused run for a (config, substep-count, frame-count) bucket:
    ``num_frames`` whole frames back to back at a constant time scale,
    with no host synchronisation between them (64 buckets cached).

    On the card this is one host call per frame: the frame's CUDA graph
    (captured without metrics, per graph bucket as in
    :func:`make_frame_fn`) replayed ``num_frames`` times, then the metrics
    once. The frames are not captured as one graph of ``num_frames``
    frames, whose instantiation time would grow with the count. On the CPU
    the frames run eagerly.

    Returns ``(state, metrics)`` with the metrics of the final state only:
    the frames in between run without theirs. The clock advances per
    frame, and the chain-log ring in the state keeps every event for the
    host to drain afterwards.
    """
    graphs = FrameGraphs(cfg, num_steps, frame_body,
                         functools.partial(_metrics, batched=batched), frames=num_frames,
                         graph_metrics=False)

    def run(state, time_scale, frame_dt, physics_dt=cfg.effective_dt(),
            raw_physics_dt=cfg.physics_dt):
        if not batched and state.batch != 1:
            raise ValueError(f"a single-nucleus run takes a batch of 1, got {state.batch}")
        return graphs(state, time_scale, frame_dt, physics_dt, raw_physics_dt)

    run.graphs = graphs
    return run
