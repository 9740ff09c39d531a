"""Host-side simulation loop.

The counterpart of the reference's ``NuclearSimulation``
(nuclear_sim.py:31-613): owns the static config, the device state, the
interactive time/camera controls, substep scheduling, decay-event logging,
rendering and checkpointing. All physics happens in the frame functions of
:mod:`pyqmd_tpu_torch.core.step`; this class only makes host decisions
(which substep count to run, what to log) and keeps UI state (camera lerp,
zoom).

The state is always batched: a lone nucleus is a batch of one, and
``ensemble`` (not a tensor's rank) says which mode the simulation is in. The
state's device picks the path: on the card the frames run the CUDA kernels,
and a kernel that fails to build or launch raises out of :meth:`frame`
with ``sim.state`` still the pre-frame state. There is no second path.

Every readback waits for the stream, so this class makes few: a frame
dispatches its work and returns; ``status()`` and the chain log each arrive in
one packed transfer.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from collections import deque

import numpy as np
import torch

from pyqmd_tpu_torch import prng
from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core.decay import force_decay as _force_decay
from pyqmd_tpu_torch.core.dynamics import FrameDynamics
from pyqmd_tpu_torch.core.init import ensemble_init, init_state
from pyqmd_tpu_torch.core.step import make_frame_fn, make_run_fn
from pyqmd_tpu_torch.data.elements import element_symbol, isotope_label
from pyqmd_tpu_torch.state import DECAY_SYMBOLS, NucleusState
from pyqmd_tpu_torch.utils.checkpoint import read_checkpoint, save_checkpoint
from pyqmd_tpu_torch.utils.format import format_time_value_with_unit
from pyqmd_tpu_torch.utils.profiling import StepTimer, fence

logger = logging.getLogger("pyqmd_tpu_torch")

_F32 = np.float32


def _status_pack(st: NucleusState, index: int = 0) -> torch.Tensor:
    """Pack every scalar :meth:`Simulation.status` reads of member
    ``index`` into ONE int32 vector, so the host fetches it in ONE
    readback (each separate ``int(tensor)`` would synchronise the stream).
    Floats ride as their bit patterns. Layout: [z, n, alive, ejecta,
    chain_cursor, decay_counts[8]], then [half_life, time_passed,
    rms_radius, kinetic] as f32 bits."""
    one = slice(index, index + 1)
    ints = torch.cat([
        st.z[one], st.n[one],
        st.alive_count()[one],
        st.ej_alive[one].sum(-1, dtype=torch.int32),
        st.chain_cursor[one],
        st.decay_counts[index],
    ])
    floats = torch.cat([
        st.half_life[one], st.time_passed[one],
        st.rms_radius()[one], st.kinetic_energy()[one],
    ]).to(torch.float32)
    return torch.cat([ints, floats.view(torch.int32)])


def _status_pack_batched(st: NucleusState) -> torch.Tensor:
    """Batched-status aggregate in one readback: [total_alive,
    decay_counts summed over the ensemble] as one int32 vector."""
    return torch.cat([
        st.alive.sum(dtype=torch.int32)[None],
        st.decay_counts.sum(0, dtype=torch.int32),
    ])


def _chain_pack(st: NucleusState, index: int = 0) -> torch.Tensor:
    """The six chain-ring arrays of member ``index`` as one (6, L) int32
    tensor (durations as their f32 bits): one transfer for the whole log."""
    return torch.stack([
        st.chain_z0[index], st.chain_n0[index], st.chain_z1[index],
        st.chain_n1[index], st.chain_dtype[index],
        st.chain_time[index].view(torch.int32),
    ])


def _fit_frame_device(state: NucleusState, width: int, height: int, origin, index: int = 0):
    """View-fitted full-frame render with no readback: the
    :meth:`Simulation._render_fit` camera math (alive-masked center of
    mass, max |pos - com| extent with the 5.0 floor and +3.0 margin,
    0.45·min(w, h)/extent zoom, nuclear_sim.py:68-75 semantics) computed on
    the device, then the rasterizer with that camera and zoom as tensors.
    Returns the (H, W, 3) uint8 image on the state's device."""
    from pyqmd_tpu_torch.render.framebuffer import pair_on, render_frame

    pos = state.pos[index]
    w = state.alive[index].to(torch.float32)
    cnt = w.sum()
    origin = pair_on(pos.device, *origin)
    com = torch.where(
        cnt > 0, (pos * w[:, None]).sum(0) / torch.clamp(cnt, min=1.0), origin
    )
    d = torch.where(w[:, None] > 0, torch.abs(pos - com), 0.0)
    extent = torch.where(cnt > 0, torch.clamp(d.max(), min=5.0) + 3.0, 10.0)
    zoom = 0.45 * min(width, height) / extent
    return render_frame(state, com, zoom, width, height, ruler=False, index=index)


# Time-scale presets (nuclear_sim.py:78-87).
TIME_SCALE_PRESETS = {
    "real": 1.0,
    "minute": 60.0,
    "hour": 3600.0,
    "day": 86400.0,
    "year": 31557600.0,
    "millennium": 31557600000.0,
    "million": 31557600000000.0,
    "billion": 31557600000000000.0,
}

MIN_TIME_SCALE = 1e-40  # nuclear_sim.py:52
MAX_TIME_SCALE = 1e30  # nuclear_sim.py:53
MIN_ZOOM, MAX_ZOOM = 0.1, 100.0  # nuclear_sim.py:74-75

# Default isotope keymap (nuclear_sim.py:494-504).
ISOTOPE_KEYMAP = {
    1: (1, 2),    # H-3
    2: (2, 3),    # He-5
    3: (6, 8),    # C-14
    4: (8, 9),    # O-17
    5: (26, 33),  # Fe-59
    6: (47, 61),  # Ag-108
    7: (79, 119), # Au-198
    8: (82, 127), # Pb-209
    9: (92, 146), # U-238
}


@dataclasses.dataclass
class _InFlight:
    """A frame that was dispatched and may not have finished: ``event`` marks
    its end on the stream (None on the CPU), ``nan`` is its NaN flag on
    the host once the event has passed."""

    event: torch.cuda.Event | None
    metrics: dict
    steps: int
    nan: torch.Tensor


class Simulation:
    """One nucleus (or an ensemble) plus interactive host controls."""

    def __init__(
        self,
        cfg: SimConfig | None = None,
        *,
        z: int = 92,
        n: int = 146,
        seed: int = 0,
        ensemble: int | None = None,
        pad_to: int = 128,
        device="cuda",
        overrides: dict | None = None,
    ):
        """The state lives on ``device`` (the card unless the caller names
        another; without a card the default raises). ``overrides`` are
        extra SimConfig field values applied on top of the built config
        (and re-applied on isotope switches): the configurable-physics
        surface (every reference constant is a SimConfig field)."""
        self.seed = seed
        self._overrides = dict(overrides or {})
        self.ensemble = ensemble
        self.pad_to = pad_to
        self.device = torch.device(device)
        # Interactive single-nucleus sims get a deeper chain ring so the
        # zero-loss log drain (see frame()) reads the log every ~11 frames
        # instead of every ~2 at max substeps; ensembles keep the small
        # ring (it is per-member memory: 64k x 256 slots x 6 arrays would
        # be 400 MB).
        self.cfg = cfg or SimConfig.for_isotope(
            z, n, pad_to=pad_to, max_chain_log=64 if ensemble else 256,
        )
        if self._overrides:
            self.cfg = dataclasses.replace(self.cfg, **self._overrides)
        self._init_controls()
        self._chain_seen = 0
        self._decay_log: list[str] = []
        self._init_observability()
        self.reset()

    def _init_controls(self):
        self.time_scale = 1.0
        self.frame_count = 0
        self.substeps_used = 0
        # Host scheduling state (nuclear_sim.py:59-66): the physics timestep
        # and accuracy are arguments of the frame, so the F-key auto-adjust
        # (nuclear_sim.py:131-142) and the timestep controls change no
        # frame function.
        self.physics_dt = self.cfg.physics_dt
        self.accuracy = self.cfg.accuracy
        self.max_substeps = self.cfg.max_substeps
        self.auto_adjust_substeps = False
        # Camera/zoom with lerp targets (nuclear_sim.py:68-75, 126-128).
        self.camera = [self.cfg.origin_x, self.cfg.origin_y]
        self.camera_target = list(self.camera)
        self.zoom = 15.0
        self.target_zoom = 15.0
        self.zoom_speed = 0.1
        self.chain_scroll = 0  # decay-chain panel scroll (rendering.py:528-536)
        self.info_scroll = 0  # info panel scroll lines (rendering.py:140, 534-536)
        # Default viewport size; the resize analog (nuclear_sim.py:419-428).
        self.view_width = 800
        self.view_height = 600
        self.last_metrics = None

    def _init_observability(self):
        # Frame pipelining + throughput tracking (the reference's FPS deque,
        # nuclear_sim.py:60, 119-121). A frame is dispatched without waiting
        # for it; it retires through this queue, fenced only when it falls
        # off the end, so up to maxlen frames are in flight and the timers
        # measure the real retire rate, not the dispatch rate.
        self._inflight: deque = deque(maxlen=4)
        self._substep_timer = StepTimer(window=30)
        self._fps_timer = StepTimer(window=30)
        self._undrained_substeps = 0
        self._chain_cache: tuple[int, list] | None = None
        # NaN-guard cadence: the guard reads the flag of the oldest frame
        # in flight every N frames, so it never waits for the newest.
        self.nan_check_interval = 30
        self._nan_slots: torch.Tensor | None = None  # pinned host flags, on the card only
        self._markers_dispatched = 0  # picks the pinned slot, on the card only

    # -- lifecycle ----------------------------------------------------------

    def reset(self, z: int | None = None, n: int | None = None, seed: int | None = None):
        """(Re)build the nucleus, the create_nucleus equivalent
        (nuclear_sim.py:92-116). Resets clocks, counters, chain."""
        if z is not None or n is not None:
            z = z if z is not None else self.cfg.z
            n = n if n is not None else self.cfg.n
            self.cfg = SimConfig.for_isotope(
                z, n, pad_to=self.pad_to, max_chain_log=self.cfg.max_chain_log,
            )
            if self._overrides:
                self.cfg = dataclasses.replace(self.cfg, **self._overrides)
        if seed is not None:
            self.seed = seed
        if self.ensemble:
            self.state = ensemble_init(
                self.cfg, self.ensemble, seed=self.seed, device=self.device
            )
        else:
            self.state = init_state(self.cfg, seed=self.seed, device=self.device)
        self._chain_seen = 1  # skip the initial-state entry
        self._decay_log.clear()  # the old nucleus's log lines aren't ours
        self.camera_target = [self.cfg.origin_x, self.cfg.origin_y]
        self.last_metrics = None
        self._inflight.clear()
        self._substep_timer.reset()
        self._fps_timer.reset()
        self._undrained_substeps = 0
        self._chain_cache = None  # fresh ring may reuse old cursor values
        logger.info("nucleus: %s (seed %d)", self.isotope, self.seed)

    def set_isotope_key(self, key: int):
        """1-9 isotope selection (nuclear_sim.py:492-506)."""
        if key in ISOTOPE_KEYMAP:
            self.reset(*ISOTOPE_KEYMAP[key])

    @property
    def batched(self) -> bool:
        """Ensemble mode. An ensemble of one is still an ensemble."""
        return bool(self.ensemble)

    @property
    def isotope(self) -> str:
        if self.batched:
            return f"{isotope_label(self.cfg.z, self.cfg.n)} x{self.ensemble}"
        z, n = torch.stack([self.state.z[0], self.state.n[0]]).tolist()
        return isotope_label(z, n)

    # -- time & camera controls ---------------------------------------------

    def set_time_scale(self, value: float):
        self.time_scale = float(np.clip(value, MIN_TIME_SCALE, MAX_TIME_SCALE))
        logger.info("time scale: %g", self.time_scale)

    def scale_time(self, factor: float):
        """Arrow-key-style multiplicative change (nuclear_sim.py:437-448)."""
        self.set_time_scale(self.time_scale * factor)

    def set_preset(self, name: str):
        if name not in TIME_SCALE_PRESETS:
            raise KeyError(f"unknown preset {name!r}; options: {list(TIME_SCALE_PRESETS)}")
        self.set_time_scale(TIME_SCALE_PRESETS[name])

    def zoom_by(self, factor: float):
        self.target_zoom = float(np.clip(self.target_zoom * factor, MIN_ZOOM, MAX_ZOOM))

    def pan(self, dx: float, dy: float):
        """WASD camera pan, speed scaled by 1/zoom (nuclear_sim.py:412-417)."""
        speed = 5.0 / self.zoom
        self.camera_target[0] += dx * speed
        self.camera_target[1] += dy * speed

    def _lerp_camera(self):
        """nuclear_sim.py:126-128."""
        self.camera[0] += (self.camera_target[0] - self.camera[0]) * 0.1
        self.camera[1] += (self.camera_target[1] - self.camera[1]) * 0.1
        self.zoom += (self.target_zoom - self.zoom) * self.zoom_speed

    # -- stepping ------------------------------------------------------------

    # Substep-count ladder: in auto-adjust mode the reference allows up to
    # max_substeps * log10(time_scale) substeps (nuclear_sim.py:149-150);
    # the count is snapped down to this ladder, as in the JAX package,
    # where it bounds the compiled variants. The ladder applies ONLY in
    # auto-adjust mode: with it off, counts are already bounded by
    # max_substeps (default 20) and must match the reference's exact
    # integer (nuclear_sim.py:153), so e.g. 7 substeps stay 7.
    _SUBSTEP_LADDER = (
        1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 25, 32, 40, 50, 64, 80, 100,
        128, 160, 200,
    )

    def _schedule(self, frame_dt: float) -> tuple[int, float]:
        """Host scheduling decision: (num_substeps, effective_physics_dt),
        the logic of nuclear_sim.py:131-154 including the auto-adjust mode."""
        ts = self.time_scale
        pdt = self.physics_dt
        if self.auto_adjust_substeps and ts != 1.0:
            if ts > 1.0:
                scale = min(10.0, ts**0.3)
                pdt = min(1.0 / 60.0, self.cfg.physics_dt_factor * scale / 240.0)
            else:
                scale = max(0.1, ts**0.2)
                pdt = max(1.0 / 1000.0, self.cfg.physics_dt_factor * scale / 240.0)
            self.physics_dt = pdt
        effective = pdt * (2.0 - self.accuracy)
        ts_factor = 1.0 if ts <= 10.0 else math.log10(ts)
        adj_max = (
            int(self.max_substeps * ts_factor)
            if self.auto_adjust_substeps
            else self.max_substeps
        )
        num = max(1, min(adj_max, int(frame_dt * ts / effective)))
        if self.auto_adjust_substeps:
            # Snap to the ladder (largest entry <= num).
            for step in reversed(self._SUBSTEP_LADDER):
                if step <= num:
                    num = step
                    break
        return num, effective

    def frame(self, frame_dt: float = 1.0 / 60.0):
        """Advance one frame. The substep count is the host's
        (nuclear_sim.py:153).

        The frame is dispatched and not waited for: up to
        ``_inflight.maxlen`` frames queue on the device before the host
        fences on a *retired* frame (never on the one just dispatched), so
        interactive throughput is not bound by a host round trip per frame.
        The decay log drains lazily (on access, or before the chain ring
        could wrap).

        An exception raised inside the frame function leaves by the caller
        with ``self.state`` still the pre-frame state. A periodic NaN guard
        logs numerical blowup instead of the reference's silent kernel-skip
        (nuclear_forces.py:222-224).
        """
        num_steps, eff_dt = self._schedule(frame_dt)
        self.substeps_used = num_steps
        if not self.batched and (
            self._undrained_substeps + num_steps >= self.cfg.max_chain_log
        ):
            # Zero-loss log drain, checked BEFORE the frame is dispatched
            # against THIS frame's actual substep count (auto-adjust frames
            # can run up to 200 substeps, far past max_substeps): the
            # pre-frame state holds every entry so far, so draining now
            # guarantees the ring cannot wrap past unseen entries.
            self._drain_chain_log()
        fn = make_frame_fn(self.cfg, num_steps, batched=self.batched)
        self.state, metrics = fn(
            self.state, self.time_scale, frame_dt, eff_dt, self.physics_dt
        )
        self.frame_count += 1
        self._retire(metrics, num_steps)
        self._lerp_camera()
        self.last_metrics = metrics
        if not self.batched:
            self._undrained_substeps += num_steps
        return metrics

    def _dispatch_marker(self, metrics: dict, num_steps: int) -> _InFlight:
        """Queue the frame's NaN flag for the host and mark the frame's end
        on the stream, waiting for neither."""
        flag = metrics["nan"].any()
        if not flag.is_cuda:
            return _InFlight(None, metrics, num_steps, flag)
        # One pinned slot more than the queue holds markers, allocated once
        # and taken in turn by a count of the markers dispatched (not by
        # ``frame_count``, which a fused run raises without dispatching one):
        # a slot comes round again only after the marker that held it has
        # left the queue.
        if self._nan_slots is None:
            self._nan_slots = torch.empty(
                self._inflight.maxlen + 1, dtype=torch.bool, pin_memory=True
            )
        host = self._nan_slots[self._next_nan_slot()]
        host.copy_(flag, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(flag.device))
        return _InFlight(event, metrics, num_steps, host)

    def _next_nan_slot(self) -> int:
        """Index of the pinned slot for the next marker: the slots are
        taken in ring order, one per dispatched marker."""
        slot = self._markers_dispatched % (self._inflight.maxlen + 1)
        self._markers_dispatched += 1
        return slot

    def _retire(self, metrics: dict, num_steps: int):
        """Push this frame into the pipeline; fence on the frame that
        falls off the end."""
        self._inflight.append(self._dispatch_marker(metrics, num_steps))
        if len(self._inflight) == self._inflight.maxlen:
            old = self._inflight.popleft()
            if old.event is not None:
                fence(old.event)
            if self._substep_timer.primed:
                self._substep_timer.lap(None, steps=old.steps)
                self._fps_timer.lap(None)
            else:
                # Prime on the first retire: the span from dispatch #1 to
                # retire #1 covers the whole pipeline fill and would bias
                # the rolling rate ~3x low if credited to one frame.
                self._substep_timer.start()
                self._fps_timer.start()
        if self.nan_check_interval and (
            self.frame_count % self.nan_check_interval == 0
        ):
            self._check_nan(self._inflight[0])  # oldest in flight

    def _check_nan(self, frame: _InFlight):
        if frame.event is not None:
            fence(frame.event)
        if bool(frame.nan):
            logger.error(
                "non-finite state detected near frame %d (time scale %g)",
                self.frame_count, self.time_scale,
            )

    @property
    def fps(self) -> float:
        """Rolling frames/sec over retired (device-complete) frames."""
        return self._fps_timer.steps_per_sec

    @property
    def substeps_per_sec(self) -> float:
        """Rolling physics substeps/sec over retired frames."""
        return self._substep_timer.steps_per_sec

    def run(self, frames: int, frame_dt: float = 1.0 / 60.0, fused: bool = False):
        """Advance many frames. ``fused=True`` dispatches all frames in one
        call with no host work between them (constant time scale, metrics
        of the final state only): the throughput mode; the per-frame loop
        is the interactive mode (camera lerp, live logs)."""
        if not fused:
            m = self.last_metrics
            for _ in range(frames):
                m = self.frame(frame_dt)
            return m
        num_steps, eff_dt = self._schedule(frame_dt)
        self.substeps_used = num_steps
        fn = make_run_fn(self.cfg, num_steps, frames, batched=self.batched)
        self.state, metrics = fn(
            self.state, self.time_scale, frame_dt, eff_dt, self.physics_dt
        )
        self.frame_count += frames
        if not self.batched:
            self._drain_chain_log()
        self.last_metrics = metrics
        return metrics

    def force_decay(self):
        """SPACE-key forced decay (nuclear_sim.py:433-434)."""
        if self.batched:
            raise RuntimeError("force_decay is for single-nucleus mode")
        dyn = FrameDynamics(
            _F32(self.time_scale),
            _F32(max(1, self.substeps_used)),
            _F32(self.cfg.effective_dt()),
            _F32(self.cfg.effective_dt() * self.time_scale),
            _F32(self.physics_dt),
        )
        # key, sub = split(key): the event draws from ``sub``, the state
        # keeps ``key``.
        keys = prng.split(self.state.rng, 2)
        state, _ = _force_decay(self.state, self.cfg, keys[:, 1].contiguous(), dyn)
        self.state = state.replace(rng=keys[:, 0].contiguous())
        self._drain_chain_log()

    # -- observability --------------------------------------------------------

    def _drain_chain_log(self, cursor: int | None = None):
        """Emit reference-style decay log lines (nuclear_sim.py:285) for new
        chain entries. Formats from :meth:`chain_entries`, which bulk-reads
        and caches the ring by cursor, so one render+drain cycle costs one
        set of device transfers, not two. ``cursor`` passes an
        already-fetched chain cursor through (status() reads it in its
        packed readback) to skip the scalar fetch."""
        self._undrained_substeps = 0
        entries = self.chain_entries(cursor=cursor)
        if not entries:
            return
        cursor = entries[-1]["index"] + 1
        if cursor == self._chain_seen:
            return
        cap = self.cfg.max_chain_log
        if cursor - self._chain_seen > cap:
            logger.warning(
                "decay log: %d entries lost (chain ring of %d wrapped "
                "between drains; raise SimConfig.max_chain_log to keep more)",
                cursor - self._chain_seen - cap, cap,
            )
        for e in entries:
            if e["index"] < self._chain_seen:
                continue
            line = (
                f"DECAY: {isotope_label(*e['parent'])}"
                f" → {isotope_label(*e['child'])}"
                f" ({e['symbol']})"
                f" after {format_time_value_with_unit(e['duration'])}"
            )
            self._decay_log.append(line)
            logger.info(line)
        self._chain_seen = cursor

    @property
    def decay_log(self) -> list[str]:
        if not self.batched:
            self._drain_chain_log()  # frames dispatch async; sync on access
        return list(self._decay_log)

    def chain_entries(self, cursor: int | None = None):
        """Decoded chain-log entries, oldest first (the decay-chain panel's
        data source, rendering.py:248-380). At most two transfers: the
        cursor, then the six ring arrays in one pack, cached by cursor. The
        ring is append-only, so an unchanged cursor means unchanged
        content and a render+drain cycle re-reads one scalar. Callers that
        already fetched the cursor (the packed status readback) pass it in
        to skip even that."""
        if self.batched:
            # Per-member rings exist but a single merged log would
            # interleave B independent chains meaninglessly; the panel
            # and decay_log already branch on batched.
            raise RuntimeError(
                "chain log is single-nucleus mode only; ensemble members "
                "decay independently (use analysis.chain_populations)"
            )
        st = self.state
        if cursor is None:
            cursor = int(st.chain_cursor[0])
        if self._chain_cache is not None and self._chain_cache[0] == cursor:
            return self._chain_cache[1]
        cap = self.cfg.max_chain_log
        ring = _chain_pack(st).cpu().numpy()
        z0, n0, z1, n1, dt_ = ring[:5].tolist()
        tm = ring[5].view(np.float32).tolist()
        out = []
        for c in range(max(0, cursor - cap), cursor):
            i = c % cap
            out.append(
                dict(
                    index=c,
                    parent=(z0[i], n0[i]),
                    child=(z1[i], n1[i]),
                    symbol=DECAY_SYMBOLS[dt_[i]],
                    duration=tm[i],
                )
            )
        self._chain_cache = (cursor, out)
        return out

    def status(self) -> dict:
        """Info-panel data (rendering.py:135-246 equivalent).

        All device scalars arrive in ONE packed readback
        (:func:`_status_pack`): status runs per rendered frame (the info
        panel), and each separate scalar fetch would wait for the stream
        again."""
        st = self.state
        if self.batched:
            agg = _status_pack_batched(st).cpu().numpy()
            return dict(
                isotope=self.isotope,
                ensemble=self.ensemble,
                alive=int(agg[0]),
                decay_counts=agg[1:9].tolist(),
                time_scale=self.time_scale,
                substeps=self.substeps_used,
                fps=self.fps,
                substeps_per_sec=self.substeps_per_sec,
            )
        ints = _status_pack(st).cpu().numpy()
        v = ints[13:].view(np.float32)
        z, n = int(ints[0]), int(ints[1])
        self._drain_chain_log(cursor=int(ints[4]))
        return dict(
            # isotope from the packed z/n (the property would read the
            # device again).
            isotope=isotope_label(z, n),
            z=z,
            n=n,
            element=element_symbol(z),
            half_life=float(v[0]),
            alive=int(ints[2]),
            ejecta=int(ints[3]),
            decay_counts=ints[5:13].tolist(),
            time_passed=float(v[1]),
            time_scale=self.time_scale,
            substeps=self.substeps_used,
            physics_dt=self.physics_dt,
            auto_adjust=self.auto_adjust_substeps,
            zoom=self.zoom,
            backend=self.device.type,
            fps=self.fps,
            substeps_per_sec=self.substeps_per_sec,
            rms_radius=float(v[2]),
            kinetic_energy=float(v[3]),
        )

    # -- render & persistence -------------------------------------------------

    def resize(self, width: int, height: int):
        """Set the default viewport size (the VIDEORESIZE handler analog,
        nuclear_sim.py:387-389, 419-428)."""
        self.view_width = max(16, int(width))
        self.view_height = max(16, int(height))

    def render(
        self,
        width: int | None = None,
        height: int | None = None,
        index: int = 0,
        panels: bool = True,
        controls: bool = True,
    ):
        """Rasterize the current nucleus (``index`` selects an ensemble
        member) to a host (H, W, 3) uint8 array.

        ``panels=True`` burns the info panel and the decay-chain panel into
        the frame (the reference draws both every frame,
        rendering.py:135-380): particles/ruler rasterize on the device, the
        text overlay composes on the host (it changes at most once per
        frame) and burns in one vectorized masked write.
        """
        from pyqmd_tpu_torch.render import burn_overlay, compose_panels, render_to_host

        width = width or self.view_width
        height = height or self.view_height
        img = render_to_host(
            self.state, tuple(self.camera), self.zoom, width, height, index=index
        )
        if panels:
            chain = None if self.batched else self.chain_entries()
            if chain is not None:
                # Clamp the STORED scroll to the content (the reference
                # stores max_decay_scroll and clamps, rendering.py:289-292)
                # so scrolling back responds immediately after overshooting.
                # n_steps uses the same index>0 filter as draw_decay_chain
                # (after the ring wraps, the index-0 initial record is gone
                # and every returned entry counts).
                from pyqmd_tpu_torch.render.panels import chain_scroll_limit

                n_steps = sum(1 for e in chain if e["index"] > 0)
                self.chain_scroll = min(
                    self.chain_scroll,
                    chain_scroll_limit(width, height, n_steps),
                )
            rgb, mask = compose_panels(
                width, height, self.status(), chain,
                max_substeps=self.max_substeps,
                chain_scroll=self.chain_scroll,
                info_scroll=self.info_scroll,
                controls=controls,
            )
            img = burn_overlay(img, rgb, mask)
        return img

    def render_fit_device(self, width: int, height: int, index: int = 0):
        """Device-fitted frame with NO host readback: camera fit (alive
        center of mass + extent, the :meth:`_render_fit` math) and the
        rasterizer both on the device, returning an un-fenced (H, W, 3)
        uint8 tensor there."""
        return _fit_frame_device(
            self.state, width, height, [self.cfg.origin_x, self.cfg.origin_y], index
        )

    def _render_fit(self, width: int, height: int, index: int = 0):
        """Render with the view fitted to the nucleus extent (the REPL
        viewport; render() uses the interactive camera instead). ``alive``
        and ``pos`` of the member come over in one transfer."""
        from pyqmd_tpu_torch.render import render_to_host

        st = self.state
        packed = torch.cat(
            [st.pos[index], st.alive[index].to(torch.float32)[:, None]], dim=1
        ).cpu().numpy()
        pos = packed[packed[:, 2] > 0, :2]
        if len(pos):
            com = pos.mean(0)
            extent = max(float(np.abs(pos - com).max()), 5.0) + 3.0
        else:
            com, extent = np.array([self.cfg.origin_x, self.cfg.origin_y]), 10.0
        zoom = 0.45 * min(width, height) / extent
        return render_to_host(
            st, (float(com[0]), float(com[1])), zoom, width, height,
            ruler=False, index=index,
        )

    def render_grid(self, nx: int = 4, ny: int = 4, tile: int = 120):
        """Montage of the first nx*ny ensemble members, each view-fitted:
        population-level visual inspection (no reference equivalent)."""
        if not self.batched:
            raise RuntimeError("render_grid is for ensemble mode")
        count = min(nx * ny, self.state.batch)
        rows = []
        for j in range(ny):
            row = []
            for i in range(nx):
                k = j * nx + i
                if k < count:
                    img = self._render_fit(tile, tile, index=k)
                else:
                    img = np.zeros((tile, tile, 3), np.uint8)
                img = img.copy()
                img[0, :] = img[:, 0] = 40  # tile border
                row.append(img)
            rows.append(np.concatenate(row, axis=1))
        return np.concatenate(rows, axis=0)

    def render_ansi(self, width: int = 72, height: int = 48, index: int = 0) -> str:
        """Truecolor terminal view (two pixels per character row)."""
        from pyqmd_tpu_torch.render.ansi import ansi_render

        return ansi_render(self._render_fit(width, height, index))

    def render_ascii(self, width: int = 72, height: int = 30, index: int = 0) -> str:
        """Terminal view: the interactive-display analog for the REPL.
        Protons 'o', neutrons '.', ejecta by type letter. Fits the view to
        the nucleus (unlike render(), which uses the interactive camera)."""
        img = self._render_fit(width, height, index).astype(np.int32)
        # Classify by dominant channel of the rasterized pixel: one
        # vectorized np.select, no per-pixel Python loop.
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        classes = np.select(
            [
                (r == 0) & (g == 0) & (b == 0),
                (r > 200) & (g < 180) & (b < 180),  # proton reds
                (b > 200) & (r < 180),              # neutron blues
                (r > 150) & (g > 150) & (b < 100),  # alpha yellow
                (g > 150) & (r < 100) & (b > 150),  # electron cyan
                (g > 150) & (r < 100),              # gamma green
                (r > 150) & (b > 150),              # positron magenta
            ],
            np.arange(7, dtype=np.uint8),
            default=7,
        )
        glyphs = np.frombuffer(b" o.aeyp#", dtype=np.uint8)
        rows = glyphs[classes]
        return "\n".join(bytes(row).decode("ascii") for row in rows)

    def save(self, path: str):
        """Write the state and config as a checkpoint both packages read; a
        lone nucleus is stored without its batch axis."""
        save_checkpoint(path, self.state, self.cfg, single=not self.batched)
        logger.info("saved checkpoint: %s", path)

    @classmethod
    def load(cls, path: str, device="cuda") -> "Simulation":
        """Resume from a checkpoint of either package, on ``device`` (the
        card unless the caller names another)."""
        state, cfg, single = read_checkpoint(path, device)
        sim = cls.__new__(cls)
        sim.cfg = cfg
        sim.seed = 0
        sim._overrides = {}
        sim.pad_to = cfg.max_particles
        sim.device = state.pos.device
        sim.state = state
        sim.ensemble = None if single else state.batch
        sim._init_controls()
        sim._chain_seen = int(state.chain_cursor[0]) if single else 0
        sim._decay_log = []
        sim._init_observability()
        return sim
