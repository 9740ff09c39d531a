"""The benchmark's He-4 configuration (``benchmark/configs/he4.json``) and
its cell ``he4.ensemble.b10240`` on the CPU: the file states the port's own
He-4 config, the port's ``Simulation`` frames agree with the benchmark's
plain reference frame, and the sub-warp force kernel's roofline reader
reads a hand-built trace."""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

import _torch_parity  # noqa: F401  (caps torch threads)
from benchmark import compare, harness, roofline
from benchmark.drivers.sim_frames import as_reference_state
from benchmark.reference import frame as ref
from benchmark.traces import Op, Trace
from pyqmd_tpu_torch import Simulation
from pyqmd_tpu_torch.config import SimConfig

ROOT = Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "benchmark/configs/he4.json").read_text())
CELL = json.loads((ROOT / "benchmark/workloads/he4.ensemble.b10240.json").read_text())


@pytest.mark.parametrize("mode,ring", [("ensemble", 64), ("single", 256)])
def test_the_configuration_file_is_the_ports_he4_config(mode, ring):
    """Field for field ``SimConfig.for_isotope(2, 2, pad_to=8)``, with the
    chain-log ring ``Simulation`` picks for the mode."""
    fields = dict(CONFIG["sim_config"], max_chain_log=CONFIG["sim_config"]["max_chain_log"][mode])
    want = dataclasses.asdict(SimConfig.for_isotope(2, 2, pad_to=8, max_chain_log=ring))
    assert fields == want
    assert CONFIG["pad_to"] == 8 and CONFIG["sim_config"]["max_particles"] == 8
    assert CONFIG["reduced"] == [] and CONFIG["assumed"] == []


def test_simulation_frames_agree_with_the_reference_on_the_cpu():
    """Two frames of a 16-member He-4 ``Simulation`` at the billion preset,
    each against the reference's frame from the same state: integer fields,
    RNG words and the clock bitwise, positions and velocities within the
    cell's limits."""
    sim = Simulation(z=2, n=2, seed=5, ensemble=16, pad_to=8, device="cpu")
    sim.set_preset(CELL["time_scale"])
    rcfg = ref.config_from_file(CONFIG, "ensemble")
    ts = ref.TIME_SCALE_PRESETS[CELL["time_scale"]]
    steps, eff = ref.schedule(rcfg, ts, CELL["frame_dt"])
    assert sim.time_scale == ts and steps == 20
    limits = CELL["limits"]
    for _ in range(2):
        before = sim.state
        metrics = sim.frame(CELL["frame_dt"])
        want, wm = ref.full_frame(as_reference_state(before), rcfg, ts, CELL["frame_dt"], steps,
                                  eff, rcfg.physics_dt)
        got = compare.frame_numbers(sim.state, want, {k: metrics[k] for k in wm},
                                    {k: wm[k] for k in wm})
        assert got["ints_differing"] == 0 and got["clock_rel_gap"] == 0.0
        for k in ("pos_gap", "vel_gap", "metrics_rel_gap"):
            assert got[k] <= limits[k], (k, got[k])
        for f in compare.INT_FIELDS + compare.CLOCK_FIELDS:
            assert torch.equal(getattr(sim.state, f), getattr(want, f)), f
    assert int(sim.state.alive.sum()) == 16 * 4  # He-4 is stable


def _trace(name: str, seconds: float, info: dict) -> Trace:
    op = Op(name, "kernel", 1e-3, 1e-3 + seconds, "bench.frame")
    return Trace([op], [], (0.0, 1.0), info)


def test_the_sub_warp_force_roofline_reads_its_kernel():
    """A launch of 4.5 us over 10,240 He-4 nuclei (61,440 alive pairs,
    81,920 slots): byte-bound, 37 bytes a slot at 3.35 TB/s, so ~20%. A
    trace without the kernel, or without the window's pairs, reads None."""
    read = harness.metric_reader("force_small_roofline_pct")
    info = {"alive_pairs": 10240 * 6.0, "slots": 10240 * 8}
    bound_ms, by = roofline.force_ms(info["alive_pairs"], info["slots"])
    assert by == "bytes" and bound_ms == pytest.approx(81920 * 37 / 3.35e12 * 1e3)
    share = read(_trace("void force_small_kernel<true, 8>(float2 const*)", 4.5e-6, info))
    assert share == pytest.approx(100 * bound_ms / 4.5e-3) and 20.0 < share < 20.2
    assert read(_trace("void force_step_kernel<true>(float2 const*)", 4.5e-6, info)) is None
    assert read(_trace("void force_small_kernel<true, 8>()", 4.5e-6, {})) is None
