"""Every entry point of the port runs on the card unless the caller names
another device. Where no CUDA device is present such a call raises; it
never carries on on the CPU. Whether there is a card is decided inside the
test, never at import."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import _torch_parity  # noqa: F401  (caps torch threads)
from pyqmd_tpu_torch import Simulation, analysis, cli, load_checkpoint, prng
from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core import init
from pyqmd_tpu_torch.state import empty_state, state_from_numpy, state_to_numpy

C14 = SimConfig.for_isotope(6, 8, pad_to=8)


def _arrays():
    return state_to_numpy(empty_state(C14, batch=2, device="cpu"))


CALLS = {
    "init_state": lambda **kw: init.init_state(C14, **kw).pos,
    "ensemble_init": lambda **kw: init.ensemble_init(C14, 4, **kw).pos,
    "mixed_ensemble_init": lambda **kw: init.mixed_ensemble_init(C14, [(6, 8, 2)], **kw).pos,
    "empty_state": lambda **kw: empty_state(C14, batch=2, **kw).pos,
    "state_from_numpy": lambda **kw: state_from_numpy(_arrays(), **kw).pos,
    "prng_key": lambda **kw: prng.prng_key(3, **kw),
    "survival_curve": lambda **kw: analysis.survival_curve(6, 8, batch=16, frames=1, **kw),
    "chain_populations": lambda **kw: analysis.chain_populations(6, 8, batch=16, frames=1, **kw),
    "Simulation": lambda **kw: Simulation(z=6, n=8, pad_to=8, **kw).state.pos,
    "Simulation_ensemble": lambda **kw: Simulation(z=6, n=8, pad_to=8, ensemble=3, **kw).state.pos,
}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ck") / "c14.npz")
    Simulation(z=6, n=8, pad_to=8, device="cpu").save(path)
    return path


@pytest.mark.parametrize("name", ["Simulation.load", "load_checkpoint"])
def test_loading_defaults_to_the_card(name, checkpoint):
    call = {"Simulation.load": lambda **kw: Simulation.load(checkpoint, **kw).state.pos,
            "load_checkpoint": lambda **kw: load_checkpoint(checkpoint, **kw)[0].pos}[name]
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()
    assert call(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("mode", ["run", "load", "survival", "populations"])
def test_cli_main_defaults_to_the_card(mode, checkpoint, tmp_path, capsys):
    args = {"run": ["--isotope", "He-4", "--frames", "1"],
            "load": ["--load", checkpoint, "--frames", "1"],
            "survival": ["--isotope", "C-14", "--ensemble", "8", "--frames", "1",
                         "--survival", str(tmp_path / "s.csv")],
            "populations": ["--isotope", "C-14", "--ensemble", "8", "--frames", "1",
                            "--populations", str(tmp_path / "p.csv")]}[mode] + ["-q"]
    if torch.cuda.is_available():
        assert cli.main(args) == 0
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            cli.main(args)
    assert cli.main(args + ["--device", "cpu"]) == 0


def _device_of(out) -> str | None:
    if isinstance(out, torch.Tensor):
        return out.device.type
    if isinstance(out, dict) and "device" in out:
        return torch.device(out["device"]).type
    return None  # host-side results (survival curve, populations)


@pytest.mark.parametrize("name", sorted(CALLS))
def test_entry_point_defaults_to_the_card(name):
    call = CALLS[name]
    if torch.cuda.is_available():
        assert _device_of(call()) in ("cuda", None)
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()
    assert _device_of(call(device="cpu")) in ("cpu", None)


@pytest.mark.parametrize("script", ["chip_smoke.py"])
def test_card_scripts_refuse_to_run_without_a_card(script):
    """The card's check never falls back to the CPU: without a CUDA device
    it exits nonzero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, str(repo / script)], cwd=repo, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == "", proc.stdout
