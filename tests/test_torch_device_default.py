"""Every entry point of the port runs on the card unless the caller names
another device. Where no CUDA device is present such a call raises; it
never carries on on the CPU. Whether there is a card is decided inside the
test, never at import."""

import pytest
import torch

import _torch_parity  # noqa: F401  (caps torch threads)
from pyqmd_tpu_torch import analysis, frame_profile, prng
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
    "frame_breakdown": lambda **kw: frame_profile.frame_breakdown(
        6, 8, batch=16, frames=20, half_lives=2.0, substeps=1, **kw),
}


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
