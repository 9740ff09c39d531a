"""The frames' part-by-part profiles run on the CPU at a small size and
time every part (on a card they are run as
``python -m pyqmd_tpu_torch.frame_profile``)."""

import math

import _torch_parity  # noqa: F401  (caps torch threads)
from pyqmd_tpu_torch import frame_profile


def test_frame_breakdown_times_every_part_on_cpu():
    out = frame_profile.frame_breakdown(6, 8, batch=64, frames=20, half_lives=2.0, substeps=3,
                                        device="cpu")
    assert out["B"] == 64 and out["P"] == 16 and len(out["frame_ms"]) == 5
    assert set(out["parts_ms"]) == {"clock", "clone", "pack", "decay_frame", "unpack",
                                    "metrics"}
    assert all(math.isfinite(v) and v > 0 for v in out["parts_ms"].values())
    assert out["profiled_kernels"] == 0 and out["idle_share"] is None
    assert [s[0] for s in frame_profile.SLICES] == ["c14_survival", "u238_chain"]


def test_he4_full_frame_breakdown_times_every_part_on_cpu():
    out = frame_profile.full_frame_breakdown(2, 2, batch=4, substeps=2, pad_to=8, device="cpu")
    assert out["B"] == 4 and out["P"] == 8 and len(out["frame_ms"]) == 5
    assert set(out["parts_ms"]) == {"key_tree", "ejecta_decay_x2", "force_kernel_x2",
                                    "overlap", "metrics"}
    assert all(math.isfinite(v) and v > 0 for v in out["parts_ms"].values())


def test_full_frame_breakdown_times_every_part_on_cpu():
    out = frame_profile.full_frame_breakdown(92, 146, batch=2, substeps=2, device="cpu")
    assert out["B"] == 2 and out["P"] == 256 and len(out["frame_ms"]) == 5
    assert set(out["parts_ms"]) == {"key_tree", "ejecta_decay_x2", "force_kernel_x2",
                                    "overlap", "metrics"}
    assert all(math.isfinite(v) and v > 0 for v in out["parts_ms"].values())
    assert out["profiled_kernels"] == 0 and out["idle_share"] is None
    assert [s[0] for s in frame_profile.FULL_SLICES] == ["u238_full", "he4_full"]
