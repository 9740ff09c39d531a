"""The statistics frame's part-by-part profile runs on the CPU at a small
size and times every part (on a card it is run as
``python -m pyqmd_tpu_torch.frame_profile``)."""

import math

import _torch_parity  # noqa: F401  (caps torch threads)
from pyqmd_tpu_torch import frame_profile


def test_frame_breakdown_times_every_part_on_cpu():
    out = frame_profile.frame_breakdown(6, 8, batch=64, frames=20, half_lives=2.0, substeps=3,
                                        device="cpu")
    assert out["B"] == 64 and out["P"] == 16 and len(out["frame_ms"]) == 5
    assert set(out["parts_ms"]) == {"key_tree", "clone", "pack", "decay_substeps_x3",
                                    "unpack", "metrics"}
    assert all(math.isfinite(v) and v > 0 for v in out["parts_ms"].values())
    assert out["profiled_kernels"] == 0 and out["idle_share"] is None
    assert [s[0] for s in frame_profile.SLICES] == ["c14_survival", "u238_chain"]


def test_full_frame_breakdown_times_every_part_on_cpu():
    out = frame_profile.full_frame_breakdown(92, 146, batch=2, substeps=2, device="cpu")
    assert out["B"] == 2 and out["P"] == 256 and len(out["frame_ms"]) == 5
    assert set(out["parts_ms"]) == {"key_tree", "ejecta_decay_x2", "force_kernel_x2",
                                    "overlap", "metrics"}
    assert all(math.isfinite(v) and v > 0 for v in out["parts_ms"].values())
    assert out["profiled_kernels"] == 0 and out["idle_share"] is None
    assert frame_profile.FULL_SLICE[0] == "u238_full"
