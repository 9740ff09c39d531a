"""The He-4 cell ``he4.ensemble.b10240`` run whole on the CPU at a tiny
size, where the program takes its plain path and has to agree with the
reference exactly, untraced and traced."""

import pytest

SEED = 2**31 + 1733
CELL = "he4.ensemble.b10240"
TINY = {"members": 4, "warmup_frames": 1, "sample_within": 2, "trace_frames": 2}


@pytest.mark.parametrize("trace", [False, True])
def test_the_he4_cell_agrees_with_the_reference_on_the_cpu(trace):
    from benchmark.run import run_cell

    out = run_cell(CELL, SEED, 0.5, trace, device="cpu", overrides=TINY)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["checks"]["ints_differing"]["value"] == 0
    assert out["checks"]["pos_gap"]["value"] == 0.0  # the same plain path on both sides
    if trace:
        # No device operations on the CPU: the kernel readers find nothing.
        assert out["metrics"] == {} and out["device"]["window_s"] > 0
    else:
        assert set(out["metrics"]) == {"full_nucleus_substeps_per_s", "setup_s"}
        assert all(v["value"] > 0 for v in out["metrics"].values())
