"""``correct`` comes out false when the timed path is broken underneath
(a state left unchanged, half of the batch left out, an answer altered
where it is produced, the exchange between ranks left out) and when the
control (the reference in bfloat16) stands in the program's place: whole
runs of the harness on the CPU at tiny sizes, past its look for a card."""

import pytest

from benchmark.tests import faults
from benchmark.tests.test_bench_harness import SEED, TINY


def _run(cell, **kw):
    from benchmark.run import run_cell

    return run_cell(cell, SEED + 1, 0.5, False, device="cpu", overrides=TINY[cell], **kw)


@pytest.fixture
def restore():
    """Undo the planted faults: every patched module attribute."""
    import pyqmd_tpu_torch.analysis as analysis
    import pyqmd_tpu_torch.core.step as step
    import pyqmd_tpu_torch.parallel as parallel
    import pyqmd_tpu_torch.parallel.ensemble as ensemble
    import pyqmd_tpu_torch.render.interactive as interactive
    import pyqmd_tpu_torch.sim as sim

    saved = [(sim, "make_frame_fn"), (analysis, "make_decay_frame_fn"), (step, "make_frame_fn"),
             (interactive, "render_frame_packed"), (ensemble, "dist"), (ensemble, "make_frame_fn"),
             (parallel, "make_sharded_frame_fn")]
    values = [getattr(m, a) for m, a in saved]
    yield
    for (m, a), v in zip(saved, values):
        setattr(m, a, v)


# A lone nucleus has no half of a batch to leave out.
@pytest.mark.parametrize("cell, kind", [
    ("u238.ensemble.b10240", "unchanged"), ("u238.ensemble.b10240", "half"),
    ("u238.ensemble.b10240", "altered"), ("u238.view.b1", "unchanged"),
    ("u238.view.b1", "altered")])
def test_a_broken_frame_is_not_correct(cell, kind, restore):
    faults.break_frames(kind)
    out = _run(cell)
    assert not out["correct"]
    assert out["checks"]["ints_differing"]["value"] > 0


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_a_broken_statistics_frame_is_not_correct(kind, restore):
    faults.break_survival(kind)
    out = _run("c14.survival.b2m")
    assert not out["correct"]
    assert out["checks"]["survivors_differing"]["value"] > 0


def test_an_altered_picture_is_not_correct(restore):
    faults.break_pictures()
    out = _run("u238.view.b1")
    assert out["checks"]["pixels_differing_share"]["value"] > 0
    assert not out["correct"]


@pytest.mark.parametrize("fault", ["drop_allreduce", "unchanged_sharded"])
def test_a_broken_sharded_frame_is_not_correct(fault, restore):
    out = _run("u238-dp4.ensemble.b40960", patch=f"benchmark.tests.faults:{fault}")
    assert not out["correct"]
    key = "aggregates_differing" if fault == "drop_allreduce" else "ints_differing"
    assert out["checks"][key]["value"] > 0


@pytest.mark.parametrize("cell", ["u238.ensemble.b10240", "u238.view.b1", "c14.survival.b2m",
                                  "u238-dp4.ensemble.b40960"])
def test_the_control_is_not_correct(cell, restore):
    from benchmark.control import run_control

    out = run_control(cell, SEED + 2, 0.5, device="cpu", overrides=TINY[cell])
    assert not out["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["u238.ensemble.b10240", "u238.view.b1", "c14.survival.b2m"])
def test_the_control_is_not_correct_at_the_cells_size(cell, restore):
    """The control at the cell's own size on the card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.control import run_control

    assert not run_control(cell, SEED + 3, 5.0)["correct"]
