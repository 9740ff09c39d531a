"""Faults planted under the timed path, for the tests that see ``correct``
come out false. Each function patches the program in the process that
calls it (the sharded cell calls it in every rank)."""

from __future__ import annotations

import types


def _frame_faults(kind: str):
    """A frame factory with the port's signature that runs the real frame
    and then breaks it: ``unchanged`` returns the state it got, ``half``
    leaves the second half of the batch out, ``altered`` changes one
    member's Z where it is produced."""
    import torch

    from pyqmd_tpu_torch.core import step
    from pyqmd_tpu_torch.state import NucleusState

    real = step.make_frame_fn

    def make(cfg, num_steps, batched=False):
        fn = real(cfg, num_steps, batched=batched)

        def frame(state, *args):
            if kind == "unchanged":
                return state, step._metrics(state, batched)
            new, _ = fn(state, *args)
            if kind == "half":
                h = max(1, state.batch // 2)
                new = NucleusState(**{f: torch.cat([getattr(new, f)[:h], getattr(state, f)[h:]])
                                      for f in NucleusState.__dataclass_fields__})
            elif kind == "altered":
                new = new.replace(z=new.z.clone())
                new.z[0] += 1
            return new, step._metrics(new, batched)

        frame.graphs = fn.graphs
        return frame

    return make


def break_frames(kind: str) -> None:
    import pyqmd_tpu_torch.sim as sim

    sim.make_frame_fn = _frame_faults(kind)


def break_survival(kind: str) -> None:
    """The statistics frame: ``unchanged``, ``half`` or ``altered`` as for
    the full frame."""
    import torch

    import pyqmd_tpu_torch.analysis as analysis
    from pyqmd_tpu_torch.state import NucleusState

    real = analysis.make_decay_frame_fn

    def make(cfg, num_steps):
        fn = real(cfg, num_steps)

        def frame(state, *args):
            if kind == "unchanged":
                return state, {"z": state.z, "n": state.n,
                               "total_decay_counts": state.decay_counts.sum(0)}
            new, m = fn(state, *args)
            if kind == "half":
                h = state.batch // 2
                new = NucleusState(**{f: torch.cat([getattr(new, f)[:h], getattr(state, f)[h:]])
                                      for f in NucleusState.__dataclass_fields__})
            elif kind == "altered":
                new = new.replace(z=new.z.clone())
                new.z[0] += 1
            return new, {"z": new.z, "n": new.n, "total_decay_counts": new.decay_counts.sum(0)}

        return frame

    analysis.make_decay_frame_fn = make


def break_pictures() -> None:
    """One pixel of every packed picture moved to another palette entry."""
    import pyqmd_tpu_torch.render.interactive as interactive

    real = interactive.render_frame_packed

    def packed(*args, **kw):
        out = real(*args, **kw).clone()
        out[0, 0] = out[0, 0] + 1
        return out

    interactive.render_frame_packed = packed


def drop_allreduce() -> None:
    """The sharded frames' exchange between ranks left out."""
    import pyqmd_tpu_torch.parallel.ensemble as ensemble

    ensemble.dist = types.SimpleNamespace(all_reduce=lambda *a, **k: None)


def unchanged_sharded() -> None:
    """Each rank's sharded frame returns the state it got."""
    import pyqmd_tpu_torch.parallel.ensemble as ensemble

    ensemble.make_frame_fn = _frame_faults("unchanged")
