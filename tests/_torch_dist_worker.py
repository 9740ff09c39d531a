"""Rank program of the port's multi-process tests on gloo CPU groups.

    python tests/_torch_dist_worker.py --world W --out DIR [--device cuda]

starts W ranks by ``torch.multiprocessing.spawn`` (joined through a
``file://`` store in DIR) and runs every case of :data:`CASES` on each:
gloo on the CPU, or with ``--device cuda`` NCCL with rank r on card r and
only the cases of :data:`CARD_CASES`. With ``--world 1`` the one rank
runs in this process and starts no group itself, so ``make_mesh`` starts
the world of one. Rank r writes its results, numpy arrays and plain
values, to ``DIR/rank{r}.pkl`` and the sharded checkpoints under ``DIR``.
It imports torch, numpy, the port and ``_torch_parity`` (no JAX either)
only: spawned ranks re-import this module, the test modules import JAX,
and the card's machine has none.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import _torch_parity as tp  # noqa: E402
from pyqmd_tpu_torch.config import SimConfig  # noqa: E402
from pyqmd_tpu_torch.core.dynamics import FrameScalars, frame_dynamics, scalar_values  # noqa: E402
from pyqmd_tpu_torch.core.init import ensemble_init, init_state  # noqa: E402
from pyqmd_tpu_torch.core.step import ensemble_step, simulate_frame  # noqa: E402
from pyqmd_tpu_torch.parallel import (  # noqa: E402
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    initialize_multihost,
    local_batch_slice,
    make_hybrid_frame_fn,
    make_mesh,
    make_ring_force_step,
    make_ring_frame_fn,
    make_sharded_decay_fn,
    make_sharded_frame_fn,
    make_sharded_run_fn,
    replicated,
    shard_ensemble,
)
from pyqmd_tpu_torch.parallel.ensemble import sharded_frame  # noqa: E402
from pyqmd_tpu_torch.parallel.mesh import local_rows  # noqa: E402
from pyqmd_tpu_torch.state import state_to_numpy  # noqa: E402
from pyqmd_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint_sharded,
    save_checkpoint_sharded,
)
from pyqmd_tpu_torch.utils.profiling import counters  # noqa: E402

DEVICE = "cpu"  # this rank's device type, set by run_rank
U238_TS = 3.15576e16
# The calls of one graph bucket: the first captures on the card, then a
# replay at the same scalars, at a hundredth of the time scale and at
# another frame interval (time_scale > 1 throughout).
BUCKET_CALLS = ((U238_TS, 1 / 60.0), (U238_TS, 1 / 60.0), (U238_TS / 100, 1 / 60.0),
                (U238_TS, 1 / 30.0))


def _aggregates(m) -> dict:
    return {k: m[k].cpu().numpy() for k in ("total_decay_counts", "total_alive", "survivors")}


def _error(fn) -> str | None:
    """The message of the ValueError ``fn`` raises, else None."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _two_d(world: int) -> tuple[int, int]:
    """A data x model split of the world with two ranks per replica where
    there are two."""
    model = 2 if world % 2 == 0 else 1
    return world // model, model


def case_mesh(world, out):
    mesh = make_mesh(device=DEVICE)
    d, m = _two_d(world)
    mesh2 = make_mesh((d, m), (DATA_AXIS, MODEL_AXIS), device=DEVICE)
    return {
        "names": mesh.mesh_dim_names, "shape": tuple(mesh.shape),
        "names2": mesh2.mesh_dim_names, "shape2": tuple(mesh2.shape),
        "too_big": _error(lambda: make_mesh((2 * world,), device=DEVICE)),
        "too_small": _error(lambda: make_mesh((1,), device=DEVICE)) if world > 1 else "n/a",
        "batch_sharding": [repr(p) for p in batch_sharding(mesh2)],
        "replicated": [repr(p) for p in replicated(mesh2)],
        "backend": dist.get_backend(), "world": dist.get_world_size(),
        "indivisible_batch": _error(lambda: local_rows(mesh, 2 * world + 1)) if world > 1 else "n/a",
    }


def case_sharded_frame(world, out):
    cfg = SimConfig.for_isotope(6, 8, pad_to=8)
    mesh = make_mesh(device=DEVICE)
    states = shard_ensemble(ensemble_init(cfg, 32, seed=0, device=DEVICE), mesh)
    st, m = make_sharded_frame_fn(cfg, 2, mesh)(states, 1.0, 1 / 60.0)
    return {"rows": local_rows(mesh, 32), "state": state_to_numpy(st), **_aggregates(m)}


def case_many_frames(world, out):
    cfg = SimConfig.for_isotope(2, 2, pad_to=8)
    mesh = make_mesh(device=DEVICE)
    states = shard_ensemble(ensemble_init(cfg, 16, seed=1, device=DEVICE), mesh)
    fn = make_sharded_frame_fn(cfg, 2, mesh)
    for _ in range(3):
        states, m = fn(states, 1.0, 1 / 60.0)
    return {"finite": bool(torch.isfinite(states.pos).all()), **_aggregates(m)}


def _ring_force(cfg, seed, world, steps=1):
    st = init_state(cfg, seed=seed, device=DEVICE)
    mesh = make_mesh((world,), (MODEL_AXIS,), device=DEVICE)
    ring = make_ring_force_step(cfg, mesh)
    pos, vel = st.pos[0], st.vel[0]  # (P, 2): the reference's unbatched form
    for _ in range(steps):
        pos, vel = ring(pos, vel, st.ptype[0], st.alive[0], 1 / 240.0)
    return {"pos": pos.cpu().numpy(), "vel": vel.cpu().numpy()}


def case_ring_force(world, out):
    return _ring_force(SimConfig.for_isotope(26, 30, pad_to=8, fast_math=False), 0, world)


def case_ring_leapfrog(world, out):
    return _ring_force(SimConfig.for_isotope(26, 30, pad_to=8, integrator="leapfrog"), 0, world)


def case_ring_steps(world, out):
    return _ring_force(SimConfig.for_isotope(26, 30, pad_to=8), 2, world, steps=20)


def case_ring_2d(world, out):
    """Batch rows over ``data``, the ring over ``model`` on them."""
    cfg = SimConfig.for_isotope(8, 8, pad_to=8)
    mesh = make_mesh(_two_d(world), (DATA_AXIS, MODEL_AXIS), device=DEVICE)
    batch = shard_ensemble(ensemble_init(cfg, 8, seed=3, device=DEVICE), mesh)
    ring = make_ring_force_step(cfg, mesh, axis=MODEL_AXIS)
    pos, vel = ring(batch.pos, batch.vel, batch.ptype, batch.alive, 1 / 240.0)
    return {"rows": local_rows(mesh, 8), "out": {"pos": pos.cpu().numpy(), "vel": vel.cpu().numpy()}}


def case_multihost(world, out):
    return {"init": initialize_multihost(), "init_one": initialize_multihost(num_processes=1),
            "slice": local_batch_slice(64),
            "indivisible": _error(lambda: local_batch_slice(4 * world + 1)) if world > 1 else "n/a"}


def case_ring_frame(world, out):
    cfg = SimConfig.for_isotope(92, 146, pad_to=8)  # 240 = 4 x 60
    mesh = make_mesh((world,), (MODEL_AXIS,), device=DEVICE)
    frame = make_ring_frame_fn(cfg, 4, mesh)
    st, _ = frame(init_state(cfg, seed=0, device=DEVICE), U238_TS, 1 / 60.0)
    first = state_to_numpy(st)
    for _ in range(3):
        st, _ = frame(st, U238_TS, 1 / 60.0)
    return {"state": first, "finite": bool(torch.isfinite(st.pos).all()),
            "indivisible": _error(lambda: make_ring_frame_fn(
                SimConfig.for_isotope(2, 2, pad_to=5), 2, mesh)) if world > 1 else "n/a"}


def case_hybrid(world, out):
    """Every data x model split of the world, on one config and batch."""
    # 256 = 4 x 64; exact math, as the ring's plain pair terms are.
    cfg = SimConfig.for_isotope(92, 146, pad_to=32, fast_math=False)
    res = {}
    for model in (m for m in (1, 2, 4) if world % m == 0):
        shape = (world // model, model)
        mesh = make_mesh(shape, (DATA_AXIS, MODEL_AXIS), device=DEVICE)
        states = shard_ensemble(ensemble_init(cfg, 8, seed=0, device=DEVICE), mesh)
        st, m = make_hybrid_frame_fn(cfg, 2, mesh)(states, U238_TS, 1 / 60.0)
        res[shape] = {"rows": local_rows(mesh, 8), "state": state_to_numpy(st), **_aggregates(m),
                      "indivisible": _error(lambda: make_hybrid_frame_fn(
                          SimConfig.for_isotope(2, 2, pad_to=5), 2, mesh)) if model > 1 else "n/a"}
    return res


def case_run(world, out):
    cfg = SimConfig.for_isotope(6, 8, pad_to=8)
    mesh = make_mesh(device=DEVICE)
    a = shard_ensemble(ensemble_init(cfg, 16, seed=0, device=DEVICE), mesh)
    frame = make_sharded_frame_fn(cfg, 2, mesh)
    for _ in range(3):
        a, ma = frame(a, U238_TS, 1 / 60.0)
    b = shard_ensemble(ensemble_init(cfg, 16, seed=0, device=DEVICE), mesh)
    b, mb = make_sharded_run_fn(cfg, 2, 3, mesh)(b, U238_TS, 1 / 60.0)
    return {"rows": local_rows(mesh, 16), "loop": state_to_numpy(a), "run": state_to_numpy(b),
            "loop_agg": _aggregates(ma), "run_agg": _aggregates(mb)}


def case_decay(world, out):
    cfg = SimConfig.for_isotope(82, 132, pad_to=8)  # Pb-214: events happen
    mesh = make_mesh(device=DEVICE)
    states = shard_ensemble(ensemble_init(cfg, 32, seed=0, device=DEVICE), mesh)
    st, m = make_sharded_decay_fn(cfg, 4, mesh)(states, 400.0, 1.0)
    return {"rows": local_rows(mesh, 32), "state": state_to_numpy(st), **_aggregates(m)}


def case_checkpoint(world, out):
    """Save sharded over ``data`` (1-D, and data x model), load on the
    same world into this rank's rows, and step one more frame from both."""
    cfg = SimConfig.for_isotope(6, 8, pad_to=8)
    res = {}
    for name, shape, names in (("1d", (world,), (DATA_AXIS,)),
                               ("2d", _two_d(world), (DATA_AXIS, MODEL_AXIS))):
        mesh = make_mesh(shape, names, device=DEVICE)
        fn = make_sharded_frame_fn(cfg, 2, mesh)
        states, _ = fn(shard_ensemble(ensemble_init(cfg, 16, seed=0, device=DEVICE), mesh),
                       U238_TS, 1 / 60.0)
        path = os.path.join(out, f"ck_{name}")
        save_checkpoint_sharded(path, states, cfg, mesh)
        restored, cfg2 = load_checkpoint_sharded(path, sharding_state=states, mesh=mesh)
        whole, _ = load_checkpoint_sharded(path, device=DEVICE)  # every rank, the whole state
        cont_a, _ = fn(states, U238_TS, 1 / 60.0)
        cont_b, _ = fn(restored, U238_TS, 1 / 60.0)
        res[name] = {"rows": local_rows(mesh, 16), "saved": state_to_numpy(states),
                     "restored": state_to_numpy(restored), "whole": state_to_numpy(whole),
                     "cfg_equal": cfg2 == cfg, "next_saved": state_to_numpy(cont_a),
                     "next_restored": state_to_numpy(cont_b)}
    return res


def _graph_meshes(world, device):
    """The meshes of the three frame factories on this world: ``data`` over
    every rank, ``model`` over every rank, and the data x model split."""
    return (make_mesh(device=device), make_mesh((world,), (MODEL_AXIS,), device=device),
            make_mesh(_two_d(world), (DATA_AXIS, MODEL_AXIS), device=device))


def factories_and_eager_forms(world, device, batch=8, steps=2):
    """``{kind: (factory frame, its bare eager form, input state, the
    rank's rows of the batch)}`` for the sharded, ring and hybrid frames of
    U-238 at P=256 (4 x 64); the ring's one nucleus is every rank's."""
    cfg = SimConfig.for_isotope(92, 146, pad_to=32)
    data, model, two_d = _graph_meshes(world, device)
    ring, ring_2d = make_ring_force_step(cfg, model), make_ring_force_step(cfg, two_d)
    init = ensemble_init(cfg, batch, seed=5, device=device)
    return {
        "sharded": (make_sharded_frame_fn(cfg, steps, data),
                    sharded_frame(lambda st, ts, fdt: ensemble_step(st, cfg, ts, fdt, steps),
                                  cfg, data, DATA_AXIS),
                    shard_ensemble(init, data), local_rows(data, batch)),
        "ring": (make_ring_frame_fn(cfg, steps, model),
                 lambda st, ts, fdt: simulate_frame(st, cfg, ts, fdt, steps, force_step_fn=ring),
                 init_state(cfg, seed=5, device=device), slice(0, 1)),
        "hybrid": (make_hybrid_frame_fn(cfg, steps, two_d),
                   sharded_frame(lambda st, ts, fdt: ensemble_step(st, cfg, ts, fdt, steps,
                                                                   force_step_fn=ring_2d),
                                 cfg, two_d, DATA_AXIS),
                   shard_ensemble(init, two_d), local_rows(two_d, batch)),
    }


def _launches():
    c = counters()
    return tuple(c[f"kernels.{k}"] for k in ("force_step.launches", "force_step.small_launches",
                                             "overlap_step.launches",
                                             "ejecta_decay_substep.launches"))


def factories_against_eager(world, device) -> dict:
    """Each factory frame against its bare eager form over
    :data:`BUCKET_CALLS`: the fields and metrics that differ (none, for
    bitwise), the launch counts of both, the captures and buckets, and the
    final state. On the card every call but a bucket's first, which
    captures, runs under PyTorch's synchronisation check set to raise."""
    res = {}
    for kind, (fn, eager, init, rows) in factories_and_eager_forms(world, device).items():
        got = want = init
        differ, launches = [], []
        for i, (ts, fdt) in enumerate(BUCKET_CALLS):
            before = _launches()
            want, wm = eager(want, ts, fdt)
            mid = _launches()
            if device == "cuda" and i:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                got, gm = fn(got, ts, fdt)
            finally:
                if device == "cuda":
                    torch.cuda.set_sync_debug_mode("default")
            launches.append(([a - b for a, b in zip(_launches(), mid)],
                             [a - b for a, b in zip(mid, before)]))
            differ += [(i, f.name) for f in dataclasses.fields(got)
                       if not torch.equal(getattr(got, f.name), getattr(want, f.name))]
            differ += [(i, k) for k in wm if k not in gm or not torch.equal(gm[k], wm[k])]
        res[kind] = {"differ": differ, "launches": launches, "captures": fn.graphs.captures,
                     "buckets": len(fn.graphs.graphs), "state": state_to_numpy(got),
                     "rows": rows, "bucket": fn.graphs.describe(fn.graphs.bucket(got, None, True))}
    return res


def case_graph_frames(world, out):
    """The factories bitwise their bare eager forms: graph replays on the
    cards (NCCL), the eager path on CPU tensors (gloo)."""
    return factories_against_eager(world, DEVICE)


def case_capture_safety(world, out):
    """What the ring and hybrid graphs capture, the frame body with its
    metrics, logged op by op at the scalars of each later call of
    :data:`BUCKET_CALLS` (worlds of 1 and 2, ``model`` of the world's
    size): the op sequences, collectives included, must be alike, with no
    host read."""
    if world > 2:
        return "n/a"
    res = {}
    for kind, (fn, _, st, _) in factories_and_eager_forms(world, DEVICE, batch=2).items():
        if kind == "sharded":
            continue
        g, logs = fn.graphs, []
        for i, (ts, fdt) in enumerate(BUCKET_CALLS):
            values, fast = scalar_values(frame_dynamics(g.cfg, ts, fdt, g.num_steps, None, None),
                                         g.cfg)
            # The first call is the warm-up: it puts the tables on the device.
            with tp.OpLog() as log:
                g.metrics(g.body(st, g.cfg, FrameScalars.views(torch.from_numpy(values), fast),
                                 g.num_steps))
            if i:
                logs.append(log.ops)
        differs = [(str(a), str(b)) for log in logs[1:] for a, b in zip(logs[0], log) if a != b]
        names = [op[0] for op in logs[0]]
        res[kind] = {
            "lengths": [len(log) for log in logs],
            "first_difference": differs[0] if differs else None,
            "collectives": {n: names.count(n) for n in set(names) if n.startswith("c10d.")},
            "host_reads": sum(op[0].startswith("aten._local_scalar_dense")
                              for log in logs for op in log),
        }
    return res


CASES = {name.removeprefix("case_"): fn for name, fn in globals().items()
         if name.startswith("case_")}
# The cases an NCCL world on the cards runs.
CARD_CASES = ("sharded_frame", "run", "decay", "ring_force", "hybrid", "checkpoint",
              "graph_frames")


def gather(results, key):
    """The whole batch from each rank's ``(rows, results[key])``: rows in
    order, and ranks that hold the same rows (replicas over ``model``)
    bitwise alike."""
    by_rows = {}
    for res in results:
        rows, part = res["rows"], res[key]
        if rows.start in by_rows:
            for f in part:
                np.testing.assert_array_equal(part[f], by_rows[rows.start][f], err_msg=f)
        by_rows[rows.start] = part
    parts = [by_rows[s] for s in sorted(by_rows)]
    return {f: np.concatenate([p[f] for p in parts]) for f in parts[0]}


def run_rank(rank: int, world: int, out: str, device: str = "cpu") -> None:
    global DEVICE
    DEVICE = device
    torch.set_num_threads(1)
    cases = CASES
    if device == "cuda":
        torch.cuda.set_device(rank)
        cases = {name: CASES[name] for name in CARD_CASES}
    if world > 1:
        store = os.path.join(out, "rendezvous")
        kw = {"device_id": torch.device("cuda", rank)} if device == "cuda" else {}
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                init_method=f"file://{store}", rank=rank, world_size=world, **kw)
    try:
        res = {name: fn(world, out) for name, fn in cases.items()}
        res["world_started"] = (dist.get_world_size(), dist.get_backend())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    args = parser.parse_args()
    if args.world == 1:
        run_rank(0, 1, args.out, args.device)
    else:
        import torch.multiprocessing as mp

        mp.spawn(run_rank, args=(args.world, args.out, args.device), nprocs=args.world, join=True)


if __name__ == "__main__":
    main()
