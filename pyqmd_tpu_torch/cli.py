"""Command-line interface.

The headless capability surface of the reference's event/input system
(nuclear_sim.py:381-521): isotope selection, time-scale control and
presets, forced decay, zoom/camera, plus ensembles, checkpoints,
PNG/APNG/GIF export and the ensemble statistics modes. Everything runs on
the CUDA card unless ``--device cpu`` is given.

Two modes:
  * batch: ``pyqmd-torch --isotope U-238 --frames 1000 --time-scale 1e9yr``
  * interactive: ``pyqmd-torch -i``, a REPL with commands mapped 1:1 onto
    the reference's keybindings (SPACE -> ``decay``, arrows -> ``faster``/
    ``slower``, R/T/H/J/Y/M/B -> ``preset ...``, 1-9 -> ``iso N`` ...).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from pyqmd_tpu_torch.data.elements import isotope_label, parse_isotope
from pyqmd_tpu_torch.sim import ISOTOPE_KEYMAP, Simulation
from pyqmd_tpu_torch.state import DECAY_TYPE_NAMES
from pyqmd_tpu_torch.utils.format import (
    format_half_life,
    format_time_scale,
    format_time_value,
    format_time_value_with_unit,
    parse_time_scale,
)

logger = logging.getLogger("pyqmd_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pyqmd-torch",
        description="Nuclear structure & radioactive decay simulator (PyTorch / CUDA)",
    )
    p.add_argument("--isotope", default="U-238", help="e.g. U-238, C14, 92:146")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--frames", "--steps", dest="frames", type=int, default=None,
        help="frames to simulate (default 600; statistics modes like "
        "--survival/--populations default to 20 time points)",
    )
    p.add_argument("--frame-dt", type=float, default=1 / 60, help="wall seconds per frame")
    p.add_argument(
        "--time-scale",
        default="1",
        help="sim seconds per wall second: float or value+unit (1e9yr, 5day, 2h)",
    )
    p.add_argument("--ensemble", type=int, default=None, help="batch of independent nuclei")
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the simulation runs: the CUDA card (hand-written "
        "kernels; an error without a card) or the CPU (plain PyTorch)",
    )
    p.add_argument(
        "--set", dest="overrides", action="append", default=[],
        metavar="FIELD=VALUE",
        help="override any SimConfig field (repeatable): e.g. "
        "--set strong_strength=120 --set fast_math=false --set "
        "integrator=leapfrog — the 'what if the strong force were weaker' "
        "surface (every reference constant is a config field)",
    )
    p.add_argument(
        "--render", metavar="PATH",
        help="write final frame as PNG (with --render-every: animated PNG, "
        "or animated GIF if PATH ends in .gif)",
    )
    p.add_argument(
        "--render-every", type=int, default=0, metavar="N",
        help="with --render: collect every Nth frame into an animated PNG",
    )
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument(
        "--zoom", type=float, default=None,
        help="initial zoom for --render (default: the reference's 15.0, "
        "sized for an 800x600+ viewport)",
    )
    p.add_argument(
        "--no-panels", action="store_true",
        help="render without the info/decay-chain panel overlays",
    )
    p.add_argument("--save", metavar="PATH", help="write checkpoint at end")
    p.add_argument("--load", metavar="PATH", help="resume from checkpoint")
    p.add_argument("-i", "--interactive", action="store_true", help="REPL mode")
    p.add_argument("--status-json", action="store_true", help="print final status as JSON")
    p.add_argument(
        "--serve", metavar="PORT", type=int, default=None,
        help="serve the live browser view on http://127.0.0.1:PORT/ "
             "(the graphical-window replacement; Ctrl-C to stop)",
    )
    p.add_argument(
        "--profile", metavar="LOGDIR",
        help="capture a torch.profiler trace of the run, the program's spans in it, into "
             "LOGDIR/trace.json and the counters' growth into LOGDIR/counters.json",
    )
    p.add_argument(
        "--survival", metavar="CSV",
        help="ensemble mode: run a survival-curve measurement over "
        "--half-lives tabulated half-lives, write CSV, print the fit",
    )
    p.add_argument(
        "--populations", metavar="CSV",
        help="ensemble mode: track the isotope populations of a decaying "
        "ensemble over --half-lives (one CSV column per isotope)",
    )
    p.add_argument(
        "--theory", metavar="CSV",
        help="write the analytical Bateman population expectation over "
        "--half-lives (standalone, or on the same time grid as "
        "--populations for a measured-vs-theory pair)",
    )
    p.add_argument("--half-lives", type=float, default=2.0)
    p.add_argument(
        "--list-isotopes", action="store_true",
        help="print the tabulated isotope database (half-lives, decay modes) and exit",
    )
    p.add_argument("-q", "--quiet", action="store_true")
    return p


def parse_overrides(pairs: list[str]) -> dict:
    """Parse repeated ``--set field=value`` flags into typed SimConfig
    kwargs (type taken from the dataclass field)."""
    import dataclasses

    from pyqmd_tpu_torch.config import SimConfig

    types = {f.name: f.type for f in dataclasses.fields(SimConfig)}
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(f"--set expects FIELD=VALUE, got {pair!r}")
        name, value = pair.split("=", 1)
        name = name.strip()
        if name not in types:
            raise ValueError(
                f"unknown SimConfig field {name!r}; options: {sorted(types)}"
            )
        t = str(types[name])
        if "bool" in t:
            out[name] = value.strip().lower() in ("1", "true", "yes", "on")
        elif "int" in t:
            out[name] = int(value)
        elif "float" in t:
            out[name] = float(value)
        else:
            out[name] = value.strip()
    return out


def list_isotopes() -> None:
    from pyqmd_tpu_torch.data.chains import DECAY_CHAINS
    from pyqmd_tpu_torch.data.halflives import HALF_LIVES
    from pyqmd_tpu_torch.state import DECAY_SYMBOLS

    print(f"{'isotope':<10} {'Z':>3} {'N':>3}  {'half-life':<22} decay")
    for (z, n), hl in sorted(HALF_LIVES.items()):
        if hl < 1.0:  # sub-second half-lives need SI prefixes
            label = format_time_value_with_unit(hl)
        else:
            label, _ = format_half_life(hl)
        modes = DECAY_CHAINS.get((z, n))
        mode = (
            "/".join(DECAY_SYMBOLS[m[2]] for m in modes) if modes
            else ("stable" if hl == float("inf") else "predicted")
        )
        print(f"{isotope_label(z, n):<10} {z:>3} {n:>3}  {label:<22} {mode}")


def print_status(sim: Simulation) -> None:
    """Info-panel equivalent (rendering.py:135-246)."""
    s = sim.status()
    print(f"  isotope:    {s['isotope']}")
    if not sim.batched:
        hl_label, _ = format_half_life(s["half_life"])
        val, unit = format_time_value(s["time_passed"])
        print(f"  Z/N:        {s['z']}/{s['n']}   nucleons alive: {s['alive']}")
        print(f"  half-life:  {hl_label}")
        print(f"  sim time:   {val:.2f} {unit}")
        print(f"  ejecta:     {s['ejecta']}")
        # 0.5 sim unit = 1 fm (rendering.py:15).
        print(f"  rms radius: {2.0 * s['rms_radius']:.1f} fm   "
              f"kinetic: {s['kinetic_energy']:.1f}")
    print(f"  time scale: {format_time_scale(s['time_scale'])}")
    print(f"  substeps:   {s['substeps']}/{sim.max_substeps}"
          + ("  (auto)" if getattr(sim, "auto_adjust_substeps", False) else ""))
    if "physics_dt" in s:
        print(f"  physics dt: {s['physics_dt']:.6f}s")
    if s.get("fps"):
        print(f"  throughput: {s['fps']:.1f} fps, "
              f"{s['substeps_per_sec']:.0f} substeps/s")
    counts = {
        DECAY_TYPE_NAMES[i]: c for i, c in enumerate(s["decay_counts"]) if c and i
    }
    if counts:
        print(f"  decays:     {counts}")


HELP = """commands (reference keybinding in brackets):
  step [N]        advance N frames (default 1)
  run N           advance N frames, printing decays
  decay           force a decay                      [SPACE]
  faster / slower time scale x10 / /10               [UP/DOWN]
  ff / rew        time scale x2 / /2                 [RIGHT/LEFT]
  t VALUE         set time scale (e.g. 1e9yr, 3600)  [numeric]
  preset NAME     real|minute|hour|day|year|millennium|million|billion [R/T/H/J/Y/M/B]
  iso SPEC        switch isotope (U-238, C14, or keymap digit 1-9) [1-9]
  zoom in|out|N   zoom control                       [Q/E/Z]
  pan dx dy       move camera                        [WASD]
  auto            toggle auto-substep adjustment     [F]
  dt VALUE        set physics timestep               [,/.]
  accuracy VALUE  set accuracy factor (0-1)
  substeps N      set max substeps per frame         [-/+]
  chain           show decay chain                   [decay-chain panel]
  scroll N|reset  scroll decay-chain panel by N      [PgUp/PgDn/C]
  iscroll N|reset scroll info panel by N lines       [mouse wheel on panel]
  size W H        set the default viewport size      [VIDEORESIZE]
  status          show info panel
  show [ascii]    color/ASCII view of the nucleus    [main viewport]
  watch [SECS]    live 60fps ASCII view              [run loop]
  serve [PORT]    live browser view (blocks; ^C)     [PyGame window]
  render PATH     write PNG of current frame
  save/load PATH  checkpoint
  quit            exit                               [ESC]
"""


def interactive(sim: Simulation) -> None:
    print(f"pyqmd-torch interactive — {sim.isotope}. 'help' for commands.")
    while True:
        try:
            line = input("pyqmd> ").strip()
        except EOFError:
            break
        if not line:
            continue
        cmd, *args = line.split()
        try:
            if cmd in ("quit", "exit", "q"):
                break
            elif cmd == "help":
                print(HELP)
            elif cmd == "step":
                n = int(args[0]) if args else 1
                for _ in range(n):
                    sim.frame()
                print_status(sim)
            elif cmd == "run":
                before = len(sim.decay_log)
                for _ in range(int(args[0])):
                    sim.frame()
                for entry in sim.decay_log[before:]:
                    print(" ", entry)
                print_status(sim)
            elif cmd == "decay":
                before = len(sim.decay_log)
                sim.force_decay()
                for entry in sim.decay_log[before:]:
                    print(" ", entry)
            elif cmd == "faster":
                sim.scale_time(10.0)
                print("  time scale:", format_time_scale(sim.time_scale))
            elif cmd == "slower":
                sim.scale_time(0.1)
                print("  time scale:", format_time_scale(sim.time_scale))
            elif cmd == "ff":
                sim.scale_time(2.0)
                print("  time scale:", format_time_scale(sim.time_scale))
            elif cmd == "rew":
                sim.scale_time(0.5)
                print("  time scale:", format_time_scale(sim.time_scale))
            elif cmd == "t":
                sim.set_time_scale(parse_time_scale(args[0]))
                print("  time scale:", format_time_scale(sim.time_scale))
            elif cmd == "preset":
                sim.set_preset(args[0])
                print("  time scale:", format_time_scale(sim.time_scale))
            elif cmd == "iso":
                spec = args[0]
                if spec.isdigit() and int(spec) in ISOTOPE_KEYMAP:
                    sim.set_isotope_key(int(spec))
                else:
                    sim.reset(*parse_isotope(spec))
                print("  now:", sim.isotope)
            elif cmd == "zoom":
                if args[0] == "in":
                    sim.zoom_by(1.5)
                elif args[0] == "out":
                    sim.zoom_by(1 / 1.5)
                else:
                    sim.target_zoom = float(args[0])
                print(f"  zoom target: {sim.target_zoom:.1f}x")
            elif cmd == "pan":
                sim.pan(float(args[0]), float(args[1]))
            elif cmd == "auto":
                sim.auto_adjust_substeps = not sim.auto_adjust_substeps
                print(f"  auto-adjust substeps: {'ON' if sim.auto_adjust_substeps else 'OFF'}")
            elif cmd == "dt":
                sim.physics_dt = float(args[0])
                print(f"  physics dt: {sim.physics_dt:.6f}s")
            elif cmd == "accuracy":
                v = float(args[0])
                if not 0.0 <= v < 2.0:
                    # effective dt = physics_dt * (2 - accuracy): 2.0
                    # would zero it and crash the substep scheduler.
                    raise ValueError(f"accuracy must be in [0, 2), got {v}")
                sim.accuracy = v
                print(f"  accuracy: {sim.accuracy} (effective dt x{2.0 - sim.accuracy:.2f})")
            elif cmd == "substeps":
                sim.max_substeps = int(args[0])
                print(f"  max substeps: {sim.max_substeps}")
            elif cmd == "chain":
                # Same index>0 filter as the render panel: entry 0 is the
                # initial-state record until the ring wraps past it, after
                # which every surviving entry is a real decay (positional
                # [1:] slicing would drop a real one).
                entries = [e for e in sim.chain_entries() if e["index"] > 0]
                if args:  # 'chain N' tails the last N entries (scroll analog)
                    entries = entries[-int(args[0]):]
                for e in entries:
                    print(
                        f"  {e['index']}. {isotope_label(*e['parent'])} → "
                        f"{isotope_label(*e['child'])} ({e['symbol']}) "
                        f"after {format_time_value_with_unit(e['duration'])}"
                    )
            elif cmd == "scroll":
                # PgUp/PgDn/C chain-scroll analog (nuclear_sim.py:507-519);
                # clamped to content by the panel composer on render.
                if args and args[0] == "reset":
                    sim.chain_scroll = 0
                else:
                    sim.chain_scroll = max(0, sim.chain_scroll + int(args[0]))
                print(f"  chain scroll: {sim.chain_scroll}")
            elif cmd == "iscroll":
                # Info-panel scroll (rendering.py:140, 534-536).
                if args and args[0] == "reset":
                    sim.info_scroll = 0
                else:
                    sim.info_scroll = max(0, sim.info_scroll + int(args[0]))
                print(f"  info scroll: {sim.info_scroll}")
            elif cmd == "size":
                sim.resize(int(args[0]), int(args[1]))
                print(f"  viewport: {sim.view_width}x{sim.view_height}")
            elif cmd == "status":
                print_status(sim)
            elif cmd == "show":
                if args and args[0] == "ascii":
                    print(sim.render_ascii())
                else:
                    print(sim.render_ansi())
            elif cmd == "watch":
                # Real-time loop at ~60 fps with live ASCII refresh — the
                # run-loop analog (nuclear_sim.py:589-606). Ctrl-C to stop.
                # The camera fit runs ON DEVICE (render_fit_device) and
                # frames reach the host through the pipelined reader, so
                # the loop never waits for the frame it just issued: each
                # shown frame is 3 frames late.
                import time as _time

                from pyqmd_tpu_torch.render.ansi import ansi_render
                from pyqmd_tpu_torch.render.interactive import PipelinedFrameReader

                seconds = float(args[0]) if args else 5.0
                t_end = _time.time() + seconds
                # Raw RGB frames (no palettization at this tiny size), so
                # decode is the identity; depth 3 keeps latency low. Each
                # frame is printed before the next submit, while it is valid.
                reader = PipelinedFrameReader(depth=3, decode=lambda a: a)
                try:
                    while _time.time() < t_end:
                        t0 = _time.time()
                        sim.frame()
                        rgb = reader.submit(sim.render_fit_device(64, 44))
                        if rgb is not None:
                            print("\033[2J\033[H" + ansi_render(rgb))
                            print(f"{sim.isotope}  ts={sim.time_scale:g}  "
                                  f"substeps={sim.substeps_used}")
                        _time.sleep(max(0.0, 1 / 60 - (_time.time() - t0)))
                    tail = reader.flush()
                    if tail:  # show the freshest in-flight frame
                        print("\033[2J\033[H" + ansi_render(tail[-1]))
                        print(f"{sim.isotope}  ts={sim.time_scale:g}  "
                              f"substeps={sim.substeps_used}")
                except KeyboardInterrupt:
                    pass
            elif cmd == "serve":
                from pyqmd_tpu_torch.render.httpview import serve as _serve

                # serve() handles Ctrl-C itself and returns once stopped.
                _serve(sim, port=int(args[0]) if args else 8400)
                print("  live view stopped")
            elif cmd == "render":
                from pyqmd_tpu_torch.render import write_png

                write_png(args[0], sim.render())
                print("  wrote", args[0])
            elif cmd == "save":
                sim.save(args[0])
            elif cmd == "load":
                sim = Simulation.load(args[0], device=sim.device)
                print("  loaded:", sim.isotope)
            else:
                print(f"  unknown command {cmd!r} — try 'help'")
        except (IndexError, ValueError, KeyError, RuntimeError,
                ZeroDivisionError) as e:
            # RuntimeError covers mode guards (force_decay / chain log on
            # an ensemble); a REPL must report them, not die on them.
            print(f"  error: {e}")


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        overrides = parse_overrides(args.overrides)
    except ValueError as e:
        parser.error(str(e))  # clean usage error, not a traceback
    if args.frames is not None and args.frames < 1:
        parser.error("--frames must be >= 1")
    # The statistics modes build their own SimConfig; thread --set through
    # so it is never silently ignored.
    stats_overrides = dict(overrides)
    logging.basicConfig(
        level=logging.WARNING if args.quiet else logging.INFO,
        format="%(asctime)s - %(levelname)s - %(message)s",
    )

    if args.list_isotopes:
        list_isotopes()
        return 0

    if args.survival:
        from pyqmd_tpu_torch.analysis import decay_rate_summary, survival_curve

        z, n = parse_isotope(args.isotope)
        res = survival_curve(
            z, n,
            batch=args.ensemble or 4096,
            frames=args.frames if args.frames is not None else 20,
            half_lives=args.half_lives,
            seed=args.seed,
            overrides=stats_overrides,
            device=args.device,
        )
        with open(args.survival, "w") as f:
            f.write(res.to_csv())
        print(json.dumps(decay_rate_summary(res)))
        return 0

    if args.populations or args.theory:
        import math as _math

        import numpy as _np

        from pyqmd_tpu_torch.analysis import (
            bateman_populations,
            chain_populations,
            chain_populations_csv,
        )
        from pyqmd_tpu_torch.data.tables import half_life_host

        z, n = parse_isotope(args.isotope)
        frames = args.frames if args.frames is not None else 20
        if not _math.isfinite(half_life_host(z, n)):
            parser.error(f"{args.isotope} is stable; no chain to measure")
        measured = None
        if args.populations:
            measured = chain_populations(
                z, n,
                batch=args.ensemble or 4096,
                frames=frames,
                half_lives=args.half_lives,
                seed=args.seed,
                overrides=stats_overrides,
                device=args.device,
            )
            with open(args.populations, "w") as f:
                f.write(chain_populations_csv(measured))
            print("wrote", args.populations)
        if args.theory:
            if measured is not None:
                times = _np.asarray(measured["times"])
            else:
                hl = half_life_host(z, n)
                times = _np.linspace(0.0, args.half_lives * hl, frames + 1)
            theory = bateman_populations(z, n, times)
            with open(args.theory, "w") as f:
                f.write(chain_populations_csv(theory))
            print("wrote", args.theory)
        return 0

    if args.load:
        sim = Simulation.load(args.load, device=args.device)
        if overrides:
            # Apply physics overrides on resume too — but the state arrays
            # were shaped by the checkpoint's capacities, so those fields
            # cannot change here.
            import dataclasses as _dc

            for f in ("max_particles", "max_ejecta", "max_chain_log"):
                if f in overrides and overrides[f] != getattr(sim.cfg, f):
                    parser.error(
                        f"--set {f} cannot change on --load (checkpoint "
                        f"state is shaped by it)"
                    )
            sim.cfg = _dc.replace(sim.cfg, **overrides)
            sim._overrides = dict(overrides)
    else:
        z, n = parse_isotope(args.isotope)
        sim = Simulation(
            z=z, n=n, seed=args.seed, ensemble=args.ensemble,
            device=args.device,
            overrides=overrides,
        )
    sim.set_time_scale(parse_time_scale(str(args.time_scale)))
    if args.zoom is not None:
        from pyqmd_tpu_torch.sim import MAX_ZOOM, MIN_ZOOM

        # Same clamp as every interactive zoom path (nuclear_sim.py:74-75).
        sim.zoom = sim.target_zoom = min(MAX_ZOOM, max(MIN_ZOOM, float(args.zoom)))

    if args.serve is not None:
        from pyqmd_tpu_torch.render.httpview import serve

        serve(sim, port=args.serve)
        return 0

    if args.interactive:
        interactive(sim)
        return 0

    frames = []
    import contextlib

    profile_ctx = contextlib.nullcontext()
    if args.profile:
        from pyqmd_tpu_torch.utils.profiling import trace

        profile_ctx = trace(args.profile)
    num_frames = args.frames if args.frames is not None else 600
    with profile_ctx:
        for f in range(num_frames):
            sim.frame(args.frame_dt)
            if args.render and args.render_every and f % args.render_every == 0:
                frames.append(
                    sim.render_grid() if sim.batched else
                    sim.render(args.width, args.height, panels=not args.no_panels)
                )

    print_status(sim)
    if args.render:
        from pyqmd_tpu_torch.render import write_apng, write_gif, write_png

        if frames:
            # Container by extension: .gif -> animated GIF (universally
            # viewable), anything else -> APNG.
            if args.render.lower().endswith(".gif"):
                write_gif(args.render, frames)
            else:
                write_apng(args.render, frames)
        elif sim.batched:
            write_png(args.render, sim.render_grid())  # ensemble montage
        else:
            write_png(
                args.render,
                sim.render(args.width, args.height, panels=not args.no_panels),
            )
        print("wrote", args.render)
    if args.save:
        sim.save(args.save)
    if args.status_json:
        print(json.dumps(sim.status()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
