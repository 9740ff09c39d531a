"""The port's command line on the CPU (``--device cpu``): the batch run,
resume, every REPL command, the live views (``watch``, ``serve``,
``--serve``), ``--set``, the statistics modes
and ``python -m pyqmd_tpu_torch``, with the outputs the JAX package's CLI
gives for the same arguments where they are deterministic."""

import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (caps torch threads)
from pyqmd_tpu.cli import main as jax_cli_main
from pyqmd_tpu_torch import cli
from pyqmd_tpu_torch.cli import main as cli_main

REPO = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]


def test_cli_batch_run(tmp_path, capsys):
    png, ck = tmp_path / "out.png", tmp_path / "out.npz"
    args = ["--isotope", "C-14", "--frames", "3", "--time-scale", "2.0", "--status-json", "-q",
            "--width", "120", "--height", "90"]
    assert cli_main(args + CPU + ["--render", str(png), "--save", str(ck)]) == 0
    out = capsys.readouterr().out
    assert "isotope:    C-14" in out
    status = json.loads(out.strip().splitlines()[-1])
    assert status["z"] == 6 and status["alive"] == 14 and status["backend"] == "cpu"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and ck.exists()
    # the reference CLI prints the same status for the same arguments
    jpng = tmp_path / "jax.png"
    assert jax_cli_main(args + ["--render", str(jpng), "--backend", "jnp"]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(status) == list(ref)
    for k in ("isotope", "z", "n", "alive", "ejecta", "decay_counts", "time_passed", "substeps",
              "half_life", "time_scale"):
        assert status[k] == ref[k], k
    assert status["rms_radius"] == pytest.approx(ref["rms_radius"], rel=1e-4)


def test_cli_resume_and_cross_package_resume(tmp_path, capsys):
    ck = tmp_path / "r.npz"
    assert cli_main(CPU + ["--isotope", "He-4", "--frames", "2", "--save", str(ck), "-q"]) == 0
    assert cli_main(CPU + ["--load", str(ck), "--frames", "2", "-q"]) == 0
    assert "He-4" in capsys.readouterr().out
    assert jax_cli_main(["--load", str(ck), "--frames", "1", "-q"]) == 0  # the port's file
    jck = tmp_path / "j.npz"
    assert jax_cli_main(["--isotope", "C-14", "--ensemble", "3", "--frames", "1", "--save",
                         str(jck), "-q", "--backend", "jnp"]) == 0
    capsys.readouterr()
    assert cli_main(CPU + ["--load", str(jck), "--frames", "1", "-q"]) == 0  # and back
    assert "C-14 x3" in capsys.readouterr().out


def test_cli_interactive(capsys, monkeypatch):
    commands = "status\ndecay\nt 1e6yr\nstep 2\nchain\nbogus\nquit\n"
    monkeypatch.setattr("sys.stdin", io.StringIO(commands))
    assert cli_main(CPU + ["--isotope", "U-238", "-i", "-q"]) == 0
    out = capsys.readouterr().out
    assert "pyqmd-torch interactive" in out
    assert "U-238 → Th-234" in out and "unknown command 'bogus'" in out
    monkeypatch.setattr("sys.stdin", io.StringIO(commands))
    assert jax_cli_main(["--isotope", "U-238", "-i", "-q"]) == 0
    ref = capsys.readouterr().out
    pick = lambda text: [l for l in text.splitlines() if "→" in l or "Z/N" in l or "time scale" in l]
    assert pick(out) == pick(ref)


def test_cli_interactive_all_ported_commands(tmp_path, capsys, monkeypatch):
    """Drive every REPL command the port has once."""
    png, ck = tmp_path / "v.png", tmp_path / "v.npz"
    commands = "\n".join([
        "help", "status", "step 2", "run 2", "decay", "faster", "slower", "ff", "rew",
        "t 1e6yr", "preset hour", "iso C-14", "iso 9", "zoom in", "zoom out", "zoom 12",
        "pan 1 -1", "auto", "auto", "dt 0.005", "accuracy 0.8", "substeps 10", "chain", "chain 1",
        "scroll 2", "scroll -1", "scroll reset", "iscroll 3", "iscroll reset", "size 400 300",
        "show ascii", "show", f"render {png}", f"save {ck}", f"load {ck}", "status", "", "quit",
    ]) + "\n"
    monkeypatch.setattr("sys.stdin", io.StringIO(commands))
    assert cli_main(CPU + ["--isotope", "U-238", "-i", "-q"]) == 0
    out = capsys.readouterr().out
    assert "error:" not in out and "unknown command" not in out
    assert "auto-adjust substeps: ON" in out and "auto-adjust substeps: OFF" in out
    assert "physics dt: 0.005000s" in out and "viewport: 400x300" in out
    assert "\x1b[38;2;" in out  # truecolor 'show'
    assert png.exists() and ck.exists() and "loaded:" in out


def test_watch_prints_ansi_frames_and_returns_to_the_prompt(capsys, monkeypatch):
    """``watch SECS``: the pipelined ASCII loop, its status line under each
    frame, the tail flush, then the next command."""
    monkeypatch.setattr("sys.stdin", io.StringIO("watch 0.3\nstatus\nquit\n"))
    assert cli_main(CPU + ["--isotope", "He-4", "-i", "-q"]) == 0
    out = capsys.readouterr().out
    assert "unknown command" not in out and "error:" not in out
    assert "\x1b[2J\x1b[H" in out and "\x1b[38;2;" in out  # clear + truecolor frame
    assert "He-4  ts=1  substeps=4" in out
    # 64x44 pixels, two per character row: 22 rows of 64 half blocks
    frame = out.split("\x1b[2J\x1b[H")[-1].split("He-4  ts=")[0]
    assert frame.count("\n") == 22 and frame.count("\u2580") == 64 * 22
    assert out.rindex("isotope:    He-4") > out.rindex("\x1b[2J")  # 'status' ran after it


def test_watch_stops_on_ctrl_c(capsys, monkeypatch):
    from pyqmd_tpu_torch.render import interactive

    def interrupted(self, frame):
        raise KeyboardInterrupt

    monkeypatch.setattr(interactive.PipelinedFrameReader, "submit", interrupted)
    monkeypatch.setattr("sys.stdin", io.StringIO("watch\nstatus\nquit\n"))
    assert cli_main(CPU + ["--isotope", "He-4", "-i", "-q"]) == 0
    out = capsys.readouterr().out
    assert "\x1b[2J" not in out and "isotope:    He-4" in out


@pytest.mark.parametrize("command,port", [("serve 8123", 8123), ("serve", 8400)])
def test_serve_command_reaches_the_viewer(command, port, capsys, monkeypatch):
    """``serve [PORT]`` in the REPL: ``httpview.serve`` on that port, and
    back at the prompt once it is interrupted."""
    from pyqmd_tpu_torch.render import httpview

    seen = {}

    def constructed(self, sim, host="127.0.0.1", port=8400, **kw):
        seen.update(host=host, port=port, isotope=sim.isotope)
        real_init(self, sim, host=host, port=0, **kw)  # bind no fixed port in a test

    def interrupted(self):
        seen["served"] = True
        raise KeyboardInterrupt

    real_init = httpview.LiveViewServer.__init__
    monkeypatch.setattr(httpview.LiveViewServer, "__init__", constructed)
    monkeypatch.setattr(httpview.LiveViewServer, "serve_forever", interrupted)
    monkeypatch.setattr("sys.stdin", io.StringIO(f"{command}\nquit\n"))
    assert cli_main(CPU + ["--isotope", "He-4", "-i", "-q"]) == 0
    out = capsys.readouterr().out
    assert seen == {"host": "127.0.0.1", "port": port, "isotope": "He-4", "served": True}
    assert "live view stopped" in out and "unknown command" not in out


def test_serve_flag_reaches_the_viewer(capsys, monkeypatch):
    """``--serve PORT`` serves and exits 0 without running a frame loop."""
    from pyqmd_tpu_torch.render import httpview

    seen = {}

    def serve(sim, host="127.0.0.1", port=8400, fps=30.0):
        seen.update(port=port, isotope=sim.isotope, ts=sim.time_scale, frames=sim.frame_count)

    monkeypatch.setattr(httpview, "serve", serve)
    assert cli_main(CPU + ["--isotope", "C-14", "--serve", "8555", "--time-scale", "1e3yr",
                           "-q"]) == 0
    assert seen == {"port": 8555, "isotope": "C-14", "ts": 3.15576e10, "frames": 0}
    assert "isotope:" not in capsys.readouterr().out  # no batch run, no status print


def test_help_lists_the_live_views_and_the_jax_switches_stay_gone(capsys):
    for command in ("watch [SECS]", "serve [PORT]"):
        assert command in cli.HELP
    from pyqmd_tpu.cli import HELP as JAX_HELP

    assert cli.HELP == JAX_HELP  # the REPL's commands are the reference's, line for line
    assert "--serve PORT" in cli.build_parser().format_help()
    for gone in ("--backend", "--platform"):
        with pytest.raises(SystemExit):
            cli_main(CPU + [gone, "cpu"])
    assert "unrecognized arguments" in capsys.readouterr().err


def test_cli_interactive_ensemble_mode_survives_bad_commands(capsys, monkeypatch):
    commands = "decay\nchain\naccuracy 2\nstep\nzoom\nstatus\nquit\n"
    monkeypatch.setattr("sys.stdin", io.StringIO(commands))
    assert cli_main(CPU + ["--isotope", "C-14", "--ensemble", "4", "-i", "-q"]) == 0
    out = capsys.readouterr().out
    assert out.count("error:") == 4  # decay, chain, accuracy and the bare zoom
    assert "C-14 x4" in out  # status still works afterwards


def test_cli_config_overrides(capsys):
    ov = cli.parse_overrides(["strong_strength=120", "fast_math=false", "integrator=leapfrog",
                              "max_substeps=10"])
    assert ov == {"strong_strength": 120.0, "fast_math": False, "integrator": "leapfrog",
                  "max_substeps": 10}
    for bad in ("bogus_field=1", "no_equals", "force_backend=pallas", "decay_backend=jnp"):
        with pytest.raises(ValueError):
            cli.parse_overrides([bad])
    assert cli_main(CPU + ["--isotope", "He-4", "--frames", "2", "-q", "--status-json",
                           "--set", "strong_strength=100", "--set", "damping=0.9"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["alive"] == 4


def test_cli_set_with_load_and_error_paths(tmp_path, capsys):
    ck = tmp_path / "s.npz"
    cli_main(CPU + ["--isotope", "He-4", "--frames", "1", "--save", str(ck), "-q"])
    capsys.readouterr()
    assert cli_main(CPU + ["--load", str(ck), "--frames", "1", "-q", "--status-json",
                           "--set", "strong_strength=120"]) == 0
    for bad in (["--load", str(ck), "--set", "max_particles=512"], ["--set", "bogus_field=1"],
                ["--set", "no_equals"], ["--set", "force_backend=jnp"], ["--frames", "0"]):
        with pytest.raises(SystemExit):
            cli_main(CPU + bad + ["-q"])
    assert "unknown SimConfig field 'force_backend'" in capsys.readouterr().err


def test_cli_populations_and_theory_equal_the_reference(tmp_path, capsys):
    names = {}
    for tag, main, extra in (("port", cli_main, CPU), ("jax", jax_cli_main, [])):
        pops, theory = tmp_path / f"{tag}_pops.csv", tmp_path / f"{tag}_theory.csv"
        assert main(extra + ["--isotope", "Pb-214", "--ensemble", "256", "--frames", "6",
                             "--half-lives", "2", "--populations", str(pops),
                             "--theory", str(theory), "-q"]) == 0
        names[tag] = (pops.read_text(), theory.read_text())
    assert names["port"] == names["jax"]  # same seed, same decays, same Bateman curve
    lines = names["port"][0].strip().splitlines()
    header = lines[0].split(",")
    assert header[0] == "time_s" and "82:132" in header and len(lines) == 8
    assert dict(zip(header, lines[1].split(",")))["82:132"] == "256"
    vals = [float(x) for x in names["port"][1].strip().splitlines()[-1].split(",")[1:]]
    assert abs(sum(vals) - 1.0) < 1e-6
    only = tmp_path / "only.csv"
    assert cli_main(CPU + ["--isotope", "Pb-214", "--theory", str(only), "--frames", "4"]) == 0
    assert len(only.read_text().strip().splitlines()) == 6
    with pytest.raises(SystemExit):
        cli_main(CPU + ["--isotope", "He-4", "--theory", str(only)])


def test_cli_survival_equals_the_reference(tmp_path, capsys):
    fits = {}
    for tag, main, extra in (("port", cli_main, CPU), ("jax", jax_cli_main, [])):
        csv = tmp_path / f"{tag}.csv"
        assert main(extra + ["--isotope", "C-14", "--ensemble", "512", "--frames", "5",
                             "--survival", str(csv), "-q", "--seed", "3"]) == 0
        fits[tag] = (json.loads(capsys.readouterr().out.strip().splitlines()[-1]),
                     csv.read_text().splitlines())
    assert fits["port"][0].keys() == fits["jax"][0].keys()
    for k, v in fits["jax"][0].items():
        assert fits["port"][0][k] == pytest.approx(v, rel=1e-9), k
    assert len(fits["port"][1]) == len(fits["jax"][1]) == 7
    for a, b in zip(fits["port"][1][1:], fits["jax"][1][1:]):
        np.testing.assert_allclose([float(x) for x in a.split(",")],
                                   [float(x) for x in b.split(",")], rtol=1e-9)


def test_cli_list_isotopes_equals_the_reference(capsys):
    assert cli_main(["--list-isotopes"]) == 0  # host tables only: no device needed
    out = capsys.readouterr().out
    assert jax_cli_main(["--list-isotopes"]) == 0
    assert out == capsys.readouterr().out
    assert "U-238" in out and "stable" in out


def test_cli_animation_montage_zoom_and_profile(tmp_path, capsys):
    gif, apng, grid, prof = (tmp_path / "a.gif", tmp_path / "a.png", tmp_path / "g.png",
                             tmp_path / "prof")
    common = CPU + ["--isotope", "C-14", "-q", "--width", "96", "--height", "72"]
    assert cli_main(common + ["--frames", "4", "--render", str(gif), "--render-every", "2",
                              "--zoom", "500", "--no-panels"]) == 0
    assert gif.read_bytes()[:6] == b"GIF89a" and gif.read_bytes().count(b"\x21\xf9") == 2
    assert cli_main(common + ["--frames", "2", "--render", str(apng), "--render-every", "1",
                              "--profile", str(prof)]) == 0
    assert b"acTL" in apng.read_bytes() and (prof / "trace.json").exists()
    assert cli_main(common + ["--frames", "1", "--ensemble", "3", "--render", str(grid)]) == 0
    assert grid.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert capsys.readouterr().out.count("wrote") == 3


def test_parser_describes_the_port():
    p = cli.build_parser()
    assert p.prog == "pyqmd-torch" and "PyTorch / CUDA" in p.description
    assert p.parse_args([]).device == "cuda"
    text = p.format_help()
    assert "--device" in text and "--serve" in text and "--backend" not in text


def test_python_dash_m_package_entry():
    r = subprocess.run([sys.executable, "-m", "pyqmd_tpu_torch", "--help"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0
    assert "--device" in r.stdout and "--isotope" in r.stdout and "--serve PORT" in r.stdout
    r = subprocess.run([sys.executable, "-m", "pyqmd_tpu_torch", "--device", "cpu", "--isotope",
                        "He-4", "--frames", "2", "-q", "--status-json"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1])["alive"] == 4
