"""Every script under ``examples_torch/`` runs end to end on the CPU at a
small size, imports nothing of JAX, has the file name of the JAX example it
ports and prints what that example prints: the statistics examples the JAX
package's own numbers for the same seed and batch (the decay statistics are
bitwise equal between the packages), the dynamics examples the original's
text, the integrator table within f32 rounding."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DIR = os.path.join(_REPO, "examples_torch")

# The small sizes the JAX package's example test uses.
_ARGS = {
    "survival_curve.py": ["--cpu", "--batch", "512"],
    "mixed_population.py": ["--cpu", "--quick"],
    "bateman_vs_ensemble.py": ["--cpu", "--batch", "512"],
    "decay_chain_movie.py": ["--cpu", "--frames", "40"],
    "leapfrog_accuracy.py": ["--cpu"],
    "sharded_survival.py": ["--cpu", "--per-device", "64"],
}
# Examples of the JAX package that wait for a part of the port.
_NOT_YET = set()


def _scripts(folder):
    return sorted(f for f in os.listdir(os.path.join(_REPO, folder))
                  if f.endswith(".py") and not f.startswith("_"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run a script once per module, in a directory of its own; returns
    ``run(script, folder="examples_torch") -> (stdout, cwd)``."""
    done = {}

    def run(script, folder="examples_torch"):
        if (script, folder) not in done:
            cwd = tmp_path_factory.mktemp(folder + "_" + script.removesuffix(".py"))
            env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", JAX_PLATFORMS="cpu")
            args = _ARGS[script] if "--cpu" in open(os.path.join(_REPO, folder, script)).read() else []
            proc = subprocess.run(
                [sys.executable, os.path.join(_REPO, folder, script)] + args,
                cwd=cwd, capture_output=True, text=True, timeout=420, env=env,
            )
            assert proc.returncode == 0, (
                f"{script} failed:\n--- stdout ---\n{proc.stdout[-2000:]}"
                f"\n--- stderr ---\n{proc.stderr[-2000:]}"
            )
            done[script, folder] = (proc.stdout, cwd)
        return done[script, folder]

    return run


@pytest.mark.parametrize("script", sorted(_ARGS))
def test_example_runs_on_the_cpu(script, runs):
    out, _ = runs(script)
    assert out.strip()  # every example reports something


def test_every_example_has_its_twin():
    assert set(_scripts("examples_torch")) == set(_scripts("examples")) - _NOT_YET
    assert set(_ARGS) == set(_scripts("examples_torch"))


@pytest.mark.parametrize("script", sorted(_ARGS))
def test_example_imports_only_the_port(script):
    """torch, numpy, the standard library and ``pyqmd_tpu_torch``; the card
    is the default device and ``--cpu`` the exception, in every script."""
    src = open(os.path.join(_DIR, script)).read()
    roots = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots <= {"argparse", "json", "math", "os", "socket", "sys", "numpy", "torch",
                     "pyqmd_tpu_torch"}, roots
    assert "pyqmd_tpu_torch" in roots
    assert '"cpu" if args.cpu else "cuda"' in src


def test_survival_curve_prints_the_reference_numbers(runs):
    from pyqmd_tpu.analysis import decay_rate_summary, survival_curve

    out, cwd = runs("survival_curve.py")
    got = json.loads(out[:out.rindex("}") + 1])
    ref = decay_rate_summary(survival_curve(6, 8, batch=512, frames=30, half_lives=3.0, seed=0))
    assert got.keys() == ref.keys()
    assert got["decay_counts"] == list(ref["decay_counts"]) and got["batch"] == 512
    assert got["final_survival"] == ref["final_survival"]
    assert got["fitted_half_life_s"] == pytest.approx(ref["fitted_half_life_s"], rel=1e-9)
    assert f"fitted half-life error: {ref['rel_error'] * 100:.2f}%" in out
    rows = (cwd / "c14_survival.csv").read_text().strip().splitlines()
    assert rows[0] == "time_s,survival,activity_per_s" and len(rows) == 32


def test_bateman_vs_ensemble_prints_the_reference_populations(runs):
    from pyqmd_tpu.analysis import chain_populations, chain_populations_csv

    out, cwd = runs("bateman_vs_ensemble.py")
    ref = chain_populations(82, 132, batch=512, frames=20, half_lives=3.0)
    # the measured curves, every time point of every isotope
    assert (cwd / "pb214_measured.csv").read_text() == chain_populations_csv(ref)
    printed = {}
    for line in out.splitlines():
        cells = line.split()
        if len(cells) == 4 and ":" in cells[0]:
            printed[cells[0]] = float(cells[1])
    assert printed, out
    for key, measured in printed.items():
        assert measured == pytest.approx(ref["populations"][key][-1] / 512, abs=5e-5), key
    theory = np.loadtxt(cwd / "pb214_theory.csv", delimiter=",", skiprows=1)
    np.testing.assert_allclose(theory[:, 1:].sum(1), 1.0, atol=1e-6)


def test_mixed_population_and_movie_report_what_they_ran(runs):
    out, _ = runs("mixed_population.py")
    rows = [l for l in out.splitlines() if "Rn-222:" in l]
    assert len(rows) == 5 and "Rn-222:32" in rows[0] and "C-14:32" in rows[-1]
    first, last = (int(r.split("Rn-222:")[1].split()[0]) for r in (rows[0], rows[-1]))
    assert last < first  # Rn-222 decays on this clock, C-14 and He-4 stay
    out, cwd = runs("decay_chain_movie.py")
    assert "wrote u238_chain.png (5 frames)" in out
    assert b"acTL" in (cwd / "u238_chain.png").read_bytes()


def _leapfrog_tables(out):
    """The convergence rows (dt, euler, leapfrog) and the round-trip drifts."""
    rows = np.array([[float(c) for c in l.split()] for l in out.splitlines()
                     if l.strip().startswith("0.0")])
    drift = {l.split()[0]: float(l.split()[1]) for l in out.splitlines()
             if l.strip().startswith(("euler ", "leapfrog "))}
    return rows, drift


def test_leapfrog_accuracy_shows_both_orders(runs):
    rows, drift = _leapfrog_tables(runs("leapfrog_accuracy.py")[0])
    euler, leap = rows[:, 1], rows[:, 2]
    assert rows.shape == (3, 3)
    assert 1.7 < euler[0] / euler[1] < 2.3 and 3.0 < leap[0] / leap[1] < 5.0
    assert drift["leapfrog"] < 1e-5 < drift["euler"]


def test_leapfrog_accuracy_prints_the_reference_table(runs):
    """Positions are near 7, where one f32 step is 4.8e-7: the errors agree
    to two such steps, Euler's (1e-2 and more) to 1e-4 of their size."""
    rows, drift = _leapfrog_tables(runs("leapfrog_accuracy.py")[0])
    ref_rows, ref_drift = _leapfrog_tables(runs("leapfrog_accuracy.py", "examples")[0])
    np.testing.assert_array_equal(rows[:, 0], ref_rows[:, 0])
    np.testing.assert_allclose(rows[:, 1], ref_rows[:, 1], rtol=1e-4)
    np.testing.assert_allclose(rows[:, 2], ref_rows[:, 2], rtol=0, atol=1e-6)
    assert drift["euler"] == pytest.approx(ref_drift["euler"], rel=1e-4)
    assert drift["leapfrog"] == pytest.approx(ref_drift["leapfrog"], abs=1e-6)


def test_sharded_survival_prints_the_reference_fit(runs):
    """8 gloo ranks x 64 members against the JAX original's 8 virtual
    devices x 64: the same 512 members, so the same survival and fit, line
    for line; only the backend word of the first line differs."""
    out, ref = runs("sharded_survival.py")[0], runs("sharded_survival.py", "examples")[0]
    lines, ref_lines = out.strip().splitlines(), ref.strip().splitlines()
    assert lines[0] == "512 C-14 nuclei over 8 devices (gloo)"
    assert ref_lines[0] == "512 C-14 nuclei over 8 devices (cpu)"
    assert lines[1:] == ref_lines[1:] and len(lines) == 3
    assert lines[1].startswith("survival after 2 T1/2: ")


@pytest.mark.parametrize("script", ["mixed_population.py", "decay_chain_movie.py"])
def test_dynamics_example_prints_what_the_reference_prints(script, runs):
    """Same seed, same sizes: the population table and the movie's report
    are the JAX example's, character for character."""
    assert runs(script)[0] == runs(script, "examples")[0]
