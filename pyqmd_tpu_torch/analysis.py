"""Ensemble analysis: survival curves, chain populations, half-life fits and
the Bateman theory curves they are held against.

The port of ``pyqmd_tpu.analysis``. An ensemble of independent nuclei runs
through the decay-statistics frame (or the full-physics frame) on
``device``; each frame reduces the per-nucleus (Z, N) on the device, and
one host readback per frame brings back the counts. The Bateman solvers are
host-side numpy/scipy, copied as the JAX package has them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core.init import ensemble_init
from pyqmd_tpu_torch.core.step import make_decay_frame_fn, make_frame_fn
from pyqmd_tpu_torch.data.chains import decay_branches
from pyqmd_tpu_torch.data.estimator import STABLE_THRESHOLD, bucket_params, stability_score
from pyqmd_tpu_torch.data.halflives import HALF_LIVES
from pyqmd_tpu_torch.data.tables import half_life_host
from pyqmd_tpu_torch.state import DECAY_NONE
from pyqmd_tpu_torch.utils.profiling import annotate, count


@dataclasses.dataclass
class SurvivalResult:
    """Survival-curve measurement for one isotope ensemble."""

    z: int
    n: int
    batch: int
    times: np.ndarray  # (F+1,) sim seconds
    survival: np.ndarray  # (F+1,) fraction still the initial isotope
    decay_counts: np.ndarray  # (NUM_DECAY_TYPES,) totals at the end
    tabulated_half_life: float
    fitted_half_life: float

    @property
    def rel_error(self) -> float:
        if not math.isfinite(self.tabulated_half_life):
            return float("nan")
        return abs(self.fitted_half_life - self.tabulated_half_life) / (
            self.tabulated_half_life
        )

    def activity(self) -> np.ndarray:
        """Decays per second at each time point (A = -dN/dt), the quantity
        a detector measures; A(t) = lambda*N(t) for a pure species."""
        return -np.gradient(self.survival * self.batch, self.times)

    def to_csv(self) -> str:
        lines = ["time_s,survival,activity_per_s"]
        act = self.activity()
        lines += [f"{t},{s},{a}" for t, s, a in zip(self.times, self.survival, act)]
        return "\n".join(lines) + "\n"


def _ensemble_setup(
    z, n, batch, frames, half_lives, substeps, seed, pad_to, decay_only,
    max_chain_log, overrides, device,
):
    """Shared preamble of :func:`survival_curve` and
    :func:`chain_populations`: stability check, config (with SimConfig field
    ``overrides``), ensemble init on ``device``, the frame function and the
    time-grid step."""
    if frames < 1:
        raise ValueError(f"frames must be >= 1, got {frames}")
    hl = half_life_host(z, n)
    if not math.isfinite(hl):
        raise ValueError(f"isotope ({z},{n}) is stable; no half-life to measure")
    cfg = SimConfig.for_isotope(z, n, pad_to=pad_to, max_chain_log=max_chain_log)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    states = ensemble_init(cfg, batch, seed=seed, device=device)
    fn = (
        make_decay_frame_fn(cfg, substeps)
        if decay_only
        else make_frame_fn(cfg, substeps, batched=True)
    )
    return hl, cfg, states, fn, half_lives * hl / frames


def survival_curve(
    z: int,
    n: int,
    batch: int = 4096,
    frames: int = 20,
    half_lives: float = 2.0,
    substeps: int = 10,
    seed: int = 0,
    pad_to: int = 8,
    decay_only: bool = True,
    max_chain_log: int = 8,
    overrides: dict | None = None,
    device="cuda",
) -> SurvivalResult:
    """Run a ``batch``-nucleus ensemble of isotope (z, n) on ``device`` (the
    card unless the caller names another) for ``half_lives`` tabulated
    half-lives and record the survival curve.

    The MLE half-life fit uses the endpoint survivor count:
    ``T = ln2 * t_end / -ln(S)``; it is infinite when no member ever left
    (z, n). ``decay_only=True`` runs the decay-statistics frame, whose
    isotope trajectories equal the full-physics frame's bitwise.
    ``max_chain_log`` sizes the per-member chain-log ring; ``overrides``
    replaces SimConfig fields.

    Spans: ``pyqmd.survival.setup`` (config, ``ensemble_init``, frame
    function), ``pyqmd.survival.frame`` per frame call and
    ``pyqmd.survival.readback`` per survivor count (and the decay totals at
    the end), each readback one ``host.syncs`` on the card.
    """
    with annotate("pyqmd.survival.setup"):
        hl, cfg, states, fn, sim_dt = _ensemble_setup(
            z, n, batch, frames, half_lives, substeps, seed, pad_to,
            decay_only, max_chain_log, overrides, device,
        )
    on_card = states.pos.is_cuda

    times = [0.0]
    survival = [1.0]
    m = None
    for f in range(frames):
        with annotate("pyqmd.survival.frame"):
            states, m = fn(states, sim_dt, 1.0)
        # Reduced on the device: one scalar readback per frame.
        with annotate("pyqmd.survival.readback"):
            count("host.syncs", on_card)
            alive = int(((m["z"] == z) & (m["n"] == n)).sum())
        times.append((f + 1) * sim_dt)
        survival.append(alive / batch)

    s_end = survival[-1]
    if s_end >= 1.0:
        # No member ever left the initial isotope: zero decays in the
        # window, or a chain whose branches re-enter (z, n) (Tc-99m's γ
        # branch). -log(1.0) is -0.0, so report an infinite fit instead.
        fitted = math.inf
    else:
        fitted = math.log(2) * times[-1] / -math.log(max(s_end, 1e-12))
    with annotate("pyqmd.survival.readback"):
        count("host.syncs", on_card)
        decay_counts = m["total_decay_counts"].cpu().numpy()
    return SurvivalResult(
        z=z,
        n=n,
        batch=batch,
        times=np.asarray(times),
        survival=np.asarray(survival),
        decay_counts=decay_counts,
        tabulated_half_life=hl,
        fitted_half_life=fitted,
    )


def chain_populations(
    z: int,
    n: int,
    batch: int = 4096,
    frames: int = 30,
    half_lives: float = 3.0,
    substeps: int = 10,
    seed: int = 0,
    pad_to: int = 8,
    decay_only: bool = True,
    max_chain_log: int = 8,
    overrides: dict | None = None,
    device="cuda",
) -> dict:
    """Track the isotope populations of a decaying ensemble over time.

    Runs a ``batch``-nucleus ensemble of (z, n) on ``device`` (the card
    unless the caller names another) and, each
    frame, histograms the per-nucleus (Z, N) over the reachable chain nodes
    (:func:`decay_chain_graph`) on the device, so one readback of
    O(nodes) counts per frame reaches the host. Returns ``{"times": [...],
    "populations": {"Z:N": [...]}}``, plus an ``"other"`` row if any member
    leaves the predicted graph. ``decay_only`` as in :func:`survival_curve`.
    """
    hl, cfg, states, fn, sim_dt = _ensemble_setup(
        z, n, batch, frames, half_lives, substeps, seed, pad_to,
        decay_only, max_chain_log, overrides, device,
    )

    nodes, _ = decay_chain_graph(z, n)
    node_z = torch.tensor([zz for zz, _ in nodes], dtype=torch.int32, device=device)
    node_n = torch.tensor([nn for _, nn in nodes], dtype=torch.int32, device=device)

    keys = [f"{zz}:{nn}" for zz, nn in nodes]
    times = [0.0]
    pops: dict[str, list[int]] = {k: [0] for k in keys}
    pops[f"{z}:{n}"][0] = batch
    other: list[int] = [0]
    for f in range(frames):
        states, m = fn(states, sim_dt, 1.0)
        eq = (m["z"][:, None] == node_z) & (m["n"][:, None] == node_n)
        counts = eq.sum(0)
        # One host transfer per frame: the node counts, then the rest.
        count("host.syncs", counts.is_cuda)
        *counts, extra = torch.cat([counts, (m["z"].shape[0] - counts.sum())[None]]).tolist()
        times.append((f + 1) * sim_dt)
        for k, c in zip(keys, counts):
            pops[k].append(int(c))
        other.append(int(extra))
    if any(other):
        pops["other"] = other
    return {"times": times, "populations": pops}


def chain_populations_csv(result: dict) -> str:
    """CSV form of a :func:`chain_populations` or
    :func:`bateman_populations` result (one column per isotope, rows = time
    points)."""
    keys = sorted(result["populations"])
    lines = ["time_s," + ",".join(keys)]
    for t_idx, t in enumerate(result["times"]):
        row = [str(t)] + [str(result["populations"][k][t_idx]) for k in keys]
        lines.append(",".join(row))
    return "\n".join(lines) + "\n"


def _chain_walk(
    z: int, n: int, max_nodes: int
) -> tuple[list[tuple[int, int]], list[tuple[int, int, float]], list[tuple]]:
    """BFS over the reachable decay graph, shared by the graph functions.

    Returns ``(nodes, edges, specs)``: isotopes in BFS order, real-branch
    edges ``(parent_idx, child_idx, renormalized_prob)``, and one sojourn
    spec per node describing how the engine draws its half-life:

    - ``("stable",)`` — infinite/zero half-life or no real decay mode,
    - ``("exp", lam)`` — tabulated: a single exponential rate,
    - ``("mix", lo, hi, scale)`` — estimator bucket: per-nucleus half-life
      ``10**(lo + U(0,1)*(hi-lo)) * scale`` (decay_chains.py:309-328).
    """
    nodes: list[tuple[int, int]] = [(z, n)]
    index = {(z, n): 0}
    edges: list[tuple[int, int, float]] = []
    specs: list[tuple] = []
    i = 0
    while i < len(nodes):
        zz, nn = nodes[i]
        branches = [b for b in decay_branches(zz, nn) if b[2] != DECAY_NONE]
        spec: tuple = ("stable",)
        if branches:
            if (zz, nn) in HALF_LIVES:
                hl = float(HALF_LIVES[(zz, nn)])
                if math.isfinite(hl) and hl > 0:
                    spec = ("exp", math.log(2) / hl)
            else:
                score = stability_score(zz, nn)
                if score < STABLE_THRESHOLD:
                    spec = ("mix",) + bucket_params(score)
        specs.append(spec)
        if spec[0] != "stable":
            total = sum(b[3] for b in branches)
            for bz, bn, _mode, prob in branches:
                key = (bz, bn)
                if key not in index:
                    if len(nodes) >= max_nodes:
                        raise ValueError(f"decay graph of ({z},{n}) exceeds {max_nodes} nodes")
                    index[key] = len(nodes)
                    nodes.append(key)
                edges.append((i, index[key], prob / total))
        i += 1
    return nodes, edges, specs


def decay_chain_graph(
    z: int, n: int, max_nodes: int = 128
) -> tuple[list[tuple[int, int]], np.ndarray]:
    """Reachable-isotope decay graph rooted at (z, n).

    Returns ``(nodes, rates)``: the isotopes reachable through the chain
    database in BFS order, and the (K, K) rate matrix A of dN/dt = A·N —
    A[j][j] = -λ_j and A[child][parent] = λ_parent · branch probability,
    with branch probabilities renormalised over real decay modes. Stable
    nuclides have λ = 0; estimator-bucket nodes get the log-midpoint rate
    (u = 0.5).
    """
    nodes, edges, specs = _chain_walk(z, n, max_nodes)
    lam: list[float] = []
    for spec in specs:
        if spec[0] == "exp":
            lam.append(spec[1])
        elif spec[0] == "mix":
            lo, hi, scale = spec[1:]
            lam.append(math.log(2) / (10.0 ** (lo + 0.5 * (hi - lo)) * scale))
        else:
            lam.append(0.0)
    k = len(nodes)
    a = np.zeros((k, k), np.float64)
    for j in range(k):
        a[j, j] = -lam[j]
    for p, c, prob in edges:
        a[c, p] += lam[p] * prob
    return nodes, a


def _expanded_decay_graph(
    z: int, n: int, max_nodes: int = 128, quad: int = 32
) -> tuple:
    """Hyperexponential expansion of the decay graph: the exact ensemble
    expectation under the engine's half-life sampling.

    An estimated isotope's half-life is drawn once per nucleus on arrival,
    log-uniformly over its estimator bucket, so its sojourn time is a
    mixture of exponentials: each bucket node becomes ``quad``
    Gauss-Legendre sub-states (rate λ_m = ln2 / T(u_m), arrival weight
    w_m), and the expanded system is a linear ODE again.

    Returns ``(nodes, a, state_of, entry_w, lam_s, out_frac)``: public BFS
    nodes, the (S, S) expanded rate matrix, each node's expanded-state
    indices and arrival weights, the per-state rates, and each state's
    outflow fractions.
    """
    nodes, edges, specs = _chain_walk(z, n, max_nodes)
    state_of: list[np.ndarray] = []
    entry_w: list[np.ndarray] = []
    lam_all: list[float] = []
    for spec in specs:
        if spec[0] == "mix":
            lo, hi, scale = spec[1:]
            x, w = np.polynomial.legendre.leggauss(quad)
            u = 0.5 * (x + 1.0)
            w = 0.5 * w
            lam = math.log(2) / (10.0 ** (lo + u * (hi - lo)) * scale)
        elif spec[0] == "exp":
            lam, w = np.array([spec[1]]), np.array([1.0])
        else:
            lam, w = np.array([0.0]), np.array([1.0])
        idx = np.arange(len(lam_all), len(lam_all) + lam.size)
        state_of.append(idx)
        entry_w.append(w)
        lam_all.extend(lam.tolist())
    lam_s = np.asarray(lam_all, np.float64)
    s = lam_s.size
    a = np.zeros((s, s), np.float64)
    a[np.arange(s), np.arange(s)] = -lam_s
    # Per-state outflow fractions (sum to 1 for decaying states): the
    # branch probability times the child's arrival quadrature weight.
    out_frac: list[list[tuple[int, float]]] = [[] for _ in range(s)]
    for p, c, prob in edges:
        for sp in state_of[p]:
            a[state_of[c], sp] += lam_s[sp] * prob * entry_w[c]
            for sc, wc in zip(state_of[c], entry_w[c]):
                out_frac[sp].append((int(sc), prob * float(wc)))
    return nodes, a, state_of, entry_w, lam_s, out_frac


def _expm_taylor(m: np.ndarray) -> np.ndarray:
    """Matrix exponential by scaling-and-squaring + Taylor, for where scipy
    is missing; it stays finite for defective rate matrices."""
    norm = float(np.linalg.norm(m, 1))
    k = max(0, int(np.ceil(np.log2(norm)))) + 1 if norm > 1e-300 else 0
    a = m / (2.0 ** k)
    out = np.eye(m.shape[0])
    term = np.eye(m.shape[0])
    for i in range(1, 40):
        term = term @ a / i
        out = out + term
        if np.abs(term).max() < 1e-18:
            break
    for _ in range(k):
        out = out @ out
    return out


_FAST_LAMT = 1e4  # λ·t above this → exp(-λ·t) ≡ 0 in f64 (e^-1e4 underflows)


def _expanded_pops(z: int, n: int, times: np.ndarray, max_nodes: int, quad: int):
    """Shared solver: expanded-state populations at each time.

    A state with λ·t > ``_FAST_LAMT`` is numerically empty at time t and
    acts as an instantaneous router: its inflow is forwarded to its slow
    descendants through the outflow fractions (an O(1/(λ·t)) ≤ ~1e-4
    approximation), which also keeps expm well-conditioned at geological
    times. The forwarding recursion assumes an acyclic graph: it does not
    end on a self-looping node (Tc-99m), as in the JAX package.

    Returns ``(nodes, state_of, lam_s, pops, times)`` with ``pops`` of
    shape (T, S) over expanded states.
    """
    try:
        from scipy.linalg import expm
    except ImportError:  # pragma: no cover - scipy is installed where the port runs
        expm = _expm_taylor

    nodes, a, state_of, entry_w, lam_s, out_frac = _expanded_decay_graph(
        z, n, max_nodes=max_nodes, quad=quad
    )
    times = np.asarray(times, np.float64)
    s = lam_s.size
    n0 = np.zeros(s, np.float64)
    n0[state_of[0]] = entry_w[0]
    pops = np.empty((times.size, s), np.float64)
    for ti, t in enumerate(times.reshape(-1)):
        t = float(t)
        fast = lam_s * t > _FAST_LAMT
        if not fast.any():
            pops[ti] = np.real(expm(a * t) @ n0)
            continue
        memo: dict[int, list[tuple[int, float]]] = {}

        def route(si: int) -> list[tuple[int, float]]:
            if not fast[si]:
                return [(si, 1.0)]
            got = memo.get(si)
            if got is None:
                acc: dict[int, float] = {}
                for sc, f in out_frac[si]:
                    for st2, f2 in route(sc):
                        acc[st2] = acc.get(st2, 0.0) + f * f2
                got = memo[si] = list(acc.items())
            return got

        slow = np.flatnonzero(~fast)
        pos = {int(si): j for j, si in enumerate(slow)}
        n0r = np.zeros(slow.size, np.float64)
        for si in range(s):
            if n0[si]:
                for st2, f in route(si):
                    n0r[pos[st2]] += n0[si] * f
        ar = np.zeros((slow.size, slow.size), np.float64)
        for j, si in enumerate(slow):
            si = int(si)
            ar[j, j] = -lam_s[si]
            for sc, f in out_frac[si]:
                for st2, f2 in route(sc):
                    ar[pos[st2], j] += lam_s[si] * f * f2
        row = np.zeros(s, np.float64)
        row[slow] = np.real(expm(ar * t) @ n0r)
        pops[ti] = row
    return nodes, state_of, lam_s, np.clip(pops, 0.0, 1.0), times


def bateman_populations(
    z: int, n: int, times: np.ndarray, max_nodes: int = 128, quad: int = 32
) -> dict:
    """Expected population fractions of every isotope in the decay chain of
    (z, n) at ``times``: the theory curve for :func:`chain_populations`
    (same ``{"times", "populations"}`` shape, as fractions of the initial
    ensemble). Solves dN/dt = A·N by matrix exponential over the expanded
    graph (:func:`_expanded_decay_graph`), so estimated nodes are the exact
    mixture expectation.
    """
    nodes, state_of, _lam_s, pops, times = _expanded_pops(z, n, times, max_nodes, quad)
    return {
        "times": times,
        "populations": {
            f"{zz}:{nn}": pops[:, state_of[j]].sum(axis=-1)
            for j, (zz, nn) in enumerate(nodes)
        },
    }


def bateman_activity(z: int, n: int, times: np.ndarray, max_nodes: int = 128) -> dict:
    """Expected activity A_i(t) = λ_i·N_i(t) (decays per second per initial
    nucleus) of every isotope in the chain of (z, n), in the shape of
    :func:`bateman_populations`; estimated nodes sum λ_m·N_m(t) over their
    sub-states."""
    nodes, state_of, lam_s, pops, times = _expanded_pops(z, n, times, max_nodes, quad=32)
    return {
        "times": times,
        "populations": {
            f"{zz}:{nn}": (pops[:, state_of[j]] * lam_s[state_of[j]]).sum(axis=-1)
            for j, (zz, nn) in enumerate(nodes)
        },
    }


def decay_rate_summary(result: SurvivalResult) -> dict:
    """Compact JSON-able summary of a survival run."""
    return {
        "isotope": f"{result.z}:{result.n}",
        "batch": result.batch,
        "tabulated_half_life_s": result.tabulated_half_life,
        "fitted_half_life_s": result.fitted_half_life,
        "rel_error": result.rel_error,
        "final_survival": float(result.survival[-1]),
        "decay_counts": result.decay_counts.tolist(),
    }
