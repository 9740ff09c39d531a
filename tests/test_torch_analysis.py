"""The port's ensemble analysis against ``pyqmd_tpu.analysis``: the same
seeds give the same survival counts and chain populations exactly, and the
host-side graph and Bateman solvers agree to 1e-12 relative. Tc-99m stays
out of the Bateman cases: the reference's forwarding recursion does not end
on its self-looping node, and the port keeps that behaviour.
"""

import math

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (caps torch threads)
from pyqmd_tpu import analysis as jax_analysis
from pyqmd_tpu.data.tables import half_life_host as jax_half_life_host
from pyqmd_tpu_torch import analysis
from pyqmd_tpu_torch.data.tables import half_life_host


@pytest.mark.parametrize("zn,batch,frames,half_lives,seed,decay_only", [
    ((6, 8), 256, 5, 2.0, 3, True),
    ((82, 132), 128, 4, 3.0, 0, True),
    ((6, 8), 32, 2, 2.0, 1, False),
])
def test_survival_curve_matches_the_reference(zn, batch, frames, half_lives, seed, decay_only):
    kw = dict(batch=batch, frames=frames, half_lives=half_lives, seed=seed,
              decay_only=decay_only)
    ref = jax_analysis.survival_curve(*zn, **kw)
    got = analysis.survival_curve(*zn, **kw, device="cpu")
    np.testing.assert_array_equal(got.times, ref.times)
    np.testing.assert_array_equal(got.survival, ref.survival)
    np.testing.assert_array_equal(got.decay_counts, np.asarray(ref.decay_counts))
    assert got.fitted_half_life == ref.fitted_half_life
    assert got.survival[-1] < 1.0
    assert got.to_csv() == ref.to_csv()
    assert analysis.decay_rate_summary(got) == jax_analysis.decay_rate_summary(ref)


def test_survival_curve_guards():
    with pytest.raises(ValueError):
        analysis.survival_curve(2, 2, device="cpu")  # He-4 is stable
    with pytest.raises(ValueError):
        analysis.survival_curve(6, 8, batch=16, frames=0, device="cpu")
    with pytest.raises(ValueError):
        analysis.survival_curve(6, 8, batch=16, frames=2, overrides={"max_particles": 4},
                                device="cpu")
    # Tc-99m's branches re-enter (43, 56): survival stays 1, the fit is inf.
    res = analysis.survival_curve(43, 56, batch=32, frames=2, device="cpu")
    assert res.survival[-1] == 1.0 and math.isinf(res.fitted_half_life)


@pytest.mark.parametrize("zn,batch,frames,half_lives,seed", [
    ((86, 136), 256, 8, 2.0, 1),
    ((92, 146), 128, 6, 3.0, 0),
])
def test_chain_populations_match_the_reference(zn, batch, frames, half_lives, seed):
    kw = dict(batch=batch, frames=frames, half_lives=half_lives, seed=seed)
    ref = jax_analysis.chain_populations(*zn, **kw)
    got = analysis.chain_populations(*zn, **kw, device="cpu")
    assert got["times"] == ref["times"]
    assert got["populations"] == ref["populations"]
    assert analysis.chain_populations_csv(got) == jax_analysis.chain_populations_csv(ref)
    for t in range(len(got["times"])):
        assert sum(v[t] for v in got["populations"].values()) == batch
    assert sum(v[-1] for k, v in got["populations"].items() if k != f"{zn[0]}:{zn[1]}") > 0


@pytest.mark.parametrize("zn", [(92, 146), (6, 8), (86, 136)])
def test_decay_chain_graph_matches_the_reference(zn):
    nodes, a = analysis.decay_chain_graph(*zn)
    ref_nodes, ref_a = jax_analysis.decay_chain_graph(*zn)
    assert nodes == ref_nodes
    np.testing.assert_allclose(a, ref_a, rtol=1e-12, atol=0)


@pytest.mark.parametrize("zn,times", [
    ((92, 146), [0.0, 1e9, 1e15, 1.4e17, 4.2e17]),
    ((6, 8), [0.0, 1e10, 1.8e11, 5e11]),
])
def test_bateman_solvers_match_the_reference(zn, times):
    times = np.asarray(times)
    for ours, theirs in ((analysis.bateman_populations, jax_analysis.bateman_populations),
                         (analysis.bateman_activity, jax_analysis.bateman_activity)):
        got, ref = ours(*zn, times), theirs(*zn, times)
        np.testing.assert_array_equal(got["times"], ref["times"])
        assert got["populations"].keys() == ref["populations"].keys()
        for k, v in ref["populations"].items():
            np.testing.assert_allclose(got["populations"][k], v, rtol=1e-12, atol=0, err_msg=k)
    np.testing.assert_allclose(analysis._expm_taylor(np.diag([-1.0, -2.0])),
                               np.diag(np.exp([-1.0, -2.0])), rtol=1e-12)


def test_half_life_host_matches_the_reference():
    for z, n in ((6, 8), (92, 146), (2, 2), (40, 50), (25, 20), (100, 160)):
        for u in (0.0, 0.5, 0.93):
            assert half_life_host(z, n, u) == jax_half_life_host(z, n, u)
