"""The decay kernels' per-nucleus arithmetic (``csrc/decay_math.cuh``),
compiled for the CPU with g++ through a small C shim, against the port's
plain PyTorch version. ``pq_decay_stats_frame_nucleus`` (a frame of one
substep or of ten, its keys split from the member's rng) is the whole body
of the CUDA kernel, so a wrong branch, slot, bit, key or draw shows up here
without a GPU; the key split is also held to ``jax.random.split``.

Draws (threefry2x32 and the uniform mantissa trick) and every integer field,
the bitfield words included, must be bitwise equal. Floats go through exp
and log, which round differently in glibc and in torch's vectorised CPU
kernels: 1e-6 relative, inf == inf. The seeds are ones where no Bernoulli
draw sits within ULPs of its probability; a case that does is printed.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from pyqmd_tpu_torch import prng
from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core import decay
from pyqmd_tpu_torch.core.dynamics import FrameDynamics
from pyqmd_tpu_torch.core.init import ensemble_init, mixed_ensemble_init
from pyqmd_tpu_torch.data import tables
from pyqmd_tpu_torch.kernels.decay import DECAY_FIELDS, _plain_substep, decay_stats_frame
from pyqmd_tpu_torch.state import state_to_numpy

CSRC = Path(__file__).resolve().parent.parent / "pyqmd_tpu_torch" / "csrc"

SHIM = r"""
#include "decay_math.cuh"

extern "C" {
void shim_decay_frame(void* z, void* n, void* cc, void* hl, const void* tp, void* ld,
                      void* counts, void* ab, void* pb, void* cz0, void* cn0, void* cdt,
                      void* cz1, void* cn1, void* ct, const void* rng, void* next_rng,
                      const void* rows, int B, int W, int C, float step_time, int num_steps) {
  const PqDecayView v = pq_decay_view(z, n, cc, hl, tp, ld, counts, ab, pb, cz0, cn0, cdt, cz1,
                                      cn1, ct, rng, rows, W, C, step_time);
  for (int64_t i = 0; i < B; ++i) pq_decay_stats_frame_nucleus(v, i, num_steps, (int64_t*)next_rng);
}

void shim_split(const int64_t* keys, int B, int m, int64_t* out) {
  for (int i = 0; i < B; ++i)
    for (int c = 0; c < m; ++c) {
      uint32_t o1, o2;
      pq_split_key((uint32_t)keys[2 * i], (uint32_t)keys[2 * i + 1], (uint32_t)c, &o1, &o2);
      out[(i * m + c) * 2] = o1;
      out[(i * m + c) * 2 + 1] = o2;
    }
}

void shim_uniform(const int64_t* keys, int B, int m, float* out) {
  for (int i = 0; i < B; ++i)
    for (int c = 0; c < m; ++c)
      out[i * m + c] = pq_uniform((uint32_t)keys[2 * i], (uint32_t)keys[2 * i + 1], (uint32_t)c);
}

void shim_probability(const float* hl, int B, float dt, float* out) {
  for (int i = 0; i < B; ++i) out[i] = pq_decay_probability(hl[i], dt);
}

void shim_adjust(int64_t* ab, int64_t* pb, const int32_t* dtype, int B, int W) {
  for (int i = 0; i < B; ++i) pq_adjust_nucleons(ab + i * W, pb + i * W, W, dtype[i]);
}
}
"""

INT_CARRY = ("z", "n", "chain_cursor", "decay_counts", "chain_z0", "chain_n0",
             "chain_dtype", "chain_z1", "chain_n1")
FLOAT_CARRY = ("half_life", "last_decay_time", "chain_time")


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("decay_math")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run(
        [gxx, "-O2", "-ffp-contract=off", "-shared", "-fPIC", f"-I{CSRC}", str(d / "shim.cpp"),
         "-o", str(lib), "-lm"],
        check=True, capture_output=True, text=True,
    )
    return ctypes.CDLL(str(lib))


def _ptr(t: torch.Tensor):
    assert t.is_contiguous()
    return ctypes.c_void_p(t.data_ptr())


def _keys(rng, b) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, 2**32, (b, 2), dtype=np.int64))


def _hot_state(states, rng, step_time):
    """Half-lives around the substep (both probability regimes, tiny and
    stable ones), clocks for both duration records, cursors near
    wrap-around."""
    b = states.z.shape[0]
    hl = step_time * 10.0 ** rng.uniform(-3, 2.5, b)
    hl[rng.uniform(size=b) < 0.05] = np.inf
    hl[rng.uniform(size=b) < 0.05] = 1e-4
    tp_ = rng.choice([0.0, 5e-4, 50.0, 3e9], b)
    ld = np.where(rng.uniform(size=b) < 0.5, 0.0, tp_)
    c = states.chain_time.shape[-1]
    return states.replace(
        half_life=torch.from_numpy(hl.astype(np.float32)),
        time_passed=torch.from_numpy(tp_.astype(np.float32)),
        last_decay_time=torch.from_numpy(ld.astype(np.float32)),
        chain_cursor=torch.from_numpy(rng.integers(1, 3 * c, b).astype(np.int32)),
    )


def _carry_ptrs(carry, bits):
    return [
        *(_ptr(getattr(carry, f)) for f in ("z", "n", "chain_cursor", "half_life",
                                            "time_passed", "last_decay_time", "decay_counts")),
        _ptr(bits[0]), _ptr(bits[1]),
        *(_ptr(getattr(carry, f)) for f in ("chain_z0", "chain_n0", "chain_dtype", "chain_z1",
                                            "chain_n1", "chain_time")),
    ]


def _shim_frame(shim, carry, bits, rng, rows, step_time, num_steps):
    b, w = bits[0].shape
    next_rng = torch.empty_like(rng)
    shim.shim_decay_frame(*_carry_ptrs(carry, bits), _ptr(rng), _ptr(next_rng), _ptr(rows), b,
                          w, carry.chain_time.shape[-1], ctypes.c_float(step_time), num_steps)
    return next_rng


def _clone(carry, bits):
    return (carry.replace(**{f: getattr(carry, f).clone() for f in DECAY_FIELDS}),
            tuple(x.clone() for x in bits))


def _near_ties(u0, hl, step_time):
    p = decay.decay_probability(hl, step_time)
    return int((torch.abs(u0 - p) <= 4 * torch.finfo(torch.float32).eps * p).sum())


CASES = {
    # P=16, one word: β- only.
    "c14": lambda: ensemble_init(SimConfig.for_isotope(6, 8, pad_to=8, max_chain_log=8), 512,
                                 seed=0, device="cpu"),
    # P=256, eight words: α, β-, β+, p-emission and γ side by side.
    "mixed": lambda: mixed_ensemble_init(
        SimConfig(z=92, n=146, max_particles=256, max_chain_log=8),
        [(92, 146, 96), (82, 132, 96), (40, 50, 96), (25, 20, 96), (43, 56, 96)], seed=3,
        device="cpu"),
    # P=240: the last word half full.
    "u238": lambda: ensemble_init(SimConfig.for_isotope(92, 146, pad_to=8, max_chain_log=4), 256,
                                  seed=1, device="cpu"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_nucleus_transition_matches_plain(shim, case):
    """Six frames of one substep each, every one from fresh member keys:
    the substep runs under ``split(split(rng, 3)[:, 0], 1)[:, 0]``, and
    the next rng is ``split(rng, 3)[:, 2]``."""
    states = CASES[case]()
    cfg = SimConfig(z=int(states.z[0]), n=int(states.n[0]), max_particles=states.alive.shape[1],
                    max_chain_log=states.chain_time.shape[1])
    rng = np.random.default_rng(len(case))
    step_time = np.float32(1e6)
    dyn = FrameDynamics(np.float32(1.0), np.float32(1.0), np.float32(cfg.effective_dt()),
                        step_time, None)
    carry = _hot_state(states, rng, step_time)
    bits = decay.pack_nucleon_bits(states.alive, states.ptype)
    rows = tables.rows_on("cpu")
    fired = modes = 0
    for _ in range(6):
        frame_rng = _keys(rng, carry.z.shape[0])
        k3 = prng.split(frame_rng, 3)
        keys = prng.split(k3[:, 0], 1)[:, 0].contiguous()
        u0 = prng.uniform(keys, (1,))[:, 0]
        assert _near_ties(u0, carry.half_life, step_time) == 0, "a draw sits at its probability"
        want, want_bits = _clone(carry, bits)
        _plain_substep(want, want_bits, cfg, keys, dyn)
        got, got_bits = _clone(carry, bits)
        assert torch.equal(_shim_frame(shim, got, got_bits, frame_rng, rows, step_time, 1),
                           k3[:, 2])
        w, g = state_to_numpy(want), state_to_numpy(got)
        for f in INT_CARRY:
            np.testing.assert_array_equal(g[f], w[f], err_msg=f)
        for a, c in zip(got_bits, want_bits):
            assert torch.equal(a, c)
        for f in FLOAT_CARRY:
            tp.assert_rel_close(g[f], w[f], 1e-6, f)
        fired += int((want.chain_cursor != carry.chain_cursor).sum())
        modes |= sum(1 << m for m in want.chain_dtype.unique().tolist())
        carry, bits = want, want_bits
    assert fired > carry.z.shape[0] // 2
    if case == "mixed":
        assert modes & 0b1111110 == 0b1011110, bin(modes)  # α, β-, β+, γ, p


def test_split_key_is_jax_random_split_bitwise(shim):
    keys = _keys(np.random.default_rng(9), 257)
    out = torch.empty(257, 12, 2, dtype=torch.int64)
    shim.shim_split(_ptr(keys), 257, 12, _ptr(out))
    wrapped = jax.vmap(jax.random.wrap_key_data)(jnp.asarray(keys.numpy(), jnp.uint32))
    ref = jax.vmap(lambda k: jax.random.key_data(jax.random.split(k, 12)))(wrapped)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref).astype(np.int64))
    assert torch.equal(out, prng.split(keys, 12))


# name: (state, step time); the frames run 10 substeps on _hot_state's clock.
FRAME_CASES = {
    # β- into a stable daughter.
    "c14": (lambda: ensemble_init(SimConfig.for_isotope(6, 8, pad_to=8, max_chain_log=8), 512,
                                  seed=4, device="cpu"), 1e6),
    # β- into β- into a 164 µs α: several decays in one frame.
    "pb214": (lambda: ensemble_init(SimConfig.for_isotope(82, 132, pad_to=8, max_chain_log=8),
                                    512, seed=5, device="cpu"), 3e2),
    # P=240 (the last word half full), the 8-slot ring wrapping.
    "u238": (lambda: ensemble_init(SimConfig.for_isotope(92, 146, pad_to=8, max_chain_log=8), 256,
                                   seed=6, device="cpu"), 1e6),
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_frame_transition_matches_the_plain_frame(shim, case):
    """pq_decay_stats_frame_nucleus over every nucleus, 10 substeps from the
    members' rng, against the plain frame (the key tree, then maybe_decay
    per substep): every integer field, bitfield word and the next rng
    bitwise; a member's second decay in a frame sees its new half-life and
    (Z, N)."""
    make, step_time = FRAME_CASES[case]
    states = make()
    cfg = SimConfig(z=int(states.z[0]), n=int(states.n[0]), max_particles=states.alive.shape[1],
                    max_chain_log=states.chain_time.shape[1])
    rng = np.random.default_rng(100 + len(case))
    step_time = np.float32(step_time)
    dyn = FrameDynamics(np.float32(1.0), np.float32(10.0), np.float32(cfg.effective_dt()),
                        step_time, None)
    carry = _hot_state(states, rng, step_time)
    if case == "pb214":  # the parent within a substep, then the chain's own half-lives
        carry = carry.replace(half_life=states.half_life * 1e-3)
    bits = decay.pack_nucleon_bits(states.alive, states.ptype)
    frame_rng = _keys(rng, carry.z.shape[0])
    rows = tables.rows_on("cpu")

    # The plain frame, substep by substep, with its draws checked for ties.
    want, want_bits = _clone(carry, bits)
    k3 = prng.split(frame_rng, 3)
    for keys in prng.split(k3[:, 0], 10).transpose(0, 1).contiguous():
        u0 = prng.uniform(keys, (1,))[:, 0]
        assert _near_ties(u0, want.half_life, step_time) == 0, "a draw sits at its probability"
        _plain_substep(want, want_bits, cfg, keys, dyn)
    # The CPU wrapper of the frame kernel is that plain frame.
    wrapped, wrapped_bits = _clone(carry, bits)
    next_plain = decay_stats_frame(wrapped, wrapped_bits, frame_rng, cfg, dyn, 10)
    assert torch.equal(next_plain, k3[:, 2])
    for f in DECAY_FIELDS:
        assert torch.equal(getattr(wrapped, f), getattr(want, f)), f
    assert all(torch.equal(a, b) for a, b in zip(wrapped_bits, want_bits))

    got, got_bits = _clone(carry, bits)
    next_rng = _shim_frame(shim, got, got_bits, frame_rng, rows, step_time, 10)
    assert torch.equal(next_rng, k3[:, 2])
    w, g = state_to_numpy(want), state_to_numpy(got)
    for f in INT_CARRY:
        np.testing.assert_array_equal(g[f], w[f], err_msg=f)
    for a, c in zip(got_bits, want_bits):
        assert torch.equal(a, c)
    for f in FLOAT_CARRY:
        tp.assert_rel_close(g[f], w[f], 1e-6, f)
    fired = want.chain_cursor - carry.chain_cursor
    assert int((fired > 0).sum()) > carry.z.shape[0] // 4
    if case != "c14":
        assert int((fired > 1).sum()) > 0  # second decays in the frame
    c = cfg.max_chain_log
    assert int(((carry.chain_cursor // c) != (want.chain_cursor // c)).sum()) > 0  # ring wraps


def test_uniforms_are_jax_random_uniform_bitwise(shim):
    keys = _keys(np.random.default_rng(7), 333)
    out = torch.empty(333, 11)
    shim.shim_uniform(_ptr(keys), 333, 11, _ptr(out))
    assert torch.equal(out, prng.uniform(keys, (11,)))


def test_decay_probability_matches_plain(shim):
    rng = np.random.default_rng(8)
    hl = (10.0 ** rng.uniform(-35, 35, 4000)).astype(np.float32)
    hl[:5] = [np.inf, 0.0, 1e-40, 1.0, 100.0]
    hl = torch.from_numpy(hl)
    for dt in (1e-6, 1.0, 1e10, 1.75e16):
        out = torch.empty_like(hl)
        shim.shim_probability(_ptr(hl), hl.numel(), ctypes.c_float(dt), _ptr(out))
        # 1 - exp(x) cancels: a last-bit difference of exp near 1 is up to
        # two ULPs of 1.0 absolute in p.
        np.testing.assert_allclose(out.numpy(), decay.decay_probability(hl, np.float32(dt)).numpy(),
                                   rtol=1e-6, atol=2 * np.finfo(np.float32).eps, err_msg=str(dt))


@pytest.mark.parametrize("w", [1, 3, 8])
def test_bitfield_adjustment_matches_plain(shim, w):
    rng = np.random.default_rng(w)
    b = 2000
    ab = torch.from_numpy(rng.integers(0, 2**32, (b, w), dtype=np.int64))
    ab[rng.uniform(size=(b, w)) < 0.3] = 0  # empty words: the scan carries over
    pb = torch.from_numpy(rng.integers(0, 2**32, (b, w), dtype=np.int64))
    dtype = torch.from_numpy(rng.integers(1, 8, b).astype(np.int32))
    got_a, got_p = ab.clone(), pb.clone()
    shim.shim_adjust(_ptr(got_a), _ptr(got_p), _ptr(dtype), b, w)
    rm_p = decay._lut(decay._REMOVE_P, dtype)
    rm_n = decay._lut(decay._REMOVE_N, dtype)
    apb, anb = ab & pb, ab & ~pb
    kill = decay._lowest_set_bits(apb, rm_p) | decay._lowest_set_bits(anb, rm_n)
    want_a = ab & ~kill
    bm = (dtype == 2)[:, None]
    bp = (dtype == 3)[:, None]
    want_p = (pb | torch.where(bm, decay._first_set_bit(anb), 0)) & ~torch.where(
        bp, decay._first_set_bit(apb), 0)
    assert torch.equal(got_a, want_a) and torch.equal(got_p, want_p)
    assert not torch.equal(got_a, ab) and not torch.equal(got_p, pb)
