"""The port's host-only helpers against the JAX package's: the formatters
and element tables over the reference tests' inputs and a sweep (equal
strings), and the step timer, fence and trace context of
``utils/profiling.py``."""

import json
import math
import time

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (caps torch threads)
from pyqmd_tpu.data import elements as jax_elements
from pyqmd_tpu.utils import format as jax_format
from pyqmd_tpu_torch.data import elements
from pyqmd_tpu_torch.utils import format as fmt
from pyqmd_tpu_torch.utils import profiling

YEAR = 31557600.0
TIMES = [0, 2.5e-16, 2.5e-13, 3.53 * 86400, 164.3e-6, 5730 * YEAR, 30, 90, 1e10, 10.0,
         float("inf"), 1e-22, 7e-9, 3e-3, 59.9, 3599, 86399, 2.6e6, 4.47e9 * YEAR, 1e25, -5.0]


@pytest.mark.parametrize("name", ["format_time_value_with_unit", "format_time_value",
                                  "format_half_life", "format_time_scale"])
def test_formatters_equal_the_reference(name):
    ref, got = getattr(jax_format, name), getattr(fmt, name)
    values = TIMES + np.logspace(-24, 26, 101).tolist()
    if name == "format_time_scale":
        values = [v for v in values if v > 0 and math.isfinite(v)]
    for v in values:
        assert got(v) == ref(v), (name, v)


def test_format_reference_examples():
    assert fmt.format_time_value_with_unit(164.3e-6) == "164.30 μs"
    assert fmt.format_time_scale(31557600000000000.0) == "1.0 billion years/s"
    assert fmt.format_half_life(float("inf")) == ("Stable", "stable")
    assert fmt.format_time_value(90)[1] == "minutes"


@pytest.mark.parametrize("text", ["1e9yr", "5day", "2h", "3600", "min", "1.5e-3s", "7y", "2.5"])
def test_parse_time_scale_equals_the_reference(text):
    try:
        want = jax_format.parse_time_scale(text)
    except ValueError:
        with pytest.raises(ValueError):
            fmt.parse_time_scale(text)
        return
    assert fmt.parse_time_scale(text) == want


def test_parse_time_scale_rejects_garbage_like_the_reference():
    for text in ("fast", "", "1e9 parsecs"):
        with pytest.raises(ValueError):
            jax_format.parse_time_scale(text)
        with pytest.raises(ValueError):
            fmt.parse_time_scale(text)


def test_element_tables_equal_the_reference():
    for z in range(0, 121):
        assert elements.element_symbol(z) == jax_elements.element_symbol(z)
        assert elements.element_name(z) == jax_elements.element_name(z)
        assert elements.isotope_label(z, z + 3) == jax_elements.isotope_label(z, z + 3)


@pytest.mark.parametrize("spec", ["U-238", "C14", "92:146", "he-4", "Pb214", "u238"])
def test_parse_isotope_equals_the_reference(spec):
    assert elements.parse_isotope(spec) == jax_elements.parse_isotope(spec)


@pytest.mark.parametrize("spec", ["Xx-999", "", "238", "U-"])
def test_parse_isotope_rejects_what_the_reference_rejects(spec):
    with pytest.raises(ValueError):
        jax_elements.parse_isotope(spec)
    with pytest.raises(ValueError):
        elements.parse_isotope(spec)


def test_step_timer_counts_steps_per_second():
    t = profiling.StepTimer(window=3)
    assert not t.primed and t.steps_per_sec == 0.0
    t.start()
    assert t.primed
    for _ in range(5):
        time.sleep(0.01)
        rate = t.lap(torch.zeros(3), steps=4)
    assert len(t.times) == 3  # rolling window
    assert 4 / 0.1 < rate < 4 / 0.01 * 1.01
    t.reset()
    assert not t.primed and t.steps_per_sec == 0.0
    assert t.lap() == 0.0 and t.primed  # the first lap only sets the mark


def test_fence_accepts_cpu_results_without_a_card():
    profiling.fence(torch.ones(2))
    profiling.fence({"a": torch.ones(2), "b": 3})
    profiling.fence([torch.ones(1), torch.zeros(1)])


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.annotate("the_marked_region"):
            torch.ones(8).sum()
    data = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in data["traceEvents"]}
    assert "the_marked_region" in names
