"""Share of the sub-warp force kernel's roofline (``csrc/forces_small.cu``,
P <= 32): the least time of one step over the window's alive pairs (mean of
the pairs at its start and its end), over the profiled time per launch of
``force_small_kernel``."""

from benchmark import roofline


def read(trace):
    launches = trace.kernels(name="force_small_kernel")
    if not launches or "alive_pairs" not in trace.info:
        return None
    per_launch_ms = 1e3 * sum(k.seconds for k in launches) / len(launches)
    bound_ms, _ = roofline.force_ms(trace.info["alive_pairs"], trace.info["slots"])
    return roofline.share_pct(bound_ms, per_launch_ms)
