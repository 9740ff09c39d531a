"""Share of the overlap kernel's roofline (``csrc/overlap.cu``): the least
time of one projection over the window's alive pairs and the pairs in range
at the window's end, over the profiled time per launch of
``overlap_step_kernel``."""

from benchmark import roofline


def read(trace):
    launches = trace.kernels(name="overlap_step_kernel")
    if not launches or "overlap_pairs_in_range" not in trace.info:
        return None
    per_launch_ms = 1e3 * sum(k.seconds for k in launches) / len(launches)
    bound_ms, _ = roofline.overlap_ms(trace.info["alive_pairs"],
                                      trace.info["overlap_pairs_in_range"], trace.info["slots"])
    return roofline.share_pct(bound_ms, per_launch_ms)
