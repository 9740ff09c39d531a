"""Share of the decay-statistics frame kernel's roofline (``csrc/decay.cu``):
the int32 least time of one frame from the nuclei, the substeps and the
decays per frame of the traced fits, over the profiled time per launch of
``decay_stats_frame_kernel``."""

from benchmark import roofline


def read(trace):
    launches = trace.kernels(name="decay_stats_frame_kernel")
    info = trace.info
    if not launches or "nuclei" not in info:
        return None
    per_launch_ms = 1e3 * sum(k.seconds for k in launches) / len(launches)
    bound_ms, _ = roofline.decay_frame_ms(info["nuclei"], info["substeps"],
                                          info["decays"] / len(launches), info["words"])
    return roofline.share_pct(bound_ms, per_launch_ms)
