"""Device kernel ms per half-life fit outside the decay frame kernel:
ensemble init, the carry's clone, bitfield pack and unpack, metrics and
the per-frame survivor counts."""


def read(trace):
    fits = trace.info.get("fits")
    ms = trace.kernel_ms(("bench.fit",), exclude=("decay_stats_frame_kernel",))
    return ms / fits if fits and ms else None
