"""Device kernel ms per full-physics frame of an ensemble outside the port's
named kernels (force, overlap, decay) and NCCL's: the key tree, ejecta,
decay checks, clock, copies into and out of the graph, metrics."""

SPANS = ("bench.frame", "bench.sharded_frame")
NAMED = ("force_step_kernel", "force_small_kernel", "overlap_step_kernel", "decay_stats",
         "nccl", "Nccl")


def read(trace):
    frames = trace.info.get("frames")
    ms = trace.kernel_ms(SPANS, exclude=NAMED)
    return ms / frames if frames and ms else None
