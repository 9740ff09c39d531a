"""Device kernels per full-physics frame of an ensemble: those launched
under ``bench.frame`` or ``bench.sharded_frame``, NCCL's excluded, over the
traced frames (a count)."""

SPANS = ("bench.frame", "bench.sharded_frame")


def read(trace):
    frames = trace.info.get("frames")
    n = sum(len([k for k in trace.kernels(span) if "nccl" not in k.name.lower()])
            for span in SPANS)
    return n / frames if frames and n else None
