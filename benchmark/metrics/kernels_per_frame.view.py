"""Device kernels per full-physics frame of the lone nucleus of the live
view: those launched under ``bench.frame``, over the traced frames (a
count)."""


def read(trace):
    frames = trace.info.get("frames")
    n = len(trace.kernels("bench.frame"))
    return n / frames if frames and n else None
