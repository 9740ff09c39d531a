"""Device ms per live-view picture: the kernels launched under
``bench.render`` (the rasterizer and the palette match), per frame."""


def read(trace):
    frames = trace.info.get("frames")
    ms = trace.kernel_ms(("bench.render",))
    return ms / frames if frames and ms else None
