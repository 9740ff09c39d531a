"""Share of the traced window of live-view frames (frame, picture,
readback) in which no operation ran on the device: 1 - union of device
intervals over the window."""


def read(trace):
    return trace.idle_pct()
