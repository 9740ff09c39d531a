"""Share of the traced window of whole half-life fits in which no operation
ran on the device: 1 - union of device intervals over the window."""


def read(trace):
    return trace.idle_pct()
