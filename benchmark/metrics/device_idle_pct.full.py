"""Share of the traced window of ensemble frames in which no operation ran
on the device (rank 0's card on four): 1 - union of device intervals over
the window."""


def read(trace):
    return trace.idle_pct()
