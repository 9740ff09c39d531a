"""Host ms per ``Simulation.frame()`` call of the live view (schedule,
dispatch of the graph replay, retire): the mean duration, on the host's
clock, of the benchmark's own ``bench.frame`` spans around the call (the
program has no span of its own there yet)."""


def read(trace):
    spans = trace.span_seconds("bench.frame")
    return 1e3 * sum(spans) / len(spans) if spans else None
