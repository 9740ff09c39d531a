"""Rank 0's NCCL kernel ms per sharded frame: the all-reduce of the
aggregates, including its wait for the slowest rank."""


def read(trace):
    frames = trace.info.get("frames")
    ms = 1e3 * sum(k.seconds for k in trace.ops if k.cat == "kernel" and "nccl" in k.name.lower())
    return ms / frames if frames and ms else None
