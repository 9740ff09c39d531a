"""The yardstick of the kernels' rooflines: one NVIDIA H100 SXM's published
peaks and the least time each kernel's work needs.

A kernel's work is counted from the inputs of the window it ran in (alive
pairs, nuclei, substeps, decays), never from how the kernel does it, so a
later change that fuses or renames a kernel leaves the count as it is.
The least time is the larger of bytes over the memory rate and each
operation count over its peak; a roofline share is that time over the
measured time per launch.

Peaks: NVIDIA's H100 SXM data sheet and Hopper white paper, at the full
power limit of 700 W (a card set lower runs slower under load: the result
line names the card's limit).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# Special-function unit: 16 per SM per clock, 132 SMs at 1.98 GHz boost.
SFU_OPS = 16 * 132 * 1.98e9
# Integer work issues on two pipes: 64 lanes per SM per clock in the
# integer ALU and 64 in the FMA pipe as IMAD.
INT32_OPS = 128 * 132 * 1.98e9

# Force kernel: 40 f32 operations and 3 transcendentals per alive pair
# (reference forces_pallas.py:474, 485); pos, vel, ptype, alive in and
# pos, vel out, 37 bytes per slot.
FORCE_FLOPS_PER_PAIR, FORCE_SFU_PER_PAIR, FORCE_BYTES_PER_SLOT = 40, 3, 37
# Overlap kernel: every alive pair takes the range test (6 flops); a pair in
# range adds the push (15 flops, 3 transcendentals); every slot a cos and a
# sin; pos, alive, u in and pos out, 21 bytes per slot.
OVERLAP_FLOPS_PER_PAIR, OVERLAP_FLOPS_PER_HIT, OVERLAP_SFU_PER_HIT = 6, 15, 3
OVERLAP_SFU_PER_SLOT, OVERLAP_BYTES_PER_SLOT = 2, 21
# Decay-statistics frame: every nucleus reads its rng and half-life and
# writes its next rng (36 bytes) and hashes 2 + 2 x substeps threefry blocks
# (two frame splits, a key split and a Bernoulli uniform per substep); a
# decay adds 40 + 16 W bytes (W bitfield words) and three hashes.
THREEFRY_INT_OPS = 80  # 20 rounds of add, rotate, xor plus 5 key injections
DECAY_BYTES_PER_NUCLEUS, DECAY_HASHES_PER_DECAY = 36, 3


def least_ms(nbytes: float = 0.0, flops: float = 0.0, sfu: float = 0.0,
             int_ops: float = 0.0) -> tuple[float, str]:
    """The least time for the work in ms, and what sets it."""
    ms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "f32": flops / F32_FLOPS * 1e3,
          "sfu": sfu / SFU_OPS * 1e3, "int32": int_ops / INT32_OPS * 1e3}
    by = max(ms, key=ms.get)
    return ms[by], by


def force_ms(alive_pairs: float, slots: int) -> tuple[float, str]:
    """One force + integrate step over ``slots`` nucleon slots holding
    ``alive_pairs`` pairs of alive nucleons."""
    return least_ms(slots * FORCE_BYTES_PER_SLOT, flops=FORCE_FLOPS_PER_PAIR * alive_pairs,
                    sfu=FORCE_SFU_PER_PAIR * alive_pairs)


def overlap_ms(alive_pairs: float, in_range: float, slots: int) -> tuple[float, str]:
    """One overlap projection."""
    return least_ms(slots * OVERLAP_BYTES_PER_SLOT,
                    flops=OVERLAP_FLOPS_PER_PAIR * alive_pairs + OVERLAP_FLOPS_PER_HIT * in_range,
                    sfu=OVERLAP_SFU_PER_HIT * in_range + OVERLAP_SFU_PER_SLOT * slots)


def decay_frame_ms(nuclei: int, substeps: int, decays: float, words: int) -> tuple[float, str]:
    """One decay-statistics frame of ``substeps`` substeps over ``nuclei``
    nuclei in which ``decays`` decays happen."""
    hashes = nuclei * (2 + 2 * substeps) + DECAY_HASHES_PER_DECAY * decays
    return least_ms(nuclei * DECAY_BYTES_PER_NUCLEUS + decays * (40 + 16 * words),
                    int_ops=THREEFRY_INT_OPS * hashes)


def alive_pairs(alive) -> float:
    """Pairs of alive nucleons in a (B, P) alive mask: sum of a(a-1)/2."""
    a = alive.sum(-1).double()
    return float((a * (a - 1) / 2).sum())


def pairs_in_range(pos, alive, min_dist: float, block: int = 512) -> float:
    """Pairs of alive nucleons closer than ``min_dist`` (the overlap
    projection's pushes), counted in blocks of members."""
    import torch

    total = 0
    p = alive.shape[-1]
    upper = torch.ones(p, p, dtype=torch.bool, device=alive.device).triu(1)
    for s in range(0, pos.shape[0], block):
        x, a = pos[s:s + block], alive[s:s + block]
        d = x[:, None] - x[:, :, None]
        both = a[:, None] & a[:, :, None] & upper
        total += int(((d * d).sum(-1) < min_dist * min_dist)[both].sum())
    return float(total)


def share_pct(bound_ms: float, measured_ms: float) -> float:
    """A roofline share in percent: the least time over the measured."""
    return 100.0 * bound_ms / measured_ms
