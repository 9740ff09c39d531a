"""Nucleon overlap resolution: the plain PyTorch version.

One Jacobi projection of ``pyqmd_tpu.core.overlap._resolve_once`` (the
reformulation of the reference's host-side sweep, nuclear_sim.py:355-379):
every alive pair closer than ``overlap_min_dist`` is pushed apart by half
its overlap along the unit offset, all against the same snapshot, and the
per-particle sum is capped at half the separation distance. Coincident
pairs (dist < 0.001) separate along the angle ``u_i + u_j``, from a (P,)
uniform draw through the angle-sum identity, with the sign flipped on the
``j < i`` side so the two sides push oppositely.

This is the version CPU tensors run
(:func:`pyqmd_tpu_torch.kernels.overlap.overlap_step` dispatches here) and
the oracle the CUDA kernel is held against.
"""

from __future__ import annotations

import math

import torch

from pyqmd_tpu_torch import prng
from pyqmd_tpu_torch.config import SimConfig
from pyqmd_tpu_torch.core.forces import _rdiv, chunk_plan, sqrt_rn


def _rand_u(keys: torch.Tensor, p: int) -> torch.Tensor:
    """Per-particle degenerate-separation angles for one Jacobi pass:
    (..., P) from (..., 2) keys."""
    return prng.uniform(keys, (p,), maxval=2.0 * math.pi)


def overlap_push(dx, dy, dist2, cs, ss, md: float):
    """Displacement that one in-range pair applies along its direction:
    ``(push·dir_x, push·dir_y)``. ``(cs, ss)`` is the signed random
    direction used when the pair is coincident."""
    dist = sqrt_rn(torch.clamp(dist2, min=1e-12))
    degen = dist < 0.001
    dir_x = torch.where(degen, cs, dx / dist)
    dir_y = torch.where(degen, ss, dy / dist)
    push = (md - torch.where(degen, 0.001, dist)) * 0.5
    return push * dir_x, push * dir_y


def _resolve_once(pos, alive, u, cfg: SimConfig):
    """One Jacobi pass over (..., P, 2) positions with angles ``u`` (..., P)."""
    p = pos.shape[-2]
    md = cfg.overlap_min_dist
    d = pos[..., None, :, :] - pos[..., :, None, :]  # d[i, j] = pos_j - pos_i
    dist2 = (d * d).sum(-1)
    eye = torch.eye(p, dtype=torch.bool, device=pos.device)
    pair = alive[..., :, None] & alive[..., None, :] & ~eye & (dist2 < md * md)

    # cos/sin(u_i + u_j) by the angle-sum identity, sign-flipped below the
    # diagonal (cos(s + pi) = -cos(s)).
    cu, su = torch.cos(u), torch.sin(u)
    cs = cu[..., :, None] * cu[..., None, :] - su[..., :, None] * su[..., None, :]
    ss = su[..., :, None] * cu[..., None, :] + cu[..., :, None] * su[..., None, :]
    idx = torch.arange(p, device=pos.device)
    sign = torch.where(idx[:, None] < idx[None, :], 1.0, -1.0)
    push_x, push_y = overlap_push(d[..., 0], d[..., 1], dist2, sign * cs, sign * ss, md)

    # Cap the summed correction at half the separation distance: an
    # uncapped Jacobi sum overshoots by the neighbour count in a dense
    # cluster.
    delta_x = -torch.where(pair, push_x, 0.0).sum(-1)
    delta_y = -torch.where(pair, push_y, 0.0).sum(-1)
    delta = torch.stack([delta_x, delta_y], dim=-1)
    mag = sqrt_rn((delta * delta).sum(-1, keepdim=True))
    delta = delta * torch.clamp(_rdiv(md * 0.5, torch.clamp(mag, min=1e-9)), max=1.0)
    return pos + torch.where(alive[..., None], delta, 0.0)


def resolve_overlaps(pos, alive, u, cfg: SimConfig, *, max_chunk: int = 1024):
    """One Jacobi pass over a batch (B, P, 2) with angles ``u`` (B, P).
    Batches above ``max_chunk`` run in ``chunk_plan`` chunks, bounding the
    (chunk, P, P) pair temporaries."""
    b = pos.shape[0]
    if b <= max_chunk:
        return _resolve_once(pos, alive, u, cfg)
    _, chunk, _ = chunk_plan(b, max_chunk)
    return torch.cat([
        _resolve_once(pos[s:s + chunk], alive[s:s + chunk], u[s:s + chunk], cfg)
        for s in range(0, b, chunk)
    ])
