"""Per-spike radial clustering: the shadow-mitigation voxel bounds.

Semantics of ``icet_tpu/ops/clustering.py``: sort the points by
(voxel id, range); consecutive points whose radial gaps are all
``<= gap`` form a run; a voxel's cluster is its FIRST run of at least
``min_pts`` points, and its bounds are that run's ``[r_first - buffer,
r_last + buffer]`` (inner bound floored at 0).  Voxels without such a run,
and the sentinel row, get bounds (0, 0) and ``found = False``.

Here the lexicographic order comes from two stable sorts and the per-voxel
first run from one ``scatter_reduce(amin)``; nothing reads back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_BIG = torch.iinfo(torch.int64).max


class ClusterResult(NamedTuple):
    #: (V+1, 2) inner/outer radial bounds (0 where no cluster; sentinel 0)
    bounds: torch.Tensor
    #: (V+1,) bool, True where a qualifying cluster was found
    found: torch.Tensor


def radial_cluster_bounds(
    vid: torch.Tensor,
    r: torch.Tensor,
    valid: torch.Tensor,
    n_voxels: int,
    min_pts: int,
    gap: float,
    buffer: float,
) -> ClusterResult:
    """Per-voxel radial cluster bounds of points ``(vid, r)``; points with
    ``valid`` False take the sentinel id and never form a cluster."""
    n = r.shape[0]
    dev = r.device
    vid = torch.where(valid, vid, n_voxels).long()
    order = torch.argsort(r, stable=True)
    order = order[torch.argsort(vid[order], stable=True)]
    vid_s = vid[order]
    r_s = r[order]

    brk = torch.ones(n, dtype=torch.bool, device=dev)
    brk[1:] = (vid_s[1:] != vid_s[:-1]) | ((r_s[1:] - r_s[:-1]) > gap)
    run_id = torch.cumsum(brk.long(), 0) - 1
    run_len = torch.zeros(n, dtype=torch.long, device=dev).index_add_(
        0, run_id, torch.ones_like(run_id)
    )
    idx = torch.arange(n, device=dev)
    q_start = brk & (run_len[run_id] >= min_pts) & (vid_s < n_voxels)
    first = torch.full((n_voxels + 1,), _BIG, dtype=torch.long, device=dev)
    first = first.scatter_reduce(
        0, vid_s, torch.where(q_start, idx, _BIG), reduce="amin"
    )
    found = first < _BIG
    first_start = torch.where(found, first, 0)
    first_end = first_start + run_len[run_id[first_start]] - 1
    r_inner = torch.clamp(r_s[first_start] - buffer, min=0.0)
    r_outer = r_s[first_end] + buffer
    zero = torch.zeros_like(r_inner)
    bounds = torch.stack(
        [torch.where(found, r_inner, zero), torch.where(found, r_outer, zero)],
        dim=-1,
    )
    return ClusterResult(bounds=bounds, found=found)


def membership(
    vid: torch.Tensor,
    r: torch.Tensor,
    valid: torch.Tensor,
    bounds: torch.Tensor,
    n_voxels: int,
) -> torch.Tensor:
    """Point-in-cluster mask: a valid point belongs to its voxel iff its
    range lies within that voxel's bounds (sentinel row zero, so
    out-of-band points never belong)."""
    vid = torch.where(valid, vid, n_voxels).long()
    b = bounds[vid]
    return valid & (vid < n_voxels) & (r >= b[..., 0]) & (r <= b[..., 1])
