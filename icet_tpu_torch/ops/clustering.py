"""Per-spike radial clustering: the shadow-mitigation voxel bounds.

Semantics of ``icet_tpu/ops/clustering.py``: sort the points by
(voxel id, range); consecutive points whose radial gaps are all
``<= gap`` form a run; a voxel's cluster is its FIRST run of at least
``min_pts`` points, and its bounds are that run's ``[r_first - buffer,
r_last + buffer]`` (inner bound floored at 0).  Voxels without such a run,
and the sentinel row, get bounds (0, 0) and ``found = False``.

Here the lexicographic order comes from two stable sorts and the per-voxel
first run from one ``scatter_reduce(amin)``; nothing reads back to the host.
A voxel's bounds depend only on the multiset of its points' ranges, so the
distributed variant, which clusters each voxel on the shard that owns it,
is bit-identical to the replicated one.
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


def distributed_radial_cluster_bounds(
    vid: list,
    r: list,
    valid: list,
    n_voxels: int,
    min_pts: int,
    gap: float,
    buffer: float,
    axis,
    capacity_factor: float = 2.0,
) -> ClusterResult:
    """:func:`radial_cluster_bounds` with the points sharded over ``axis``
    (``icet_tpu/ops/clustering.py::distributed_radial_cluster_bounds``).

    ``vid``, ``r`` and ``valid`` are lists over the axis's local shards,
    all of one size.  Each shard buckets its points by the shard that owns
    their voxel range (``ceil(V / S)`` voxels a shard), at most ``cap =
    ceil(int(capacity_factor * N_local) / S)`` points a bucket; one
    ``all_to_all`` delivers the buckets, each shard clusters its own
    voxels, and one ``all_gather`` assembles the ``(V+1,)`` tables on
    ``axis.device``.  When any bucket overflows anywhere (the summed
    overflow is read on the host), the points' ``(vid, r)`` are gathered
    and clustered whole instead.  Either way the result is bit-identical
    to :func:`radial_cluster_bounds` on the whole cloud."""
    S = axis.size
    n_local = r[0].shape[0]
    vps = -(-n_voxels // S)
    cap = -(-int(capacity_factor * n_local) // S)
    sends, overflow = [], []
    for v, rr, ok in zip(vid, r, valid):
        dev = rr.device
        v = torch.where(ok, v, n_voxels).to(torch.int32)
        # Invalid points go to a bucket S that is never sent.
        dst = torch.clamp(v // vps, max=S - 1)
        key = torch.where(ok & (v < n_voxels), dst, S)
        order = torch.argsort(key, stable=True)
        counts = torch.bincount(key, minlength=S + 1)
        offsets = (torch.cumsum(counts, 0) - counts)[:S]
        within = torch.arange(cap, device=dev)
        take = torch.clamp(offsets[:, None] + within, 0, n_local - 1)
        slot_ok = within < counts[:S, None]
        v_s, r_s = v[order][take], rr.to(torch.float32)[order][take]
        # (S, cap, 2) int32: the voxel id and the range's bits.
        sends.append(torch.stack([torch.where(slot_ok, v_s, n_voxels),
                                  torch.where(slot_ok, r_s, 0.0).view(torch.int32)], -1))
        overflow.append(torch.clamp(counts[:S] - cap, min=0).sum())
    if int(axis.psum(overflow)) > 0:
        both = axis.all_gather([torch.stack([torch.where(ok, v, n_voxels).to(torch.int32),
                                             rr.to(torch.float32).view(torch.int32)], -1)
                                for v, rr, ok in zip(vid, r, valid)])
        v_full, r_full = both[:, 0], both[:, 1].view(torch.float32)
        return radial_cluster_bounds(v_full, r_full, v_full < n_voxels, n_voxels,
                                     min_pts, gap, buffer)
    tables = []
    for idx, recv in zip(axis.index, axis.all_to_all(sends)):
        recv_vid = recv[..., 0].reshape(-1)
        recv_r = recv[..., 1].reshape(-1).view(torch.float32)
        lo = idx * vps
        in_range = (recv_vid >= lo) & (recv_vid < lo + vps)
        cr = radial_cluster_bounds(torch.where(in_range, recv_vid - lo, vps), recv_r,
                                   in_range, vps, min_pts, gap, buffer)
        tables.append(torch.cat([cr.bounds[:vps], cr.found[:vps, None].to(cr.bounds)], -1))
    table = axis.all_gather(tables)
    zero = torch.zeros((1, 3), dtype=table.dtype, device=table.device)
    table = torch.cat([table[:n_voxels], zero])
    return ClusterResult(bounds=table[:, :2].contiguous(), found=table[:, 2] > 0.5)


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
