"""Per-voxel Gaussian moments: anchored feature sums and their finalize.

Points are accumulated relative to a per-voxel anchor (grid.voxel_anchors),
so single-pass float32 covariance sums stay accurate.  The raw sums are a
``(V+1, 16)`` table: columns ``[1, g, gx^2, gy^2, gz^2, gx gy, gx gz,
gy gz]`` about the anchor, columns 10-15 zero (the JAX package's layout).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from icet_tpu_torch.ops.moment_scatter import (
    moment_scatter_reference,
    moment_scatter_sums,
)

N_FEATURES = 16  # 10 used; the JAX package's padded layout


class VoxelMoments(NamedTuple):
    count: torch.Tensor  # (V+1,) points per voxel
    mean: torch.Tensor  # (V+1, 3) cartesian mean
    cov: torch.Tensor  # (V+1, 3, 3) sample covariance (N-1 denominator)


def _point_features(g: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """Per-point features ``(N, 16)`` about the anchor offsets ``g``.

    Non-members are zeroed with a select, not a multiply, so NaN offsets
    cannot reach the sums through NaN * 0."""
    gx, gy, gz = g[..., 0], g[..., 1], g[..., 2]
    feats = torch.stack(
        [torch.ones_like(gx), gx, gy, gz, gx * gx, gy * gy, gz * gz,
         gx * gy, gx * gz, gy * gz],
        dim=-1,
    )
    feats = torch.where(member[..., None], feats, torch.zeros_like(feats))
    pad = feats.new_zeros(feats.shape[:-1] + (N_FEATURES - 10,))
    return torch.cat([feats, pad], dim=-1)


def _split3_bf16(x: torch.Tensor):
    """Exact 3-way bfloat16 split ``x == hi + mid + lo`` (float32), each
    part representable in bf16 (``icet_tpu.ops.moments._split3_bf16``)."""
    hi = x.to(torch.bfloat16)
    r1 = x - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def _accumulate_onehot(feats: torch.Tensor, vid: torch.Tensor, n_voxels: int,
                       block: int) -> torch.Tensor:
    """``moment_method="onehot"``: blocks of ``block`` points (the last
    padded with the sentinel id), each contracted as a ``(block, V+1)``
    one-hot matrix against the three bf16 parts of its features, the three
    products added to the accumulator in that order, as the JAX package's
    ``lax.scan`` does (moments.py:87-122).  The parts are widened to
    float32 before the product: a bf16 x bf16 ``matmul`` returns bf16 and
    would round the sums away.  Each product of a one-hot entry and a
    part is exact; the sums are float32, without TF32
    (``device.set_fp32_precision``)."""
    n = feats.shape[0]
    pad = (-n) % block
    if pad:
        feats = torch.cat([feats, feats.new_zeros((pad, N_FEATURES))])
        vid = torch.cat([vid, vid.new_full((pad,), n_voxels)])
    feats = feats.reshape(-1, block, N_FEATURES)
    vid = vid.reshape(-1, block)
    volume = torch.arange(n_voxels + 1, dtype=vid.dtype, device=vid.device)
    acc = feats.new_zeros((n_voxels + 1, N_FEATURES))
    for f, v in zip(feats, vid):
        onehot_t = (volume[:, None] == v[None, :]).to(torch.float32)
        for part in _split3_bf16(f):
            acc = acc + onehot_t @ part.float()
    return acc


def voxel_moment_sums(
    points: torch.Tensor,
    vid: torch.Tensor,
    member: torch.Tensor,
    anchors: torch.Tensor,
    n_voxels: int,
    method: str = "segsum",
    block: int = 1024,
) -> torch.Tensor:
    """Raw ``(V+1, 16)`` anchored sums of ``points`` by voxel id.

    ``"segsum"`` sums with ``index_add_``; ``"pallas"`` with the moment
    scatter (the CUDA kernel on CUDA tensors, ``index_add_`` on CPU ones);
    ``"onehot"`` as blocked one-hot products of ``block`` points
    (:func:`_accumulate_onehot`), on any device."""
    if method not in ("segsum", "pallas", "onehot"):
        raise ValueError(f"unknown moment accumulation {method!r}")
    vid = torch.where(member, vid, n_voxels).to(torch.int32)
    g = points - anchors[vid.long()]
    feats = _point_features(g, member)
    if method == "pallas":
        return moment_scatter_sums(vid, feats.contiguous(), n_voxels)
    if method == "onehot":
        return _accumulate_onehot(feats, vid, n_voxels, block)
    return moment_scatter_reference(vid, feats, n_voxels)


def finalize_moments_planes(sums: torch.Tensor, anchors: torch.Tensor):
    """``(count (V+1,), mean (V+1, 3), cov6 (V+1, 6))`` with ``cov6`` the
    packed symmetric sample covariance ``[xx, yy, zz, xy, xz, yz]``."""
    count = sums[:, 0]
    safe_n = torch.clamp(count, min=1.0)
    gbar = sums[:, 1:4] / safe_n[:, None]
    mean = anchors + gbar
    denom = torch.clamp(count - 1.0, min=1.0)
    gx, gy, gz = gbar[:, 0], gbar[:, 1], gbar[:, 2]
    pairs = (
        (4, gx * gx), (5, gy * gy), (6, gz * gz),
        (7, gx * gy), (8, gx * gz), (9, gy * gz),
    )
    cov6 = torch.stack(
        [(sums[:, i] - safe_n * g2) / denom for i, g2 in pairs], dim=-1
    )
    return count, mean, cov6


def cov6_to_matrix(cov6: torch.Tensor) -> torch.Tensor:
    """(V, 6) packed symmetric planes -> (V, 3, 3)."""
    xx, yy, zz, xy, xz, yz = (cov6[:, i] for i in range(6))
    return torch.stack(
        [torch.stack([xx, xy, xz], -1),
         torch.stack([xy, yy, yz], -1),
         torch.stack([xz, yz, zz], -1)],
        dim=-2,
    )


def finalize_moments(sums: torch.Tensor, anchors: torch.Tensor) -> VoxelMoments:
    """Raw sums -> count / mean / (V+1, 3, 3) sample covariance."""
    count, mean, cov6 = finalize_moments_planes(sums, anchors)
    return VoxelMoments(count=count, mean=mean, cov=cov6_to_matrix(cov6))


def voxel_moments(
    points: torch.Tensor,
    vid: torch.Tensor,
    member: torch.Tensor,
    anchors: torch.Tensor,
    n_voxels: int,
    method: str = "segsum",
    block: int = 1024,
) -> VoxelMoments:
    """Per-voxel count / mean / covariance of the member points."""
    sums = voxel_moment_sums(points, vid, member, anchors, n_voxels, method, block)
    return finalize_moments(sums, anchors)
