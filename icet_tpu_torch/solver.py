"""The ICET registration solver on tensors (``icet_tpu/solver.py``).

1. :func:`prepare_reference` fits the dense voxel model to scan 1:
   spherical binning, radial clustering, anchored moments (the fused pass
   at X = 0), 3x3 eigendecomposition and the extended-surface axis mask.
2. :func:`register` runs Gauss-Newton iterations: each one is a fused
   moments pass over scan 2 at the current X (the CUDA kernel on the
   card), the plane-form normal equations, a 6x6 Jacobi eigensystem and a
   condition-pruned update.

Early exit: the JAX package runs the iterations in a device-side
``lax.while_loop``; here a Python loop reads ``|dx|`` and the exit
threshold on the host once per iteration, which executes the same
iterations.  Diagnostics of skipped iterations repeat the last executed
values, as in the JAX package.

Every function follows the device of its input tensors; the entry points
that take numpy input (:func:`register_pair`) choose CUDA unless told
otherwise.

The compiled entry points :func:`prepare_reference_jit`,
:func:`register_jit`, :func:`register_pair_jit` and
:func:`odometry_step_jit` (the JAX package's jitted ones) run the same solve as capture-safe stages, none of which
reads the device from the host: on CUDA each stage is a CUDA graph
captured once per ``(device, N, cfg)`` and replayed
(``icet_tpu_torch.graphs``), on the CPU the stages run as plain calls.
The host reads one flag an iteration for the early exit, so they execute
the eager solve's iterations, and on the CPU they equal
:func:`prepare_reference`, :func:`register`, :func:`register_pair_impl`
and :func:`odometry_step` bit for bit: those stay the plain version.

Point sharding: :func:`prepare_reference` and :func:`register` take a
shard ``axis`` (``icet_tpu_torch.parallel``: the in-process mesh's or the
process group's), in the place of the JAX package's ``axis_name``.  The
scan is then a list of this process's point shards, each on its own
device; each shard's moments pass runs there, and ``axis.psum`` adds the
``(V+1, 16)`` sums on ``axis.device``, where the replicated per-voxel math
runs.  The radial clustering routes points to the shard owning their
voxel range (:func:`~icet_tpu_torch.ops.clustering.
distributed_radial_cluster_bounds`).  Every exit decision reads the
reduced values only, so every shard runs the same iterations.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from icet_tpu_torch.config import ICETConfig
from icet_tpu_torch.device import as_points, resolve_device
from icet_tpu_torch.ops.clustering import (
    ClusterResult,
    distributed_radial_cluster_bounds,
    membership,
    radial_cluster_bounds,
)
from icet_tpu_torch.ops.fused_moments import (
    MAX_SHARED_BYTES,
    fused_moment_sums,
    fused_moment_sums_reference,
    shared_bytes,
)
from icet_tpu_torch.ops.geometry import (
    cart_to_spherical,
    point_norm,
    rotation_jacobian,
    transform_points,
)
from icet_tpu_torch.ops.grid import fixed_shell_bounds, voxel_anchors, voxel_ids
from icet_tpu_torch.ops.linalg import eigh_small, eigh_small_warm_safe
from icet_tpu_torch.ops.moments import (
    cov6_to_matrix,
    finalize_moments_planes,
    voxel_moment_sums,
)
from icet_tpu_torch.ops.wls_planes import (
    assemble_normal_equations,
    eigh3_planes,
    residual_compact_planes,
)


class VoxelModel(NamedTuple):
    """Dense per-voxel reference model fitted to scan 1 (all tables V+1)."""

    bounds: torch.Tensor  # (V+1, 2) radial cluster bounds
    anchors: torch.Tensor  # (V+1, 3) cartesian anchors (bf16-rounded)
    count: torch.Tensor  # (V+1,)
    mean: torch.Tensor  # (V+1, 3)
    cov: torch.Tensor  # (V+1, 3, 3)
    basis: torch.Tensor  # (V+1, 3, 3) eigenvectors as COLUMNS (ascending)
    lmask: torch.Tensor  # (V+1, 3) per-eigenaxis keep mask (0 = extended)
    valid: torch.Tensor  # (V+1,) bool, voxel participates in the solve


class IterationDiag(NamedTuple):
    """Per-iteration diagnostics, each stacked to (n_iters,)."""

    n_corr: torch.Tensor
    condition: torch.Tensor
    dx_norm: torch.Tensor
    n_dropped_axes: torch.Tensor
    n_rejected_moving: torch.Tensor
    #: always 0: the port's moments kernel has no window to overflow
    windowed_overflow: torch.Tensor


class RegistrationResult(NamedTuple):
    X: torch.Tensor  # (6,) solved state [t_xyz, phi, theta, psi]
    pred_stds: torch.Tensor  # (6,) predicted per-component solution std
    Q: torch.Tensor  # (6, 6) predicted solution error covariance
    diagnostics: IterationDiag
    static_mask: torch.Tensor  # (N2,) scan-2 points in used voxels (local shards)
    #: Gauss-Newton iterations executed (each one moments pass)
    iterations: int


# ---------------------------------------------------------------------------
# Scan-1 preparation
# ---------------------------------------------------------------------------


def _sigma_axis_mask(model_mean, eigvals, basis, bounds, valid, cfg: ICETConfig):
    """Keep eigen-axis k iff an endpoint ``mu +- s sqrt(lam_k) u_k`` lies
    inside the voxel (same bin, within the radial bounds)."""
    sq = torch.sqrt(torch.clamp(eigvals, min=0.0))
    offsets = cfg.sigma_scale * sq[:, None, :] * basis  # (V+1, 3, 3)
    endpoints = torch.stack(
        [model_mean[:, :, None] + offsets, model_mean[:, :, None] - offsets], dim=0
    )  # (2, V+1, coord, axis)
    ep = torch.movedim(endpoints, 2, 3)  # (2, V+1, axis, coord)
    rtp = cart_to_spherical(ep)
    ep_vid = voxel_ids(rtp, cfg)
    own_vid = torch.arange(
        model_mean.shape[0], dtype=torch.int32, device=model_mean.device
    )[None, :, None]
    b = bounds[None, :, None, :]
    inside = (ep_vid == own_vid) & (rtp[..., 0] >= b[..., 0]) & (rtp[..., 0] <= b[..., 1])
    keep = inside[0] | inside[1]
    return torch.where(valid[:, None], keep.to(model_mean.dtype), 0.0)


def _clip_fill_mask(model_mean, eigvals, basis, bounds, valid, cfg: ICETConfig):
    """Clip-fill guard: prune axis k when ``sigma_scale sqrt(lam_k)``
    exceeds ``clip_fill / 2`` of the cell's extent along it (L1 box bound
    in the local spherical frame).  Projections in float32."""
    r = torch.linalg.norm(model_mean, dim=-1)
    safe_r = torch.clamp(r, min=1e-6)
    rhat = model_mean / safe_r[:, None]
    sin_phi = torch.sqrt(
        torch.clamp(model_mean[:, 0] ** 2 + model_mean[:, 1] ** 2, min=1e-12)
    ) / safe_r
    cos_th = model_mean[:, 0] / torch.clamp(sin_phi * safe_r, min=1e-9)
    sin_th = model_mean[:, 1] / torch.clamp(sin_phi * safe_r, min=1e-9)
    that = torch.stack([-sin_th, cos_th, torch.zeros_like(sin_th)], dim=-1)
    phat = torch.linalg.cross(that, rhat)

    d_theta = 2.0 * math.pi / cfg.n_theta
    d_phi = (cfg.phi_max - cfg.phi_min) / cfg.n_phi
    w_r = bounds[:, 1] - bounds[:, 0]
    w_t = r * sin_phi * d_theta
    w_p = r * d_phi

    def proj(nv):
        return torch.abs(torch.sum(nv[:, :, None] * basis, dim=1))

    extent = (
        proj(rhat) * w_r[:, None] + proj(that) * w_t[:, None] + proj(phat) * w_p[:, None]
    )
    span = cfg.sigma_scale * torch.sqrt(torch.clamp(eigvals, min=0.0))
    keep = span <= 0.5 * cfg.clip_fill * extent
    return torch.where(valid[:, None], keep.to(model_mean.dtype), 0.0)


def _ndt_axis_mask(eigvals, basis, bounds, valid, cfg: ICETConfig):
    """NDT-style test: prune axis k when any component of
    ``|u_k| lam_k`` exceeds the voxel's radial width squared."""
    width = bounds[:, 1] - bounds[:, 0]
    thr = width * width
    rotated = torch.abs(basis) * torch.clamp(eigvals, min=0.0)[:, None, :]
    extended = torch.any(rotated > thr[:, None, None], dim=1)
    return torch.where(valid[:, None], (~extended).to(eigvals.dtype), 0.0)


def _scatter_sums(pts, X, bounds, anchors, cfg: ICETConfig, method: str) -> torch.Tensor:
    """``moment_method="pallas"`` or ``"onehot"``: transform, bin,
    membership and per-point features in PyTorch, then the moment scatter
    or the blocked one-hot products."""
    raw_ok = point_norm(pts) >= cfg.min_range
    p2 = transform_points(pts, X)
    rtp = cart_to_spherical(p2)
    vid = voxel_ids(rtp, cfg)
    member = membership(vid, rtp[..., 0], raw_ok, bounds, cfg.n_voxels)
    return voxel_moment_sums(p2, vid, member, anchors, cfg.n_voxels, method=method,
                             block=cfg.moment_block)


def moment_route(cfg: ICETConfig) -> str:
    """Which moments pass a solve with ``cfg`` takes, decided from the
    config alone before any launch: ``"fused"`` (the fused kernel's
    wrapper: kernel on CUDA, plain version on CPU), ``"plain"`` (the plain
    ``index_add_`` version on any device), ``"scatter"`` (the moment
    scatter) or ``"onehot"`` (blocked one-hot products, on any device,
    where the JAX package's ``_moment_method`` sends ``"onehot"``).

    ``"auto"``/``"fused"`` take the fused kernel when its whole table fits
    one block's shared memory (adaptive radial mode, V <= 5,774 voxels).
    Fixed radial mode's 90,000-row table and larger adaptive grids do not
    fit: there, as the JAX package computes fixed mode and its segsum
    outside any Pallas kernel, they take the plain version.  ``"segsum"``
    is the plain version, ``"pallas"`` the scatter, ``"onehot"`` the
    one-hot products (an XLA ``dot_general`` in the JAX package, not a
    Pallas kernel, so ``torch.matmul`` here)."""
    method = cfg.moment_method
    if method in ("auto", "fused"):
        fits = (cfg.radial_mode != "fixed"
                and shared_bytes(cfg.n_voxels) <= MAX_SHARED_BYTES)
        return "fused" if fits else "plain"
    if method == "segsum":
        return "plain"
    if method == "pallas":
        return "scatter"
    if method == "onehot":
        return "onehot"
    raise ValueError(
        f"unknown moment_method {method!r}; "
        "use 'auto', 'fused', 'segsum', 'pallas' or 'onehot'"
    )


def _moment_sums(pts, X, bounds, anchors, cfg: ICETConfig) -> torch.Tensor:
    """(V+1, 16) moment sums of ``pts`` at X, by :func:`moment_route`."""
    route = moment_route(cfg)
    if route == "fused":
        return fused_moment_sums(pts, X, bounds, anchors, cfg)
    if route == "plain":
        return fused_moment_sums_reference(pts, X, bounds, anchors, cfg)
    return _scatter_sums(pts, X, bounds, anchors, cfg,
                         "pallas" if route == "scatter" else "onehot")


def _sums(pts, X, bounds, anchors, cfg: ICETConfig, axis=None) -> torch.Tensor:
    """(V+1, 16) moment sums of ``pts`` at X; under ``axis``, of every
    shard of ``pts`` on its own device, summed over the axis."""
    if axis is None:
        return _moment_sums(pts, X, bounds, anchors, cfg)
    return axis.psum([
        _moment_sums(p, X.to(p.device), bounds.to(p.device), anchors.to(p.device), cfg)
        for p in pts
    ])


def _local(pts, axis):
    """The local point shards as contiguous tensors, and the device of the
    replicated math."""
    if axis is None:
        pts = pts.contiguous()
        return pts, pts.device
    return [p.contiguous() for p in pts], axis.device


def prepare_reference(scan1, cfg: ICETConfig, axis=None) -> VoxelModel:
    """Fit the dense voxel model to scan 1 ``(N, 3)`` on its device.

    Under ``axis``, ``scan1`` is the list of local point shards: the
    clustering runs distributed and the moments are summed over the axis;
    the model lies on ``axis.device``."""
    scan1, dev = _local(scan1, axis)
    if cfg.radial_mode == "fixed":
        clusters = ClusterResult(
            bounds=fixed_shell_bounds(cfg, dev).clone(),
            found=torch.cat([
                torch.ones(cfg.n_voxels, dtype=torch.bool, device=dev),
                torch.zeros(1, dtype=torch.bool, device=dev),
            ]),
        )
    elif axis is not None:
        rtps = [cart_to_spherical(p) for p in scan1]
        clusters = distributed_radial_cluster_bounds(
            [voxel_ids(rtp, cfg) for rtp in rtps], [rtp[..., 0] for rtp in rtps],
            [rtp[..., 0] >= cfg.min_range for rtp in rtps], cfg.n_voxels,
            cfg.min_pts, cfg.cluster_gap, cfg.cluster_buffer, axis,
        )
    else:
        rtp = cart_to_spherical(scan1)
        r = rtp[..., 0]
        clusters = radial_cluster_bounds(
            voxel_ids(rtp, cfg), r, r >= cfg.min_range, cfg.n_voxels,
            cfg.min_pts, cfg.cluster_gap, cfg.cluster_buffer,
        )
    anchors = voxel_anchors(clusters.bounds, cfg)
    dtype = (scan1 if axis is None else scan1[0]).dtype
    sums = _sums(scan1, torch.zeros(6, dtype=dtype, device=dev),
                 clusters.bounds, anchors, cfg, axis)
    count, mean, cov6 = finalize_moments_planes(sums, anchors)

    valid = (
        clusters.found
        & (count >= cfg.min_pts)
        & (clusters.bounds[:, 1] > cfg.min_outer_range)
    )
    eigvals, basis = eigh3_planes(cov6)
    if cfg.suppression == "ndt":
        lmask = _ndt_axis_mask(eigvals, basis, clusters.bounds, valid, cfg)
    else:
        lmask = _sigma_axis_mask(mean, eigvals, basis, clusters.bounds, valid, cfg)
    if cfg.clip_fill > 0.0:
        lmask = lmask * _clip_fill_mask(mean, eigvals, basis, clusters.bounds, valid, cfg)
    return VoxelModel(
        bounds=clusters.bounds, anchors=anchors, count=count, mean=mean,
        cov=cov6_to_matrix(cov6), basis=basis, lmask=lmask, valid=valid,
    )


# ---------------------------------------------------------------------------
# Per-iteration Gauss-Newton update
# ---------------------------------------------------------------------------


def _covariance_yaw(cov: torch.Tensor) -> torch.Tensor:
    """Moving-object heuristic: yaw of the covariance's first row,
    ``atan2(-cov[0,1], cov[0,0])``; (V, 3, 3) or (V, 6) packed input."""
    if cov.ndim == 2:
        return torch.atan2(-cov[:, 3], cov[:, 0])
    return torch.atan2(-cov[..., 0, 1], cov[..., 0, 0])


def _iteration(
    model: VoxelModel,
    scan2,
    X: torch.Tensor,
    it: int,
    cfg: ICETConfig,
    corr_mask: torch.Tensor | None = None,
    U2_warm: torch.Tensor | None = None,
    want_range_sens: bool = False,
    axis=None,
):
    sums = _sums(scan2, X.contiguous(), model.bounds, model.anchors, cfg, axis)
    count2, mean2, cov2 = finalize_moments_planes(sums, model.anchors)

    corr = model.valid & (count2 >= cfg.min_pts)
    if corr_mask is not None:
        corr = corr & corr_mask

    n_rejected = torch.zeros((), dtype=torch.int32, device=X.device)
    if cfg.remove_moving and it >= cfg.rm_start_iter:
        res_compact = residual_compact_planes(model.basis, model.lmask, model.mean, mean2)
        bad_res = torch.any(torch.abs(res_compact) > cfg.rm_residual_thresh, dim=-1)
        yaw_delta = torch.abs(_covariance_yaw(model.cov) - _covariance_yaw(cov2))
        bad = corr & (bad_res | (yaw_delta > cfg.rm_yaw_thresh))
        n_rejected = torch.sum(bad, dtype=torch.int32)
        corr = corr & ~bad

    cm = corr.to(X.dtype)
    dR = rotation_jacobian(X[3:6])
    args = (model.basis, model.lmask, model.cov, model.count, cov2, count2,
            model.mean, mean2, dR, cm, cfg.pinv_rcond)
    htwg = None
    if want_range_sens:
        # A common-mode range offset moves the transformed voxel means along
        # (mu2 - t) / |mu2 - t|.
        d3 = [mean2[:, j] - X[j] for j in range(3)]
        gn = torch.sqrt(torch.clamp(d3[0] ** 2 + d3[1] ** 2 + d3[2] ** 2, min=1e-12))
        HTWH, HTWdz, _, htwg = assemble_normal_equations(
            *args, extra_dz=[dj / gn for dj in d3]
        )
    else:
        HTWH, HTWdz, _ = assemble_normal_equations(*args)

    if U2_warm is None:
        w6, U2 = eigh_small(HTWH)
    else:
        w6, U2 = eigh_small_warm_safe(HTWH, U2_warm)
    cond_full = torch.abs(w6[-1]) / torch.clamp(torch.abs(w6[0]), min=1e-30)
    keep = (torch.abs(w6[-1]) <= cfg.condition_cutoff * torch.abs(w6)) & (
        torch.abs(w6) > 1e-30
    )
    dx = U2 @ (_inverse_where(w6, keep) * (U2.T @ HTWdz))
    diag = (
        torch.sum(corr, dtype=torch.int32),
        cond_full,
        torch.linalg.norm(dx),
        torch.sum(~keep, dtype=torch.int32),
        n_rejected,
    )
    return X + dx, w6, keep, corr, U2, diag, htwg


def _inverse_where(w: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """``1 / w`` where ``ok``, 0 elsewhere (no division by the others)."""
    return torch.where(ok, 1.0 / torch.where(ok, w, torch.ones_like(w)),
                       torch.zeros_like(w))


def _exit_threshold(w6, U2, cfg: ICETConfig) -> torch.Tensor:
    """max(tol, stat_scale * |stds|) with the UNINFLATED stds."""
    t = torch.full((), cfg.convergence_tol, dtype=w6.dtype, device=w6.device)
    if cfg.convergence_stat_scale > 0.0:
        wmax = torch.amax(torch.abs(w6))
        inv = _inverse_where(w6, torch.abs(w6) > cfg.pinv_rcond * wmax)
        var = torch.sum(U2 * U2 * inv[None, :], dim=1)
        t = torch.maximum(t, cfg.convergence_stat_scale * torch.sqrt(torch.sum(torch.abs(var))))
    return t


def _predicted_covariance(w6, U2, keep, cfg: ICETConfig, htwg=None):
    """Predicted solution covariance and per-component stds from the final
    eigensystem; pruned axes inflate the stds by ``|U2| @ dropped``."""
    wmax = torch.amax(torch.abs(w6))
    inv_all = _inverse_where(w6, torch.abs(w6) > cfg.pinv_rcond * wmax)
    Q = (U2 * inv_all[None, :]) @ U2.T
    if htwg is not None:
        inv_kept = torch.where(keep, inv_all, torch.zeros_like(inv_all))
        v = U2 @ (inv_kept * (U2.T @ htwg))
        Q = Q + (2.0 * cfg.range_sigma**2) * torch.outer(v, v)
    pred_stds = torch.sqrt(torch.abs(torch.diagonal(Q)))
    dropped = (~keep).to(pred_stds.dtype)
    pred_stds = pred_stds + torch.abs(U2) @ dropped
    return pred_stds, Q


def exit_schedule(cfg: ICETConfig, it_offset: int = 0) -> tuple[bool, int]:
    """``(early, min_it)``: whether the solve may exit before ``n_iters``,
    and the fewest iterations it runs (with moving-object rejection on, at
    least one iteration past ``rm_start_iter``, as in the JAX package)."""
    early = cfg.convergence_tol > 0.0 or cfg.convergence_stat_scale > 0.0
    if cfg.remove_moving:
        return early, min(max(cfg.rm_start_iter + 1 - it_offset, 1), cfg.n_iters)
    return early, 1


def _stack_diags(rows) -> IterationDiag:
    cols = list(zip(*rows))
    n_corr, cond, dxn, ndrop, nrej = (torch.stack(c) for c in cols)
    return IterationDiag(
        n_corr=n_corr, condition=cond, dx_norm=dxn, n_dropped_axes=ndrop,
        n_rejected_moving=nrej, windowed_overflow=torch.zeros_like(n_corr),
    )


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def register(
    model: VoxelModel,
    scan2,
    x0: torch.Tensor,
    cfg: ICETConfig,
    corr_mask: torch.Tensor | None = None,
    want_static_mask: bool = True,
    it_offset: int = 0,
    axis=None,
) -> RegistrationResult:
    """Solve for the 6-DOF transform aligning scan 2 to the voxel model.

    Iteration 0 runs the cold 6x6 eigendecomposition; later iterations
    warm-start from the previous eigenbasis.  With ``convergence_tol`` or
    ``convergence_stat_scale`` set, iterations stop once ``|dx|`` falls
    below the exit threshold (after ``min_it``; ``n_iters`` is the cap).

    ``it_offset`` is the global index of this call's first iteration, for
    callers that split one solve into phases (the DNN filter): the
    moving-object schedule (``it >= rm_start_iter``) sees global indices.

    Under ``axis``, ``scan2`` is the list of local point shards and the
    returned ``static_mask`` covers those shards, concatenated in order;
    everything else is replicated over the axis.  The early exit reads
    ``|dx|`` and its threshold, both computed from the summed moments, so
    every shard of the axis takes the same decision.
    """
    scan2, dev = _local(scan2, axis)
    dtype = (scan2 if axis is None else scan2[0]).dtype
    X = x0.to(device=dev, dtype=dtype)
    X, w6, keep, corr, U2, d, _ = _iteration(
        model, scan2, X, it_offset, cfg, corr_mask, None, axis=axis
    )
    rows = [d]
    n_it = cfg.n_iters
    early, min_it = exit_schedule(cfg, it_offset)
    it = 1
    thresh = _exit_threshold(w6, U2, cfg) if early else None
    while it < n_it:
        if early and it >= min_it and not bool(d[2] >= thresh):
            break
        X, w6, keep, corr, U2, d, _ = _iteration(
            model, scan2, X, it + it_offset, cfg, corr_mask, U2, axis=axis
        )
        rows.append(d)
        if early:
            thresh = _exit_threshold(w6, U2, cfg)
        it += 1
    iterations = it
    rows += [rows[-1]] * (n_it - len(rows))
    diags = _stack_diags(rows)

    if cfg.range_sigma > 0.0:
        # One extra assembly at the converged X for the range sensitivity.
        _, w6, keep, _, U2, _, htwg = _iteration(
            model, scan2, X, it_offset + n_it - 1, cfg, corr_mask, U2,
            want_range_sens=True, axis=axis,
        )
        pred_stds, Q = _predicted_covariance(w6, U2, keep, cfg, htwg)
    else:
        pred_stds, Q = _predicted_covariance(w6, U2, keep, cfg)

    if want_static_mask and axis is None:
        static_mask = _static_mask(scan2, X, model.bounds, corr, cfg)
    elif want_static_mask:
        static_mask = torch.cat([
            _static_mask(p, X.to(p.device), model.bounds.to(p.device),
                         corr.to(p.device), cfg).to(dev)
            for p in scan2
        ])
    else:
        static_mask = torch.zeros(0, dtype=torch.bool, device=dev)

    return RegistrationResult(
        X=X, pred_stds=pred_stds, Q=Q, diagnostics=diags,
        static_mask=static_mask, iterations=iterations,
    )


def _static_mask(scan2, X, bounds, corr, cfg: ICETConfig) -> torch.Tensor:
    """Scan-2 points inside used voxels at X."""
    raw_ok = point_norm(scan2) >= cfg.min_range
    rtp2 = cart_to_spherical(transform_points(scan2, X))
    vid2 = voxel_ids(rtp2, cfg)
    member2 = membership(vid2, rtp2[..., 0], raw_ok, bounds, cfg.n_voxels)
    return member2 & corr[torch.where(member2, vid2, cfg.n_voxels).long()]


def register_pair_impl(
    scan1,
    scan2,
    x0: torch.Tensor,
    cfg: ICETConfig,
    axis=None,
    want_static_mask: bool = True,
) -> RegistrationResult:
    """Registration of a pair of tensors (local shards under ``axis``) on
    their device: :func:`prepare_reference`, then :func:`register`."""
    model = prepare_reference(scan1, cfg, axis)
    return register(model, scan2, x0, cfg, want_static_mask=want_static_mask, axis=axis)


def register_pair(
    scan1,
    scan2,
    x0,
    cfg: ICETConfig,
    device: str | torch.device | None = None,
) -> RegistrationResult:
    """End-to-end registration of a scan pair (numpy or tensors) on
    ``device`` (CUDA unless told otherwise): :func:`register_pair_jit`
    where :func:`compiled_route` holds (the JAX package's jitted
    ``register_pair``), else :func:`register_pair_impl`."""
    dev = resolve_device(device)
    s1 = as_points(scan1, dev)
    s2 = as_points(scan2, dev)
    x0 = torch.as_tensor(x0, dtype=torch.float32).to(dev)
    pair = register_pair_jit if compiled_route(cfg) else register_pair_impl
    return pair(s1, s2, x0, cfg)


def odometry_step(
    model: VoxelModel, scan: torch.Tensor, x0: torch.Tensor, cfg: ICETConfig
) -> tuple[RegistrationResult, VoxelModel]:
    """Register ``scan`` against the previous frame's model, then fit the
    scan's own model for the next frame."""
    res = register(model, scan, x0, cfg, want_static_mask=False)
    return res, prepare_reference(scan, cfg)


# ---------------------------------------------------------------------------
# Capture-safe stages and the compiled entry points
# ---------------------------------------------------------------------------
#
# Each stage reads and writes the static buffers ``b`` of one frame
# (``icet_tpu_torch.graphs.FrameBuffers``) and nothing else, and never reads
# the device from the host, so a CUDA graph can capture it.  Python-level
# branches depend on the config alone.

#: moment routes whose solve the compiled entry points capture
CAPTURED_ROUTES = ("fused", "plain")


def compiled_route(cfg: ICETConfig) -> bool:
    """Whether ``cfg``'s solve runs through the compiled entry points: the
    ``"fused"`` and ``"plain"`` moment routes, with or without the DNN
    filter (decided from the config alone, as :func:`moment_route` is)."""
    return moment_route(cfg) in CAPTURED_ROUTES


def _stage_prepare(b, cfg: ICETConfig, src: str = "scan") -> None:
    """:func:`prepare_reference` of the scan buffer ``src`` into
    ``b.prepared``."""
    for name, t in zip(VoxelModel._fields, prepare_reference(getattr(b, src), cfg)):
        b.prepared[name].copy_(t)


def _commit(b, cfg: ICETConfig, X, w6, keep, corr, U2, d) -> None:
    """Store one iteration's state and its diagnostics row ``b.it``, and
    leave the exit flag ``|dx| >= threshold`` in ``b.go``."""
    for dst, src in ((b.X, X), (b.w6, w6), (b.keep, keep), (b.corr, corr), (b.U2, U2)):
        dst.copy_(src)
    for col, v in zip(b.diag, d):
        col.index_copy_(0, b.it, v.reshape(1))
    b.it.add_(1)
    if exit_schedule(cfg)[0]:
        torch.ge(d[2], _exit_threshold(w6, U2, cfg), out=b.go)


def _corr_mask(b, masked: bool):
    """The DNN filter's keep mask (``b.filt``) where the phase is filtered."""
    return b.filt["keep"] if masked else None


def _stage_first(b, cfg: ICETConfig, it: int = 0, masked: bool = False,
                 start: str = "x0") -> None:
    """Iteration ``it`` (a phase's first) from ``b.x0`` or, with ``start="X"``,
    from the previous phase's ``b.X``: the cold 6x6 eigendecomposition."""
    b.it.zero_()
    x = b.x0 if start == "x0" else b.X
    _commit(b, cfg, *_iteration(b.model, b.scan, x, it, cfg, _corr_mask(b, masked))[:6])


def _stage_warm(b, cfg: ICETConfig, it: int, masked: bool = False) -> None:
    """One warm iteration from ``b.X`` and ``b.U2``; ``it`` (global) matters
    only through the moving-object schedule (``it >= rm_start_iter``)."""
    _commit(b, cfg, *_iteration(b.model, b.scan, b.X, it, cfg, _corr_mask(b, masked),
                                b.U2)[:6])


def _stage_finish(b, cfg: ICETConfig, want_static_mask: bool, it_offset: int = 0,
                  masked: bool = False) -> None:
    """The predicted covariance (after the range-sensitivity assembly when
    ``range_sigma > 0``), the diagnostics with skipped iterations repeating
    the last executed row, and the static mask, into the result buffer of
    ``(cfg.n_iters, want_static_mask)``."""
    n_it = cfg.n_iters
    if cfg.range_sigma > 0.0:
        _, w6, keep, _, U2, _, htwg = _iteration(
            b.model, b.scan, b.X, it_offset + n_it - 1, cfg, _corr_mask(b, masked), b.U2,
            want_range_sens=True,
        )
        pred_stds, Q = _predicted_covariance(w6, U2, keep, cfg, htwg)
    else:
        pred_stds, Q = _predicted_covariance(b.w6, b.U2, b.keep, cfg)
    out = b.result[(n_it, want_static_mask)]
    out["X"].copy_(b.X)
    out["pred_stds"].copy_(pred_stds)
    out["Q"].copy_(Q)
    fill = torch.minimum(torch.arange(n_it, device=b.it.device), b.it - 1)
    for name, col in zip(IterationDiag._fields, b.diag):
        out[name].copy_(col[fill])
    out["windowed_overflow"].zero_()
    if want_static_mask:
        out["static_mask"].copy_(_static_mask(b.scan, b.X, b.model.bounds, b.corr, cfg))


def compiled_graphs(scan, cfg: ICETConfig):
    """The frame graphs of ``scan``'s device, size and ``cfg``; raises
    NotImplementedError, before any launch, for what is not captured."""
    if isinstance(scan, (list, tuple)):
        raise NotImplementedError(
            "the compiled entry points take one unsharded scan; use register "
            "and prepare_reference with a shard axis"
        )
    if not compiled_route(cfg):
        raise NotImplementedError(
            f"the compiled entry points capture the moment routes {CAPTURED_ROUTES}; "
            f"cfg takes route {moment_route(cfg)!r}: use the eager functions"
        )
    # Imported here: icet_tpu_torch.graphs builds on this module.
    from icet_tpu_torch import graphs

    return graphs.frame_graphs(scan.device, scan.shape[0], cfg)


def prepare_reference_jit(scan1: torch.Tensor, cfg: ICETConfig) -> VoxelModel:
    """:func:`prepare_reference` as a captured graph (the JAX package's
    ``prepare_reference_jit``)."""
    fg = compiled_graphs(scan1, cfg)
    fg.load(scan=scan1)
    fg.run_prepare()
    return fg.prepared()


def register_jit(
    model: VoxelModel, scan2: torch.Tensor, x0: torch.Tensor, cfg: ICETConfig
) -> RegistrationResult:
    """:func:`register` (with the static mask) as captured graphs: one
    replay for iteration 0, one for each further iteration, one for the
    finish (the JAX package's ``register_jit``)."""
    fg = compiled_graphs(scan2, cfg)
    fg.load(scan=scan2, x0=x0, model=model)
    return fg.result(fg.solve(True), True)


def register_pair_jit(
    scan1: torch.Tensor,
    scan2: torch.Tensor,
    x0: torch.Tensor,
    cfg: ICETConfig,
    want_static_mask: bool = True,
) -> RegistrationResult:
    """:func:`register_pair_impl` as captured graphs: scan 1's prepare, the
    prepared model handed over into the solve's model buffer by one device
    copy, then the solve (with the static mask unless told otherwise)."""
    fg1 = compiled_graphs(scan1, cfg)
    fg1.load(scan=scan1)
    fg1.run_prepare()
    fg = compiled_graphs(scan2, cfg)
    fg.load(scan=scan2, x0=x0, model=VoxelModel(**fg1.buffers.prepared))
    return fg.result(fg.solve(want_static_mask), want_static_mask)


def odometry_step_jit(
    model: VoxelModel, scan: torch.Tensor, x0: torch.Tensor, cfg: ICETConfig
) -> tuple[RegistrationResult, VoxelModel]:
    """:func:`odometry_step` as captured graphs: register ``scan`` against
    ``model``, then fit the scan's own model (the JAX package's
    ``odometry_step_jit``)."""
    fg = compiled_graphs(scan, cfg)
    fg.load(scan=scan, x0=x0, model=model)
    iterations = fg.solve(False)
    fg.run_prepare()
    return fg.result(iterations, False), fg.prepared()


__all__ = [
    "IterationDiag",
    "RegistrationResult",
    "VoxelModel",
    "compiled_graphs",
    "compiled_route",
    "exit_schedule",
    "moment_route",
    "odometry_step",
    "odometry_step_jit",
    "prepare_reference",
    "prepare_reference_jit",
    "register",
    "register_jit",
    "register_pair",
    "register_pair_impl",
    "register_pair_jit",
]
