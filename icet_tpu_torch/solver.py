"""The ICET registration solver on tensors (``icet_tpu/solver.py``).

1. :func:`prepare_reference` fits the dense voxel model to scan 1:
   spherical binning, radial clustering, anchored moments (the fused pass
   at X = 0), 3x3 eigendecomposition and the extended-surface axis mask
   (``ops.model_fit``: two CUDA kernel launches on the card).
2. :func:`register` runs Gauss-Newton iterations: each one is a fused
   moments pass over scan 2 at the current X (the CUDA kernel on the
   card), the plane-form normal equations (``ops.gn_assembly``: one CUDA
   kernel on the card), a 6x6 Jacobi eigensystem and a condition-pruned
   update (``ops.gn_eigh6``: one CUDA kernel on the card).

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
reduced values only, so every shard runs the same iterations.  The
compiled sharded step (``parallel.sharding.make_sharded_register``) runs
the same math split at its sums: :func:`model_from_sums`,
:func:`iteration_from_sums`, :func:`finish_result`, :func:`static_mask_of`.
"""

from __future__ import annotations

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
from icet_tpu_torch.ops.fused_moments import fused_moment_sums
from icet_tpu_torch.ops.geometry import (
    cart_to_spherical,
    point_norm,
    rotation_jacobian,
    transform_points,
)
from icet_tpu_torch.ops.gn_assembly import gn_assembly
from icet_tpu_torch.ops.gn_eigh6 import gn_eigh6
from icet_tpu_torch.ops.grid import fixed_shell_bounds, voxel_anchors, voxel_ids
from icet_tpu_torch.ops.linalg import inverse_where
from icet_tpu_torch.ops.model_fit import model_fit
from icet_tpu_torch.ops.moments import voxel_moment_sums


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
    #: Gauss-Newton iterations executed (each one moments pass): a host int
    #: from the eager functions, a 0-d int64 device count from the compiled
    #: ones (read it with ``int(...)`` where needed: the read waits for the
    #: device)
    iterations: int | torch.Tensor


# ---------------------------------------------------------------------------
# Scan-1 preparation
# ---------------------------------------------------------------------------


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
    wrapper: kernel on CUDA, plain version on CPU), ``"plain"`` (transform,
    bin, membership and features in PyTorch, summed by the moment scatter
    kernel on CUDA and by ``index_add_`` on the CPU), ``"scatter"`` (the
    moment scatter) or ``"onehot"`` (blocked one-hot products, on any
    device, where the JAX package's ``_moment_method`` sends ``"onehot"``).

    ``"auto"``/``"fused"`` take the fused kernel on every grid, as the TPU
    kernel takes both radial modes and any table size: adaptive tables of
    up to 5,774 voxels in one block's shared memory, fixed radial mode's
    90,000-row table and larger adaptive grids by the kernel's sorted
    parts.  ``"segsum"`` is the plain route, ``"pallas"`` the scatter,
    ``"onehot"`` the one-hot products (an XLA ``dot_general`` in the JAX
    package, not a Pallas kernel, so ``torch.matmul`` here).  The plain
    route sums on the card with the scatter kernel and not ``index_add_``,
    whose float atomics add in whatever order the hardware commits them:
    every route gives the same bits on every run."""
    method = cfg.moment_method
    if method in ("auto", "fused"):
        return "fused"
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
        # The plain version's ``index_add_`` on the CPU, the scatter kernel's
        # fixed order of addition on the card.
        return _scatter_sums(pts, X, bounds, anchors, cfg,
                             "pallas" if pts.device.type == "cuda" else "segsum")
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


def fixed_clusters(cfg: ICETConfig, dev) -> ClusterResult:
    """Fixed radial mode's shells: every voxel found, the sentinel not."""
    return ClusterResult(
        bounds=fixed_shell_bounds(cfg, dev).clone(),
        found=torch.cat([
            torch.ones(cfg.n_voxels, dtype=torch.bool, device=dev),
            torch.zeros(1, dtype=torch.bool, device=dev),
        ]),
    )


def model_from_sums(sums, clusters: ClusterResult, anchors, cfg: ICETConfig) -> VoxelModel:
    """The voxel model from scan 1's ``(V+1, 16)`` moment sums at X = 0, its
    clusters and anchors: finalize, validity, eigensystems and axis masks
    (``ops.model_fit``: two CUDA kernel launches on the card)."""
    count, mean, cov, basis, lmask, valid = model_fit(sums, clusters, anchors, cfg)
    return VoxelModel(
        bounds=clusters.bounds, anchors=anchors, count=count, mean=mean,
        cov=cov, basis=basis, lmask=lmask, valid=valid,
    )


def prepare_reference(scan1, cfg: ICETConfig, axis=None) -> VoxelModel:
    """Fit the dense voxel model to scan 1 ``(N, 3)`` on its device.

    Under ``axis``, ``scan1`` is the list of local point shards: the
    clustering runs distributed and the moments are summed over the axis;
    the model lies on ``axis.device``."""
    scan1, dev = _local(scan1, axis)
    if cfg.radial_mode == "fixed":
        clusters = fixed_clusters(cfg, dev)
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
    return model_from_sums(sums, clusters, anchors, cfg)


# ---------------------------------------------------------------------------
# Per-iteration Gauss-Newton update
# ---------------------------------------------------------------------------


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
    return iteration_from_sums(model, sums, X, it, cfg, corr_mask, U2_warm, want_range_sens)


def iteration_from_sums(
    model: VoxelModel,
    sums: torch.Tensor,
    X: torch.Tensor,
    it: int,
    cfg: ICETConfig,
    corr_mask: torch.Tensor | None = None,
    U2_warm: torch.Tensor | None = None,
    want_range_sens: bool = False,
):
    """One Gauss-Newton iteration from scan 2's ``(V+1, 16)`` moment sums
    at X: correspondences, the moving-object test, the normal equations,
    the 6x6 eigensystem and the pruned update (the replicated math of a
    sharded iteration)."""
    dR = rotation_jacobian(X[3:6])
    corr, n_corr, n_rejected, HTWH, HTWdz, htwg = gn_assembly(
        model, sums, X, dR, it, cfg, corr_mask, want_range_sens
    )

    X_new, w6, keep, U2, cond_full, dx_norm, n_dropped = gn_eigh6(
        HTWH, HTWdz, X, U2_warm, cfg.condition_cutoff
    )
    diag = (n_corr, cond_full, dx_norm, n_dropped, n_rejected)
    return X_new, w6, keep, corr, U2, diag, htwg


def _exit_threshold(w6, U2, cfg: ICETConfig) -> torch.Tensor:
    """max(tol, stat_scale * |stds|) with the UNINFLATED stds."""
    t = torch.full((), cfg.convergence_tol, dtype=w6.dtype, device=w6.device)
    if cfg.convergence_stat_scale > 0.0:
        wmax = torch.amax(torch.abs(w6))
        inv = inverse_where(w6, torch.abs(w6) > cfg.pinv_rcond * wmax)
        var = torch.sum(U2 * U2 * inv[None, :], dim=1)
        t = torch.maximum(t, cfg.convergence_stat_scale * torch.sqrt(torch.sum(torch.abs(var))))
    return t


def _predicted_covariance(w6, U2, keep, cfg: ICETConfig, htwg=None):
    """Predicted solution covariance and per-component stds from the final
    eigensystem; pruned axes inflate the stds by ``|U2| @ dropped``."""
    wmax = torch.amax(torch.abs(w6))
    inv_all = inverse_where(w6, torch.abs(w6) > cfg.pinv_rcond * wmax)
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
        static_mask = static_mask_of(scan2, X, model.bounds, corr, cfg)
    elif want_static_mask:
        static_mask = torch.cat([
            static_mask_of(p, X.to(p.device), model.bounds.to(p.device),
                           corr.to(p.device), cfg).to(dev)
            for p in scan2
        ])
    else:
        static_mask = torch.zeros(0, dtype=torch.bool, device=dev)

    return RegistrationResult(
        X=X, pred_stds=pred_stds, Q=Q, diagnostics=diags,
        static_mask=static_mask, iterations=iterations,
    )


def static_mask_of(scan2, X, bounds, corr, cfg: ICETConfig) -> torch.Tensor:
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
    (the JAX package's jitted ``register_pair``; :func:`register_pair_impl`
    is the plain version)."""
    dev = resolve_device(device)
    s1 = as_points(scan1, dev)
    s2 = as_points(scan2, dev)
    x0 = torch.as_tensor(x0, dtype=torch.float32).to(dev)
    return register_pair_jit(s1, s2, x0, cfg)


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

def _stage_prepare(b, cfg: ICETConfig, src: str = "scan") -> None:
    """:func:`prepare_reference` of the scan buffer ``src`` into
    ``b.prepared``."""
    for name, t in zip(VoxelModel._fields, prepare_reference(getattr(b, src), cfg)):
        b.prepared[name].copy_(t)


def _commit(b, cfg: ICETConfig, X, w6, keep, corr, U2, d) -> None:
    """Store one iteration's state and its diagnostics row ``b.it``, count
    it in ``b.iters``, and leave the exit flag ``|dx| >= threshold`` in
    ``b.go``."""
    for dst, src in ((b.X, X), (b.w6, w6), (b.keep, keep), (b.corr, corr), (b.U2, U2)):
        dst.copy_(src)
    for col, v in zip(b.diag, d):
        col.index_copy_(0, b.it, v.reshape(1))
    b.it.add_(1)
    b.iters.add_(1)
    if exit_schedule(cfg)[0]:
        torch.ge(d[2], _exit_threshold(w6, U2, cfg), out=b.go)


def _corr_mask(b, masked: bool):
    """The DNN filter's keep mask (``b.filt``) where the phase is filtered."""
    return b.filt["keep"] if masked else None


def _stage_first(b, cfg: ICETConfig, it: int = 0, masked: bool = False,
                 start: str = "x0") -> None:
    """Iteration ``it`` (a phase's first) from ``b.x0`` or, with ``start="X"``,
    from the previous phase's ``b.X``: the cold 6x6 eigendecomposition.  A
    registration starts from ``b.x0``, so that start zeroes its iteration
    count too."""
    b.it.zero_()
    if start == "x0":
        b.iters.zero_()
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
    sens = None
    if cfg.range_sigma > 0.0:
        sens = _iteration(b.model, b.scan, b.X, it_offset + cfg.n_iters - 1, cfg,
                          _corr_mask(b, masked), b.U2, want_range_sens=True)
    finish_result(b, cfg, want_static_mask, sens)
    if want_static_mask:
        b.result[(cfg.n_iters, True)]["static_mask"].copy_(
            static_mask_of(b.scan, b.X, b.model.bounds, b.corr, cfg))


def finish_result(b, cfg: ICETConfig, want_static_mask: bool, sens=None) -> None:
    """The finish without the static mask: the predicted covariance from
    the last iteration's eigensystem or, with ``range_sigma > 0``, from
    ``sens`` (the range-sensitivity iteration's outputs), and the
    diagnostics, into the result buffer of ``(cfg.n_iters,
    want_static_mask)``."""
    n_it = cfg.n_iters
    if sens is not None:
        _, w6, keep, _, U2, _, htwg = sens
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
    out["iterations"].copy_(b.iters[0])


def compiled_graphs(scan, cfg: ICETConfig):
    """The frame graphs of ``scan``'s device, size and ``cfg``; raises,
    before any launch, NotImplementedError for a list of shards and
    ValueError for an unknown moment method."""
    if isinstance(scan, (list, tuple)):
        raise NotImplementedError(
            "the compiled entry points take one unsharded scan; use register "
            "and prepare_reference with a shard axis"
        )
    moment_route(cfg)
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
    """:func:`register` (with the static mask) as one captured graph:
    iteration 0, the later iterations under the device's early exit, the
    finish (the JAX package's ``register_jit``)."""
    fg = compiled_graphs(scan2, cfg)
    fg.load(scan=scan2, x0=x0, model=model)
    fg.solve(True)
    return fg.result(True)


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
    fg.solve(want_static_mask)
    return fg.result(want_static_mask)


def odometry_step_jit(
    model: VoxelModel, scan: torch.Tensor, x0: torch.Tensor, cfg: ICETConfig
) -> tuple[RegistrationResult, VoxelModel]:
    """:func:`odometry_step` as captured graphs: register ``scan`` against
    ``model``, then fit the scan's own model (the JAX package's
    ``odometry_step_jit``)."""
    fg = compiled_graphs(scan, cfg)
    fg.load(scan=scan, x0=x0, model=model)
    fg.solve(False)
    fg.run_prepare()
    return fg.result(False), fg.prepared()


__all__ = [
    "IterationDiag",
    "RegistrationResult",
    "VoxelModel",
    "compiled_graphs",
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
