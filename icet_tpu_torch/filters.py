"""The DNN perspective-shift filter (``icet_tpu/filters.py``).

Per voxel, S points are sampled from each scan; the bias network predicts
the voxel's true inter-scan translation, and voxels whose ICET mean
residual disagrees with it beyond ``cfg.dnn_thresh`` (in the voxel's
extended-axis-suppressed frame) are rejected from the solve.  With
``cfg.dnn_in_loop`` the mask is recomputed from the current estimate at
every iteration from ``dnn_start_iter`` on; otherwise once, at the phase
boundary.

Differences from the JAX package, none of which changes a result:

* the lean samples that feed only the encoder are a ``(V+1, S, 3)`` bf16
  tensor, not bf16 pairs packed into u32 words (a TPU scatter trick);
* the filter's moments pass over the aligned scan is the solver's own
  ``_moment_sums`` (the fused CUDA kernel on the card), which has no
  window, so there is no spill pass and nothing overflows;
* the ``register`` calls whose result only carries X (the plain phase
  and all in-loop steps but the last) skip the range-sensitivity pass,
  which cannot change X.

The compiled entry points :func:`model_voxel_samples_jit`,
:func:`odometry_step_dnn_jit` and :func:`register_pair_with_dnn` run the
same computation as capture-safe stages (``_stage_samples``,
``_stage_filter``, the solver's stages of each phase's derived config,
``_stage_handover``): on CUDA each one a CUDA graph of the frame's set
(``icet_tpu_torch.graphs``), on the CPU plain calls that equal the eager
functions bit for bit.  The filter reads scan 1 only through its samples,
so the previous scan itself is not carried in a buffer.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from icet_tpu_torch import graphs
from icet_tpu_torch.config import ICETConfig
from icet_tpu_torch.device import as_points, resolve_device
from icet_tpu_torch.models.bias_net import (
    BiasNet,
    apply_bias_net,
    load_pretrained,
    pack_voxel_samples,
)
from icet_tpu_torch.ops.clustering import membership
from icet_tpu_torch.ops.geometry import cart_to_spherical, transform_points
from icet_tpu_torch.ops.grid import voxel_ids
from icet_tpu_torch.ops.linalg import small_matmul
from icet_tpu_torch.ops.moments import finalize_moments_planes
from icet_tpu_torch.solver import (
    RegistrationResult,
    VoxelModel,
    _moment_sums,
    compiled_graphs,
    prepare_reference,
    prepare_reference_jit,
    register,
    register_pair,
)


def sample_voxel_points(
    points: torch.Tensor,
    vid: torch.Tensor,
    member: torch.Tensor,
    n_voxels: int,
    n_samples: int,
    mode: str = "head",
    counts: torch.Tensor | None = None,
    fill_tail: bool = True,
):
    """Fixed-size per-voxel point samples, dense ``(V+1, S, 3)``.

    ``mode="head"`` takes each voxel's first S points in scan order (a
    stable sort of the member-masked voxel ids, the coordinates carried
    through it).  With ``fill_tail`` the rows past a voxel's count repeat
    its first point and the clipped counts come back; without it (the lean
    path, which feeds only the bf16 encoder) the samples come back as
    zero-tailed bf16 and no counts.  ``mode="strided"`` takes S evenly
    strided positions over each voxel's run, with the per-voxel counts.
    """
    n = points.shape[0]
    vidm = torch.where(member, vid, n_voxels).long()
    if mode == "strided":
        if counts is None:
            counts = torch.zeros(n_voxels + 1, dtype=torch.int32, device=points.device)
            counts = counts.index_add_(0, vidm, torch.ones_like(vidm, dtype=torch.int32))
        order = torch.argsort(vidm, stable=True)
        offsets = torch.cumsum(counts, 0) - counts
        k = torch.arange(n_samples, dtype=torch.int64, device=points.device)[None, :]
        within = (k * torch.clamp(counts, min=1).long()[:, None]) // n_samples
        take = torch.clamp(offsets.long()[:, None] + within, 0, n - 1)
        return points[order[take]], counts

    S, v1 = n_samples, n_voxels + 1
    vs, order = torch.sort(vidm, stable=True)
    pts_s = points[order]
    # Rank within the voxel's run: position minus the run's start.  The
    # counts come from index_add_ into V+1 rows and every point is written
    # (the ones past S or outside any voxel to one dump row past the
    # (V+1) S slots, then sliced off: the JAX package's mode="drop"), so no
    # size is read back from the device.
    counts = torch.zeros(v1, dtype=torch.int64, device=points.device).index_add_(
        0, vs, torch.ones_like(vs))
    rank = torch.arange(n, device=points.device) - (torch.cumsum(counts, 0) - counts)[vs]
    write = (vs < n_voxels) & (rank < S)
    tgt = torch.where(write, vs * S + rank, v1 * S)
    dtype = points.dtype if fill_tail else torch.bfloat16
    buf = torch.zeros((v1 * S + 1, 3), dtype=dtype, device=points.device)
    buf[tgt] = pts_s.to(dtype)
    samples = buf[: v1 * S].reshape(v1, S, 3)
    if not fill_tail:
        return samples, None
    # Member points are range-gated, so a slot was written iff a coordinate
    # is nonzero; tail slots repeat the voxel's first point (max-neutral).
    row_ok = torch.any(samples != 0.0, dim=-1)
    samples = torch.where(row_ok[..., None], samples, samples[:, :1, :])
    return samples, row_ok.sum(dim=-1, dtype=torch.int32)


def _unpack_fill_samples(lean: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Zero-tailed bf16 lean samples ``(V+1, S, 3)`` -> float32 with each
    voxel's first point repeated into the rows past ``min(counts, S)``."""
    samples = lean.float()
    S = samples.shape[-2]
    ok = (torch.arange(S, device=samples.device)[None, :]
          < torch.clamp(counts, 1, S)[:, None])
    return torch.where(ok[..., None], samples, samples[:, :1, :])


def model_voxel_samples(model: VoxelModel, scan1: torch.Tensor, cfg: ICETConfig):
    """Lean per-voxel samples of the model's source scan and its member
    counts clipped to ``cfg.dnn_sample_pts`` (from the model's own exact
    counts: the sampling uses the same membership)."""
    rtp = cart_to_spherical(scan1)
    vid = voxel_ids(rtp, cfg)
    member = membership(vid, rtp[..., 0], rtp[..., 0] >= cfg.min_range,
                        model.bounds, cfg.n_voxels)
    samples, _ = sample_voxel_points(scan1, vid, member, cfg.n_voxels,
                                     cfg.dnn_sample_pts, fill_tail=False)
    counts = torch.clamp(model.count.to(torch.int32), 0, cfg.dnn_sample_pts)
    return samples, counts


class DnnFilterResult(NamedTuple):
    keep: torch.Tensor  # (V+1,) voxels NOT rejected
    dnn_shift: torch.Tensor  # (V+1, 3) network-estimated voxel translations
    icet_shift: torch.Tensor  # (V+1, 3) mean-residual shift compared with it
    n_rejected: torch.Tensor  # () int32
    # Of a filtered solve (``register_with_dnn``), every pass in order, the
    # last one the fields above; None from a single pass (dnn_reject_mask).
    keeps: torch.Tensor | None = None  # (P, V+1)
    dnn_shifts: torch.Tensor | None = None  # (P, V+1, 3)
    icet_shifts: torch.Tensor | None = None  # (P, V+1, 3)


def _passes(filts: list) -> DnnFilterResult:
    """The last of a solve's passes ``filts``, with every pass's keep mask
    and both shifts."""
    return filts[-1]._replace(keeps=torch.stack([f.keep for f in filts]),
                              dnn_shifts=torch.stack([f.dnn_shift for f in filts]),
                              icet_shifts=torch.stack([f.icet_shift for f in filts]))


def dnn_reject_mask(
    net: BiasNet,
    model: VoxelModel,
    scan1: torch.Tensor,
    scan2_aligned: torch.Tensor,
    cfg: ICETConfig,
    refine_steps: int | None = None,
    samples1: tuple | None = None,
) -> DnnFilterResult:
    """Keep-mask of the voxels whose ICET mean residual agrees with the bias
    network's translation estimate.  ``samples1`` is scan 1's precomputed
    :func:`model_voxel_samples`."""
    s1, n1 = samples1 if samples1 is not None else model_voxel_samples(model, scan1, cfg)
    s2, _ = model_voxel_samples(model, scan2_aligned, cfg)

    # The exact per-voxel mean residual, from one moments pass at X = 0.
    zero6 = torch.zeros(6, dtype=scan2_aligned.dtype, device=scan2_aligned.device)
    sums2 = _moment_sums(scan2_aligned, zero6, model.bounds, model.anchors, cfg)
    count2, mean2, _ = finalize_moments_planes(sums2, model.anchors)
    icet_shift = mean2 - model.mean
    n2 = torch.clamp(count2.to(torch.int32), 0, cfg.dnn_sample_pts)

    # Iterative refinement: shift sample 1 by the running estimate.
    s1f = _unpack_fill_samples(s1, n1)
    s2f = _unpack_fill_samples(s2, n2)
    shift = torch.zeros_like(icet_shift)
    if refine_steps is None:
        refine_steps = cfg.dnn_refine_steps
    for _ in range(refine_steps):
        shift = shift + apply_bias_net(net, pack_voxel_samples(s1f + shift[:, None, :], s2f))

    # Compare in the extended-axis-suppressed frame, U diag(l) U^T.
    P = model.lmask[:, :, None] * torch.swapaxes(model.basis, -1, -2)
    proj = small_matmul(model.basis, P)
    diff = torch.sum(proj * (icet_shift - shift)[:, None, :], dim=-1)
    candidates = model.valid & (model.count >= cfg.min_pts) & (count2 >= cfg.min_pts)
    bad = candidates & torch.any(torch.abs(diff) > cfg.dnn_thresh, dim=-1)
    return DnnFilterResult(keep=~bad, dnn_shift=shift, icet_shift=icet_shift,
                           n_rejected=bad.sum(dtype=torch.int32))


_PRETRAINED_CACHE: dict = {}


def pretrained_dnn(cfg: ICETConfig, device: str | torch.device | None = None) -> BiasNet:
    """The bundled pretrained bias network for ``cfg.dnn_sample_pts`` on
    ``device`` (CUDA unless told otherwise; process-cached)."""
    dev = resolve_device(device)
    key = (cfg.dnn_sample_pts, str(dev))
    if key not in _PRETRAINED_CACHE:
        _PRETRAINED_CACHE[key] = load_pretrained(cfg.dnn_sample_pts).to(dev)
    return _PRETRAINED_CACHE[key]


def register_with_dnn(
    model: VoxelModel,
    scan1: torch.Tensor,
    scan2: torch.Tensor,
    x0: torch.Tensor,
    cfg: ICETConfig,
    net: BiasNet,
    want_static_mask: bool = True,
    samples1: tuple | None = None,
) -> tuple[RegistrationResult, DnnFilterResult]:
    """Registration against a prepared model with the DNN filter engaged.

    ``n_pre = max(min(dnn_start_iter, n_iters - 1), 1)`` plain iterations,
    then ``n_post = n_iters - n_pre`` filtered ones: in-loop, each
    recomputes the mask at the current X; one-shot (``dnn_in_loop=False``),
    one mask at the boundary serves them all.  Every phase carries the
    global iteration index.  With ``n_iters < 2`` the solve runs once and
    the mask is only reported.  The result's ``iterations`` counts the
    iterations of all phases; the filter's result is the last pass, with
    every pass's mask and shifts (``keeps``, ``dnn_shifts``,
    ``icet_shifts``).
    """
    scan2 = scan2.contiguous()
    if cfg.n_iters < 2:
        pre = register(model, scan2, x0, cfg.replace(n_iters=1),
                       want_static_mask=want_static_mask)
        filt = dnn_reject_mask(net, model, scan1, transform_points(scan2, pre.X), cfg,
                               samples1=samples1)
        return pre, _passes([filt])
    n_pre = max(min(cfg.dnn_start_iter, cfg.n_iters - 1), 1)
    n_post = cfg.n_iters - n_pre
    # Results that only carry X skip the range-sensitivity pass: it cannot
    # change X.
    pre = register(model, scan2, x0, cfg.replace(n_iters=n_pre, range_sigma=0.0),
                   want_static_mask=False)

    if not cfg.dnn_in_loop:
        filt = dnn_reject_mask(net, model, scan1, transform_points(scan2, pre.X), cfg,
                               samples1=samples1)
        post = register(model, scan2, pre.X, cfg.replace(n_iters=n_post),
                        corr_mask=filt.keep, want_static_mask=want_static_mask,
                        it_offset=n_pre)
        return post._replace(iterations=pre.iterations + post.iterations), _passes([filt])

    step_cfg = cfg.replace(n_iters=1, convergence_tol=0.0)
    s1 = samples1 if samples1 is not None else model_voxel_samples(model, scan1, cfg)
    X, filts = pre.X, []
    for k in range(n_post - 1):
        filts.append(dnn_reject_mask(net, model, scan1, transform_points(scan2, X), cfg,
                                     samples1=s1))
        X = register(model, scan2, X, step_cfg.replace(range_sigma=0.0),
                     corr_mask=filts[-1].keep, want_static_mask=False,
                     it_offset=n_pre + k).X
    filts.append(dnn_reject_mask(net, model, scan1, transform_points(scan2, X), cfg,
                                 samples1=s1))
    res = register(model, scan2, X, step_cfg, corr_mask=filts[-1].keep,
                   want_static_mask=want_static_mask, it_offset=cfg.n_iters - 1)
    return res._replace(iterations=pre.iterations + n_post), _passes(filts)


def register_pair_with_dnn(
    scan1,
    scan2,
    x0,
    cfg: ICETConfig,
    net: BiasNet,
    device: str | torch.device | None = None,
) -> tuple[RegistrationResult, DnnFilterResult]:
    """Pair-level entry on ``device`` (CUDA unless told otherwise; ``net``
    must be there too): fit scan 1's model, then register scan 2 with the
    filter: scan 1's model and samples, then the filtered solve, as
    captured graphs (:func:`register_with_dnn` is the plain version)."""
    dev = resolve_device(device)
    s1, s2 = as_points(scan1, dev), as_points(scan2, dev)
    x0 = torch.as_tensor(x0, dtype=torch.float32).to(dev)
    model = prepare_reference_jit(s1, cfg)
    samples1 = model_voxel_samples_jit(model, s1, cfg)
    fg = compiled_graphs(s2, cfg)
    fg.load(scan=s2, x0=x0, model=model, samples=samples1)
    n_final = solve_dnn(fg, net, True)
    return fg.result(True, n_final), _filter_out(fg)


def register_scans(
    scan1,
    scan2,
    x0=None,
    cfg: ICETConfig | None = None,
    device: str | torch.device | None = None,
) -> RegistrationResult:
    """Config-driven scan-pair registration on ``device`` (CUDA unless told
    otherwise): with ``cfg.dnn_filter`` the bundled pretrained bias network
    engages the filter, otherwise this is :func:`solver.register_pair`."""
    cfg = cfg or ICETConfig()
    if x0 is None:
        x0 = torch.zeros(6)
    if not cfg.dnn_filter:
        return register_pair(scan1, scan2, x0, cfg, device=device)
    dev = resolve_device(device)
    res, _ = register_pair_with_dnn(scan1, scan2, x0, cfg, pretrained_dnn(cfg, dev), dev)
    return res


def odometry_step_dnn(
    model: VoxelModel,
    prev_scan: torch.Tensor,
    prev_samples: tuple,
    scan: torch.Tensor,
    x0: torch.Tensor,
    cfg: ICETConfig,
    net: BiasNet,
) -> tuple[RegistrationResult, VoxelModel, tuple, DnnFilterResult]:
    """DNN-filtered odometry step: register ``scan`` against the previous
    frame's model with the filter (the previous scan's samples reused), then
    fit the scan's own model and samples for the next frame.  Returns the
    filter's last result too (the JAX package's step drops it)."""
    res, filt = register_with_dnn(model, prev_scan, scan, x0, cfg, net,
                                  want_static_mask=False, samples1=prev_samples)
    new_model = prepare_reference(scan, cfg)
    return res, new_model, model_voxel_samples(new_model, scan, cfg), filt


# ---------------------------------------------------------------------------
# Capture-safe stages and the compiled entry points
# ---------------------------------------------------------------------------


def _stage_samples(b, cfg: ICETConfig, src: str) -> None:
    """:func:`model_voxel_samples` of ``b.scan`` against ``b.model``
    (``src="model"``) or the prepared model (``"prepared"``), into
    ``b.samples_next``."""
    model = b.model if src == "model" else VoxelModel(**b.prepared)
    samples, counts = model_voxel_samples(model, b.scan, cfg)
    b.samples_next["samples"].copy_(samples)
    b.samples_next["counts"].copy_(counts)


def _stage_filter(b, cfg: ICETConfig, net: BiasNet, k: int) -> None:
    """:func:`dnn_reject_mask` of ``b.scan`` aligned by ``b.X`` against
    ``b.model``, scan 1 given by its samples ``b.samples1``, into
    ``b.filt`` as the solve's pass ``k``: the sampling pass, kernel #1's
    moments pass at X = 0, ``dnn_refine_steps`` launches of kernel #4, the
    comparison."""
    filt = dnn_reject_mask(net, b.model, None, transform_points(b.scan, b.X), cfg,
                           samples1=(b.samples1["samples"], b.samples1["counts"]))
    for name, t in zip(DnnFilterResult._fields, filt):
        if t is not None:
            b.filt[name].copy_(t)
    b.filt["keeps"][k].copy_(filt.keep)
    b.filt["dnn_shifts"][k].copy_(filt.dnn_shift)
    b.filt["icet_shifts"][k].copy_(filt.icet_shift)


def _stage_handover(b) -> None:
    """The next frame's inputs: the prepared model and the new scan's
    samples into the model and scan-1 sample buffers."""
    b.model_buf.copy_(b.prepared_buf)
    b.samples1_buf.copy_(b.samples_next_buf)


def solve_dnn(fg, net: BiasNet, want_static_mask: bool) -> int:
    """:func:`register_with_dnn` of the loaded scan against the loaded model
    and scan-1 samples, from the loaded x0, as one graph of the set: the
    same phases, each the schedule of a register call of its derived
    config (its early exit guarded on the device, its iterations with their
    global indices), the filter stage between them (each pass a span
    ``dnn_filter`` of the frame log: ``graphs.Span``).  The last filter
    pass, and every pass's keep mask and shifts, stay in ``b.filt``; the
    iterations of all phases are counted in ``b.iters``.  Returns the
    ``n_iters`` of the finished call."""
    cfg = fg.cfg
    fg.pin(net)
    versions = tuple(t._version for t in net.encoder_weights())

    def filt(k):
        return graphs.Span("dnn_filter", lambda b: _stage_filter(b, cfg, net, k))

    if cfg.n_iters < 2:
        schedule = fg.solve_schedule(want_static_mask, cfg.replace(n_iters=1)) + [filt(0)]
        n_final = 1
    else:
        n_pre, n_post = graphs.dnn_phases(cfg)
        schedule = fg.solve_schedule(False, cfg.replace(n_iters=n_pre, range_sigma=0.0),
                                     finish=False)
        if not cfg.dnn_in_loop:
            schedule += [filt(0)] + fg.solve_schedule(
                want_static_mask, cfg.replace(n_iters=n_post), it_offset=n_pre, masked=True,
                start="X")
            n_final = n_post
        else:
            step_cfg = cfg.replace(n_iters=1, convergence_tol=0.0)
            for k in range(n_post - 1):
                schedule += [filt(k)] + fg.solve_schedule(
                    False, step_cfg.replace(range_sigma=0.0), it_offset=n_pre + k, masked=True,
                    start="X", finish=False)
            schedule += [filt(n_post - 1)] + fg.solve_schedule(
                want_static_mask, step_cfg, it_offset=cfg.n_iters - 1, masked=True, start="X")
            n_final = 1
    fg.run_schedule(("dnn", id(net), versions, want_static_mask), schedule)
    return n_final


def _samples_out(fg) -> tuple[torch.Tensor, torch.Tensor]:
    b = fg.buffers
    v = b.samples_layout.views(graphs.clone_out(b.samples_next_buf))
    return v["samples"], v["counts"]


def _filter_out(fg) -> DnnFilterResult:
    b = fg.buffers
    return DnnFilterResult(**b.filt_layout.views(graphs.clone_out(b.filt_buf)))


def model_voxel_samples_jit(model: VoxelModel, scan: torch.Tensor, cfg: ICETConfig):
    """:func:`model_voxel_samples` as a captured graph (the JAX package's
    ``model_voxel_samples_jit``)."""
    fg = compiled_graphs(scan, cfg)
    fg.load(scan=scan, model=model)
    fg.run(("samples", "model"), lambda b: _stage_samples(b, cfg, "model"))
    return _samples_out(fg)


def odometry_step_dnn_jit(
    model: VoxelModel,
    prev_scan: torch.Tensor,
    prev_samples: tuple,
    scan: torch.Tensor,
    x0: torch.Tensor,
    cfg: ICETConfig,
    net: BiasNet,
    return_filter: bool = False,
):
    """:func:`odometry_step_dnn` as captured graphs (the JAX package's
    ``odometry_step_dnn_jit``): the filtered registration of ``scan``
    against ``model`` (scan 1 given by ``prev_samples``; ``prev_scan`` is
    not read, as in the JAX package), then the scan's own model and
    samples, then the hand-over of both into the buffers the next frame
    reads, so that passing them back costs no copy.  Returns ``(res,
    new_model, new_samples)``, and the last filter pass as a fourth element
    with ``return_filter``."""
    del prev_scan
    fg = compiled_graphs(scan, cfg)
    fg.load(scan=scan, x0=x0, model=model, samples=prev_samples)
    n_final = solve_dnn(fg, net, False)
    fg.run_prepare()
    fg.run(("samples", "prepared"), lambda b: _stage_samples(b, cfg, "prepared"))
    res = fg.result(False, n_final)
    new_model, new_samples = fg.prepared(), _samples_out(fg)
    filt = _filter_out(fg) if return_filter else None
    fg.run(("handover",), _stage_handover)
    fg.hold("model", new_model)
    fg.hold("samples", new_samples)
    if return_filter:
        return res, new_model, new_samples, filt
    return res, new_model, new_samples


__all__ = [
    "DnnFilterResult",
    "dnn_reject_mask",
    "model_voxel_samples",
    "model_voxel_samples_jit",
    "odometry_step_dnn",
    "odometry_step_dnn_jit",
    "pretrained_dnn",
    "register_pair_with_dnn",
    "register_scans",
    "register_with_dnn",
    "sample_voxel_points",
]
