"""Gauss-Newton normal-equation assembly: from scan 2's ``(V+1, 16)``
moment sums and the voxel model to the correspondences and the normal
equations of one iteration.

``gn_assembly`` launches the CUDA kernel ``csrc/gn_assembly.cu`` on CUDA
tensors, one launch an iteration, and takes the plain version,
``gn_assembly_reference``, only for CPU tensors.  The kernel replaces no
TPU kernel: the JAX package leaves this plane math to XLA's fusion, and on
this card the unfused chain (``finalize_moments_planes``, the mask, the
moving-object test, ``assemble_normal_equations``) is ~1,650 tiny launches
an iteration, more than the rest of the frame.  Each row's values are the
plain version's bit for bit; the sums over rows are added in an order the
kernel fixes (block partials, then the blocks in order), the same bits
every launch.  ``launch_plan`` sizes the launch, ``scratch_words`` its
block partials.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icet_tpu_torch import _build
from icet_tpu_torch.config import ICETConfig
from icet_tpu_torch.ops.moments import finalize_moments_planes
from icet_tpu_torch.ops.wls_planes import assemble_normal_equations, residual_compact_planes

#: threads a block below and above :data:`SMALL_ROWS` rows
SMALL_THREADS, LARGE_THREADS = 64, 256
#: the most rows the small blocks take (256 blocks of 64)
SMALL_ROWS = 256 * SMALL_THREADS
#: 32-bit words of a block's partial: 33 sums, n_corr and n_rejected
#: (``kStride`` in the kernel)
PARTIAL_WORDS = 35
#: floats of the output: H^T W H (6, 6), H^T W dz (6,), H^T W g (6,)
OUT_FLOATS = 48
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: ``icet_gn_assembly``'s parameters: the 11 inputs, rows, min_pts, rcond,
#: moving, its two thresholds, sens, blocks, threads, then scratch, corr,
#: out, counts and the stream
ARGTYPES = (_P,) * 11 + (_I, _F, _F, _I, _F, _F, _I, _I, _I) + (_P,) * 5


def moving_active(cfg: ICETConfig, it: int) -> bool:
    """Whether iteration ``it`` (global) runs the moving-object test."""
    return cfg.remove_moving and it >= cfg.rm_start_iter


def covariance_yaw(cov: torch.Tensor) -> torch.Tensor:
    """Moving-object heuristic: yaw of the covariance's first row,
    ``atan2(-cov[0,1], cov[0,0])``; (V, 3, 3) or (V, 6) packed input."""
    if cov.ndim == 2:
        return torch.atan2(-cov[:, 3], cov[:, 0])
    return torch.atan2(-cov[..., 0, 1], cov[..., 0, 0])


def gn_assembly_reference(model, sums, X, dR, it: int, cfg: ICETConfig,
                          corr_mask=None, want_range_sens: bool = False):
    """Plain PyTorch version of :func:`gn_assembly`."""
    count2, mean2, cov2 = finalize_moments_planes(sums, model.anchors)

    corr = model.valid & (count2 >= cfg.min_pts)
    if corr_mask is not None:
        corr = corr & corr_mask

    n_rejected = torch.zeros((), dtype=torch.int32, device=X.device)
    if moving_active(cfg, it):
        res_compact = residual_compact_planes(model.basis, model.lmask, model.mean, mean2)
        bad_res = torch.any(torch.abs(res_compact) > cfg.rm_residual_thresh, dim=-1)
        yaw_delta = torch.abs(covariance_yaw(model.cov) - covariance_yaw(cov2))
        bad = corr & (bad_res | (yaw_delta > cfg.rm_yaw_thresh))
        n_rejected = torch.sum(bad, dtype=torch.int32)
        corr = corr & ~bad

    cm = corr.to(X.dtype)
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
    return corr, torch.sum(corr, dtype=torch.int32), n_rejected, HTWH, HTWdz, htwg


def launch_plan(rows: int) -> tuple[int, int]:
    """``(blocks, threads a block)``: one thread a row, in blocks of
    :data:`SMALL_THREADS` up to :data:`SMALL_ROWS` rows (so few rows still
    spread over the SMs), else of :data:`LARGE_THREADS` (so the last block
    adds fewer partials)."""
    threads = SMALL_THREADS if rows <= SMALL_ROWS else LARGE_THREADS
    return -(-rows // threads), threads


def scratch_words(blocks: int) -> int:
    """32-bit words of the kernel's scratch: a partial a block."""
    return blocks * PARTIAL_WORDS


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("gn_assembly")
    lib.icet_gn_assembly.argtypes = list(ARGTYPES)
    lib.icet_gn_assembly.restype = _I
    lib.icet_cuda_error_string.argtypes = [_I]
    lib.icet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(model, sums, X, dR, corr_mask) -> None:
    rows = sums.shape[0]
    f32, b8 = torch.float32, torch.bool
    tensors = {
        "sums": (sums, (rows, 16), f32), "anchors": (model.anchors, (rows, 3), f32),
        "count": (model.count, (rows,), f32), "mean": (model.mean, (rows, 3), f32),
        "cov": (model.cov, (rows, 3, 3), f32), "basis": (model.basis, (rows, 3, 3), f32),
        "lmask": (model.lmask, (rows, 3), f32), "valid": (model.valid, (rows,), b8),
        "X": (X, (6,), f32), "dR": (dR, (3, 3, 3), f32),
    }
    if corr_mask is not None:
        tensors["corr_mask"] = (corr_mask, (rows,), b8)
    for name, (t, shape, dtype) in tensors.items():
        if t.device != sums.device:
            raise ValueError(f"{name} is on {t.device}, sums on {sums.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if rows < 1 or rows * 16 >= 2**31:
        raise ValueError(f"{rows} rows: outside the kernel's 32-bit indexing")


def gn_assembly(model, sums, X, dR, it: int, cfg: ICETConfig, corr_mask=None,
                want_range_sens: bool = False):
    """One iteration's correspondences and normal equations from scan 2's
    ``(V+1, 16)`` moment sums at X and the voxel ``model``: ``(corr (V+1,)
    bool, n_corr int32, n_rejected int32, HTWH (6, 6), HTWdz (6,), HTWg (6,)
    or None)``.  ``dR`` is the (3, 3, 3) rotation derivative at X; ``it``
    the global iteration (the moving-object test runs from
    ``cfg.rm_start_iter`` when ``cfg.remove_moving``); ``corr_mask`` an
    optional (V+1,) bool mask of allowed voxels; ``want_range_sens`` adds
    ``HTWg``, the range-sensitivity right-hand side.

    CUDA tensors go to the kernel, one launch a call and no read back to
    the host (``gn_assembly.launches`` counts its launches); CPU tensors go
    to :func:`gn_assembly_reference`.
    """
    if sums.device.type == "cpu":
        return gn_assembly_reference(model, sums, X, dR, it, cfg, corr_mask, want_range_sens)
    if sums.device.type != "cuda":
        raise ValueError(f"no normal-equation kernel for device {sums.device}")
    _check(model, sums, X, dR, corr_mask)
    # Views (the eager model's count is a column of its sums) are copied;
    # the compiled paths' buffers are contiguous already.
    model = type(model)(*(t.contiguous() for t in model))
    sums, X, dR = sums.contiguous(), X.contiguous(), dR.contiguous()
    if corr_mask is not None:
        corr_mask = corr_mask.contiguous()
    rows, dev = sums.shape[0], sums.device
    blocks, threads = launch_plan(rows)
    scratch = torch.empty(scratch_words(blocks), dtype=torch.float32, device=dev)
    corr = torch.empty(rows, dtype=torch.bool, device=dev)
    out = torch.empty(OUT_FLOATS, dtype=torch.float32, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.icet_gn_assembly(
            sums.data_ptr(), model.anchors.data_ptr(), model.count.data_ptr(),
            model.mean.data_ptr(), model.cov.data_ptr(), model.basis.data_ptr(),
            model.lmask.data_ptr(), model.valid.data_ptr(),
            None if corr_mask is None else corr_mask.data_ptr(), X.data_ptr(), dR.data_ptr(),
            rows, float(cfg.min_pts), cfg.pinv_rcond, int(moving_active(cfg, it)),
            cfg.rm_residual_thresh, cfg.rm_yaw_thresh, int(want_range_sens), blocks, threads,
            scratch.data_ptr(), corr.data_ptr(), out.data_ptr(), counts.data_ptr(), stream,
        )
    if err != 0:
        msg = lib.icet_cuda_error_string(err).decode()
        raise RuntimeError(f"normal-equation kernel launch failed: {msg} ({err})")
    gn_assembly.launches += 1
    htwg = out[42:48] if want_range_sens else None
    return corr, counts[0], counts[1], out[:36].view(6, 6), out[36:42], htwg


#: launches of the CUDA kernel (plain-version calls on CPU tensors do not count)
gn_assembly.launches = 0
