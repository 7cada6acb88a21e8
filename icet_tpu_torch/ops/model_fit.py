"""The voxel-model fit of the prepare: from scan 1's ``(V+1, 16)`` moment
sums at X = 0, its clusters and anchors to the model's count, mean,
covariance, eigenbasis, per-axis keep mask and validity.

``model_fit`` launches the CUDA kernels of ``csrc/model_fit.cu`` on CUDA
tensors, two launches a fit, and takes the plain version,
``model_fit_reference``, only for CPU tensors.  The kernels replace no TPU
kernel: the JAX package leaves this plane math to XLA's fusion, and on this
card the unfused chain (``finalize_moments_planes``, ``eigh3_planes``, the
axis masks) is ~1,270 tiny launches a fit, 83% of every frame's
prepare.  Each row's values are the plain version's bit for bit;
the safeguard's two flags are ORs of integer bits over every row, the same
in any order.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from icet_tpu_torch import _build
from icet_tpu_torch.config import ICETConfig
from icet_tpu_torch.ops.geometry import TWO_PI, cart_to_spherical
from icet_tpu_torch.ops.gn_assembly import launch_plan
from icet_tpu_torch.ops.grid import voxel_ids
from icet_tpu_torch.ops.moments import cov6_to_matrix, finalize_moments_planes
from icet_tpu_torch.ops.wls_planes import eigh3_planes

#: eigh3_planes' cyclic sweeps before its safeguard
SWEEPS = 4
#: eigh3_planes' safeguard tolerance: the kernel takes float32 of its square
RTOL = 1e-5
#: float32 words of the kernel's scratch a row: two states of A and V
#: (``kScratchPerRow``)
SCRATCH_PER_ROW = 36
#: launches a fit: the sweeps, then the masks
LAUNCHES = 2
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: ``icet_model_fit``'s parameters: the 4 inputs, rows, sweeps, min_pts,
#: min_outer_range, rtol^2, the grid (6 ints, 6 floats), ndt, clip,
#: sigma_scale, clip_fill / 2, the cell's two angles, blocks, threads, then
#: scratch, flags, the 6 outputs and the stream
ARGTYPES = ((_P,) * 4 + (_I, _I, _F, _F, _F) + (_I,) * 6 + (_F,) * 6
            + (_I, _I, _F, _F, _F, _F, _I, _I) + (_P,) * 9)


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


def model_fit_reference(sums, clusters, anchors, cfg: ICETConfig, sweeps: int = SWEEPS):
    """Plain PyTorch version of :func:`model_fit`."""
    count, mean, cov6 = finalize_moments_planes(sums, anchors)
    valid = (
        clusters.found
        & (count >= cfg.min_pts)
        & (clusters.bounds[:, 1] > cfg.min_outer_range)
    )
    eigvals, basis = eigh3_planes(cov6, sweeps=sweeps, rtol=RTOL)
    if cfg.suppression == "ndt":
        lmask = _ndt_axis_mask(eigvals, basis, clusters.bounds, valid, cfg)
    else:
        lmask = _sigma_axis_mask(mean, eigvals, basis, clusters.bounds, valid, cfg)
    if cfg.clip_fill > 0.0:
        lmask = lmask * _clip_fill_mask(mean, eigvals, basis, clusters.bounds, valid, cfg)
    return count, mean, cov6_to_matrix(cov6), basis, lmask, valid


def reciprocal(x: float) -> float:
    """float32 of ``1 / float32(x)``: what a CUDA tensor divided by the
    Python scalar ``x`` is multiplied by (PyTorch's div_true kernel takes a
    CPU scalar divisor as its reciprocal)."""
    return float(np.float32(1.0) / np.float32(x))


def grid_args(cfg: ICETConfig) -> tuple:
    """The kernel's ``voxel_ids`` parameters: n_theta, n_phi, n_voxels,
    n_angular, radial_fixed, n_shells, then phi_min and the reciprocals of
    2 pi, the phi span, min_range and the log shell growth."""
    return (cfg.n_theta, cfg.n_phi, cfg.n_voxels, cfg.n_angular,
            int(cfg.radial_mode == "fixed"), cfg.n_shells, cfg.phi_min,
            reciprocal(TWO_PI), reciprocal(cfg.phi_max - cfg.phi_min),
            cfg.min_range, reciprocal(cfg.min_range), reciprocal(math.log(cfg.shell_growth)))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("model_fit")
    lib.icet_model_fit.argtypes = list(ARGTYPES)
    lib.icet_model_fit.restype = _I
    lib.icet_cuda_error_string.argtypes = [_I]
    lib.icet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(sums, clusters, anchors) -> None:
    rows = sums.shape[0]
    f32, b8 = torch.float32, torch.bool
    tensors = {
        "sums": (sums, (rows, 16), f32), "anchors": (anchors, (rows, 3), f32),
        "bounds": (clusters.bounds, (rows, 2), f32), "found": (clusters.found, (rows,), b8),
    }
    for name, (t, shape, dtype) in tensors.items():
        if t.device != sums.device:
            raise ValueError(f"{name} is on {t.device}, sums on {sums.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if rows < 1 or rows * SCRATCH_PER_ROW >= 2**31:
        raise ValueError(f"{rows} rows: outside the kernel's 32-bit indexing")


def model_fit(sums, clusters, anchors, cfg: ICETConfig, sweeps: int = SWEEPS):
    """The voxel model from scan 1's ``(V+1, 16)`` moment sums, its
    clusters (``bounds`` (V+1, 2), ``found`` (V+1,) bool) and anchors:
    ``(count (V+1,), mean (V+1, 3), cov (V+1, 3, 3), basis (V+1, 3, 3)
    eigenvectors as columns in ascending order, lmask (V+1, 3), valid
    (V+1,) bool)``, with eigh3_planes' ``sweeps`` cyclic sweeps before its
    safeguard (the default, 4, is the solver's).

    CUDA tensors go to the kernels, two launches a call and no read back to
    the host (``model_fit.launches`` counts the launches); CPU tensors go to
    :func:`model_fit_reference`.
    """
    if sums.device.type == "cpu":
        return model_fit_reference(sums, clusters, anchors, cfg, sweeps)
    if sums.device.type != "cuda":
        raise ValueError(f"no model-fit kernel for device {sums.device}")
    _check(sums, clusters, anchors)
    sums, anchors = sums.contiguous(), anchors.contiguous()
    bounds, found = clusters.bounds.contiguous(), clusters.found.contiguous()
    rows, dev = sums.shape[0], sums.device
    blocks, threads = launch_plan(rows)
    f32 = torch.float32
    scratch = torch.empty(rows * SCRATCH_PER_ROW, dtype=f32, device=dev)
    flags = torch.empty(blocks, dtype=torch.int32, device=dev)
    count = torch.empty(rows, dtype=f32, device=dev)
    mean = torch.empty((rows, 3), dtype=f32, device=dev)
    cov = torch.empty((rows, 3, 3), dtype=f32, device=dev)
    basis = torch.empty((rows, 3, 3), dtype=f32, device=dev)
    lmask = torch.empty((rows, 3), dtype=f32, device=dev)
    valid = torch.empty(rows, dtype=torch.bool, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.icet_model_fit(
            sums.data_ptr(), anchors.data_ptr(), bounds.data_ptr(), found.data_ptr(), rows,
            sweeps, float(cfg.min_pts), cfg.min_outer_range, RTOL * RTOL, *grid_args(cfg),
            int(cfg.suppression == "ndt"), int(cfg.clip_fill > 0.0), cfg.sigma_scale,
            0.5 * cfg.clip_fill,
            2.0 * math.pi / cfg.n_theta, (cfg.phi_max - cfg.phi_min) / cfg.n_phi,
            blocks, threads, scratch.data_ptr(), flags.data_ptr(), count.data_ptr(),
            mean.data_ptr(), cov.data_ptr(), basis.data_ptr(), lmask.data_ptr(),
            valid.data_ptr(), stream,
        )
    if err != 0:
        msg = lib.icet_cuda_error_string(err).decode()
        raise RuntimeError(f"model-fit kernel launch failed: {msg} ({err})")
    model_fit.launches += LAUNCHES
    return count, mean, cov, basis, lmask, valid


#: launches of the CUDA kernels (plain-version calls on CPU tensors do not count)
model_fit.launches = 0
