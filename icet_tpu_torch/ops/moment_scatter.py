"""Moment scatter: per-point feature rows summed into their voxel's row.

``moment_scatter_sums`` launches the CUDA kernel ``csrc/moment_scatter.cu``
on CUDA tensors and takes the plain version, ``moment_scatter_reference``
(one ``index_add_``), only for CPU tensors.  It replaces the TPU kernel
``icet_tpu/ops/pallas_moments.py::_moment_kernel`` (wrapper
``pallas_moment_sums``), the accumulator of ``moment_method="pallas"``.
Ids outside ``[0, V]`` are dropped, as the TPU kernel drops them (they
match no column of its one-hot).  One cooperative launch a call:
tables of up to ``SHARED_ROWS`` rows are summed per block in shared memory,
larger ones (fixed radial mode's 90,001 rows) with global atomics
(``launch_plan`` sizes the grid).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icet_tpu_torch import _build

#: feature columns of a row (the JAX package's padded moment layout)
N_COLS = 16
#: largest table (rows x 16 float32) one block's shared memory holds
#: beside the kernel's static shared memory
SHARED_ROWS = (232_448 - 8) // (N_COLS * 4)
#: points a block of the kernel takes a round (1,024 threads, 4 a point);
#: the grid stops growing at one round a block
POINTS_PER_ROUND = 256


def moment_scatter_reference(vid: torch.Tensor, feats: torch.Tensor, n_voxels: int) -> torch.Tensor:
    """Plain PyTorch version: ``(V+1, 16)`` sums of the rows of ``feats``
    by voxel id ``vid`` (ids in ``[0, V]``, ``V`` the sentinel row; other
    ids are dropped).  With every id in range it is one ``index_add_``
    into the table, bit for bit."""
    idx = vid.long()
    dropped = (idx < 0) | (idx > n_voxels)
    # Dropped rows go to one extra row, sliced off after the sum.
    out = feats.new_zeros((n_voxels + 2, feats.shape[1]))
    out.index_add_(0, torch.where(dropped, n_voxels + 1, idx), feats)
    return out[: n_voxels + 1]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("moment_scatter")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.icet_moment_scatter.argtypes = [p, p, i, i, p, i, i, i, p]
    lib.icet_moment_scatter.restype = i
    lib.icet_cuda_error_string.argtypes = [i]
    lib.icet_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_plan(n: int, n_voxels: int, sm_count: int) -> tuple[int, int, bool]:
    """``(blocks, points a block, shared)`` of one launch.  ``shared``: the
    V+1 rows fit one block's shared memory.  Then at most one block an SM
    and at least ``POINTS_PER_ROUND`` points a block; else one block an SM,
    all of which zero the large table.  Each block takes a contiguous slice
    of ``ceil(n / blocks)`` points."""
    shared = n_voxels + 1 <= SHARED_ROWS
    blocks = max(1, min(sm_count, -(-n // POINTS_PER_ROUND))) if shared else sm_count
    return blocks, -(-n // blocks), shared


def _check(vid: torch.Tensor, feats: torch.Tensor) -> None:
    if vid.device != feats.device:
        raise ValueError(f"vid is on {vid.device}, feats on {feats.device}")
    if vid.dtype != torch.int32:
        raise TypeError(f"vid must be int32, got {vid.dtype}")
    if feats.dtype != torch.float32:
        raise TypeError(f"feats must be float32, got {feats.dtype}")
    n = vid.shape[0]
    if vid.ndim != 1 or tuple(feats.shape) != (n, N_COLS):
        raise ValueError(
            f"vid must be (N,) and feats (N, {N_COLS}); got {tuple(vid.shape)} "
            f"and {tuple(feats.shape)}"
        )
    if not (vid.is_contiguous() and feats.is_contiguous()):
        raise ValueError("vid and feats must be contiguous")
    if feats.data_ptr() % 16:
        raise ValueError("feats must be 16-byte aligned (the kernel loads float4s)")
    if n * N_COLS >= 2**31:
        raise ValueError("too many points for 32-bit indexing")


def moment_scatter_sums(vid: torch.Tensor, feats: torch.Tensor, n_voxels: int) -> torch.Tensor:
    """``(V+1, 16)`` sums of the ``(N, 16)`` float32 rows of ``feats`` by
    their int32 voxel id ``vid``; ids outside ``[0, V]`` are dropped.

    CUDA tensors go to the kernel, one launch a call and no read back to the
    host (``moment_scatter_sums.launches`` counts its launches); CPU tensors
    go to :func:`moment_scatter_reference`.
    """
    if vid.device.type == "cpu" and feats.device.type == "cpu":
        return moment_scatter_reference(vid, feats, n_voxels)
    if feats.device.type != "cuda":
        raise ValueError(f"no moment scatter kernel for device {feats.device}")
    _check(vid, feats)
    rows = n_voxels + 1
    index = feats.device.index if feats.device.index is not None else torch.cuda.current_device()
    blocks, per_block, shared = launch_plan(vid.shape[0], n_voxels, _sm_count(index))
    out = torch.empty((rows, N_COLS), dtype=torch.float32, device=feats.device)
    lib = _lib()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.icet_moment_scatter(
            vid.data_ptr(), feats.data_ptr(), vid.shape[0], rows, out.data_ptr(),
            blocks, per_block, int(shared), stream,
        )
    if err != 0:
        msg = lib.icet_cuda_error_string(err).decode()
        raise RuntimeError(f"moment scatter kernel launch failed: {msg} ({err})")
    moment_scatter_sums.launches += 1
    return out


#: launches of the CUDA kernel (plain-version calls on CPU tensors do not count)
moment_scatter_sums.launches = 0
