"""Moment scatter: per-point feature rows summed into their voxel's row.

``moment_scatter_sums`` launches the CUDA kernel ``csrc/moment_scatter.cu``
on CUDA tensors and takes the plain version, ``moment_scatter_reference``
(one ``index_add_``), only for CPU tensors.  It replaces the TPU kernel
``icet_tpu/ops/pallas_moments.py::_moment_kernel`` (wrapper
``pallas_moment_sums``), the accumulator of ``moment_method="pallas"``,
and sums the plain moments route on the card.  Ids outside ``[0, V]`` are
dropped, as the TPU kernel drops them (they match no column of its
one-hot).  One cooperative launch a call, every float sum in an order the
kernel fixes, so a call repeats bit for bit: tables of up to
``SHARED_ROWS`` rows are summed per block in shared memory, larger ones
(fixed radial mode's 90,001 rows) by sorting parts of at most
``SORT_POINTS`` points by id; the parts' compacted partials are added in
part order (``launch_plan`` sizes the grid, ``part_plan`` the parts,
``scratch_words`` their scratch).
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
#: points of one set of a round (1,024 threads, 4 lanes a point); the grid
#: stops growing at one set a block
POINTS_PER_ROUND = 256
#: points a part of a larger table takes (one a thread of the block's sort)
SORT_POINTS = 1024
#: shared memory one block can hold on Hopper (227 KB)
MAX_SHARED_BYTES = 232_448
#: bytes of the sort's buffers beside the bitmap (``SortSmem`` in the kernel)
SORT_SMEM_BYTES = 12_800


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
    lib.icet_moment_scatter.argtypes = [p, p, i, i, p, p, i, i, i, i, i, p]
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
    all of which write the large table.  Each block takes a contiguous
    slice of ``ceil(n / blocks)`` points (cut into parts by
    :func:`part_plan`)."""
    shared = n_voxels + 1 <= SHARED_ROWS
    blocks = max(1, min(sm_count, -(-n // POINTS_PER_ROUND))) if shared else sm_count
    return blocks, -(-n // blocks), shared


def part_plan(n: int, n_voxels: int, blocks: int, per_block: int,
              shared: bool) -> tuple[int, int, int]:
    """``(points a part, parts, cap)`` of a launch planned by
    :func:`launch_plan`: in shared memory one part a block; else parts of
    ``SORT_POINTS`` points, the block's whole sort (at least one part; the
    fewer the parts, the fewer partials the combine reads).  ``cap`` bounds
    the rows one part can touch."""
    if shared:
        chunk, parts = per_block, blocks
    else:
        chunk, parts = SORT_POINTS, max(1, -(-n // SORT_POINTS))
    return chunk, parts, max(1, min(n_voxels + 1, chunk))


def bitmap_words(n_voxels: int) -> int:
    """32-bit words of a part's touched-row bitmap over the V+1 rows."""
    return -(-(n_voxels + 1) // 32)


def scratch_words(parts: int, cap: int, n_voxels: int) -> int:
    """32-bit elements of the kernel's scratch: each part's compacted
    (cap, 16) rows, then its bitmap and its prefix counts."""
    return parts * cap * N_COLS + 2 * parts * bitmap_words(n_voxels)


def shared_bytes(n_voxels: int, shared: bool) -> int:
    """Dynamic shared memory of one block: the table and 32 warp counts, or
    the combine's (1,024, 16) run sums if larger; or the sort's buffers and
    a part's bitmap."""
    if shared:
        return max((n_voxels + 1) * N_COLS * 4 + 32, 1024 * N_COLS * 4)
    return SORT_SMEM_BYTES + 4 * bitmap_words(n_voxels)


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
    host, the same bits on every call with the same inputs
    (``moment_scatter_sums.launches`` counts its launches); CPU tensors go
    to :func:`moment_scatter_reference`.
    """
    if vid.device.type == "cpu" and feats.device.type == "cpu":
        return moment_scatter_reference(vid, feats, n_voxels)
    if feats.device.type != "cuda":
        raise ValueError(f"no moment scatter kernel for device {feats.device}")
    _check(vid, feats)
    rows, n = n_voxels + 1, vid.shape[0]
    index = feats.device.index if feats.device.index is not None else torch.cuda.current_device()
    blocks, per_block, shared = launch_plan(n, n_voxels, _sm_count(index))
    chunk, parts, cap = part_plan(n, n_voxels, blocks, per_block, shared)
    if shared_bytes(n_voxels, shared) > MAX_SHARED_BYTES:
        raise ValueError(f"{rows} rows: a part's bitmap exceeds one block's shared memory")
    scratch = torch.empty(scratch_words(parts, cap, n_voxels), dtype=torch.float32,
                          device=feats.device)
    out = torch.empty((rows, N_COLS), dtype=torch.float32, device=feats.device)
    lib = _lib()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.icet_moment_scatter(
            vid.data_ptr(), feats.data_ptr(), n, rows, out.data_ptr(), scratch.data_ptr(),
            blocks, chunk, parts, cap, int(shared), stream,
        )
    if err != 0:
        msg = lib.icet_cuda_error_string(err).decode()
        raise RuntimeError(f"moment scatter kernel launch failed: {msg} ({err})")
    moment_scatter_sums.launches += 1
    return out


#: launches of the CUDA kernel (plain-version calls on CPU tensors do not count)
moment_scatter_sums.launches = 0
