"""Fused moment sums: transform, re-bin, membership and anchored moments in
one pass over the scan.

``fused_moment_sums`` launches the CUDA kernel ``csrc/fused_moments.cu``
on CUDA tensors and takes the plain version,
``fused_moment_sums_reference``, only for CPU tensors.  It replaces the TPU
kernel ``icet_tpu/ops/pallas_fused.py::_kernel`` and computes what
``icet_tpu/solver.py::_jnp_sums`` computes, in both radial modes and at any
table size.  The kernel has no window: nothing overflows, and
``IterationDiag.windowed_overflow`` is always 0 in the port.  One launch a
call: after a grid barrier the blocks sum each other's compacted partials.
Adaptive tables that fit one block's shared memory (V <= 5,774) are summed
there (``launch_plan`` and ``scratch_floats`` size the launch); fixed
radial mode and larger tables take the sorted parts of the moment scatter
kernel (``large_table``, ``large_plan``, ``moment_scatter.scratch_words``).

``fused_moment_sums_windowed`` is the port of the TPU's windowed variant
(``_windowed_kernel``, kernel ``csrc/fused_moments_windowed.cu``): each
block of points sums only into a narrow band of voxel ids and counts the
points off its band.  No solver path calls it, in either package; it is
exposed as the JAX package exposes it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from icet_tpu_torch import _build
from icet_tpu_torch.config import ICETConfig
from icet_tpu_torch.ops import moment_scatter
from icet_tpu_torch.ops.clustering import membership
from icet_tpu_torch.ops.geometry import cart_to_spherical, point_norm, transform_points
from icet_tpu_torch.ops.grid import voxel_ids
from icet_tpu_torch.ops.moments import N_FEATURES, voxel_moment_sums

#: shared memory one block can hold on Hopper (227 KB)
MAX_SHARED_BYTES = 232_448
#: threads a block of the shared table (``kThreads`` in ``csrc/fused_moments.cu``)
THREADS = 512
#: the fewest points a block takes before the grid stops growing
MIN_POINTS_PER_BLOCK = 256
#: the kernel's ``branch``: the shared table; the sorted parts (the kernel
#: keeps a part's bitmap in shared memory where it fits)
SHARED, SORTED = 0, 1


def fused_moment_sums_reference(
    pts: torch.Tensor,
    X: torch.Tensor,
    bounds: torch.Tensor,
    anchors: torch.Tensor,
    cfg: ICETConfig,
) -> torch.Tensor:
    """Plain PyTorch version: ``(V+1, 16)`` sums of the points of ``pts``
    transformed by ``X`` that fall inside their voxel's radial bounds,
    gated on the raw range ``|p| >= min_range``."""
    raw_ok = point_norm(pts) >= cfg.min_range
    p2 = transform_points(pts, X)
    rtp = cart_to_spherical(p2)
    vid = voxel_ids(rtp, cfg)
    member = membership(vid, rtp[..., 0], raw_ok, bounds, cfg.n_voxels)
    return voxel_moment_sums(p2, vid, member, anchors, cfg.n_voxels)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_moments")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.icet_fused_moment_sums.argtypes = [
        p, i, p, p, p, i, i, i, f, f, f, i, i, f, p, i, i, i, i, i, p, p,
    ]
    lib.icet_fused_moment_sums.restype = i
    lib.icet_cuda_error_string.argtypes = [i]
    lib.icet_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bitmap_words(n_voxels: int) -> int:
    """32-bit words of a block's touched-row bitmap over the V+1 rows."""
    return -(-(n_voxels + 1) // 32)


def shared_bytes(n_voxels: int) -> int:
    """Dynamic shared memory of one block: the (V+1, 10) float table, the
    bitmap and its per-word prefix counts; or, if larger, the combine's
    (THREADS, 10) run sums."""
    return 4 * max((n_voxels + 1) * 10 + 2 * bitmap_words(n_voxels), THREADS * 10)


def launch_plan(n: int, n_voxels: int, sm_count: int) -> tuple[int, int, int]:
    """``(blocks, points a block, cap)`` of one launch: at most one block an
    SM and at least ``MIN_POINTS_PER_BLOCK`` points a block (one block when
    ``n`` is 0), each block a contiguous slice of ``ceil(n / blocks)``
    points; ``cap`` bounds the rows one block can touch (its points, and
    the V voxel rows; the sentinel row is never a member's)."""
    blocks = max(1, min(sm_count, -(-n // MIN_POINTS_PER_BLOCK)))
    per_block = -(-n // blocks)
    return blocks, per_block, max(1, min(n_voxels, per_block))


def scratch_floats(blocks: int, cap: int, n_voxels: int) -> int:
    """32-bit elements of the kernel's scratch: each block's compacted
    (cap, 10) rows, then its bitmap and its prefix counts."""
    return blocks * cap * 10 + 2 * blocks * bitmap_words(n_voxels)


def large_table(cfg: ICETConfig) -> bool:
    """Whether ``cfg``'s table takes the sorted parts: fixed radial mode,
    or an adaptive table whose :func:`shared_bytes` exceed one block."""
    return cfg.radial_mode == "fixed" or shared_bytes(cfg.n_voxels) > MAX_SHARED_BYTES


def large_plan(n: int, n_voxels: int, sm_count: int) -> tuple[int, int, int, int]:
    """``(blocks, points a part, parts, cap)`` of a launch of the sorted
    parts: one block an SM, walking parts of ``moment_scatter.SORT_POINTS``
    points (at least one part), as the moment scatter plans its large
    tables (``moment_scatter.part_plan``); ``cap`` bounds the rows one part
    can touch."""
    chunk, parts, cap = moment_scatter.part_plan(n, n_voxels, sm_count, -(-n // sm_count),
                                                 False)
    return sm_count, chunk, parts, cap


def _check(pts, X, bounds, anchors, cfg: ICETConfig) -> None:
    v1 = cfg.n_voxels + 1
    shapes = {"pts": (pts, (pts.shape[0], 3)), "X": (X, (6,)),
              "bounds": (bounds, (v1, 2)), "anchors": (anchors, (v1, 3))}
    for name, (t, shape) in shapes.items():
        if t.device != pts.device:
            raise ValueError(f"{name} is on {t.device}, pts on {pts.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pts.shape[0] >= 2**31 // 3 or v1 * N_FEATURES >= 2**31:
        raise ValueError("too many points or voxels for 32-bit indexing")


def fused_moment_sums(
    pts: torch.Tensor,
    X: torch.Tensor,
    bounds: torch.Tensor,
    anchors: torch.Tensor,
    cfg: ICETConfig,
) -> torch.Tensor:
    """``(V+1, 16)`` anchored moment sums of ``pts`` transformed by ``X``.

    CUDA tensors go to the kernel, one launch a call, in either radial
    mode and at any table size (``fused_moment_sums.launches`` counts its
    launches); CPU tensors go to :func:`fused_moment_sums_reference`.
    Columns 10-15 and the sentinel row V are zero.
    """
    if pts.device.type == "cpu":
        return fused_moment_sums_reference(pts, X, bounds, anchors, cfg)
    if pts.device.type != "cuda":
        raise ValueError(f"no fused moments kernel for device {pts.device}")
    _check(pts, X, bounds, anchors, cfg)
    n, V = pts.shape[0], cfg.n_voxels
    index = pts.device.index if pts.device.index is not None else torch.cuda.current_device()
    if large_table(cfg):
        blocks, per_block, parts, cap = large_plan(n, V, _sm_count(index))
        branch, words = SORTED, moment_scatter.scratch_words(parts, cap, V)
    else:
        blocks, per_block, cap = launch_plan(n, V, _sm_count(index))
        parts, branch, words = blocks, SHARED, scratch_floats(blocks, cap, V)
    scratch = torch.empty(words, dtype=torch.float32, device=pts.device)
    out = torch.empty((V + 1, N_FEATURES), dtype=torch.float32, device=pts.device)
    lib = _lib()
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.icet_fused_moment_sums(
            pts.data_ptr(), n, X.data_ptr(), bounds.data_ptr(),
            anchors.data_ptr(), V, cfg.n_theta, cfg.n_phi,
            cfg.phi_min, cfg.phi_max - cfg.phi_min, cfg.min_range,
            # The log growth as the float32 that grid.voxel_ids divides by
            # (ctypes rounds it as torch rounds the Python scalar).
            int(cfg.radial_mode == "fixed"), cfg.n_shells, math.log(cfg.shell_growth),
            scratch.data_ptr(), branch, blocks, per_block, parts, cap, out.data_ptr(), stream,
        )
    if err != 0:
        msg = lib.icet_cuda_error_string(err).decode()
        raise RuntimeError(f"fused moments kernel launch failed: {msg} ({err})")
    fused_moment_sums.launches += 1
    return out


#: launches of the CUDA kernel (plain-version calls on CPU tensors do not count)
fused_moment_sums.launches = 0


# ---------------------------------------------------------------------------
# Windowed variant (kernel #2)
# ---------------------------------------------------------------------------


def _windowed_v_pad(n_voxels: int, window: int) -> int:
    """The TPU kernel's padded voxel axis: ``max(round_up(V+1, 128),
    2 * window)``; window starts never pass ``v_pad - window``."""
    return max(-(-(n_voxels + 1) // 128) * 128, 2 * window)


def fused_moment_sums_windowed_reference(
    pts: torch.Tensor,
    X: torch.Tensor,
    bounds: torch.Tensor,
    anchors: torch.Tensor,
    cfg: ICETConfig,
    block: int = 512,
    window: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_moment_sums_windowed`,
    vectorised over the point blocks: ``((V+1, 16) sums, overflow int32)``.

    The range gate reads the TRANSFORMED range ``|R p + t| >= min_range``,
    as the TPU kernel does (unlike :func:`fused_moment_sums_reference`,
    which gates the raw range as the solver's ``_jnp_sums`` does)."""
    n, V = pts.shape[0], cfg.n_voxels
    p2 = transform_points(pts, X)
    rtp = cart_to_spherical(p2)
    vid = voxel_ids(rtp, cfg)
    ok = vid < V
    nb = -(-n // block)
    pad = nb * block - n
    big = torch.iinfo(torch.int32).max
    vid_b = torch.nn.functional.pad(torch.where(ok, vid, big), (0, pad), value=big)
    vmin = vid_b.reshape(nb, block).amin(dim=1) if nb else vid_b.new_zeros(0)
    vmin = torch.where(vmin == big, 0, vmin)
    v_pad = _windowed_v_pad(V, window)
    start = torch.clamp(torch.clamp((vmin // 128) * 128, max=v_pad - window), min=0)
    start = torch.repeat_interleave(start, block)[:n]
    in_win = ok & (vid >= start) & (vid < start + window - 1)
    overflow = torch.sum(ok & ~in_win, dtype=torch.int32)
    member = membership(vid, rtp[..., 0], in_win, bounds, V)
    return voxel_moment_sums(p2, vid, member, anchors, V), overflow


#: most threads a block of the windowed kernel (``kMaxThreads`` in
#: ``csrc/fused_moments_windowed.cu``)
WIN_THREADS = 512
#: the windowed kernel's static shared memory, bytes (its ``-Xptxas -v``)
WIN_STATIC_SHARED = 16


def windowed_plan(n: int, block: int, window: int) -> tuple[int, int, int, int]:
    """``(point blocks, threads a block, cap, bitmap words)`` of one launch
    of the windowed kernel: ``ceil(n / block)`` point blocks, blocks of
    ``block`` threads rounded up to a warp (at most ``WIN_THREADS``), ``cap``
    bounds the rows one point block can touch (its points, and the
    window's ``window - 1`` columns; the last is the overflow slot), and
    ``ceil(window / 32)`` words of its touched-row bitmap."""
    threads = min(WIN_THREADS, -(-block // 32) * 32)
    return -(-n // block), threads, max(1, min(window - 1, block)), -(-window // 32)


def windowed_scratch_words(nb: int, cap: int, words: int) -> int:
    """32-bit elements of the windowed kernel's scratch: each point block's
    compacted (cap, 12) rows, its bitmap words with their prefix counts,
    and its start and overflow count."""
    return nb * cap * 12 + nb * words * 2 + nb * 2


def windowed_shared_bytes(window: int) -> int:
    """Dynamic shared memory of one block of the windowed kernel: the
    (window, 10) float table, its bitmap and the bitmap's prefix counts."""
    return window * 40 + 8 * (-(-window // 32))


@functools.lru_cache(maxsize=None)
def _windowed_lib() -> ctypes.CDLL:
    lib = _build.load("fused_moments_windowed")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.icet_fused_moment_sums_windowed.argtypes = [
        p, i, p, p, p, i, i, i, f, f, f, i, i, f, i, i, i, i, i, p, p, p, p,
    ]
    lib.icet_fused_moment_sums_windowed.restype = i
    lib.icet_windowed_shared_bytes.argtypes = [i]
    lib.icet_windowed_shared_bytes.restype = i
    if lib.icet_windowed_shared_bytes(256) != windowed_shared_bytes(256):
        raise RuntimeError("the windowed kernel and its wrapper disagree on shared memory")
    lib.icet_cuda_error_string.argtypes = [i]
    lib.icet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_windowed(pts, X, bounds, anchors, cfg: ICETConfig, block: int, window: int) -> None:
    v1 = cfg.n_voxels + 1
    shapes = {"pts": (pts, (pts.shape[0], 3)), "X": (X, (6,)),
              "bounds": (bounds, (v1, 2)), "anchors": (anchors, (v1, 3))}
    for name, (t, shape) in shapes.items():
        if t.device != pts.device:
            raise ValueError(f"{name} is on {t.device}, pts on {pts.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # window <= v_pad holds by construction (v_pad >= 2 * window).
    if block < 1 or window < 1:
        raise ValueError(f"block {block} and window {window} must be positive")
    # Only the window lives in shared memory: any block size is taken, as
    # the TPU kernel takes it.
    if windowed_shared_bytes(window) > MAX_SHARED_BYTES - WIN_STATIC_SHARED:
        raise ValueError(f"window {window} exceeds one block's shared memory")
    if pts.shape[0] >= 2**31 // 3 or v1 * N_FEATURES >= 2**31:
        raise ValueError("too many points or voxels for 32-bit indexing")


def fused_moment_sums_windowed(
    pts: torch.Tensor,
    X: torch.Tensor,
    bounds: torch.Tensor,
    anchors: torch.Tensor,
    cfg: ICETConfig,
    block: int = 512,
    window: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``((V+1, 16) sums, overflow int32 scalar tensor)``: the fused moment
    sums with each ``block``-point block restricted to a ``window``-wide band
    of voxel ids starting at its least valid id rounded down to 128; points
    off their block's band are left out of the sums and counted in
    ``overflow``.  Adaptive and fixed radial modes.

    CUDA tensors go to ``csrc/fused_moments_windowed.cu``, one launch a
    call (``fused_moment_sums_windowed.launches`` counts its launches); CPU
    tensors go to :func:`fused_moment_sums_windowed_reference`.  It
    replaces the TPU kernel ``icet_tpu/ops/pallas_fused.py::_windowed_kernel``,
    which, as here, no solver path reaches: the port's solver uses
    :func:`fused_moment_sums`, which has no window.
    """
    if pts.device.type == "cpu":
        return fused_moment_sums_windowed_reference(pts, X, bounds, anchors, cfg, block, window)
    if pts.device.type != "cuda":
        raise ValueError(f"no windowed fused moments kernel for device {pts.device}")
    _check_windowed(pts, X, bounds, anchors, cfg, block, window)
    n, v1 = pts.shape[0], cfg.n_voxels + 1
    nb, threads, cap, words = windowed_plan(n, block, window)
    dev = pts.device
    scratch = torch.empty(max(1, windowed_scratch_words(nb, cap, words)), dtype=torch.float32,
                          device=dev)
    out = torch.empty((v1, N_FEATURES), dtype=torch.float32, device=dev)
    overflow = torch.empty((), dtype=torch.int32, device=dev)
    lib = _windowed_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.icet_fused_moment_sums_windowed(
            pts.data_ptr(), n, X.data_ptr(), bounds.data_ptr(), anchors.data_ptr(),
            cfg.n_voxels, cfg.n_theta, cfg.n_phi, cfg.phi_min, cfg.phi_max - cfg.phi_min,
            cfg.min_range, int(cfg.radial_mode == "fixed"), cfg.n_shells,
            math.log(cfg.shell_growth), block, window, _windowed_v_pad(cfg.n_voxels, window),
            threads, cap, scratch.data_ptr(), out.data_ptr(), overflow.data_ptr(), stream,
        )
    if err != 0:
        msg = lib.icet_cuda_error_string(err).decode()
        raise RuntimeError(f"windowed fused moments kernel launch failed: {msg} ({err})")
    fused_moment_sums_windowed.launches += 1
    return out, overflow


#: launches of the CUDA kernel (plain-version calls on CPU tensors do not count)
fused_moment_sums_windowed.launches = 0
