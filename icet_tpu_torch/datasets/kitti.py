"""KITTI odometry-benchmark directory IO; a copy of
``icet_tpu/datasets/kitti.py`` that needs no JAX.

The reference evaluates its accuracy story on KITTI urban drives
(reference README.md:67-110) and replays KITTI velodyne ``.bin``
files through its fake_lidar node (reference src/fake_lidar.py:101-114)
but ships no harness to score a trajectory against KITTI ground truth.
This module reads (and, for fixtures, writes) the benchmark's on-disk
layout so ``icet_tpu_torch.examples.eval_kitti`` can run any sequence end-to-end:

    sequences/NN/velodyne/000000.bin   float32 (x, y, z, reflectance)
    sequences/NN/calib.txt             "Tr: <12 floats>"  (T_cam0<-velo)
    poses/NN.txt                       12 floats/line, 3x4 T_w<-cam0

Ground-truth poses are published in the left-camera frame; the velodyne
trajectory needed to score lidar odometry is ``T_w_cam @ Tr``.  When no
calib file exists (synthetic fixtures) ``Tr`` defaults to identity, i.e.
poses are taken to be in the sensor frame already.
"""

from __future__ import annotations

import os
from typing import Iterator, Sequence

import numpy as np

from icet_tpu_torch.datasets.loaders import (
    DEFAULT_MAX_POINTS,
    detect_beam_count,
    load_kitti_bin,
    to_beam_major,
)


def load_poses(path: str) -> np.ndarray:
    """poses/NN.txt -> (N, 4, 4) homogeneous transforms (row-major 3x4)."""
    rows = np.loadtxt(path, dtype=np.float64).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (rows.shape[0], 1, 1))
    out[:, :3, :] = rows
    return out


def save_poses(path: str, poses: Sequence[np.ndarray]) -> None:
    """Inverse of :func:`load_poses` (writes the 3x4 rows)."""
    rows = np.stack([np.asarray(T)[:3, :].reshape(12) for T in poses])
    np.savetxt(path, rows, fmt="%.9e")


def load_calib_tr(path: str) -> np.ndarray | None:
    """calib.txt -> 4x4 ``Tr`` (T_cam0<-velo), or None if absent."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        for line in f:
            if line.startswith("Tr"):
                vals = np.array(line.split(":", 1)[1].split(), np.float64)
                T = np.eye(4)
                T[:3, :] = vals.reshape(3, 4)
                return T
    return None


class KittiOdometrySource:
    """Iterate a KITTI odometry sequence directory as ``(scan, T_w_velo)``.

    ``scan`` is the padded (max_points, 3) float32 canonical cloud.
    ``T_w_velo`` is None when no poses file is given (live/unscored runs).

    ``beam_major="auto"`` re-strides azimuth-major scans into beam-major
    order (pure permutation: registration results are order-invariant;
    the JAX package's windowed fast path wants it, and the port keeps the
    same point order so both packages take the same branch).

    ``prefetch="auto"`` reads scan files through the native C prefetch
    queue (file IO + padding overlap the consumer's solves in producer
    pthreads, ``icet_tpu_torch/csrc/prefetch.c``) when the host compiler
    builds it, falling back to in-process numpy reads (host IO, not the
    device); ``True`` requires it, ``False`` disables it.

    ``strict`` is the real-data mode (``eval_kitti.py --strict-real``):
    instead of silently padding/subsampling past a format surprise it
    fails fast on (a) a ``.bin`` whose byte size is not a whole number of
    16-byte records, (b) a scan with more returns than ``max_points``,
    (c) non-finite coordinates, and (d) a poses file with fewer rows than
    there are scans (which would mis-score the tail).  File-size checks
    run up front (stat only), so the native prefetcher stays engaged;
    per-scan value checks run as scans stream.
    """

    def __init__(
        self,
        sequence_dir: str,
        poses_file: str | None = None,
        max_points: int = DEFAULT_MAX_POINTS,
        beam_major: str | bool = "auto",
        start: int = 0,
        end: int | None = None,
        prefetch: str | bool = "auto",
        strict: bool = False,
    ):
        self.velodyne_dir = os.path.join(sequence_dir, "velodyne")
        self.files = sorted(
            os.path.join(self.velodyne_dir, f)
            for f in os.listdir(self.velodyne_dir)
            if f.endswith(".bin")
        )[start:end]
        if not self.files:
            raise FileNotFoundError(f"no .bin scans under {self.velodyne_dir}")
        self.max_points = max_points
        self.beam_major = beam_major
        self.prefetch = prefetch
        self.strict = strict
        if strict:
            for path in self.files:
                size = os.path.getsize(path)
                if size % 16:
                    raise ValueError(
                        f"{path}: {size} bytes is not a whole number of "
                        "16-byte (x, y, z, reflectance) records — "
                        "truncated or not a KITTI velodyne .bin"
                    )
                if size // 16 > max_points:
                    raise ValueError(
                        f"{path}: {size // 16} returns > max_points="
                        f"{max_points}; strict mode refuses the silent "
                        "stride subsample — raise max_points"
                    )
        if prefetch is True:
            from icet_tpu_torch.native import ensure_built

            if ensure_built() is None:
                raise RuntimeError(
                    "prefetch=True but the native prefetch queue cannot be "
                    "built (csrc/prefetch.c needs a C compiler)"
                )

        self.poses: np.ndarray | None = None
        if poses_file is not None:
            cam_poses = load_poses(poses_file)[start:]
            if strict and cam_poses.shape[0] < len(self.files):
                raise ValueError(
                    f"{poses_file}: {cam_poses.shape[0]} poses after "
                    f"start={start} for {len(self.files)} scans — a short "
                    "poses file would silently mis-score the tail"
                )
            tr = load_calib_tr(os.path.join(sequence_dir, "calib.txt"))
            if tr is not None:
                cam_poses = cam_poses @ tr  # T_w<-velo = T_w<-cam0 @ Tr
            self.poses = cam_poses[: len(self.files)]

    def __len__(self) -> int:
        return len(self.files)

    def _canonicalize(self, scan: np.ndarray) -> np.ndarray:
        if self.beam_major is True or self.beam_major == "auto":
            nz = scan[np.any(scan != 0.0, axis=1)]
            beams = detect_beam_count(nz)
            if beams is not None:
                fixed = to_beam_major(nz, beams)
                out = np.zeros_like(scan)
                out[: fixed.shape[0]] = fixed
                return out
        return scan

    def _iter_scans(self) -> Iterator[np.ndarray]:
        if self.prefetch:
            from icet_tpu_torch.native import Prefetcher, ensure_built

            native = ensure_built(quiet=True)
            if native is not None:
                yield from Prefetcher(
                    native, self.files, self.max_points,
                    n_threads=2, depth=4, loop=False, repeat=0,
                )
                return
            if self.prefetch is True:
                raise RuntimeError(
                    "prefetch=True but the native prefetch queue cannot be "
                    "built (csrc/prefetch.c needs a C compiler)"
                )
        for path in self.files:
            yield load_kitti_bin(path, self.max_points, strict=self.strict)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray | None]]:
        for i, scan in enumerate(self._iter_scans()):
            if self.strict and not np.isfinite(scan).all():
                raise ValueError(
                    f"{self.files[i]}: non-finite coordinates in strict mode"
                )
            T = None if self.poses is None else self.poses[i]
            yield self._canonicalize(scan), T


def write_kitti_sequence(
    out_dir: str,
    scans: Sequence[np.ndarray],
    poses: Sequence[np.ndarray],
    calib_tr: np.ndarray | None = None,
) -> str:
    """Write scans+poses as a KITTI odometry sequence directory (fixture
    generator for tests and offline experiments).

    Layout written: ``<out_dir>/velodyne/%06d.bin``, ``<out_dir>/poses.txt``
    and, if ``calib_tr`` is given, ``<out_dir>/calib.txt``.  Zero-pad rows
    are stripped so files round-trip through :class:`KittiOdometrySource`.
    Returns ``out_dir``.
    """
    vdir = os.path.join(out_dir, "velodyne")
    os.makedirs(vdir, exist_ok=True)
    for i, scan in enumerate(scans):
        pts = np.asarray(scan, np.float32).reshape(-1, 3)
        pts = pts[np.any(pts != 0.0, axis=1)]
        rec = np.concatenate(
            [pts, np.zeros((pts.shape[0], 1), np.float32)], axis=1
        )
        rec.tofile(os.path.join(vdir, f"{i:06d}.bin"))
    save_poses(os.path.join(out_dir, "poses.txt"), poses)
    if calib_tr is not None:
        with open(os.path.join(out_dir, "calib.txt"), "w") as f:
            f.write("Tr: " + " ".join(
                f"{v:.9e}" for v in np.asarray(calib_tr)[:3, :].reshape(12)
            ) + "\n")
    return out_dir
