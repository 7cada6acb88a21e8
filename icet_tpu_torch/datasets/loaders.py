"""Point-cloud file loaders, padding and scan-order utilities; a copy of
``icet_tpu/datasets/loaders.py`` (numpy only) that the port keeps as its own.

Every loader produces one canonical product: a fixed-shape float32
``(max_points, 3)`` array with zero padding (the solver's range gate masks
pad points).  The hdf5 and mat readers import ``h5py`` and ``scipy.io``
inside their functions, so importing this module needs neither.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator

import numpy as np

#: canonical static point budget: 131072 covers 64-channel x 2048-azimuth
DEFAULT_MAX_POINTS = 131072


def pad_cloud(
    points: np.ndarray,
    max_points: int = DEFAULT_MAX_POINTS,
    strict: bool = False,
) -> np.ndarray:
    """Pad/truncate an (N, 3) cloud to the static (max_points, 3) shape.

    Zero rows are dropped points (r < min_range gate).  Truncation keeps a
    uniform stride subsample rather than the head, so a too-large cloud stays
    spatially representative.  ``strict`` turns the silent subsample into an
    error (real-data runs should raise ``max_points`` instead of quietly
    dropping returns).
    """
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = points.shape[0]
    if n > max_points:
        if strict:
            raise ValueError(
                f"cloud has {n} points > max_points={max_points}; strict "
                "mode refuses the silent stride subsample — raise max_points"
            )
        idx = np.linspace(0, n - 1, max_points).astype(np.int64)
        return np.ascontiguousarray(points[idx])
    out = np.zeros((max_points, 3), np.float32)
    out[:n] = points
    return out


def to_beam_major(points: np.ndarray, n_beams: int) -> np.ndarray:
    """Re-stride an azimuth-major scan (all beams per azimuth column stored
    consecutively) into beam-major order (full azimuth sweep per beam).

    Pure permutation: registration results are order-invariant, and the
    port's moments kernel does not depend on scan order.
    """
    points = np.asarray(points)
    n = points.shape[0]
    if n % n_beams:
        return points
    return np.ascontiguousarray(
        points.reshape(n // n_beams, n_beams, 3).transpose(1, 0, 2).reshape(-1, 3)
    )


def detect_beam_count(points: np.ndarray, candidates=(16, 32, 64, 128)) -> int | None:
    """Guess the beam count of an azimuth-major scan by elevation coherence:
    in azimuth-major order, points k*n_beams + b share beam b, so the
    per-beam elevation variance collapses at the true count."""
    points = np.asarray(points, np.float64)
    r = np.linalg.norm(points, axis=1)
    ok = r > 0.2
    elev = np.arcsin(np.clip(points[:, 2] / np.maximum(r, 1e-9), -1, 1))
    scores = {}
    for nb in candidates:
        if len(points) % nb:
            continue
        e = elev.reshape(-1, nb)
        okb = ok.reshape(-1, nb)
        var = 0.0
        for b in range(nb):
            col = e[:, b][okb[:, b]]
            if len(col) > 10:
                var += np.var(col)
        scores[nb] = var / nb
    if not scores:
        return None
    worst = max(scores.values())
    if worst <= 0:
        return None
    # Any MULTIPLE of the true count also collapses (its columns still hold a
    # single beam each); take the SMALLEST clearly-collapsed candidate.
    for nb in sorted(scores):
        if scores[nb] < 1e-3 * worst:
            return nb
    return None


def load_npy(path: str, max_points: int = DEFAULT_MAX_POINTS) -> np.ndarray:
    """Load an (N, 3) .npy cloud (the reference's bundled sample format)."""
    return pad_cloud(np.load(path), max_points)


def load_kitti_bin(
    path: str,
    max_points: int = DEFAULT_MAX_POINTS,
    strict: bool = False,
) -> np.ndarray:
    """KITTI velodyne .bin: float32 (x, y, z, reflectance) records
    (reference replays the same files, fake_lidar.py:101-114).

    ``strict`` fails fast on format surprises a real-data run must not
    paper over: a byte size that is not a whole number of 16-byte records
    (truncated download / wrong file), non-finite coordinates, or a scan
    larger than ``max_points`` (see :func:`pad_cloud`).
    """
    raw = np.fromfile(path, dtype=np.float32)
    if raw.size % 4:
        raise ValueError(
            f"{path}: {raw.size * 4} bytes is not a whole number of "
            "16-byte (x, y, z, reflectance) records — truncated or not a "
            "KITTI velodyne .bin"
        )
    xyz = raw.reshape(-1, 4)[:, :3]
    if strict and not np.isfinite(xyz).all():
        raise ValueError(f"{path}: non-finite coordinates in strict mode")
    return pad_cloud(xyz, max_points, strict=strict)


def load_csv(
    path: str,
    max_points: int = DEFAULT_MAX_POINTS,
    fmt: str = "auto",
) -> np.ndarray:
    """Delimited-text clouds.

    fmt="ouster": the reference's Ouster studio export — skip 2 header rows,
    XYZ in millimetres in columns 8-10 (utils.cpp:12-55).
    fmt="xyz": whitespace/comma xyz per row (utils.cpp:57-91).
    fmt="auto": sniff by column count.
    """
    if fmt == "ouster":
        raw = np.genfromtxt(path, delimiter=",", skip_header=2)
        return pad_cloud(raw[:, 8:11] / 1000.0, max_points)
    delim = "," if "," in open(path).readline() else None
    raw = np.genfromtxt(path, delimiter=delim)
    if raw.ndim == 1:
        raw = raw[None, :]
    if fmt == "auto" and raw.shape[1] >= 11:
        xyz = raw[:, 8:11] / 1000.0
    else:
        xyz = raw[:, :3]
    # Header lines parse as all-NaN rows — drop them (the reference's
    # ouster branch hardcodes a 2-row skip, utils.cpp:22-26; sniffing
    # non-numeric rows generalizes it and matches the native loader).
    return pad_cloud(xyz[np.isfinite(xyz).all(axis=1)], max_points)


def load_ply(path: str, max_points: int = DEFAULT_MAX_POINTS) -> np.ndarray:
    """Minimal PLY reader (ascii + binary_little_endian float32 x/y/z-first),
    covering the KITTI-CARLA exports the reference replays
    (fake_lidar.py:88-99)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            header.append(line)
            if line == "end_header":
                break
        n_vertex = 0
        fmt = "ascii"
        props = []
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element" and parts[1] == "vertex":
                n_vertex = int(parts[2])
            elif parts[0] == "property" and len(props) < 64:
                props.append((parts[1], parts[2]))
        if fmt == "ascii":
            rows = []
            for _ in range(n_vertex):
                rows.append(
                    [float(v) for v in f.readline().split()[: len(props)]]
                )
            data = np.asarray(rows, np.float32)
        else:
            sizes = {"float": 4, "float32": 4, "double": 8, "uchar": 1,
                     "uint8": 1, "int": 4, "int32": 4, "short": 2, "ushort": 2}
            rec = sum(sizes[t] for t, _ in props)
            buf = f.read(rec * n_vertex)
            data = np.frombuffer(buf, dtype=np.uint8).reshape(n_vertex, rec)
            # Assume x, y, z are the first three float32 properties.
            data = data[:, :12].copy().view(np.float32).reshape(n_vertex, 3)
        names = [p[1] for p in props]
        if "x" in names:
            i = names.index("x")
            xyz = data[:, i : i + 3]
        else:
            xyz = data[:, :3]
        return pad_cloud(xyz, max_points)


def load_codd_hdf5(
    path: str,
    frame: int = 0,
    vehicle: int = 0,
    max_points: int = DEFAULT_MAX_POINTS,
) -> np.ndarray:
    """CODD cooperative-driving dataset: hdf5 'point_cloud' of shape
    [frames, vehicles, points, 4] (reference fake_lidar.py:126-134)."""
    import h5py

    with h5py.File(path, "r") as hf:
        pts = hf["point_cloud"][frame, vehicle, :, :3]
    return pad_cloud(np.asarray(pts), max_points)


def load_pixset_pkl(path: str, max_points: int = DEFAULT_MAX_POINTS) -> np.ndarray:
    """LeddarTech PixSet ouster64 export: a pickled structured array whose
    records start with x, y, z (reference fake_lidar.py:136-152)."""
    import pickle

    with open(path, "rb") as f:
        data = pickle.load(f)
    arr = np.asarray(data.tolist() if hasattr(data, "tolist") else data)
    return pad_cloud(np.asarray(arr, np.float64)[:, :3], max_points)


def load_ford_mat(path: str, max_points: int = DEFAULT_MAX_POINTS) -> np.ndarray:
    """Ford Campus dataset SCANS .mat: SCAN.XYZ is 3xN
    (reference fake_lidar.py:154-162)."""
    from scipy.io import loadmat

    dat = loadmat(path, simplify_cells=True)
    scan = dat["SCAN"]
    xyz = np.asarray(scan["XYZ"] if isinstance(scan, dict) else scan)
    if xyz.shape[0] == 3 and xyz.shape[1] != 3:
        xyz = xyz.T
    return pad_cloud(xyz, max_points)


_LOADERS = {
    ".npy": load_npy,
    ".bin": load_kitti_bin,
    ".csv": load_csv,
    ".txt": load_csv,
    ".ply": load_ply,
    ".h5": load_codd_hdf5,
    ".hdf5": load_codd_hdf5,
    ".pkl": load_pixset_pkl,
    ".mat": load_ford_mat,
}


def load_cloud(path: str, max_points: int = DEFAULT_MAX_POINTS) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext not in _LOADERS:
        raise ValueError(f"unknown point-cloud format: {path}")
    if ext in (".h5", ".hdf5"):
        return load_codd_hdf5(path, max_points=max_points)
    return _LOADERS[ext](path, max_points)


def load_sequence(
    paths: Iterable[str], max_points: int = DEFAULT_MAX_POINTS
) -> Iterator[np.ndarray]:
    for p in paths:
        yield load_cloud(p, max_points)
