"""Padding and scan-order utilities; a copy of the numpy helpers of
``icet_tpu/datasets/loaders.py`` that needs no JAX."""

from __future__ import annotations

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
