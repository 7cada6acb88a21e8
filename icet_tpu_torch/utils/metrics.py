"""Structured per-frame metrics and trajectory evaluation (numpy), a copy
of ``icet_tpu/utils/metrics.py`` that needs no JAX: JSONL-appendable
per-frame records of the port's :class:`~icet_tpu_torch.solver.RegistrationResult`,
trajectory export in TUM format, and the ATE/RPE evaluation.
"""

from __future__ import annotations

import dataclasses
import json
from typing import IO, Iterable

import numpy as np

#: the JAX package's windowed-moments spill capacity (icet_tpu/solver.py:58);
#: the port's moments pass has no window, so its overflow is always 0
SPILL_CAPACITY = 8192


@dataclasses.dataclass
class FrameMetrics:
    """One registration's health record (SURVEY.md section 5.5 target)."""

    index: int
    X: list
    pred_stds: list
    n_corr: int
    condition: float
    n_dropped_axes: int
    n_rejected_moving: int
    dx_final: float
    solve_ms: float
    diverged: bool = False
    #: True when any iteration's off-window point count exceeded the
    #: solver's bounded-spill capacity and the iteration fell back to the
    #: ~2x-cost segsum path (unordered scan order) — watch this in
    #: production.  Counts AT or BELOW the capacity are absorbed exactly
    #: by the cheap spill pass (keyframe-baseline parallax lives there;
    #: ~3/4 of keyframe-regime frames spill 0.7-4.3k points) and are NOT
    #: a fallback — they surface in :attr:`windowed_spill_points` instead.
    windowed_fallback: bool = False
    #: max per-iteration off-window point count (0 on clean fast-path
    #: frames; the solver's spill pass absorbs up to its capacity exactly)
    windowed_spill_points: int = 0

    @classmethod
    def from_result(cls, index, res, solve_ms=0.0, diverged=False):
        """The record of one port ``RegistrationResult`` (tensors on any
        device; the last iteration's diagnostics)."""
        d = res.diagnostics
        ovf = int(_np(getattr(d, "windowed_overflow", 0)).max())
        return cls(
            index=index,
            X=_np(res.X).tolist(),
            pred_stds=_np(res.pred_stds).tolist(),
            n_corr=int(_np(d.n_corr)[-1]),
            condition=float(_np(d.condition)[-1]),
            n_dropped_axes=int(_np(d.n_dropped_axes)[-1]),
            n_rejected_moving=int(_np(d.n_rejected_moving)[-1]),
            dx_final=float(_np(d.dx_norm)[-1]),
            solve_ms=solve_ms,
            diverged=bool(diverged),
            windowed_fallback=ovf > SPILL_CAPACITY,
            windowed_spill_points=ovf,
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def _np(v) -> np.ndarray:
    """A tensor (any device) or array as numpy."""
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class MetricsLog:
    """Append-only JSONL metrics sink."""

    def __init__(self, stream: IO | str | None = None):
        self._own = isinstance(stream, str)
        self._stream = open(stream, "a") if self._own else stream
        self.records: list[FrameMetrics] = []

    def log(self, m: FrameMetrics) -> None:
        self.records.append(m)
        if self._stream is not None:
            self._stream.write(m.to_json() + "\n")
            self._stream.flush()

    def close(self) -> None:
        if self._own and self._stream:
            self._stream.close()


# ---------------------------------------------------------------------------
# Trajectory evaluation
# ---------------------------------------------------------------------------


def ate_rmse(poses_est: Iterable[np.ndarray], poses_ref: Iterable[np.ndarray]) -> float:
    """Absolute trajectory error (RMSE of translation) between 4x4 pose lists,
    both expressed relative to their own first frame."""
    est = [np.asarray(p) for p in poses_est]
    ref = [np.asarray(p) for p in poses_ref]
    assert len(est) == len(ref) and est, "trajectory length mismatch"
    e0, r0 = np.linalg.inv(est[0]), np.linalg.inv(ref[0])
    err = [
        np.linalg.norm((e0 @ e)[:3, 3] - (r0 @ r)[:3, 3])
        for e, r in zip(est, ref)
    ]
    return float(np.sqrt(np.mean(np.square(err))))


def rpe(poses_est, poses_ref, delta: int = 1):
    """Relative pose error: per-step translation and rotation error arrays."""
    est = [np.asarray(p) for p in poses_est]
    ref = [np.asarray(p) for p in poses_ref]
    t_err, r_err = [], []
    for i in range(len(est) - delta):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dr = np.linalg.inv(ref[i]) @ ref[i + delta]
        rel = np.linalg.inv(dr) @ de
        t_err.append(np.linalg.norm(rel[:3, 3]))
        ang = np.arccos(np.clip((np.trace(rel[:3, :3]) - 1) / 2, -1, 1))
        r_err.append(ang)
    return np.asarray(t_err), np.asarray(r_err)


def save_tum(path: str, poses: Iterable[np.ndarray], times=None) -> None:
    """Export a trajectory in TUM format (t x y z qx qy qz qw) for external
    evaluation tools."""
    poses = [np.asarray(p) for p in poses]
    with open(path, "w") as f:
        for i, T in enumerate(poses):
            t = times[i] if times is not None else float(i)
            q = _rot_to_quat(T[:3, :3])
            x, y, z = T[:3, 3]
            f.write(
                f"{t} {x} {y} {z} {q[0]} {q[1]} {q[2]} {q[3]}\n"
            )


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (qx, qy, qz, qw), robust Shepperd method."""
    t = np.trace(R)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        return np.array(
            [(R[2, 1] - R[1, 2]) * s, (R[0, 2] - R[2, 0]) * s,
             (R[1, 0] - R[0, 1]) * s, 0.25 / s]
        )
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2.0
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    q[3] = (R[k, j] - R[j, k]) / s
    return q
