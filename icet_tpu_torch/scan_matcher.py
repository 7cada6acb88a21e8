"""Frame-to-frame scan matcher (``icet_tpu/scan_matcher.py``, reference
src/scanMatcher.cpp:14-147).

Per scan it returns the aligned points, the relative transform and a
status ("ok", "first_frame", "empty_cloud" or "diverged") instead of
silently swallowing failures (scanMatcher.cpp:98-104), plus a snail trail
of past sensor positions in the current frame.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from icet_tpu_torch.config import ICETConfig
from icet_tpu_torch.device import as_points, resolve_device
from icet_tpu_torch.ops.geometry import euler_R, transform_points
from icet_tpu_torch.solver import prepare_reference, register


@dataclasses.dataclass
class MatchResult:
    index: int
    #: "ok" | "first_frame" | "empty_cloud" | "diverged"
    status: str
    X: np.ndarray
    pred_stds: np.ndarray
    aligned: np.ndarray | None
    #: sensor positions of all past frames in the current frame
    trail: np.ndarray


class ScanMatcher:
    """Aligns each scan to the previous one on ``device`` (CUDA unless told
    otherwise)."""

    def __init__(
        self,
        cfg: ICETConfig | None = None,
        min_points: int = 500,
        divergence_clamp: float = 1.0,
        device: str | torch.device | None = None,
    ):
        self.cfg = cfg or ICETConfig()
        self.min_points = min_points
        self.divergence_clamp = divergence_clamp
        self.device = resolve_device(device)
        self._model = None
        self._index = 0
        self._trail = [np.zeros(3, np.float32)]

    def _result(self, status, X=None, stds=None, aligned=None) -> MatchResult:
        r = MatchResult(
            index=self._index,
            status=status,
            X=np.zeros(6, np.float32) if X is None else X,
            pred_stds=np.zeros(6, np.float32) if stds is None else stds,
            aligned=aligned,
            trail=np.stack(self._trail),
        )
        self._index += 1
        return r

    def step(self, scan) -> MatchResult:
        scan = np.asarray(scan, np.float32)
        n_valid = int((np.linalg.norm(scan, axis=1) > self.cfg.min_range).sum())
        if n_valid < self.min_points:
            # Empty/degenerate input (reference ROS_WARN, scanMatcher.cpp:40-50).
            return self._result("empty_cloud")

        scan_dev = as_points(scan, self.device)
        if self._model is None:
            self._model = prepare_reference(scan_dev, self.cfg)
            return self._result("first_frame", aligned=scan)

        res = register(self._model, scan_dev, torch.zeros(6, device=self.device), self.cfg,
                       want_static_mask=False)
        X = res.X.cpu().numpy()
        self._model = prepare_reference(scan_dev, self.cfg)
        if not np.isfinite(X).all() or np.abs(X).max() > self.divergence_clamp:
            # The reference catches solver exceptions and republishes the raw
            # cloud (scanMatcher.cpp:98-104); the status says so.
            return self._result("diverged", aligned=scan)

        aligned = transform_points(scan_dev, res.X).cpu().numpy()
        # Previous sensor positions move into the current frame through X.
        rot = euler_R(-res.X[3:6]).cpu().numpy()
        self._trail = [(p - X[:3]) @ rot for p in self._trail]
        self._trail.append(np.zeros(3, np.float32))
        return self._result("ok", X, res.pred_stds.cpu().numpy(), aligned)


__all__ = ["MatchResult", "ScanMatcher"]
