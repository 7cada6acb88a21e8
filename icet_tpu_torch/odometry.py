"""Frame-to-frame odometry (``icet_tpu/odometry.py``).

:class:`OdometryPipeline` takes one scan at a time; :func:`run_odometry_device`
takes a recorded ``(F, N, 3)`` sequence, uploads it to the card block by
block and chains the odometry step there, reading results back once per
block.  Both give the same :class:`OdometryFrame` records.  With
``cfg.dnn_filter`` the pipeline runs the DNN-filtered step; the sequence
runner refuses it, as the JAX package's does.  The pipeline survives a
failed step (:meth:`OdometryPipeline.step`).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from icet_tpu_torch.config import ICETConfig, OdometryConfig
from icet_tpu_torch.device import as_points, resolve_device
from icet_tpu_torch.filters import model_voxel_samples, odometry_step_dnn, pretrained_dnn
from icet_tpu_torch.ops.geometry import (
    compose_pose,
    compose_states,
    pose_to_state,
    relative_state,
)
from icet_tpu_torch.solver import odometry_step, prepare_reference

_log = logging.getLogger(__name__)


def warm_start_seed(x_prev: torch.Tensor, x_prev2: torch.Tensor, mode: str) -> torch.Tensor:
    """Initial guess for the next solve: ``"previous"`` returns the last
    solution, ``"extrapolate"`` the constant-acceleration composition
    ``D_k o (D_{k-1}^-1 o D_k)``."""
    if mode == "previous":
        return x_prev
    if mode == "extrapolate":
        return compose_states(x_prev, relative_state(x_prev2, x_prev))
    raise ValueError(f"unknown warm_start_mode {mode!r}")


@dataclasses.dataclass
class OdometryFrame:
    """Per-frame odometry output."""

    index: int
    #: frame-to-frame solution [t, angs]
    X: np.ndarray
    #: predicted per-component solution std
    pred_stds: np.ndarray
    #: accumulated 4x4 world pose
    T_world: np.ndarray
    #: world pose as a 6-DOF state
    pose: np.ndarray
    #: X scaled by the sensor rate
    twist: np.ndarray
    #: True if the divergence guard zeroed this frame's solution
    diverged: bool
    #: per-iteration correspondence counts (empty from run_odometry_device)
    n_corr: np.ndarray
    #: wall-clock time of the step (ms; 0 from run_odometry_device)
    solve_ms: float
    #: Gauss-Newton iterations the frame's registration executed
    iterations: int = 0
    #: voxels the DNN filter rejected at the frame's last filtered
    #: iteration (0 without the filter)
    n_rejected: int = 0


class OdometryPipeline:
    """Streaming odometry over scans of one static (N, 3) shape: each frame
    registers against the previous scan's voxel model, then fits its own.
    With ``cfg.dnn_filter`` the bundled bias network (loaded once) filters
    each registration, sampling the previous scan, whose samples are kept
    from its own frame.  Runs on ``device`` (CUDA unless told otherwise)."""

    def __init__(
        self,
        cfg: ICETConfig | None = None,
        odo_cfg: OdometryConfig | None = None,
        device: str | torch.device | None = None,
    ):
        self.cfg = cfg or ICETConfig()
        self.odo_cfg = odo_cfg or OdometryConfig()
        self.device = resolve_device(device)
        self._dnn = pretrained_dnn(self.cfg, self.device) if self.cfg.dnn_filter else None
        self.reset()

    def reset(self) -> None:
        dev = self.device
        self._model = None
        self._scan_prev = None
        self._samples_prev = None
        self._X_prev = torch.zeros(6, device=dev)
        self._X_prev2 = torch.zeros(6, device=dev)
        self._T_world = torch.eye(4, device=dev)
        self._index = 0
        # Host mirrors for recovery: the pose state and the last scan (the
        # voxel model is a function of it, so recovery refits it).
        self._last_scan = None
        self._X_host = np.zeros(6, np.float32)
        self._T_host = np.eye(4, dtype=np.float32)
        self.recoveries = 0

    def step(self, scan) -> OdometryFrame | None:
        """Feed one scan; returns None for the very first frame.

        Survives a failed step: on any exception but a TypeError or a
        ValueError (deterministic errors, raised at once) the pipeline
        probes the devices, re-uploads the host-mirrored pose, refits the
        reference model from the retained previous scan (the same model
        the failed step held) and retries the frame once; ``recoveries``
        counts these.  On CUDA this covers failures that leave the
        process's context usable; after a sticky error (an illegal address,
        an Xid) the probe finds no device or the retry raises, and a new
        process must resume from a checkpoint
        (:func:`~icet_tpu_torch.utils.checkpoint.restore_odometry`)."""
        if not isinstance(scan, torch.Tensor):
            scan = np.asarray(scan, np.float32)
        try:
            frame = self._step_device(scan)
        except (TypeError, ValueError):
            raise
        except Exception:
            _log.warning("frame %d failed; recovering", self._index, exc_info=True)
            self._recover()
            frame = self._step_device(scan)
        # The mirrors move only once the frame has completed: a failure in
        # its read-back must not refit the model from the retried scan.
        self._last_scan = scan
        if frame is not None:
            self._X_host = frame.X
            self._T_host = frame.T_world
        return frame

    def _recover(self) -> None:
        from icet_tpu_torch.parallel.elastic import probe_devices

        if not probe_devices([self.device]):
            raise RuntimeError(f"device {self.device} does not answer")
        self.recoveries += 1
        dev = self.device
        self._X_prev = torch.from_numpy(self._X_host).to(dev)
        self._X_prev2 = self._X_prev  # re-lock: no velocity history
        self._T_world = torch.from_numpy(self._T_host).to(dev)
        self._model = self._scan_prev = self._samples_prev = None
        if self._last_scan is not None:
            scan_dev = as_points(self._last_scan, dev)
            self._model = prepare_reference(scan_dev, self.cfg)
            if self._dnn is not None:
                self._scan_prev = scan_dev
                self._samples_prev = model_voxel_samples(self._model, scan_dev, self.cfg)

    def _step_device(self, scan) -> OdometryFrame | None:
        t0 = time.perf_counter()
        scan_dev = as_points(scan, self.device)
        if self._model is None:
            self._model = prepare_reference(scan_dev, self.cfg)
            if self._dnn is not None:
                self._scan_prev = scan_dev
                self._samples_prev = model_voxel_samples(self._model, scan_dev, self.cfg)
            self._index += 1
            return None

        if self.odo_cfg.warm_start:
            x0 = warm_start_seed(self._X_prev, self._X_prev2, self.odo_cfg.warm_start_mode)
        else:
            x0 = torch.zeros(6, device=self.device)
        if self._dnn is not None:
            res, next_model, self._samples_prev, filt = odometry_step_dnn(
                self._model, self._scan_prev, self._samples_prev, scan_dev, x0,
                self.cfg, self._dnn,
            )
            self._scan_prev = scan_dev
            n_rejected = int(filt.n_rejected)
        else:
            res, next_model = odometry_step(self._model, scan_dev, x0, self.cfg)
            n_rejected = 0
        X = res.X
        diverged = bool(torch.any(torch.abs(X) > self.odo_cfg.divergence_clamp))
        if diverged:
            X = torch.zeros(6, device=self.device)
        self._T_world = compose_pose(self._T_world, X)
        self._X_prev2 = self._X_prev if not diverged else X
        self._X_prev = X
        self._model = next_model

        X_np = X.cpu().numpy()
        frame = OdometryFrame(
            index=self._index,
            X=X_np,
            pred_stds=res.pred_stds.cpu().numpy(),
            T_world=self._T_world.cpu().numpy(),
            pose=pose_to_state(self._T_world).cpu().numpy(),
            twist=X_np * self.odo_cfg.sensor_hz,
            diverged=diverged,
            n_corr=res.diagnostics.n_corr.cpu().numpy(),
            solve_ms=(time.perf_counter() - t0) * 1000.0,
            iterations=res.iterations,
            n_rejected=n_rejected,
        )
        self._index += 1
        return frame

    def run(self, scans: Iterable) -> Iterator[OdometryFrame]:
        for scan in scans:
            frame = self.step(scan)
            if frame is not None:
                yield frame

    @property
    def trajectory_pose(self) -> np.ndarray:
        return self._T_world.cpu().numpy()


def run_odometry(
    scans: Iterable,
    cfg: ICETConfig | None = None,
    odo_cfg: OdometryConfig | None = None,
    device: str | torch.device | None = None,
) -> list[OdometryFrame]:
    """Run the whole sequence through :class:`OdometryPipeline`."""
    return list(OdometryPipeline(cfg, odo_cfg, device).run(scans))


def run_odometry_device(
    scans,
    cfg: ICETConfig | None = None,
    odo_cfg: OdometryConfig | None = None,
    block: int = 64,
    device: str | torch.device | None = None,
) -> list[OdometryFrame]:
    """Run a recorded ``(F, N, 3)`` sequence on ``device`` in ``block``-frame
    uploads, with the pipeline's semantics (warm start, divergence guard,
    pose accumulation) kept on the device; results come back once per
    block.  As in the JAX package's runner, the velocity history of
    ``warm_start_mode="extrapolate"`` restarts at each block boundary.
    ``cfg.dnn_filter`` raises NotImplementedError: use the pipeline."""
    cfg = cfg or ICETConfig()
    odo_cfg = odo_cfg or OdometryConfig()
    if cfg.dnn_filter:
        raise NotImplementedError(
            "run_odometry_device does not support cfg.dnn_filter; use "
            "OdometryPipeline (per-frame steps) for the DNN-filtered mode, "
            "whose step carries the per-frame voxel-sample state"
        )
    dev = resolve_device(device)
    scans = np.asarray(scans, np.float32)
    model = prepare_reference(as_points(scans[0], dev), cfg)
    x = torch.zeros(6, device=dev)
    T = torch.eye(4, device=dev)
    clamp = odo_cfg.divergence_clamp
    frames: list[OdometryFrame] = []
    for s in range(1, scans.shape[0], block):
        blk = torch.from_numpy(scans[s : s + block]).to(dev)
        xprev, xprev2 = x, x
        outs = []
        for k in range(blk.shape[0]):
            if odo_cfg.warm_start:
                seed = warm_start_seed(xprev, xprev2, odo_cfg.warm_start_mode)
            else:
                seed = torch.zeros_like(xprev)
            res, model = odometry_step(model, blk[k], seed, cfg)
            diverged = torch.any(torch.abs(res.X) > clamp)
            X = torch.where(diverged, torch.zeros_like(res.X), res.X)
            T = compose_pose(T, X)
            xprev2 = torch.where(diverged, X, xprev)
            xprev = X
            outs.append((X, res.pred_stds, diverged, T, res.iterations))
        x = xprev
        Xs, stds, divs, Ts = (
            torch.stack([o[i] for o in outs]).cpu().numpy() for i in range(4)
        )
        for j in range(len(outs)):
            frames.append(OdometryFrame(
                index=s + j,
                X=Xs[j],
                pred_stds=stds[j],
                T_world=Ts[j],
                pose=pose_to_state(torch.from_numpy(Ts[j])).numpy(),
                twist=Xs[j] * odo_cfg.sensor_hz,
                diverged=bool(divs[j]),
                n_corr=np.zeros(0, np.int32),
                solve_ms=0.0,
                iterations=outs[j][4],
            ))
    return frames
