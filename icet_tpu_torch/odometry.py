"""Frame-to-frame odometry (``icet_tpu/odometry.py``).

:class:`OdometryPipeline` takes one scan at a time; :func:`run_odometry_device`
takes a recorded ``(F, N, 3)`` sequence, uploads it to the card block by
block and chains the odometry step there, reading results back once per
block.  Both give the same :class:`OdometryFrame` records.  With
``cfg.dnn_filter`` the pipeline runs the DNN-filtered step; the sequence
runner refuses it, as the JAX package's does.  The pipeline survives a
failed step (:meth:`OdometryPipeline.step`).

Both run the compiled step on every moment route (fused, plain, scatter
and one-hot): the pipeline :func:`~icet_tpu_torch.solver.odometry_step_jit`
a frame (with the filter :func:`~icet_tpu_torch.filters.
odometry_step_dnn_jit`), the sequence runner :func:`odometry_sequence_jit`
a block, whose warm start, divergence guard, world pose and model
hand-over are captured graphs too.  The eager steps
(:func:`~icet_tpu_torch.solver.odometry_step`, :func:`~icet_tpu_torch.
filters.odometry_step_dnn`) stay as the plain version the tests hold the
compiled ones to.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from icet_tpu_torch import graphs
from icet_tpu_torch.config import ICETConfig, OdometryConfig
from icet_tpu_torch.device import as_points, resolve_device
from icet_tpu_torch.filters import (
    DnnFilterResult,
    model_voxel_samples_jit,
    odometry_step_dnn_jit,
    pretrained_dnn,
)
from icet_tpu_torch.models.bias_net import BiasNet
from icet_tpu_torch.ops.bias_encoder import bias_encoder_pool
from icet_tpu_torch.ops.geometry import (
    compose_pose,
    compose_states,
    pose_to_state,
    relative_state,
)
from icet_tpu_torch.solver import (
    compiled_graphs,
    moment_route,
    odometry_step_jit,
    prepare_reference_jit,
)
from icet_tpu_torch.utils.profiling import frame_log as _flog

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
    #: the DNN filter's last pass, on the device (None without the filter)
    dnn_filter: DnnFilterResult | None = None


class OdometryPipeline:
    """Streaming odometry over scans of one static (N, 3) shape: each frame
    registers against the previous scan's voxel model, then fits its own.
    With ``cfg.dnn_filter`` a bias network filters each registration,
    sampling the previous scan, whose samples are kept from its own frame:
    ``net`` where given (moved to ``device``), else the bundled one for
    ``cfg.dnn_sample_pts`` (loaded once a process).  Runs on ``device``
    (CUDA unless told otherwise).

    Each frame is one :func:`~icet_tpu_torch.solver.odometry_step_jit`,
    with the filter one :func:`~icet_tpu_torch.filters.odometry_step_dnn_jit`
    (captured graphs on CUDA).  An unknown ``cfg.moment_method`` raises
    ValueError here, before any frame."""

    def __init__(
        self,
        cfg: ICETConfig | None = None,
        odo_cfg: OdometryConfig | None = None,
        device: str | torch.device | None = None,
        net: BiasNet | None = None,
    ):
        self.cfg = cfg or ICETConfig()
        self.odo_cfg = odo_cfg or OdometryConfig()
        self.device = resolve_device(device)
        self._dnn = None
        if self.cfg.dnn_filter:
            self._dnn = pretrained_dnn(self.cfg, self.device) if net is None else net.to(
                self.device)
        moment_route(self.cfg)
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
        (:func:`~icet_tpu_torch.utils.checkpoint.restore_odometry`).

        Each call is one frame of the frame log (``utils.profiling``), root
        ``odometry.step``, failed or not; a filtered frame adds its counters
        ``filter_passes``, ``encoder_launches`` (kernel #4's, counted by its
        wrapper: 0 on the CPU) and ``n_rejected`` (the last pass's)."""
        token = _flog.open("odometry.step", self._index, self.device)
        frame, failed = None, True
        try:
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
            # The mirrors move only once the frame has completed: a failure
            # in its read-back must not refit the model from the retried scan.
            self._last_scan = scan
            if frame is not None:
                self._X_host = frame.X
                self._T_host = frame.T_world
            failed = False
            return frame
        finally:
            _flog.close(token, failed, 0 if frame is None else frame.iterations)

    def _recover(self) -> None:
        from icet_tpu_torch.parallel.elastic import probe_devices

        if not probe_devices([self.device]):
            raise RuntimeError(f"device {self.device} does not answer")
        self.recoveries += 1
        dev = self.device
        # The failed frame may have left a capture or its buffers half-done.
        graphs.clear(dev)
        self._X_prev = torch.from_numpy(self._X_host).to(dev)
        self._X_prev2 = self._X_prev  # re-lock: no velocity history
        self._T_world = torch.from_numpy(self._T_host).to(dev)
        self._model = self._scan_prev = self._samples_prev = None
        if self._last_scan is not None:
            self._refit(as_points(self._last_scan, dev))

    def _refit(self, scan_dev) -> None:
        """The reference model of ``scan_dev`` (and, with the filter, its
        samples) for the next frame."""
        self._model = prepare_reference_jit(scan_dev, self.cfg)
        if self._dnn is not None:
            self._scan_prev = scan_dev
            self._samples_prev = model_voxel_samples_jit(self._model, scan_dev, self.cfg)

    def _step_device(self, scan) -> OdometryFrame | None:
        t0 = time.perf_counter()
        span = _flog.begin("upload")
        scan_dev = as_points(scan, self.device)
        _flog.end(span)
        if self._model is None:
            self._refit(scan_dev)
            self._index += 1
            return None

        span = _flog.begin("seed")
        if self.odo_cfg.warm_start:
            x0 = warm_start_seed(self._X_prev, self._X_prev2, self.odo_cfg.warm_start_mode)
        else:
            x0 = torch.zeros(6, device=self.device)
        _flog.end(span)
        filt = None
        if self._dnn is not None:
            args = (self._model, self._scan_prev, self._samples_prev, scan_dev, x0,
                    self.cfg, self._dnn)
            launches = bias_encoder_pool.launches
            res, next_model, self._samples_prev, filt = odometry_step_dnn_jit(
                *args, return_filter=True)
            self._scan_prev = scan_dev
            _flog.add("filter_passes", graphs.dnn_passes(self.cfg))
            _flog.add("encoder_launches", bias_encoder_pool.launches - launches)
        else:
            res, next_model = odometry_step_jit(self._model, scan_dev, x0, self.cfg)
        X = res.X
        span = _flog.begin("divergence_read")
        _flog.read()
        diverged = bool(torch.any(torch.abs(X) > self.odo_cfg.divergence_clamp))
        _flog.end(span)
        span = _flog.begin("glue")
        if diverged:
            X = torch.zeros(6, device=self.device)
        self._T_world = compose_pose(self._T_world, X)
        self._X_prev2 = self._X_prev if not diverged else X
        self._X_prev = X
        self._model = next_model

        # One read-back of the frame's values (the step's iterations and the
        # filter's n_rejected too), and the correspondences.
        parts = [X, res.pred_stds, self._T_world.reshape(-1), pose_to_state(self._T_world),
                 torch.as_tensor(res.iterations).reshape(1).to(X)]
        if filt is not None:
            parts.append(filt.n_rejected.reshape(1).to(X.dtype))
        packed = torch.cat(parts)
        _flog.end(span)
        span = _flog.begin("readback")
        _flog.read()
        host = packed.cpu().numpy()
        _flog.read()
        n_corr = res.diagnostics.n_corr.cpu().numpy()
        _flog.end(span)
        X_np = host[0:6]
        frame = OdometryFrame(
            index=self._index,
            X=X_np,
            pred_stds=host[6:12],
            T_world=host[12:28].reshape(4, 4),
            pose=host[28:34],
            twist=X_np * self.odo_cfg.sensor_hz,
            diverged=diverged,
            n_corr=n_corr,
            solve_ms=(time.perf_counter() - t0) * 1000.0,
            iterations=int(host[34]),
            n_rejected=int(host[35]) if filt is not None else 0,
            dnn_filter=filt,
        )
        if filt is not None:
            _flog.add("n_rejected", frame.n_rejected)
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


def _stage_seed(b, warm_start: bool, mode: str) -> None:
    """The next solve's seed from the carried ``xprev``/``xprev2``."""
    if warm_start:
        b.x0.copy_(warm_start_seed(b.xprev, b.xprev2, mode))
    else:
        b.x0.zero_()


def _stage_glue(b, clamp: float, warm_start: bool, mode: str) -> None:
    """After a frame's registration and prepare: the divergence guard, the
    world pose and the velocity history, the frame's row, the prepared
    model into the registration's model buffer, and the next seed."""
    diverged = torch.any(torch.abs(b.X) > clamp)
    X = torch.where(diverged, torch.zeros_like(b.X), b.X)
    T = compose_pose(b.T, X)
    xprev2 = torch.where(diverged, X, b.xprev)
    b.row["X"].copy_(X)
    b.row["pred_stds"].copy_(b.result[(b.n_iters, False)]["pred_stds"])
    b.row["T_world"].copy_(T)
    b.row["diverged"].copy_(diverged)
    b.row["iterations"].copy_(b.iters[0])
    b.T.copy_(T)
    b.xprev2.copy_(xprev2)
    b.xprev.copy_(X)
    b.model_buf.copy_(b.prepared_buf)
    _stage_seed(b, warm_start, mode)


def odometry_sequence_jit(
    frames: torch.Tensor,
    model0,
    x0: torch.Tensor,
    T0: torch.Tensor,
    cfg: ICETConfig,
    divergence_clamp: float = 0.3,
    warm_start: bool = True,
    warm_start_mode: str = "previous",
    return_iterations: bool = False,
):
    """A block of frames ``(F, N, 3)`` chained on the device (the JAX
    package's ``odometry_sequence_jit``): each frame registers against the
    carried model from the seed, then fits its own model; the warm start
    (from ``x0`` at the block's start, so the velocity history of
    ``"extrapolate"`` restarts there), the divergence guard and the world
    pose (from ``T0``) stay on the device.  Each frame replays its solve's
    graph (the early exit on the device), its prepare's and one ``glue``
    graph; the host reads nothing until the block's outputs.

    Returns ``((model, X_last, T_last), (X, pred_stds, diverged, T_world))``
    as the JAX package's does: the carry for the next block and the
    per-frame outputs stacked on the device.  With ``return_iterations``
    a third element follows, the iterations each frame executed (an
    ``(F,)`` int64 tensor on the device; the JAX runner does not return
    them)."""
    if frames.ndim != 3 or frames.shape[0] == 0:
        raise ValueError(f"frames must be a non-empty (F, N, 3) block, got {tuple(frames.shape)}")
    fg = compiled_graphs(frames[0], cfg)
    b = fg.buffers
    fg.load(x0=x0, model=model0)
    fg.hold("model", None)  # the glue overwrites the model buffer
    graphs.copy_in(b.xprev, b.x0)
    graphs.copy_in(b.xprev2, b.x0)
    graphs.copy_in(b.T, T0)
    fg.run(("seed", warm_start, warm_start_mode),
           lambda bb: _stage_seed(bb, warm_start, warm_start_mode))
    glue = ("glue", float(divergence_clamp), warm_start, warm_start_mode)
    rows = []
    for k in range(frames.shape[0]):
        fg.load(scan=frames[k])
        fg.solve(False)
        fg.run_prepare()
        fg.run(glue, lambda bb: _stage_glue(bb, float(divergence_clamp), warm_start,
                                            warm_start_mode))
        rows.append(graphs.clone_out(b.row_buf))
    out = graphs.ROW_LAYOUT.stacked_views(torch.stack(rows))
    carry = (fg.model_copy(), graphs.clone_out(b.xprev), graphs.clone_out(b.T))
    outs = (out["X"], out["pred_stds"], out["diverged"], out["T_world"])
    return (carry, outs, out["iterations"]) if return_iterations else (carry, outs)


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
    Each block is one :func:`odometry_sequence_jit`.
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
    model = prepare_reference_jit(as_points(scans[0], dev), cfg)
    x = torch.zeros(6, device=dev)
    T = torch.eye(4, device=dev)
    frames: list[OdometryFrame] = []
    for s in range(1, scans.shape[0], block):
        blk = torch.from_numpy(scans[s : s + block]).to(dev)
        (model, x, T), outs, iterations = odometry_sequence_jit(
            blk, model, x, T, cfg, odo_cfg.divergence_clamp, odo_cfg.warm_start,
            odo_cfg.warm_start_mode, return_iterations=True)
        Xs, stds, divs, Ts, iterations = (o.cpu().numpy() for o in (*outs, iterations))
        frames += _block_frames(s, Xs, stds, divs, Ts, iterations, odo_cfg)
    return frames


def _block_frames(start, Xs, stds, divs, Ts, iterations, odo_cfg) -> list[OdometryFrame]:
    return [OdometryFrame(
        index=start + j,
        X=Xs[j],
        pred_stds=stds[j],
        T_world=Ts[j],
        pose=pose_to_state(torch.from_numpy(Ts[j])).numpy(),
        twist=Xs[j] * odo_cfg.sensor_hz,
        diverged=bool(divs[j]),
        n_corr=np.zeros(0, np.int32),
        solve_ms=0.0,
        iterations=int(iterations[j]),
    ) for j in range(len(iterations))]
