"""HD-map accumulation (``icet_tpu/mapping.py``, reference
src/simpleMapMaker.cpp).

The map is a fixed-capacity ring of points with a validity mask, held on
the device in the NEWEST sensor frame: each registered scan re-expresses
the ring and the snail trail in its own frame, then inserts a random
downsample of itself.  The sampler draws only valid points and marks
short-fall slots invalid.

Differences from the JAX package, none of which changes a trajectory: the
ring cursor and trail length are host integers; the downsample's uniforms
come from a ``torch.Generator`` seeded from ``seed`` (and are an argument
of :func:`map_update`, so a test can pass the JAX package's draws in).
:meth:`MapMaker.step` survives a failed step.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple

import numpy as np
import torch

from icet_tpu_torch.config import PROFILES, ICETConfig, MapConfig, OdometryConfig
from icet_tpu_torch.device import as_points, resolve_device
from icet_tpu_torch.ops.geometry import euler_R
from icet_tpu_torch.solver import prepare_reference, register

_log = logging.getLogger(__name__)


class MapState(NamedTuple):
    points: torch.Tensor  # (capacity, 3), expressed in the NEWEST sensor frame
    valid: torch.Tensor  # (capacity,) bool
    write_ptr: int  # ring cursor
    trail: torch.Tensor  # (trail_capacity, 3) past sensor origins, newest frame
    trail_len: int


def init_map(map_cfg: MapConfig, trail_capacity: int = 4096, device=None) -> MapState:
    return MapState(
        points=torch.zeros((map_cfg.capacity, 3), dtype=torch.float32, device=device),
        valid=torch.zeros(map_cfg.capacity, dtype=torch.bool, device=device),
        write_ptr=0,
        trail=torch.zeros((trail_capacity, 3), dtype=torch.float32, device=device),
        trail_len=0,
    )


def map_update(
    state: MapState,
    scan: torch.Tensor,
    X: torch.Tensor,
    u: torch.Tensor,
    map_cfg: MapConfig,
    min_range: float = 0.2,
) -> MapState:
    """Advance the map by one registered scan.

    ``X`` maps the new scan's frame to the previous frame (``p_prev =
    R(-angs) p_new + t``); the stored map and trail are re-expressed in the
    new frame by the inverse, ``p_new = R^T (p_prev - t)``.  The downsample
    takes the ``points_per_scan`` rows with the smallest ``u + 2 * invalid``
    (``u``: one uniform in [0, 1) a scan row), so invalid rows come last.
    """
    rot = euler_R(-X[3:6])
    pts = (state.points - X[:3]) @ rot
    trail = (state.trail - X[:3]) @ rot

    ok = torch.sum(scan * scan, dim=-1) > (min_range * min_range)
    order = torch.argsort(u.to(scan) + (~ok).to(scan.dtype) * 2.0, stable=True)
    take = order[: map_cfg.points_per_scan]

    cap, K = map_cfg.capacity, map_cfg.points_per_scan
    idx = (state.write_ptr + torch.arange(K, device=scan.device)) % cap
    pts[idx] = scan[take]
    valid = state.valid.clone()
    valid[idx] = ok[take]

    # Snail trail: append the new sensor origin, dropping the oldest when full.
    tcap = state.trail.shape[0]
    if state.trail_len >= tcap:
        trail = torch.roll(trail, -1, dims=0)
    trail[min(state.trail_len, tcap - 1)] = 0.0
    return MapState(points=pts, valid=valid, write_ptr=(state.write_ptr + K) % cap,
                    trail=trail, trail_len=min(state.trail_len + 1, tcap))


def map_step(
    model,
    state: MapState,
    scan: torch.Tensor,
    u: torch.Tensor,
    divergence_clamp: float,
    cfg: ICETConfig,
    map_cfg: MapConfig,
):
    """One mapping frame: register the scan against the previous frame's
    model from X = 0, zero the solution when any ``|X_i| > clamp``
    (simpleMapMaker.cpp:129-137), fold the scan into the ring and fit the
    scan's own model for the next frame.

    Returns ``(res, X_guarded, diverged, new_state, new_model)``."""
    res = register(model, scan, torch.zeros(6, dtype=scan.dtype, device=scan.device), cfg,
                   want_static_mask=False)
    diverged = torch.any(torch.abs(res.X) > divergence_clamp)
    X = torch.where(diverged, torch.zeros_like(res.X), res.X)
    new_state = map_update(state, scan, X, u, map_cfg, cfg.min_range)
    return res, X, diverged, new_state, prepare_reference(scan, cfg)


@dataclasses.dataclass
class MapFrame:
    index: int
    X: np.ndarray
    pred_stds: np.ndarray
    diverged: bool
    n_map_points: int


class MapMaker:
    """Streaming map accumulator (reference MapMakerNode,
    simpleMapMaker.cpp:60-289) on ``device`` (CUDA unless told otherwise):
    register each scan against the previous one, guard divergence, and fold
    the scan into the device-resident ring map."""

    def __init__(
        self,
        cfg: ICETConfig | None = None,
        map_cfg: MapConfig | None = None,
        odo_cfg: OdometryConfig | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
        snapshot_every: int = 25,
    ):
        self.cfg = cfg or PROFILES["mapping"]
        self.map_cfg = map_cfg or MapConfig()
        self.odo_cfg = odo_cfg or OdometryConfig()
        self.device = resolve_device(device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._model = None
        self._index = 0
        self.state = init_map(self.map_cfg, device=self.device)
        # Recovery: the ring map is copied to the host every
        # ``snapshot_every`` frames; the last scan and the generator state
        # are mirrored every frame (the voxel model is refit from the scan).
        # At most ``snapshot_every`` frames of map points are lost; the
        # trajectory goes on from the refit model.
        self.snapshot_every = max(int(snapshot_every), 1)
        self._last_scan = None
        self._gen_host = self._gen.get_state()
        self._snapshot: MapState | None = None
        self.recoveries = 0

    def _uniforms(self, n: int) -> torch.Tensor:
        return torch.rand(n, generator=self._gen, device=self.device)

    def step(self, scan) -> MapFrame | None:
        """Feed one scan; returns None for the first, which seeds the map.

        Survives a failed step: on any exception but a TypeError or a
        ValueError the pipeline probes the device, restores the newest map
        snapshot and the generator state, refits the model from the last
        scan and retries once; ``recoveries`` counts these.  With
        ``snapshot_every=1`` the recovered run equals an unfailed one.  On
        CUDA this covers failures that leave the context usable; after a
        sticky error the probe finds no device or the retry raises."""
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
        self._last_scan = scan
        self._gen_host = self._gen.get_state()
        if self._index % self.snapshot_every == 0:
            st = self.state
            self._snapshot = st._replace(**{k: getattr(st, k).to("cpu", copy=True)
                                            for k in ("points", "valid", "trail")})
        return frame

    def _recover(self) -> None:
        from icet_tpu_torch.parallel.elastic import probe_devices

        if not probe_devices([self.device]):
            raise RuntimeError(f"device {self.device} does not answer")
        self.recoveries += 1
        dev = self.device
        self._gen.set_state(self._gen_host)
        if self._snapshot is None:
            self.state = init_map(self.map_cfg, device=dev)
        else:
            snap = self._snapshot
            self.state = snap._replace(**{k: getattr(snap, k).to(dev, copy=True)
                                          for k in ("points", "valid", "trail")})
        self._model = (prepare_reference(as_points(self._last_scan, dev), self.cfg)
                       if self._last_scan is not None else None)

    def _step_device(self, scan) -> MapFrame | None:
        scan_dev = as_points(scan, self.device)
        u = self._uniforms(scan_dev.shape[0])
        if self._model is None:
            self._model = prepare_reference(scan_dev, self.cfg)
            self.state = map_update(self.state, scan_dev, torch.zeros(6, device=self.device),
                                    u, self.map_cfg, self.cfg.min_range)
            self._index += 1
            return None

        # The mapping node cold-starts every solve from X0 = 0
        # (simpleMapMaker.cpp:113-119).
        res, X, diverged, self.state, self._model = map_step(
            self._model, self.state, scan_dev, u, self.odo_cfg.divergence_clamp,
            self.cfg, self.map_cfg,
        )
        host = torch.cat([X, res.pred_stds, diverged[None].float(),
                          self.state.valid.sum()[None].float()]).cpu().numpy()
        frame = MapFrame(index=self._index, X=host[:6], pred_stds=host[6:12],
                         diverged=bool(host[12]), n_map_points=int(host[13]))
        self._index += 1
        return frame

    def map_points(self) -> np.ndarray:
        """The current map (newest sensor frame) as (M, 3) numpy."""
        return self.state.points[self.state.valid].cpu().numpy()

    def snail_trail(self) -> np.ndarray:
        return self.state.trail[: self.state.trail_len].cpu().numpy()


__all__ = ["MapFrame", "MapMaker", "MapState", "init_map", "map_step", "map_update"]
