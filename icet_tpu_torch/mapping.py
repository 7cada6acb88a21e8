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

The compiled entry points :func:`map_update_jit` and :func:`map_step_jit`
(the JAX package's jitted ``map_update`` and ``map_step_jit``) run as
captured stages (``icet_tpu_torch.graphs``): the solve's graphs, then one
graph of the divergence guard, the ring's re-expression, the downsample
and the insert, then the prepare.  The insert's rows come from a device
mirror of the ring cursor and trail length; the trail's roll-when-full
branch is known on the host and keys a second graph.  They take the state
as the JAX package's donated argument: the ring is written in place, so
the graph that writes it is captured once a ring (keyed by its addresses)
and replayed for every later frame.  On the CPU the stages run as plain
calls; they equal :func:`map_update` and :func:`map_step` bit for bit.
:class:`MapMaker` takes them where ``solver.compiled_route(cfg)`` holds.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple

import numpy as np
import torch

from icet_tpu_torch import graphs
from icet_tpu_torch.config import PROFILES, ICETConfig, MapConfig, OdometryConfig
from icet_tpu_torch.device import as_points, resolve_device
from icet_tpu_torch.ops.geometry import euler_R
from icet_tpu_torch.solver import (
    compiled_graphs,
    compiled_route,
    prepare_reference,
    prepare_reference_jit,
    register,
)

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


def _advance(points, valid, trail, scan, X, u, map_cfg: MapConfig, min_range: float,
             write_ptr, slot, roll: bool):
    """The ring, validity and trail after one scan, as new tensors.

    ``write_ptr`` is the ring cursor (a host int or a 0-dim device tensor),
    ``slot`` a 1-element index tensor of the trail row the new origin takes,
    ``roll`` whether the full trail drops its oldest row first."""
    rot = euler_R(-X[3:6])
    pts = (points - X[:3]) @ rot
    trail = (trail - X[:3]) @ rot

    ok = torch.sum(scan * scan, dim=-1) > (min_range * min_range)
    order = torch.argsort(u.to(scan) + (~ok).to(scan.dtype) * 2.0, stable=True)
    take = order[: map_cfg.points_per_scan]

    cap, K = map_cfg.capacity, map_cfg.points_per_scan
    idx = (write_ptr + torch.arange(K, device=scan.device)) % cap
    pts[idx] = scan[take]
    valid = valid.clone()
    valid[idx] = ok[take]

    # Snail trail: append the new sensor origin, dropping the oldest when full.
    if roll:
        trail = torch.roll(trail, -1, dims=0)
    return pts, valid, trail.index_fill_(0, slot, 0.0)


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
    tcap = state.trail.shape[0]
    slot = torch.full((1,), min(state.trail_len, tcap - 1), dtype=torch.int64,
                      device=scan.device)
    pts, valid, trail = _advance(state.points, state.valid, state.trail, scan, X, u, map_cfg,
                                 min_range, state.write_ptr, slot, state.trail_len >= tcap)
    return MapState(points=pts, valid=valid, write_ptr=_next_ptr(state, map_cfg),
                    trail=trail, trail_len=min(state.trail_len + 1, tcap))


def _next_ptr(state: MapState, map_cfg: MapConfig) -> int:
    return (state.write_ptr + map_cfg.points_per_scan) % map_cfg.capacity


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
    diverged, X = _guard(res.X, divergence_clamp)
    new_state = map_update(state, scan, X, u, map_cfg, cfg.min_range)
    return res, X, diverged, new_state, prepare_reference(scan, cfg)


def _guard(X: torch.Tensor, divergence_clamp: float):
    """``(diverged, X or 0 where diverged)``: any ``|X_i| > clamp`` zeroes
    the solution (simpleMapMaker.cpp:129-137)."""
    diverged = torch.any(torch.abs(X) > divergence_clamp)
    return diverged, torch.where(diverged, torch.zeros_like(X), X)


# ---------------------------------------------------------------------------
# Capture-safe stages and the compiled entry points
# ---------------------------------------------------------------------------


def _stage_map(b, map_cfg: MapConfig, min_range: float, roll: bool,
               divergence_clamp: float | None = None) -> None:
    """The ring map stage on ``b.ring`` (:class:`graphs.RingBuffers`): with
    ``divergence_clamp``, the divergence guard of the finished solve's X
    and the frame's outputs (X, pred_stds, the flag) first; without it the
    staged X.  Then the ring re-expressed, sampled and inserted in place
    at the mirror's cursor, the trail's new origin at the mirror's length,
    the mirror advanced, and the ring's fill."""
    rb = b.ring
    points, valid, trail = rb.ring
    X = rb.X
    if divergence_clamp is not None:
        r = b.result[(b.n_iters, False)]
        diverged, X = _guard(r["X"], divergence_clamp)
        for name, t in (("X", X), ("pred_stds", r["pred_stds"]), ("diverged", diverged)):
            rb.out[name].copy_(t)
    cap, tcap, K = rb.shape
    slot = torch.clamp(rb.at[1:], max=tcap - 1)
    new = _advance(points, valid, trail, b.scan, X, rb.u, map_cfg, min_range, rb.at[0], slot,
                   roll)
    for dst, t in zip(rb.ring, new):
        dst.copy_(t)
    rb.at[0].copy_(torch.remainder(rb.at[0] + K, cap))
    rb.at[1].copy_(torch.clamp(rb.at[1] + 1, max=tcap))
    rb.out["n_valid"].copy_(torch.sum(valid))


def _map_run(fg, state: MapState, map_cfg: MapConfig, min_range: float, u, X=None,
             divergence_clamp: float | None = None) -> MapState:
    """Replay the ring stage on ``state``'s ring (the loaded scan; ``u``
    the uniforms; ``X`` a standalone update's, else the guarded solve's),
    the cursor mirror copied in only when it holds other counters than
    the host's; the host's counters follow.  Returns the advanced state
    (the same ring tensors)."""
    rb = fg.ring_buffers((state.points, state.valid, state.trail), map_cfg.points_per_scan)
    want = (state.write_ptr, state.trail_len)
    if rb.expect != want:
        graphs.copy_in(rb.at, torch.tensor(want, dtype=torch.int64))
        rb.expect = want
    graphs.copy_in(rb.u, u)
    if X is not None:
        graphs.copy_in(rb.X, X)
    tcap = state.trail.shape[0]
    roll = state.trail_len >= tcap
    fg.run(("map", rb.shape, rb.key(), roll, min_range, divergence_clamp),
           lambda b: _stage_map(b, map_cfg, min_range, roll, divergence_clamp))
    state = state._replace(write_ptr=_next_ptr(state, map_cfg),
                           trail_len=min(state.trail_len + 1, tcap))
    rb.expect = (state.write_ptr, state.trail_len)
    return state


def _map_update_on(fg, state, scan, X, u, map_cfg: MapConfig, min_range: float) -> MapState:
    fg.load(scan=scan)
    return _map_run(fg, state, map_cfg, min_range, u, X)


def map_update_jit(
    state: MapState,
    scan: torch.Tensor,
    X: torch.Tensor,
    u: torch.Tensor,
    map_cfg: MapConfig,
    min_range: float = 0.2,
) -> MapState:
    """:func:`map_update` as a captured graph (the JAX package's jitted
    ``map_update``).  ``state`` is donated, as there: its ring, validity
    and trail are written in place and come back in the returned state;
    do not read the old state's counters after calling.  The graph set is
    the one of ``PROFILES["mapping"]`` at ``min_range`` (the map stage
    reads no solver config), where a default :class:`MapMaker` runs."""
    fg = compiled_graphs(scan, PROFILES["mapping"].replace(min_range=min_range))
    return _map_update_on(fg, state, scan, X, u, map_cfg, min_range)


def _map_frame(model, state, scan, u, divergence_clamp: float, cfg: ICETConfig,
               map_cfg: MapConfig):
    """One compiled mapping frame: ``(fg, iterations, packed outputs
    (graphs.MAP_OUT_LAYOUT, one copy), new state, new model)``."""
    fg = compiled_graphs(scan, cfg)
    fg.load(scan=scan, x0=torch.zeros(6, dtype=scan.dtype, device=scan.device), model=model)
    iterations = fg.solve(False)
    state = _map_run(fg, state, map_cfg, cfg.min_range, u,
                     divergence_clamp=float(divergence_clamp))
    fg.run_prepare()
    out = graphs.clone_out(fg.buffers.ring.out_buf)
    return fg, iterations, out, state, fg.prepared()


def map_step_jit(
    model,
    state: MapState,
    scan: torch.Tensor,
    u: torch.Tensor,
    divergence_clamp: float,
    cfg: ICETConfig,
    map_cfg: MapConfig,
):
    """:func:`map_step` as captured graphs (the JAX package's
    ``map_step_jit``): the solve from X = 0 without the static mask, the
    divergence guard as a device ``where``, the ring stage and the prepare.
    ``state`` is donated, as in :func:`map_update_jit`.

    Returns ``(res, X_guarded, diverged, new_state, new_model)``."""
    fg, iterations, out, state, model = _map_frame(model, state, scan, u, divergence_clamp,
                                                   cfg, map_cfg)
    v = graphs.MAP_OUT_LAYOUT.views(out)
    return fg.result(iterations, False), v["X"], v["diverged"], state, model


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
    the scan into the device-resident ring map.

    On a captured moment route (``solver.compiled_route``) each frame is
    one :func:`map_step_jit` (the seed frame ``prepare_reference_jit`` and
    :func:`map_update_jit`), captured graphs on CUDA writing the runner's
    own ring in place; otherwise the eager functions.  The config decides,
    once."""

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
        self._compiled = compiled_route(self.cfg)
        #: the graph set of the compiled route's last frame
        self._fg = None
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
        # The snapshot goes back into the ring itself, so the compiled
        # route's graphs, keyed by the ring's addresses, keep replaying.
        snap = self._snapshot or init_map(self.map_cfg, self.state.trail.shape[0], "cpu")
        for k in ("points", "valid", "trail"):
            getattr(self.state, k).copy_(getattr(snap, k))
        self.state = self.state._replace(write_ptr=snap.write_ptr, trail_len=snap.trail_len)
        if self._fg is not None and self._fg.buffers.ring is not None:
            self._fg.buffers.ring.expect = None  # the cursor mirror is copied in again
        if self._last_scan is None:
            self._model = None
        else:
            prepare = prepare_reference_jit if self._compiled else prepare_reference
            self._model = prepare(as_points(self._last_scan, dev), self.cfg)

    def _step_device(self, scan) -> MapFrame | None:
        scan_dev = as_points(scan, self.device)
        u = self._uniforms(scan_dev.shape[0])
        if self._model is None:
            zero = torch.zeros(6, device=self.device)
            if self._compiled:
                self._model = prepare_reference_jit(scan_dev, self.cfg)
                self._fg = compiled_graphs(scan_dev, self.cfg)
                self.state = _map_update_on(self._fg, self.state, scan_dev, zero, u,
                                            self.map_cfg, self.cfg.min_range)
            else:
                self._model = prepare_reference(scan_dev, self.cfg)
                self.state = map_update(self.state, scan_dev, zero, u, self.map_cfg,
                                        self.cfg.min_range)
            self._index += 1
            return None

        # The mapping node cold-starts every solve from X0 = 0
        # (simpleMapMaker.cpp:113-119).
        args = (self._model, self.state, scan_dev, u, self.odo_cfg.divergence_clamp,
                self.cfg, self.map_cfg)
        if self._compiled:
            _, X, _, self.state, self._model = map_step_jit(*args)
            self._fg = compiled_graphs(scan_dev, self.cfg)
            # X, pred_stds, the flag and the fill: one packed buffer, one copy.
            v = graphs.MAP_OUT_LAYOUT.views(graphs.MAP_OUT_LAYOUT.buffer(X).cpu())
            X, stds = v["X"].numpy(), v["pred_stds"].numpy()
            diverged, n_points = bool(v["diverged"]), int(v["n_valid"])
        else:
            res, X, diverged, self.state, self._model = map_step(*args)
            host = torch.cat([X, res.pred_stds, diverged[None].float(),
                              self.state.valid.sum()[None].float()]).cpu().numpy()
            X, stds, diverged, n_points = host[:6], host[6:12], bool(host[12]), int(host[13])
        frame = MapFrame(index=self._index, X=X, pred_stds=stds, diverged=diverged,
                         n_map_points=n_points)
        self._index += 1
        return frame

    def map_points(self) -> np.ndarray:
        """The current map (newest sensor frame) as (M, 3) numpy."""
        return self.state.points[self.state.valid].cpu().numpy()

    def snail_trail(self) -> np.ndarray:
        return self.state.trail[: self.state.trail_len].cpu().numpy()


__all__ = ["MapFrame", "MapMaker", "MapState", "init_map", "map_step", "map_step_jit",
           "map_update", "map_update_jit"]
