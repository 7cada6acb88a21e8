"""Deterministic scan replay sources; a copy of
``icet_tpu/datasets/replay.py`` that needs no JAX.

``ReplaySource`` replays recorded cloud files as the reference's
fake_lidar node does (src/fake_lidar.py:85-196): in sorted order,
optionally paced at the sensor rate and looping.  The two trajectory
sources raycast scans with exact ground truth.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Iterator

import numpy as np

from icet_tpu_torch.datasets.loaders import DEFAULT_MAX_POINTS, load_cloud
from icet_tpu_torch.datasets.synthetic import Scene, simulate_scan


class ReplaySource:
    """Replay a directory/glob of cloud files in sorted order.

    Args:
      pattern: glob for cloud files (npy/bin/csv/ply).
      rate_hz: if set, sleep to pace frames at this rate (the reference's
        10 Hz publisher, fake_lidar.py:80); None = as fast as possible.
      loop: restart at the sequence end (fake_lidar.py:191-196).
    """

    def __init__(
        self,
        pattern: str,
        rate_hz: float | None = None,
        loop: bool = False,
        max_points: int = DEFAULT_MAX_POINTS,
    ):
        if os.path.isdir(pattern):
            pattern = os.path.join(pattern, "*")
        self.paths = sorted(p for p in glob.glob(pattern) if os.path.isfile(p))
        if not self.paths:
            raise FileNotFoundError(f"no cloud files match {pattern}")
        self.rate_hz = rate_hz
        self.loop = loop
        self.max_points = max_points

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self) -> Iterator[np.ndarray]:
        period = 1.0 / self.rate_hz if self.rate_hz else 0.0
        while True:
            for p in self.paths:
                t0 = time.perf_counter()
                yield load_cloud(p, self.max_points)
                if period:
                    dt = time.perf_counter() - t0
                    if dt < period:
                        time.sleep(period - dt)
            if not self.loop:
                return


class SyntheticTrajectorySource:
    """Raycast scans along a parametric trajectory with exact ground truth.

    Yields (scan, T_world) pairs where T_world is the sensor-to-world pose at
    that frame — the automated form of the reference's dormant
    ``true_transform`` plumbing (msg/Num.msg:5).
    """

    def __init__(
        self,
        n_frames: int = 20,
        speed: float = 0.8,
        yaw_rate: float = 0.01,
        scene: Scene | None = None,
        seed: int = 0,
        n_beams: int = 64,
        n_azimuth: int = 1024,
    ):
        self.n_frames = n_frames
        self.speed = speed
        self.yaw_rate = yaw_rate
        self.scene = scene or Scene()
        self.seed = seed
        self.n_beams = n_beams
        self.n_azimuth = n_azimuth

    def pose(self, i: int):
        yaw = self.yaw_rate * i
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        t = np.array(
            [self.speed * i * np.cos(yaw / 2), self.speed * i * np.sin(yaw / 2), 0.0]
        )
        return R, t

    def __iter__(self):
        for i in range(self.n_frames):
            R, t = self.pose(i)
            scan = simulate_scan(
                pose_t=t,
                pose_R=R,
                scene=self.scene,
                seed=self.seed + i,
                n_beams=self.n_beams,
                n_azimuth=self.n_azimuth,
            )
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = t
            yield scan, T


class CityDriveSource:
    """A multi-lap city-block circuit with exact ground truth — the
    repo's KITTI-style long-sequence fixture (the reference evaluates on
    KITTI/Ford/CODD urban drives, README.md:67-110; no data ships with it).

    The sensor drives the rounded-rectangle ring road of
    :func:`~icet_tpu_torch.datasets.synthetic.city_scene` (corners smoothed with
    radius ``corner_radius``), heading tangent to the path, at ``speed``
    metres per frame.  Each lap revisits the same streets, so loop-closure
    detection on the estimated trajectory has genuine revisits to find.

    Yields ``(scan, T_world)`` like :class:`SyntheticTrajectorySource`.
    """

    #: default circuit rectangle (street centerlines) in scene coordinates
    X0, X1, Y0, Y1 = 10.0, 90.0, 10.0, 70.0

    def __init__(
        self,
        n_frames: int = 500,
        speed: float = 1.0,
        corner_radius: float = 6.0,
        scene: Scene | None = None,
        seed: int = 0,
        n_beams: int = 64,
        n_azimuth: int = 1024,
        range_noise: float = 0.02,
        rect: tuple | None = None,
        moving_cars: int = 0,
        car_speed: float = 1.6,
        dropout_frac: float = 0.0,
        range_bias_std: float = 0.0,
    ):
        """``moving_cars``/``dropout_frac``/``range_bias_std`` make the
        drive non-benign (VERDICT r2 #7): on the clean drive the odometry
        bias is systematic per lap, so loop factors are internally
        consistent with the drifted trajectory and pose-graph refinement
        cannot help; these corruptions make per-frame error non-systematic.

        - ``moving_cars``: box "vehicles" circulating the same ring road at
          ``car_speed``x the sensor speed (so they overtake / meet it) —
          genuine moving objects for the RM / divergence machinery.
        - ``dropout_frac``: an azimuth sector of this fraction, at a random
          per-frame heading, returns nothing (occluded / blinded sensor).
        - ``range_bias_std``: per-frame common-mode range bias (metres),
          simulating per-revolution calibration jitter.
        """
        from icet_tpu_torch.datasets.synthetic import city_scene

        if rect is not None:
            self.X0, self.X1, self.Y0, self.Y1 = rect
        self.n_frames = n_frames
        self.speed = speed
        self.rho = corner_radius
        self.scene = scene or city_scene(seed)
        self.seed = seed
        self.n_beams = n_beams
        self.n_azimuth = n_azimuth
        self.range_noise = range_noise
        self.moving_cars = moving_cars
        self.car_speed = car_speed
        self.dropout_frac = dropout_frac
        self.range_bias_std = range_bias_std

        w = self.X1 - self.X0 - 2 * self.rho  # straight lengths
        h = self.Y1 - self.Y0 - 2 * self.rho
        arc = np.pi / 2 * self.rho
        #: segment lengths: S, arc, E, arc, N, arc, W, arc (counterclockwise)
        self._segs = [w, arc, h, arc, w, arc, h, arc]
        self.lap_length = sum(self._segs)

    def pose(self, i: int):
        """(R, t) world pose at frame i (z = 0, yaw only)."""
        s = (self.speed * i) % self.lap_length
        x0, x1, y0, y1, rho = self.X0, self.X1, self.Y0, self.Y1, self.rho
        w = x1 - x0 - 2 * rho
        h = y1 - y0 - 2 * rho
        # Walk the segments counterclockwise starting at (x0+rho, y0).
        for k, L in enumerate(self._segs):
            if s <= L or k == len(self._segs) - 1:
                break
            s -= L
        if k == 0:  # south straight, heading +x
            p = np.array([x0 + rho + s, y0])
            yaw = 0.0
        elif k == 1:  # SE corner
            a = s / rho
            c = np.array([x1 - rho, y0 + rho])
            p = c + rho * np.array([np.sin(a), -np.cos(a)])
            yaw = a
        elif k == 2:  # east straight, heading +y
            p = np.array([x1, y0 + rho + s])
            yaw = np.pi / 2
        elif k == 3:  # NE corner
            a = s / rho
            c = np.array([x1 - rho, y1 - rho])
            p = c + rho * np.array([np.cos(a), np.sin(a)])
            yaw = np.pi / 2 + a
        elif k == 4:  # north straight, heading -x
            p = np.array([x1 - rho - s, y1])
            yaw = np.pi
        elif k == 5:  # NW corner
            a = s / rho
            c = np.array([x0 + rho, y1 - rho])
            p = c + rho * np.array([-np.sin(a), np.cos(a)])
            yaw = np.pi + a
        elif k == 6:  # west straight, heading -y
            p = np.array([x0, y1 - rho - s])
            yaw = 3 * np.pi / 2
        else:  # SW corner
            a = s / rho
            c = np.array([x0 + rho, y0 + rho])
            p = c + rho * np.array([-np.cos(a), -np.sin(a)])
            yaw = 3 * np.pi / 2 + a
        cy, sy = np.cos(yaw), np.sin(yaw)
        R = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
        t = np.array([p[0], p[1], 0.0])
        return R, t

    def _frame_scene(self, i: int) -> Scene:
        """Scene at frame i: static geometry + moving-car boxes circulating
        the ring (car k runs at car_speed x sensor speed, staggered around
        the lap, offset 2.5 m toward the block center — the oncoming lane)."""
        if not self.moving_cars:
            return self.scene
        import dataclasses as _dc

        cars = []
        for k in range(self.moving_cars):
            phase = (k + 1) * self.lap_length / (self.moving_cars + 1)
            s_car = (self.car_speed * self.speed * i + phase) / self.speed
            _, tc = self.pose(s_car)
            # Pull toward the block center for an oncoming-lane offset.
            cx = np.clip((self.X0 + self.X1) / 2 - tc[0], -1, 1) * 2.5
            cy = np.clip((self.Y0 + self.Y1) / 2 - tc[1], -1, 1) * 2.5
            x, y = tc[0] + cx, tc[1] + cy
            cars.append((x - 1.2, x + 1.2, y - 1.2, y + 1.2,
                         self.scene.ground_z, self.scene.ground_z + 1.6))
        return _dc.replace(self.scene, boxes=self.scene.boxes + tuple(cars))

    def __iter__(self):
        rng = np.random.default_rng(self.seed + 987654321)
        for i in range(self.n_frames):
            R, t = self.pose(i)
            scan = simulate_scan(
                pose_t=t,
                pose_R=R,
                scene=self._frame_scene(i),
                seed=self.seed + i,
                n_beams=self.n_beams,
                n_azimuth=self.n_azimuth,
                range_noise=self.range_noise,
            )
            if self.range_bias_std > 0.0:
                r = np.linalg.norm(scan, axis=1, keepdims=True)
                bias = rng.normal(0.0, self.range_bias_std)
                scale = (r + bias) / np.maximum(r, 1e-6)
                scan = np.where(r > 1e-6, scan * scale, scan)
                scan = scan.astype(np.float32)
            if self.dropout_frac > 0.0:
                # Zero a contiguous azimuth sector (scan layout is
                # beam-major: index = beam * n_azimuth + azimuth).
                width = int(self.dropout_frac * self.n_azimuth)
                a0 = rng.integers(0, self.n_azimuth)
                cols = (np.arange(width) + a0) % self.n_azimuth
                view = scan.reshape(self.n_beams, self.n_azimuth, 3)
                view[:, cols] = 0.0
                scan = view.reshape(-1, 3)
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = t
            yield scan, T
