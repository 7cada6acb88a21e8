"""The benchmark's one traffic generator: a closed lap of a city circuit,
raycast on the device.

A frozen copy of the port's ``datasets.synthetic.city_scene`` and
``datasets.replay.CityDriveSource`` (the scene, the rounded-rectangle
circuit, the spinning-lidar beam pattern), with the raycast rewritten in
PyTorch so that a whole lap is made on the card in a few calls.  The rays
are traced in float64 and the points rounded once to float32, as the NumPy
original does.  The scene's geometry is fixed by the traffic file; the run's
seed draws the range noise and the frame the lap starts at, so every seed
drives the same streets in another order and with other noise.

The lap is cut into a whole number of frames, so frame ``i`` and frame
``i + frames_per_lap`` are the same scan: a stream may go round as often as
its window needs without a jump in the trajectory.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Box(NamedTuple):
    xmin: float
    xmax: float
    ymin: float
    ymax: float
    zmin: float
    zmax: float


def city_boxes(scene_seed: int) -> list[Box]:
    """The buildings and street-side obstacles of the city block (metres;
    the sensor rides 2 m above the ground plane ``z = -2``)."""
    rng = np.random.default_rng(scene_seed)
    boxes = []

    def strip(x0, x1, y0, y1, n, axis):
        for k in range(n):
            if axis == 0:
                xa = x0 + (x1 - x0) * k / n + rng.uniform(0.5, 1.5)
                xb = x0 + (x1 - x0) * (k + 1) / n - rng.uniform(0.5, 1.5)
                ya, yb = y0 + rng.uniform(0, 1.0), y1 - rng.uniform(0, 1.0)
            else:
                ya = y0 + (y1 - y0) * k / n + rng.uniform(0.5, 1.5)
                yb = y0 + (y1 - y0) * (k + 1) / n - rng.uniform(0.5, 1.5)
                xa, xb = x0 + rng.uniform(0, 1.0), x1 - rng.uniform(0, 1.0)
            boxes.append(Box(xa, xb, ya, yb, -2.0, rng.uniform(4.0, 14.0)))

    strip(20.0, 80.0, 20.0, 26.0, 6, axis=0)
    strip(20.0, 80.0, 54.0, 60.0, 6, axis=0)
    strip(20.0, 26.0, 28.0, 52.0, 3, axis=1)
    strip(74.0, 80.0, 28.0, 52.0, 3, axis=1)
    strip(0.0, 100.0, -4.0, 2.0, 8, axis=0)
    strip(0.0, 100.0, 78.0, 84.0, 8, axis=0)
    strip(-4.0, 2.0, 0.0, 80.0, 6, axis=1)
    strip(98.0, 104.0, 0.0, 80.0, 6, axis=1)
    for _ in range(6):
        cx = rng.uniform(25, 70)
        cy = rng.choice([rng.uniform(13, 16), rng.uniform(64, 67)])
        boxes.append(Box(cx, cx + rng.uniform(2, 5), cy, cy + 2.2, -2.0, 0.8))
    return boxes


class Circuit:
    """The rounded rectangle ``rect`` (street centerlines) driven
    counterclockwise, corners of radius ``rho``, heading tangent."""

    def __init__(self, rect=(10.0, 90.0, 10.0, 70.0), rho: float = 6.0):
        self.x0, self.x1, self.y0, self.y1 = rect
        self.rho = rho
        w = self.x1 - self.x0 - 2 * rho
        h = self.y1 - self.y0 - 2 * rho
        arc = math.pi / 2 * rho
        self.segs = [w, arc, h, arc, w, arc, h, arc]
        self.length = sum(self.segs)

    def pose(self, s: float):
        """``(R (3, 3), t (3,))`` sensor-to-world at arc length ``s``."""
        s = s % self.length
        x0, x1, y0, y1, rho = self.x0, self.x1, self.y0, self.y1, self.rho
        for k, L in enumerate(self.segs):
            if s <= L or k == len(self.segs) - 1:
                break
            s -= L
        a = s / rho
        if k == 0:
            p, yaw = np.array([x0 + rho + s, y0]), 0.0
        elif k == 1:
            p, yaw = np.array([x1 - rho, y0 + rho]) + rho * np.array([np.sin(a), -np.cos(a)]), a
        elif k == 2:
            p, yaw = np.array([x1, y0 + rho + s]), np.pi / 2
        elif k == 3:
            p = np.array([x1 - rho, y1 - rho]) + rho * np.array([np.cos(a), np.sin(a)])
            yaw = np.pi / 2 + a
        elif k == 4:
            p, yaw = np.array([x1 - rho - s, y1]), np.pi
        elif k == 5:
            p = np.array([x0 + rho, y1 - rho]) + rho * np.array([-np.sin(a), np.cos(a)])
            yaw = np.pi + a
        elif k == 6:
            p, yaw = np.array([x0, y1 - rho - s]), 3 * np.pi / 2
        else:
            p = np.array([x0 + rho, y0 + rho]) + rho * np.array([-np.cos(a), -np.sin(a)])
            yaw = 3 * np.pi / 2 + a
        cy, sy = np.cos(yaw), np.sin(yaw)
        R = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
        return R, np.array([p[0], p[1], 0.0])


def beam_directions(n_beams: int, n_azimuth: int, elev_min: float, elev_max: float,
                    device) -> torch.Tensor:
    """``(n_beams * n_azimuth, 3)`` float64 unit rays in the sensor frame,
    beam-major (``index = beam * n_azimuth + azimuth``)."""
    az = torch.from_numpy(np.linspace(0.0, 2 * np.pi, n_azimuth, endpoint=False))
    el = torch.from_numpy(np.linspace(elev_min, elev_max, n_beams))
    el_g, az_g = torch.meshgrid(el, az, indexing="ij")
    el_g, az_g = el_g.reshape(-1), az_g.reshape(-1)
    d = torch.stack([torch.cos(el_g) * torch.cos(az_g), torch.cos(el_g) * torch.sin(az_g),
                     torch.sin(el_g)], dim=1)
    return d.to(device)


def raycast(R: torch.Tensor, t: torch.Tensor, d_sensor: torch.Tensor, boxes: list[Box],
            ground_z: float, max_range: float) -> torch.Tensor:
    """Ranges ``(F, N)`` float64 of the rays ``d_sensor`` from the poses
    ``(R (F, 3, 3), t (F, 3))``: the nearest hit of the ground plane and
    the boxes (slab method), 0 where nothing lies within ``max_range``."""
    d = torch.einsum("nj,fij->fni", d_sensor, R)  # d_sensor @ R^T, per frame
    o = t[:, None, :]
    inf = torch.tensor(math.inf, dtype=d.dtype, device=d.device)
    dz = d[..., 2]
    tg = (ground_z - o[..., 2]) / dz
    best = torch.where((dz.abs() > 1e-9) & (tg > 1e-3), tg, inf)
    nan_lo, nan_hi = -inf, inf
    for b in boxes:
        lo = torch.tensor([b.xmin, b.ymin, b.zmin], dtype=d.dtype, device=d.device)
        hi = torch.tensor([b.xmax, b.ymax, b.zmax], dtype=d.dtype, device=d.device)
        t1 = (lo - o) / d
        t2 = (hi - o) / d
        near = torch.minimum(t1, t2)
        far = torch.maximum(t1, t2)
        # NaN (0/0 on a slab plane) is ignored, as numpy's nanmax/nanmin do.
        tnear = torch.where(torch.isnan(near), nan_lo, near).amax(dim=-1)
        tfar = torch.where(torch.isnan(far), nan_hi, far).amin(dim=-1)
        hit = (tnear <= tfar) & (tfar > 1e-3)
        tb = torch.where(tnear > 1e-3, tnear, tfar)
        best = torch.minimum(best, torch.where(hit, tb, inf))
    hit = torch.isfinite(best) & (best < max_range)
    return torch.where(hit, best, torch.zeros_like(best))


class Lap(NamedTuple):
    #: (F, N, 3) float32 scans in the sensor frame, on the host
    scans: np.ndarray
    #: (F, 4, 4) float64 sensor-to-world poses
    poses: np.ndarray
    #: the frame the stream starts at
    start: int


def make_lap(traffic: dict, sensor: dict, seed: int, device, chunk: int = 64) -> Lap:
    """The lap of ``traffic`` seen by ``sensor``, with the noise and the
    starting frame drawn from ``seed``."""
    circuit = Circuit(tuple(traffic["rect"]), traffic["corner_radius"])
    frames = int(traffic["frames_per_lap"])
    step = circuit.length / frames
    poses = np.zeros((frames, 4, 4))
    for i in range(frames):
        R, t = circuit.pose(step * i)
        poses[i, :3, :3], poses[i, :3, 3], poses[i, 3, 3] = R, t, 1.0
    boxes = city_boxes(int(traffic["scene_seed"]))
    d_sensor = beam_directions(sensor["n_beams"], sensor["n_azimuth"], sensor["elev_min"],
                               sensor["elev_max"], device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n = d_sensor.shape[0]
    scans = np.empty((frames, n, 3), np.float32)
    P = torch.from_numpy(poses).to(device)
    for f0 in range(0, frames, chunk):
        f1 = min(frames, f0 + chunk)
        rng = raycast(P[f0:f1, :3, :3], P[f0:f1, :3, 3], d_sensor, boxes,
                      traffic["ground_z"], traffic["max_range"])
        noise = torch.randn(rng.shape, generator=gen, dtype=torch.float64, device=device)
        rng = rng + (rng > 0) * traffic["range_noise"] * noise
        scans[f0:f1] = (d_sensor[None] * rng[..., None]).float().cpu().numpy()
    start = int(torch.randint(frames, (1,), generator=gen, device=device).item())
    return Lap(scans, poses, start)
