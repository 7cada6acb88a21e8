"""Synthetic lidar scene simulator (host-side numpy); a copy of
``icet_tpu/datasets/synthetic.py`` that needs no JAX.

Replaces the reference's reliance on bundled real scans for verification and
fills the gap SURVEY.md section 4 identifies: the reference has NO automated
ground truth (its dormant `true_transform` field in msg/Num.msg:5 and the
commented publisher in src/fake_lidar.py:177-178 were never wired up).

We raycast a configurable urban-corner scene (ground plane, walls, box
pillars) from an arbitrary sensor pose with a spinning-lidar beam pattern, so
tests and Monte-Carlo studies get scans with EXACT known 6-DOF ground truth.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Scene:
    """Axis-aligned scene: horizontal ground plane, vertical wall planes, and
    axis-aligned box pillars."""

    ground_z: float = -2.0
    #: vertical planes as (axis, offset, normal_sign): plane {p[axis] == offset}
    #: visible from the side ``normal_sign``
    walls: tuple = (
        (0, 30.0, -1), (0, -30.0, 1), (1, 25.0, -1), (1, -25.0, 1),
    )
    #: axis-aligned boxes as (xmin, xmax, ymin, ymax, zmin, zmax)
    boxes: tuple = (
        (8.0, 10.0, 4.0, 6.0, -2.0, 4.0),
        (-12.0, -10.0, 8.0, 11.0, -2.0, 3.0),
        (5.0, 7.0, -14.0, -12.0, -2.0, 5.0),
        (-18.0, -15.0, -10.0, -8.0, -2.0, 2.0),
        (15.0, 18.0, 12.0, 14.0, -2.0, 6.0),
    )
    max_range: float = 120.0


def _ray_plane_axis(origin, d, axis, offset):
    """Distance along rays to plane {p[axis] == offset}; inf if behind."""
    denom = d[:, axis]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (offset - origin[axis]) / denom
    t = np.where((np.abs(denom) > 1e-9) & (t > 1e-3), t, np.inf)
    return t


def _ray_box(origin, d, box):
    """Slab-method ray/AABB intersection distances; inf on miss."""
    lo = np.array(box[0::2], dtype=np.float64)
    hi = np.array(box[1::2], dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (lo[None, :] - origin[None, :]) / d
        t2 = (hi[None, :] - origin[None, :]) / d
    tnear = np.nanmax(np.minimum(t1, t2), axis=1)
    tfar = np.nanmin(np.maximum(t1, t2), axis=1)
    hit = (tnear <= tfar) & (tfar > 1e-3)
    t = np.where(tnear > 1e-3, tnear, tfar)
    return np.where(hit, t, np.inf)


def simulate_scan(
    pose_t: np.ndarray = None,
    pose_R: np.ndarray = None,
    scene: Scene = None,
    n_beams: int = 64,
    n_azimuth: int = 1024,
    elev_range=(-0.42, 0.15),
    range_noise: float = 0.02,
    seed: int = 0,
) -> np.ndarray:
    """Simulate one spinning-lidar scan from a sensor pose.

    Args:
      pose_t: (3,) sensor position in world frame (default origin).
      pose_R: (3, 3) sensor-to-world rotation (default identity).  The
        returned points are expressed in the SENSOR frame, so two scans from
        different poses are related by the exact relative pose.
      scene: geometry to raycast.
      n_beams / n_azimuth: beam pattern (64 x 1024 ~ a 64-channel lidar).
      elev_range: beam elevation angles (radians, 0 = horizontal).
      range_noise: 1-sigma additive range noise in metres.

    Returns:
      (n_beams * n_azimuth, 3) float32 points in the sensor frame; rays that
      hit nothing return the zero point (masked out by range gates downstream).
    """
    if pose_t is None:
        pose_t = np.zeros(3)
    if pose_R is None:
        pose_R = np.eye(3)
    if scene is None:
        scene = Scene()
    rng = np.random.default_rng(seed)

    az = np.linspace(0.0, 2 * np.pi, n_azimuth, endpoint=False)
    el = np.linspace(elev_range[0], elev_range[1], n_beams)
    az_g, el_g = np.meshgrid(az, el)
    az_g = az_g.ravel()
    el_g = el_g.ravel()
    # Ray directions in sensor frame, rotated into the world frame.
    d_sensor = np.stack(
        [np.cos(el_g) * np.cos(az_g), np.cos(el_g) * np.sin(az_g), np.sin(el_g)],
        axis=1,
    )
    d_world = d_sensor @ pose_R.T

    t_best = _ray_plane_axis(pose_t, d_world, 2, scene.ground_z)
    for axis, offset, sign in scene.walls:
        t = _ray_plane_axis(pose_t, d_world, axis, offset)
        facing = np.sign(d_world[:, axis]) == np.sign(offset - pose_t[axis])
        t = np.where(facing, t, np.inf)
        t_best = np.minimum(t_best, t)
    for box in scene.boxes:
        t_best = np.minimum(t_best, _ray_box(pose_t, d_world, box))

    hit = np.isfinite(t_best) & (t_best < scene.max_range)
    t_best = np.where(hit, t_best, 0.0)
    if range_noise > 0:
        t_best = t_best + hit * rng.normal(0.0, range_noise, t_best.shape)
    pts = d_sensor * t_best[:, None]
    return pts.astype(np.float32)


def euler_R(angs: np.ndarray) -> np.ndarray:
    """Body-xyz Euler rotation ``(3,) -> (3, 3)`` in the dtype of ``angs``
    (the formula of ``icet_tpu_torch.ops.geometry.euler_R``)."""
    phi, theta, psi = angs[0], angs[1], angs[2]
    cf, sf = np.cos(phi), np.sin(phi)
    ct, st = np.cos(theta), np.sin(theta)
    cp, sp = np.cos(psi), np.sin(psi)
    return np.array([
        [ct * cp, sp * cf + sf * st * cp, sf * sp - st * cf * cp],
        [-sp * ct, cf * cp - sf * st * sp, sf * cp + st * sp * cf],
        [st, -sf * ct, cf * ct],
    ], dtype=np.asarray(angs).dtype)


def scan_pair_with_ground_truth(
    X_true: np.ndarray,
    scene: Scene = None,
    seed: int = 0,
    **kw,
):
    """Two scans whose relative pose equals the canonical transform ``X_true``.

    The solver's convention is ``p1 ~ R(-angs) p2 + t`` for points of the same
    surface observed in the two sensor frames (geometry.transform_points).
    Sensor 1 sits at the world origin with identity attitude, so a world
    point p_w is seen as ``p1 = p_w``.  Placing sensor 2 at world pose
    ``(R2, t2)`` (sensor-to-world: ``p_w = R2 p2 + t2``) and requiring
    ``p1 = R(-angs) p2 + t`` for every p_w gives exactly
    ``R2 = R(-angs)`` and ``t2 = t``.

    Returns (scan1, scan2) float32 arrays with exact ground truth ``X_true``.
    """
    X_true = np.asarray(X_true, dtype=np.float64)
    R_c = euler_R(-X_true[3:6].astype(np.float32))
    scan1 = simulate_scan(
        pose_t=np.zeros(3), pose_R=np.eye(3), scene=scene, seed=seed, **kw
    )
    scan2 = simulate_scan(
        pose_t=X_true[:3], pose_R=R_c, scene=scene, seed=seed + 1, **kw
    )
    return scan1, scan2


def city_scene(seed: int = 0) -> Scene:
    """A city-block scene for long drives: a ring road around a central
    block, buildings on both sides of the street, open ground elsewhere.

    Geometry (metres, sensor height 0 = 2 m above ground): the drive circuit
    of :class:`~icet_tpu_torch.datasets.replay.CityDriveSource` runs the rectangle
    x in [10, 90], y in [10, 70]; buildings line the inner block
    ([20, 80] x [20, 60]) and the outer frontage, so every frame sees
    structure on both sides — the KITTI-like urban-canyon regime the
    reference's papers evaluate on (README.md:67-110).
    """
    rng = np.random.default_rng(seed)
    boxes = []

    def strip(x0, x1, y0, y1, n, axis):
        """n buildings along one frontage with varied setbacks/heights."""
        for k in range(n):
            if axis == 0:
                xa = x0 + (x1 - x0) * k / n + rng.uniform(0.5, 1.5)
                xb = x0 + (x1 - x0) * (k + 1) / n - rng.uniform(0.5, 1.5)
                ya, yb = y0 + rng.uniform(0, 1.0), y1 - rng.uniform(0, 1.0)
            else:
                ya = y0 + (y1 - y0) * k / n + rng.uniform(0.5, 1.5)
                yb = y0 + (y1 - y0) * (k + 1) / n - rng.uniform(0.5, 1.5)
                xa, xb = x0 + rng.uniform(0, 1.0), x1 - rng.uniform(0, 1.0)
            h = rng.uniform(4.0, 14.0)
            boxes.append((xa, xb, ya, yb, -2.0, h))

    # Inner block frontages (facing the circuit from inside).
    strip(20.0, 80.0, 20.0, 26.0, 6, axis=0)   # south face of inner block
    strip(20.0, 80.0, 54.0, 60.0, 6, axis=0)   # north face
    strip(20.0, 26.0, 28.0, 52.0, 3, axis=1)   # west face
    strip(74.0, 80.0, 28.0, 52.0, 3, axis=1)   # east face
    # Outer frontages (facing the circuit from outside).
    strip(0.0, 100.0, -4.0, 2.0, 8, axis=0)    # south outer row
    strip(0.0, 100.0, 78.0, 84.0, 8, axis=0)   # north outer row
    strip(-4.0, 2.0, 0.0, 80.0, 6, axis=1)     # west outer row
    strip(98.0, 104.0, 0.0, 80.0, 6, axis=1)   # east outer row
    # A few street-side obstacles (parked trucks / kiosks) along the
    # straights, kept clear of the drive corridor (the circuit centerline
    # runs y = 10 / y = 70 with corner sweeps into x in [10, 16] U [84, 90],
    # so obstacles stay at x in [25, 70] with >= 1.7 m lateral clearance).
    for _ in range(6):
        cx = rng.uniform(25, 70)
        cy = rng.choice([rng.uniform(13, 16), rng.uniform(64, 67)])
        boxes.append((cx, cx + rng.uniform(2, 5), cy, cy + 2.2, -2.0, 0.8))

    return Scene(ground_z=-2.0, walls=(), boxes=tuple(boxes), max_range=120.0)
