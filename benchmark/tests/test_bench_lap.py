"""The traffic generator: the PyTorch raycast against the NumPy original,
the lap's continuity where it wraps, and the seed's role."""

from __future__ import annotations

import json

import numpy as np
import torch

from benchmark import lap as lapgen
from conftest import ROOT, TINY_SENSOR

TRAFFIC = json.loads((ROOT / "benchmark" / "traffic" / "stream.json").read_text())
SENSOR = dict(json.loads((ROOT / "benchmark" / "configs" / "os1-64.odo.json").read_text())
              ["sensor"], **TINY_SENSOR)


def test_scene_is_the_originals():
    from icet_tpu_torch.datasets.synthetic import city_scene

    assert [tuple(b) for b in lapgen.city_boxes(0)] == [tuple(b) for b in city_scene(0).boxes]


def test_raycast_matches_numpy_original():
    """Frames of the lap, without noise, against ``simulate_scan`` with the
    sensor's beam pattern at ``CityDriveSource``'s poses (the original
    traces in float64 too)."""
    from icet_tpu_torch.datasets.replay import CityDriveSource
    from icet_tpu_torch.datasets.synthetic import simulate_scan

    traffic = dict(TRAFFIC, range_noise=0.0)
    lap = lapgen.make_lap(traffic, SENSOR, seed=7, device=torch.device("cpu"))
    step = lapgen.Circuit().length / traffic["frames_per_lap"]
    src = CityDriveSource(n_frames=4, speed=step, seed=traffic["scene_seed"])
    for i in range(4):
        R, t = src.pose(i)
        np.testing.assert_allclose(lap.poses[i, :3, :3], R, atol=1e-12)
        np.testing.assert_allclose(lap.poses[i, :3, 3], t, atol=1e-12)
        scan = simulate_scan(pose_t=t, pose_R=R, scene=src.scene, n_beams=SENSOR["n_beams"],
                             n_azimuth=SENSOR["n_azimuth"],
                             elev_range=(SENSOR["elev_min"], SENSOR["elev_max"]),
                             range_noise=0.0)
        np.testing.assert_allclose(lap.scans[i], scan, atol=1e-4, rtol=0)
        assert np.count_nonzero(np.any(scan != 0, axis=1)) > 0.9 * scan.shape[0]


def test_lap_is_continuous_where_it_wraps():
    c = lapgen.Circuit(tuple(TRAFFIC["rect"]), TRAFFIC["corner_radius"])
    n = TRAFFIC["frames_per_lap"]
    step = c.length / n
    R0, t0 = c.pose(0.0)
    R1, t1 = c.pose(c.length)
    np.testing.assert_allclose(R0, R1, atol=1e-12)
    np.testing.assert_allclose(t0, t1, atol=1e-9)
    ts = np.array([c.pose(step * i)[1] for i in range(n + 1)])
    hops = np.linalg.norm(np.diff(ts, axis=0), axis=1)
    # Chords of arcs are a little shorter than the arc; the hop across the
    # wrap (frame n - 1 to frame n = frame 0) is one like the others.
    assert np.all(hops <= step + 1e-9) and np.all(hops > 0.99 * step)


def test_seed_draws_noise_and_start_only():
    dev = torch.device("cpu")
    traffic = dict(TRAFFIC, frames_per_lap=8)
    make = lapgen.make_lap.__wrapped__  # not the tests' cache
    a = make(traffic, SENSOR, seed=2**31 + 5, device=dev)
    b = make(traffic, SENSOR, seed=2**31 + 5, device=dev)
    c = make(traffic, SENSOR, seed=2**31 + 6, device=dev)
    assert np.array_equal(a.scans, b.scans) and a.start == b.start
    np.testing.assert_array_equal(a.poses, c.poses)
    assert not np.array_equal(a.scans, c.scans)
    ra = np.linalg.norm(a.scans, axis=-1)
    rc = np.linalg.norm(c.scans, axis=-1)
    hit = (ra > 0) & (rc > 0)
    noise = (ra - rc)[hit]
    assert 0.02 < np.std(noise) < 0.04  # two draws of 2 cm noise: sqrt(2) x 2 cm
