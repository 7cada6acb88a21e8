"""The port's device probes, elastic runner and recovery paths
(``icet_tpu_torch/parallel/elastic.py``, ``OdometryPipeline``,
``KeyframeOdometry`` and ``MapMaker``), as tests/test_elastic.py holds the
JAX package's.

The elastic runner works on a mesh of repeated CPU devices; a lost device
is simulated by a step that raises and a probe that reports fewer devices.
Each runner's recovery is tested by making one step raise a
``RuntimeError`` (not a TypeError or ValueError, which are raised at once):
the odometry pipelines and the MapMaker (with ``snapshot_every=1``) then
give trajectories and maps bit-identical to an unfailed run on the CPU;
the keyframe pipeline re-seeds a keyframe at the newest completed pose, as
the JAX package's does.  Grids of 25 azimuth bins against 128- and
256-column sweeps keep points off the bin edges.
"""

import threading
import time

import numpy as np
import pytest
import torch

import icet_tpu_torch.keyframe as kf_mod
import icet_tpu_torch.mapping as map_mod
import icet_tpu_torch.odometry as odo_mod
import icet_tpu_torch.parallel.elastic as elastic_mod
from icet_tpu_torch.config import ICETConfig, KeyframeConfig, MapConfig
from icet_tpu_torch.datasets.synthetic import scan_pair_with_ground_truth, simulate_scan
from icet_tpu_torch.parallel.elastic import (
    ElasticRegistrationRunner,
    best_mesh_shape,
    probe_devices,
)
from icet_tpu_torch.solver import register_pair

torch.set_num_threads(2)

CFG = ICETConfig(n_theta=25, n_phi=8, phi_min=np.pi / 3, phi_max=2 * np.pi / 3,
                 n_iters=3, min_pts=10, min_range=1.0)
CPUS = ["cpu"] * 8


@pytest.fixture(scope="module")
def batch():
    X = np.array([0.2, 0.1, 0.0, 0.0, 0.0, 0.01], np.float32)
    s1, s2 = scan_pair_with_ground_truth(X, seed=0, n_beams=16, n_azimuth=128)
    return np.stack([s1, s1]), np.stack([s2, s2]), np.zeros((2, 6), np.float32), X


def test_best_mesh_shape():
    assert best_mesh_shape(8, 2) == (2, 4)
    assert best_mesh_shape(8, 1) == (1, 8)
    assert best_mesh_shape(7, 2) == (1, 7)
    assert best_mesh_shape(6, 4) == (3, 2)
    assert best_mesh_shape(1, 4) == (1, 1)


def test_probe_devices_all_healthy():
    assert probe_devices(CPUS) == CPUS


def test_probe_devices_hang_is_time_bounded():
    """A probe that never returns makes its device unhealthy by the
    deadline; every device is probed at once."""
    never = threading.Event()

    def hanging_op(d):
        never.wait()
        return True

    t0 = time.monotonic()
    healthy = probe_devices(CPUS, timeout_s=0.5, _op=hanging_op)
    elapsed = time.monotonic() - t0
    never.set()  # release the abandoned probe threads
    assert healthy == []
    assert elapsed < 0.5 + 1.0


def test_probe_devices_mixed_hang_raise_and_healthy():
    devs = [torch.device("cuda", i) for i in range(8)]  # only named: the probe is injected
    hang = threading.Event()

    def op(d):
        if d.index % 4 == 0:
            hang.wait()
        if d.index % 4 == 1:
            raise RuntimeError("unreachable device")
        return d.index % 4 == 2

    t0 = time.monotonic()
    healthy = probe_devices(devs, timeout_s=0.5, _op=op)
    elapsed = time.monotonic() - t0
    hang.set()
    assert healthy == [devs[2], devs[6]]
    assert elapsed < 0.5 + 1.0


def test_elastic_run_and_pad(batch):
    s1, s2, x0, X_true = batch
    runner = ElasticRegistrationRunner(CFG, prefer_dp=2, devices=CPUS)
    assert runner.shape == (2, 4)
    res = runner.run(s1, s2, x0)
    assert res.X.shape == (2, 6) and isinstance(res.X, np.ndarray)
    np.testing.assert_allclose(res.X[0][:2], X_true[:2], atol=0.05)
    single = register_pair(s1[0], s2[0], np.zeros(6), CFG, device="cpu")
    np.testing.assert_allclose(res.X[0], single.X.numpy(), atol=5e-4)
    # A batch of 3 does not divide dp = 2: padded inside, 3 rows back.
    res3 = runner.run(np.concatenate([s1, s1[:1]]), np.concatenate([s2, s2[:1]]),
                      np.concatenate([x0, x0[:1]]))
    assert res3.X.shape == (3, 6) and res3.static_mask.shape == (3, s1.shape[1])
    np.testing.assert_allclose(res3.X[2], res3.X[0], atol=1e-5)


def test_elastic_recovers_from_device_loss(batch, monkeypatch):
    s1, s2, x0, _ = batch
    runner = ElasticRegistrationRunner(CFG, prefer_dp=2, devices=CPUS)
    baseline = runner.run(s1, s2, x0)
    armed = {"on": True}
    real_step = runner._step

    def exploding_step(*args):
        if armed["on"]:
            armed["on"] = False
            raise RuntimeError("DEVICE_LOST: simulated")
        return real_step(*args)

    runner._step = exploding_step
    monkeypatch.setattr(elastic_mod, "probe_devices", lambda devs=None: CPUS[:5])
    res = runner.run(s1, s2, x0)
    assert runner.rebuilds == 1
    assert runner.shape == (1, 5)  # 2,048 points padded to 2,050 over sp = 5
    np.testing.assert_allclose(res.X, baseline.X, atol=1e-3)


def test_elastic_raises_on_non_device_error(batch):
    s1, s2, x0, _ = batch
    runner = ElasticRegistrationRunner(CFG, prefer_dp=2, devices=CPUS)

    def bad_step(*args):
        raise ValueError("a real bug, not a device failure")

    runner._step = bad_step
    with pytest.raises(ValueError):
        runner.run(s1, s2, x0)
    assert runner.rebuilds == 0


def _drive_scans(n=6):
    return [np.asarray(simulate_scan(pose_t=np.array([0.25 * k, 0.05 * k, 0.0], np.float32),
                                     n_beams=32, n_azimuth=256, seed=7), np.float32)
            for k in range(n)]


def _fail_on(monkeypatch, module, name, call):
    real = getattr(module, name)
    calls = {"n": 0}

    def flaky(*args, **kw):
        calls["n"] += 1
        if calls["n"] == call:
            raise RuntimeError("simulated device failure")
        return real(*args, **kw)

    monkeypatch.setattr(module, name, flaky)


@pytest.mark.parametrize("dnn", [False, True], ids=["plain", "dnn"])
def test_odometry_pipeline_recovers_bit_identically(monkeypatch, dnn):
    """The pipeline refits the model (and, with the filter, the previous
    scan's samples) from the retained scan and the host mirrors: the
    recovered trajectory equals an unfailed one bit for bit."""
    cfg = CFG.replace(dnn_filter=True, dnn_start_iter=2) if dnn else CFG
    scans = _drive_scans()
    clean = list(odo_mod.OdometryPipeline(cfg, device="cpu").run(scans))
    # Both pipelines step through the compiled steps (the config's route is
    # captured, with or without the filter).
    _fail_on(monkeypatch, odo_mod, "odometry_step_dnn_jit" if dnn else "odometry_step_jit", 3)
    pipe = odo_mod.OdometryPipeline(cfg, device="cpu")
    frames = [f for f in (pipe.step(s) for s in scans) if f is not None]
    assert pipe.recoveries == 1
    assert len(frames) == len(clean) == len(scans) - 1
    if dnn:
        assert pipe._scan_prev is not None
    for a, b in zip(frames, clean):
        np.testing.assert_array_equal(a.X, b.X)
        np.testing.assert_array_equal(a.T_world, b.T_world)
        assert a.diverged == b.diverged and a.iterations == b.iterations


def test_pipeline_raises_deterministic_errors_at_once(monkeypatch):
    scans = _drive_scans(3)

    def bad(*args, **kw):
        raise ValueError("bad shape")

    monkeypatch.setattr(odo_mod, "odometry_step_jit", bad)
    pipe = odo_mod.OdometryPipeline(CFG, device="cpu")
    pipe.step(scans[0])
    with pytest.raises(ValueError):
        pipe.step(scans[1])
    assert pipe.recoveries == 0


def test_keyframe_recovers_from_device_failure(monkeypatch):
    """A failed keyframe step may leave the block map half-written: the
    pipeline restores its newest snapshot and re-seeds a keyframe at the
    newest completed pose (that frame returns None), and the trajectory
    goes on from there, not from the origin."""
    scans = [np.asarray(simulate_scan(pose_t=np.array([0.3 * k, 0, 0]), seed=7, n_beams=32,
                                      n_azimuth=256), np.float32) for k in range(8)]
    kf_cfg = KeyframeConfig(spawn_distance=1.0, delta_clamp=2.0)
    clean = kf_mod.KeyframeOdometry(CFG, kf_cfg, snapshot_every=2, device="cpu").run(scans)
    _fail_on(monkeypatch, kf_mod, "keyframe_step_jit", 4)
    pipe = kf_mod.KeyframeOdometry(CFG, kf_cfg, snapshot_every=2, device="cpu")
    frames = [f for f in (pipe.step(s) for s in scans) if f is not None]
    assert pipe.recoveries == 1
    assert len(frames) == len(scans) - 2
    # Frames before the failure are the unfailed run's.
    for a, b in zip(frames[:3], clean[:3]):
        np.testing.assert_array_equal(a.T_world, b.T_world)
    assert pipe.keyframe_indices[-1] == 4
    np.testing.assert_allclose(pipe.keyframe_states[-1][:3], frames[2].T_world[:3, 3],
                               atol=1e-6)
    assert all(np.isfinite(f.T_world).all() for f in frames)
    xs = [f.T_world[0, 3] for f in frames]
    assert xs[-1] > xs[0] + 1.0, xs
    assert torch.isfinite(pipe.blockmap.points).all()


def test_mapmaker_recovers_bit_identically(monkeypatch):
    scans = _drive_scans()
    mcfg = MapConfig(capacity=20_000, points_per_scan=500)
    clean = map_mod.MapMaker(CFG, mcfg, snapshot_every=1, device="cpu")
    for s in scans:
        clean.step(s)
    _fail_on(monkeypatch, map_mod, "map_step", 3)
    maker = map_mod.MapMaker(CFG, mcfg, snapshot_every=1, device="cpu")
    for s in scans:
        maker.step(s)
    assert maker.recoveries == 1
    np.testing.assert_array_equal(maker.map_points(), clean.map_points())
    np.testing.assert_array_equal(maker.snail_trail(), clean.snail_trail())
