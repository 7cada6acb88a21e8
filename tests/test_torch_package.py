"""Package-level properties of the port: it imports neither JAX nor the
JAX package, its entry points refuse to slip to the CPU, and its copies of
the dataset generators produce the JAX package's arrays."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from icet_tpu.datasets import loaders as jloaders
from icet_tpu.datasets import replay as jreplay
from icet_tpu.datasets import synthetic as jsyn
from icet_tpu_torch.datasets import loaders as tloaders
from icet_tpu_torch.datasets import replay as treplay
from icet_tpu_torch.datasets import synthetic as tsyn

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_jax_out():
    code = (
        "import sys, icet_tpu_torch, icet_tpu_torch.convert, "
        "icet_tpu_torch.datasets.replay, icet_tpu_torch.datasets.loaders, "
        "icet_tpu_torch.filters, icet_tpu_torch.models.bias_net, "
        "icet_tpu_torch.ops.bias_encoder, icet_tpu_torch.ops.moment_scatter, "
        "icet_tpu_torch.ops.fused_moments, icet_tpu_torch.keyframe, "
        "icet_tpu_torch.mapping, icet_tpu_torch.scan_matcher, "
        "icet_tpu_torch.utils.checkpoint, icet_tpu_torch.utils.metrics, "
        "icet_tpu_torch.models.train_data, icet_tpu_torch.pose_graph, "
        "icet_tpu_torch.ops.tridiag, icet_tpu_torch.parallel.sharding, "
        "icet_tpu_torch.parallel.distributed, icet_tpu_torch.parallel.elastic, "
        "icet_tpu_torch.native, icet_tpu_torch.datasets.kitti, icet_tpu_torch.viz_html, "
        "icet_tpu_torch.utils.profiling, icet_tpu_torch.examples.eval_kitti, "
        "icet_tpu_torch.examples.eval_odometry, icet_tpu_torch.examples.eval_citydrive, "
        "icet_tpu_torch.examples.make_kitti_sequence, "
        "icet_tpu_torch.examples.train_bias_net, icet_tpu_torch.examples.demo_registration, "
        "icet_tpu_torch.examples.demo_odometry, icet_tpu_torch.examples.demo_mapping, "
        "icet_tpu_torch.examples.demo_keyframe_map\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'icet_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_import_leaves_matplotlib_out():
    """``import icet_tpu_torch`` and every entry point import no matplotlib
    (the card's machine has none); only ``icet_tpu_torch.viz`` does."""
    code = (
        "import sys, icet_tpu_torch, icet_tpu_torch.viz_html\n"
        "from icet_tpu_torch.examples import demo_keyframe_map, demo_mapping, "
        "demo_odometry, demo_registration, eval_citydrive, eval_kitti, eval_odometry, "
        "make_kitti_sequence, train_bias_net\n"
        "before = 'matplotlib' in sys.modules\n"
        "import icet_tpu_torch.viz\n"
        "print(before, 'matplotlib' in sys.modules)\n"
        "sys.exit(1 if before or 'matplotlib' not in sys.modules else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


#: each new entry point's minimal command line (``--device`` left at cuda)
CLI_ARGS = {
    "eval_kitti": ["--sequence", "no_such_dir"],
    "eval_odometry": ["--synthetic", "2"],
    "eval_citydrive": ["--frames", "2"],
    "train_bias_net": ["--steps", "1"],
    "demo_registration": [],
    "demo_odometry": [],
    "demo_mapping": [],
    "demo_keyframe_map": [],
}


@pytest.mark.parametrize("entry", ["register_pair", "pipeline", "run_odometry_device",
                                   "register_scans", "dnn_pipeline", "keyframe",
                                   "dnn_keyframe", "run_keyframe_device", "mapmaker",
                                   "scan_matcher", "train_bias_net", "train_bias_net_mixed",
                                   "optimize_poses", "optimize_poses_sparse", "close_loops",
                                   "registration_mesh", "probe_devices", "elastic_runner",
                                   "init_distributed", *sorted(CLI_ARGS)])
def test_entry_points_without_device_raise_when_no_cuda(entry, monkeypatch):
    import icet_tpu_torch as it

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scans = np.zeros((2, 64, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "register_pair":
            it.register_pair(scans[0], scans[1], np.zeros(6), it.ICETConfig())
        elif entry == "pipeline":
            it.OdometryPipeline(it.ICETConfig())
        elif entry == "register_scans":
            it.register_scans(scans[0], scans[1], cfg=it.ICETConfig(dnn_filter=True))
        elif entry == "dnn_pipeline":
            it.OdometryPipeline(it.ICETConfig(dnn_filter=True))
        elif entry == "keyframe":
            it.KeyframeOdometry(it.ICETConfig())
        elif entry == "dnn_keyframe":
            it.KeyframeOdometry(it.ICETConfig(dnn_filter=True))
        elif entry == "run_keyframe_device":
            it.run_keyframe_device(scans, it.ICETConfig())
        elif entry == "mapmaker":
            it.MapMaker()
        elif entry == "scan_matcher":
            it.ScanMatcher()
        elif entry == "train_bias_net":
            it.train_bias_net(torch.Generator().manual_seed(0), steps=1, batch=2, sample_pts=4)
        elif entry == "train_bias_net_mixed":
            it.train_bias_net_mixed(steps=1, batch=2, sample_pts=4, n_pairs=1)
        elif entry in ("optimize_poses", "optimize_poses_sparse"):
            graph = it.PoseGraph(torch.zeros(1, dtype=torch.int64),
                                 torch.ones(1, dtype=torch.int64), torch.zeros(1, 6),
                                 torch.eye(6)[None])
            getattr(it, entry)(np.zeros((2, 6), np.float32), graph, 1)
        elif entry == "close_loops":
            it.close_loops(scans, [], it.ICETConfig())
        elif entry == "registration_mesh":
            from icet_tpu_torch.parallel.sharding import registration_mesh

            registration_mesh()
        elif entry == "probe_devices":
            from icet_tpu_torch.parallel.elastic import probe_devices

            probe_devices()
        elif entry == "elastic_runner":
            from icet_tpu_torch.parallel.elastic import ElasticRegistrationRunner

            ElasticRegistrationRunner(it.ICETConfig())
        elif entry == "init_distributed":
            from icet_tpu_torch.parallel.distributed import init_distributed

            init_distributed("localhost:1", 1, 0)
        elif entry in CLI_ARGS:
            import importlib

            mod = importlib.import_module(f"icet_tpu_torch.examples.{entry}")
            mod.run(mod.build_parser().parse_args(CLI_ARGS[entry]))
        else:
            it.run_odometry_device(scans, it.ICETConfig())


@pytest.mark.parametrize("kw", [
    {"seed": 3, "n_beams": 16, "n_azimuth": 128},
    {"seed": 5, "n_beams": 8, "n_azimuth": 64, "range_noise": 0.0,
     "pose_t": np.array([1.0, -2.0, 0.3])},
])
def test_simulate_scan_copy(kw):
    np.testing.assert_array_equal(tsyn.simulate_scan(**kw), jsyn.simulate_scan(**kw))


def test_scan_pair_copy():
    X = np.array([0.4, -0.2, 0.05, 0.02, -0.01, 0.1])
    for a, b in zip(tsyn.scan_pair_with_ground_truth(X, seed=2, n_beams=8, n_azimuth=64),
                    jsyn.scan_pair_with_ground_truth(X, seed=2, n_beams=8, n_azimuth=64)):
        # The copy's rotation is numpy float32, the JAX package's XLA
        # float32: equal to an ulp of the rotation, 1e-5 m at these ranges.
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("source", ["SyntheticTrajectorySource", "CityDriveSource"])
def test_trajectory_sources_copy(source):
    kw = {"n_frames": 2, "n_beams": 8, "n_azimuth": 64}
    if source == "CityDriveSource":
        kw.update(moving_cars=1, dropout_frac=0.1, range_bias_std=0.01)
    got = list(getattr(treplay, source)(**kw))
    want = list(getattr(jreplay, source)(**kw))
    for (gs, gT), (ws, wT) in zip(got, want):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gT, wT)


def test_loader_helpers_copy():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(64 * 40, 3)).astype(np.float32)
    np.testing.assert_array_equal(tloaders.to_beam_major(pts, 64),
                                  jloaders.to_beam_major(pts, 64))
    for n in (100, 5000):
        np.testing.assert_array_equal(tloaders.pad_cloud(pts, n), jloaders.pad_cloud(pts, n))
    scan = jsyn.simulate_scan(n_beams=16, n_azimuth=64)
    az_major = scan.reshape(16, 64, 3).transpose(1, 0, 2).reshape(-1, 3)
    assert tloaders.detect_beam_count(az_major) == jloaders.detect_beam_count(az_major)
