"""The port's entry points (``icet_tpu_torch.examples``) on the CPU.

``eval_kitti.run`` against the JAX package's ``examples/eval_kitti.py::run``
on one 8-frame 48x512 city fixture written as a KITTI sequence (with a
non-identity ``calib.txt``), on grids whose azimuth bin count is coprime
with the sweep's 512 columns (25 and 49; the JAX test's 48 puts columns
on bin edges, where two float32 evaluations bin them differently): equal
frames, divergences and ATE, TUM poses within 1e-4 m (float32 solves
whose sums are taken in another order; measured below 1e-6 m).  The
oracle path through a stub executable against ``_run_oracle``; a chunked
``eval_citydrive`` resume against an uninterrupted run; each remaining CLI
run once.
"""

import json
import os
import stat
import sys

import numpy as np
import pytest
import torch

from icet_tpu_torch.examples import (
    demo_keyframe_map,
    demo_mapping,
    demo_odometry,
    demo_registration,
    eval_citydrive,
    eval_kitti,
    eval_odometry,
    make_kitti_sequence,
    train_bias_net,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_ATOL_M = 1e-4


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """8 frames of the 48x512 city drive, written by the port's
    make_kitti_sequence (camera-frame poses and a calib.txt)."""
    d = str(tmp_path_factory.mktemp("kitti") / "seq")
    args = make_kitti_sequence.build_parser().parse_args(
        ["--out", d, "--frames", "8", "--beams", "48", "--azimuth", "512", "--calib"])
    out = make_kitti_sequence.run(args)
    assert out["frames"] == 8
    return d


def _argv(d, n_theta, out):
    return ["--sequence", d, "--poses", os.path.join(d, "poses.txt"),
            "--max-points", "32768", "--clamp", "2.5", "--n-theta", str(n_theta),
            "--n-phi", "16", "--min-pts", "20", "--min-range", "1.0", "--n-iters", "6",
            "--phi-band", "0.524", "--out", out]


@pytest.mark.parametrize("n_theta", [25, 49])
def test_eval_kitti_matches_jax(sequence, tmp_path, n_theta):
    sys.path.insert(0, ROOT)
    import examples.eval_kitti as jek

    tout, jout = str(tmp_path / "t"), str(tmp_path / "j")
    t = eval_kitti.run(eval_kitti.build_parser().parse_args(
        _argv(sequence, n_theta, tout) + ["--device", "cpu", "--prefetch", "on"]))
    j = jek.run(jek.build_parser().parse_args(_argv(sequence, n_theta, jout)))
    assert t["frames"] == j["frames"] == 7
    assert t["divergences"] == j["divergences"]
    assert abs(t["ate_odometry_cm"] - j["ate_odometry_cm"]) <= 0.01
    for suffix in (".odo.tum", ".gt.tum"):
        a, b = np.loadtxt(tout + suffix), np.loadtxt(jout + suffix)
        np.testing.assert_allclose(a[:, 1:4], b[:, 1:4], rtol=0, atol=POSE_ATOL_M)
    assert set(t["stages"]) == {"read", "step"} and t["stages"]["read"]["n"] == 9
    assert os.path.getsize(tout + ".map.html") > 10_000
    if n_theta == 25:
        assert t["ate_odometry_cm"] < 5.0, t  # a grid this fixture tracks on


def test_eval_kitti_keyframe_refine_strict(sequence, tmp_path):
    """--keyframe with --refine (loop candidates forced by a short gap) and
    --strict-real on the clean fixture."""
    argv = _argv(sequence, 25, str(tmp_path / "k")) + [
        "--device", "cpu", "--keyframe", "--refine", "--min-gap", "3", "--radius", "50",
        "--strict-real"]
    s = eval_kitti.run(eval_kitti.build_parser().parse_args(argv))
    assert s["frames"] == 7 and s["keyframes"][0] == 0
    assert s["loop_factors"] >= 1 and np.isfinite(s["ate_refined_cm"])
    assert set(s["stages"]) == {"read", "step", "refine"}
    assert os.path.getsize(str(tmp_path / "k") + ".opt.tum") > 0


def _stub_oracle(tmp_path) -> str:
    """An oracle executable: prints a fixed X line, fails on the pair whose
    second scan is frame 3, prints a 5-vector (malformed) on frame 5 and a
    step beyond the clamp on frame 6."""
    p = tmp_path / "oracle"
    p.write_text(
        f"#!{sys.executable}\n"
        "import os, sys\n"
        "b = os.path.basename(sys.argv[2])\n"
        "if b == '000003.bin':\n"
        "    sys.exit(3)\n"
        "if b == '000005.bin':\n"
        "    print('X: 0.1 0.2 0.3 0.4 0.5')\n"
        "elif b == '000006.bin':\n"
        "    print('X: 9.0 0 0 0 0 0')\n"
        "else:\n"
        "    print('iterations done')\n"
        "    print('X: 0.95 0.02 -0.01 0.001 -0.002 0.003')\n"
    )
    p.chmod(p.stat().st_mode | stat.S_IXUSR)
    return str(p)


def test_oracle_path_matches_jax(sequence, tmp_path):
    sys.path.insert(0, ROOT)
    import examples.eval_kitti as jek

    from icet_tpu_torch.datasets.kitti import KittiOdometrySource

    argv = _argv(sequence, 25, str(tmp_path / "o")) + ["--oracle", _stub_oracle(tmp_path)]
    src = list(KittiOdometrySource(sequence, poses_file=os.path.join(sequence, "poses.txt"),
                                   max_points=32768))
    scans = [s for s, _ in src]
    ref = [np.linalg.inv(src[0][1]) @ T for _, T in src]
    t = eval_kitti._run_oracle(eval_kitti.build_parser().parse_args(argv), scans, ref)
    j = jek._run_oracle(jek.build_parser().parse_args(argv), scans, ref)
    t.pop("ms_per_frame_wall"), j.pop("ms_per_frame_wall")
    # The rotation RPE is an arccos of a trace near 3: an ulp of difference
    # between XLA's and PyTorch's float32 sin/cos in pose_matrix moves it
    # by up to ~1e-3 deg a frame.  Every other entry is equal.
    assert abs(t.pop("rpe_r_deg") - j.pop("rpe_r_deg")) <= 1e-3
    assert t == j
    assert t["failed_pairs"] == 2


def test_eval_kitti_refuses_a_missing_oracle(sequence, tmp_path):
    argv = _argv(sequence, 25, str(tmp_path / "o")) + [
        "--device", "cpu", "--oracle", str(tmp_path / "none")]
    with pytest.raises(SystemExit, match="not an executable"):
        eval_kitti.run(eval_kitti.build_parser().parse_args(argv))


def _citydrive(argv):
    base = ["--frames", "10", "--beams", "32", "--azimuth", "256", "--device", "cpu",
            "--min-gap", "4", "--radius", "30"]
    return eval_citydrive.run(eval_citydrive.build_parser().parse_args(base + argv))


def test_eval_citydrive_chunked_resume(tmp_path):
    """Two invocations with --state --chunk 5 give the uninterrupted run's
    trajectory: the resume re-seeds on the checkpointed frame, so frame 5
    registers against the same reference model (float32 X within 1e-5)."""
    full = _citydrive(["--out", str(tmp_path / "full")])
    state = str(tmp_path / "ck" / "drive")
    first = _citydrive(["--state", state, "--chunk", "5"])
    assert first == {**first, "chunk_done": True, "next_k": 5, "frames_registered": 4}
    resumed = _citydrive(["--state", state, "--chunk", "5", "--out", str(tmp_path / "res")])
    assert resumed["frames"] == full["frames"] == 9
    assert resumed["divergences"] == full["divergences"] == 0
    a, b = np.loadtxt(str(tmp_path / "full.odo.tum")), np.loadtxt(str(tmp_path / "res.odo.tum"))
    np.testing.assert_allclose(a[:, 1:4], b[:, 1:4], rtol=0, atol=1e-5)
    assert resumed["loop_candidates"] == full["loop_candidates"] > 0
    assert resumed["iterations"] == full["iterations"]


def test_eval_citydrive_chained_and_block_scene(tmp_path):
    chained = _citydrive(["--chained"])
    stepped = _citydrive([])
    assert chained["frames"] == stepped["frames"] == 9
    assert abs(chained["ate_odometry_cm"] - stepped["ate_odometry_cm"]) <= 0.01
    block = _citydrive(["--scene", "block", "--rect", "-24", "24", "-19", "19"])
    assert block["frames"] == 9 and np.isfinite(block["ate_refined_cm"])
    with pytest.raises(SystemExit, match="DNN"):
        _citydrive(["--chained", "--dnn"])


def test_eval_odometry_replay_and_synthetic(sequence, tmp_path):
    s = eval_odometry.run(eval_odometry.build_parser().parse_args(
        ["--synthetic", "4", "--device", "cpu", "--out", str(tmp_path / "syn.tum")]))
    assert s["frames"] == 3 and s["ate_cm"] < 1.0
    r = eval_odometry.run(eval_odometry.build_parser().parse_args(
        ["--scans", os.path.join(sequence, "velodyne"), "--max-frames", "3",
         "--device", "cpu"]))
    assert r["frames"] == 2 and "ate_cm" not in r


def test_demos(tmp_path):
    from icet_tpu_torch.datasets.synthetic import scan_pair_with_ground_truth

    X_true = demo_registration.X_DEMO
    for i, c in enumerate(scan_pair_with_ground_truth(X_true, seed=0, n_beams=32,
                                                      n_azimuth=256)):
        np.save(tmp_path / f"c{i}.npy", c)
    reg = demo_registration.run(demo_registration.build_parser().parse_args(
        ["--device", "cpu", "--cloud1", str(tmp_path / "c0.npy"),
         "--cloud2", str(tmp_path / "c1.npy")]))
    np.testing.assert_allclose(reg["X"][:3], X_true[:3], atol=0.02)
    odo = demo_odometry.run(demo_odometry.build_parser().parse_args(
        ["--device", "cpu", "--frames", "4"]))
    assert odo["frames"] == 3 and odo["ate_cm"] < 1.0
    mp = demo_mapping.run(demo_mapping.build_parser().parse_args(
        ["--device", "cpu", "--frames", "3", "--out", str(tmp_path / "m")]))
    assert mp["map_points"] > 0 and mp["files"] == [str(tmp_path / "m" / "hd_map.html")]
    kf = demo_keyframe_map.run(demo_keyframe_map.build_parser().parse_args(
        ["--device", "cpu", "--frames", "8", "--out", str(tmp_path / "k"), "--viz"]))
    assert abs(kf["dz"] - 0.5) < 1e-3 and len(kf["files"]) == 5
    assert all(os.path.getsize(f) > 0 for f in kf["files"])


def test_train_bias_net_cli(tmp_path):
    from icet_tpu_torch.models.bias_net import load_pretrained

    out = str(tmp_path / "w.npz")
    s = train_bias_net.run(train_bias_net.build_parser().parse_args(
        ["--device", "cpu", "--steps", "3", "--batch", "8", "--pairs", "1", "--out", out]))
    assert s["out"] == out and np.isfinite(s["last_loss"])
    net = load_pretrained(path=out)
    x = torch.zeros(2, 200, 4)
    assert net(x).shape == (2, 3)
    default = train_bias_net.build_parser().parse_args([]).out
    assert "icet_tpu" not in os.path.abspath(default).split(os.sep)
    with pytest.raises(FileNotFoundError, match="reference"):
        train_bias_net.run(train_bias_net.build_parser().parse_args(
            ["--device", "cpu", "--real-pairs", str(tmp_path / "no_reference")]))


def test_main_prints_the_summary(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["make_kitti_sequence", "--out", str(tmp_path / "s"),
                                      "--frames", "2", "--beams", "8", "--azimuth", "64"])
    make_kitti_sequence.main()
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["frames"] == 2
