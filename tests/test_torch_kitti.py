"""The port's KITTI odometry-format IO against the JAX package's: pose and
sequence round trips, the strict-mode refusals of tests/test_kitti.py, and
identical ``(scan, T)`` streams from both ``KittiOdometrySource``s, through
the numpy reader and through each package's native prefetch queue."""

import filecmp
import os

import numpy as np
import pytest
import torch

from icet_tpu.datasets import kitti as jk
from icet_tpu.datasets.synthetic import simulate_scan
from icet_tpu_torch.datasets import kitti as tk

torch.set_num_threads(2)


def _pose(rng):
    ang = rng.normal(0, 0.2, 3)
    ca, sa = np.cos(ang), np.sin(ang)
    T = np.eye(4)
    T[:3, :3] = np.array([[ca[2], -sa[2], 0], [sa[2], ca[2], 0], [0, 0, 1]])
    T[:3, 3] = rng.normal(0, 5.0, 3)
    return T


def _streams_equal(a, b):
    n = 0
    for (sa, Ta), (sb, Tb) in zip(a, b):
        np.testing.assert_array_equal(sa, sb)
        if Ta is None or Tb is None:
            assert Ta is None and Tb is None
        else:
            np.testing.assert_array_equal(Ta, Tb)
        n += 1
    assert n == len(a) == len(b)


def test_poses_roundtrip(rng, tmp_path):
    poses = [_pose(rng) for _ in range(7)]
    tk.save_poses(str(tmp_path / "t.txt"), poses)
    jk.save_poses(str(tmp_path / "j.txt"), poses)
    assert filecmp.cmp(tmp_path / "t.txt", tmp_path / "j.txt", shallow=False)
    np.testing.assert_array_equal(tk.load_poses(str(tmp_path / "t.txt")),
                                  jk.load_poses(str(tmp_path / "t.txt")))
    np.testing.assert_allclose(tk.load_poses(str(tmp_path / "t.txt")), np.stack(poses),
                               atol=1e-7)
    assert tk.load_calib_tr(str(tmp_path / "none.txt")) is None


@pytest.mark.parametrize("prefetch", [False, True])
def test_sequence_roundtrip_with_calib(rng, tmp_path, prefetch):
    """Both packages write byte-identical sequences, and the port's source
    reads them back to the velodyne-frame poses through ``Tr``."""
    scans = [rng.normal(0, 10, (50 + 10 * i, 3)).astype(np.float32) for i in range(4)]
    T_w_velo = [_pose(rng) for _ in range(4)]
    tr = _pose(rng)
    poses_cam = [T @ np.linalg.inv(tr) for T in T_w_velo]
    d = tk.write_kitti_sequence(str(tmp_path / "t"), scans, poses_cam, calib_tr=tr)
    jk.write_kitti_sequence(str(tmp_path / "j"), scans, poses_cam, calib_tr=tr)
    for rel in ["poses.txt", "calib.txt"] + [f"velodyne/{i:06d}.bin" for i in range(4)]:
        assert filecmp.cmp(tmp_path / "t" / rel, tmp_path / "j" / rel, shallow=False), rel
    np.testing.assert_array_equal(tk.load_calib_tr(os.path.join(d, "calib.txt")),
                                  jk.load_calib_tr(os.path.join(d, "calib.txt")))
    src = tk.KittiOdometrySource(d, poses_file=os.path.join(d, "poses.txt"), max_points=256,
                                 beam_major=False, prefetch=prefetch)
    assert len(src) == 4
    for (scan, T), orig, T_orig in zip(src, scans, T_w_velo):
        nz = scan[np.any(scan != 0.0, axis=1)]
        np.testing.assert_allclose(nz, orig, atol=1e-6)
        np.testing.assert_allclose(T, T_orig, atol=1e-6)
    _streams_equal(src, jk.KittiOdometrySource(d, poses_file=os.path.join(d, "poses.txt"),
                                               max_points=256, beam_major=False,
                                               prefetch=prefetch))


@pytest.mark.parametrize("beam_major", ["auto", False])
@pytest.mark.parametrize("start,end", [(0, None), (1, 4)])
def test_streams_equal_beam_major(tmp_path, beam_major, start, end):
    """Azimuth-major 16-beam scans with no miss row: both sources detect
    the same beam count under "auto" and re-stride identically; the
    start/end window and the no-poses case stream identically too."""
    scans = []
    for i in range(5):
        s = simulate_scan(pose_t=np.array([0.3 * i, 0.0, 0.0]), seed=i, n_beams=16,
                          n_azimuth=64, range_noise=0.0)
        s = s.reshape(16, 64, 3).transpose(1, 0, 2).reshape(-1, 3)  # azimuth-major
        s[np.all(s == 0.0, axis=1)] = 50.0  # no miss rows: keep 16 | N
        scans.append(s)
    d = jk.write_kitti_sequence(str(tmp_path / "s"), scans, [np.eye(4)] * 5)
    kw = dict(max_points=2048, beam_major=beam_major, start=start, end=end)
    for poses in (os.path.join(d, "poses.txt"), None):
        t = tk.KittiOdometrySource(d, poses_file=poses, prefetch=True, **kw)
        j = jk.KittiOdometrySource(d, poses_file=poses, prefetch=False, **kw)
        _streams_equal(t, j)
    first = next(iter(tk.KittiOdometrySource(d, **kw)))[0]
    if beam_major == "auto":
        from icet_tpu_torch.datasets.loaders import detect_beam_count, to_beam_major

        beams = detect_beam_count(scans[start])
        assert beams is not None and beams % 16 == 0
        np.testing.assert_array_equal(first[:1024], to_beam_major(scans[start], beams))
    else:
        np.testing.assert_array_equal(first[:1024], scans[start])


class TestStrictReal:
    """--strict-real refuses format surprises in both packages alike
    (tests/test_kitti.py:76-143); default mode stays lenient."""

    def _seq(self, rng, tmp_path, n=3, pts=40):
        scans = [rng.normal(0, 10, (pts, 3)).astype(np.float32) for _ in range(n)]
        return tk.write_kitti_sequence(str(tmp_path / "seq"), scans, [np.eye(4)] * n)

    def test_clean_sequence_passes(self, rng, tmp_path):
        d = self._seq(rng, tmp_path)
        kw = dict(poses_file=str(tmp_path / "seq" / "poses.txt"), max_points=64,
                  beam_major=False, strict=True)
        _streams_equal(tk.KittiOdometrySource(d, prefetch=True, **kw),
                       jk.KittiOdometrySource(d, **kw))

    def test_truncated_bin_rejected(self, rng, tmp_path):
        d = self._seq(rng, tmp_path)
        path = str(tmp_path / "seq" / "velodyne" / "000001.bin")
        raw = open(path, "rb").read()
        open(path, "wb").write(raw[:-7])
        for mod in (tk, jk):
            with pytest.raises(ValueError, match="16-byte"):
                mod.KittiOdometrySource(d, max_points=64, beam_major=False, strict=True)
            with pytest.raises(ValueError):
                list(mod.KittiOdometrySource(d, max_points=64, beam_major=False,
                                             prefetch=False))

    def test_oversize_scan_rejected_only_in_strict(self, rng, tmp_path):
        d = self._seq(rng, tmp_path, pts=100)
        for mod in (tk, jk):
            with pytest.raises(ValueError, match="max_points"):
                mod.KittiOdometrySource(d, max_points=64, beam_major=False, strict=True)
        kw = dict(max_points=64, beam_major=False, prefetch=False)
        _streams_equal(tk.KittiOdometrySource(d, **kw), jk.KittiOdometrySource(d, **kw))

    @pytest.mark.parametrize("prefetch", [False, True])
    def test_nonfinite_rejected_only_in_strict(self, rng, tmp_path, prefetch):
        scans = [rng.normal(0, 10, (40, 3)).astype(np.float32) for _ in range(2)]
        scans[1][7, 1] = np.nan
        d = tk.write_kitti_sequence(str(tmp_path / "seq"), scans, [np.eye(4)] * 2)
        src = tk.KittiOdometrySource(d, max_points=64, beam_major=False, strict=True,
                                     prefetch=prefetch)
        with pytest.raises(ValueError, match="non-finite"):
            list(src)
        assert sum(1 for _ in tk.KittiOdometrySource(d, max_points=64, beam_major=False,
                                                     prefetch=prefetch)) == 2

    def test_short_poses_rejected_only_in_strict(self, rng, tmp_path):
        d = self._seq(rng, tmp_path, n=3)
        poses = str(tmp_path / "seq" / "poses.txt")
        tk.save_poses(poses, [np.eye(4)] * 2)
        for mod in (tk, jk):
            with pytest.raises(ValueError, match="poses"):
                mod.KittiOdometrySource(d, poses_file=poses, max_points=64,
                                        beam_major=False, strict=True)
        tk.KittiOdometrySource(d, poses_file=poses, max_points=64, beam_major=False)


def test_prefetch_true_raises_without_compiler(rng, tmp_path, monkeypatch):
    from icet_tpu_torch import native

    d = tk.write_kitti_sequence(str(tmp_path / "seq"),
                                [rng.normal(size=(10, 3)).astype(np.float32)], [np.eye(4)])
    monkeypatch.setattr(native, "ensure_built", lambda quiet=True: None)
    with pytest.raises(RuntimeError, match="prefetch"):
        tk.KittiOdometrySource(d, max_points=16, prefetch=True)
    # "auto" keeps the numpy reader: host IO, not the device
    scan, _ = next(iter(tk.KittiOdometrySource(d, max_points=16, beam_major=False)))
    np.testing.assert_array_equal(scan, jk.KittiOdometrySource(
        d, max_points=16, beam_major=False, prefetch=False).__iter__().__next__()[0])
