"""The port's native prefetch queue (``csrc/prefetch.c``, built with the
host C compiler through ``_build.py`` and loaded with ctypes) against the
numpy readers of both packages and the JAX package's C extension: the
scans must match bit for bit."""

import numpy as np
import pytest
import torch

from icet_tpu.datasets import loaders as jl
from icet_tpu_torch import _build, native
from icet_tpu_torch.datasets import loaders as tl
from icet_tpu_torch.datasets.replay import ReplaySource

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def lib():
    built = native.ensure_built(quiet=False)
    assert built is not None, "cc could not build csrc/prefetch.c"
    return built


def test_build_is_keyed_and_cached(lib):
    path = _build.library_path("prefetch")
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert path.name.startswith("prefetch-")
    assert _build.build(["prefetch"]) == {}  # already built: nothing compiled
    assert "prefetch" in sorted(p.stem for p in _build.CSRC.glob("*.c"))


@pytest.mark.parametrize("case", ["npy_f4", "npy_f8", "npy_f4_truncated", "bin", "csv_ouster",
                                  "txt_xyz"])
def test_load_cloud_matches_numpy_readers(lib, tmp_path, rng, case):
    max_points = 100 if case == "npy_f4_truncated" else 256
    if case.startswith("npy"):
        pts = rng.normal(0, 10, (300 if "truncated" in case else 120, 3))
        p = tmp_path / "a.npy"
        np.save(p, pts.astype(np.float64 if case == "npy_f8" else np.float32))
        want = tl.load_npy(str(p), max_points)
        if "truncated" in case:
            # the C reader keeps the head, numpy the stride subsample
            want = np.asarray(np.load(p)[:max_points], np.float32)
    elif case == "bin":
        p = tmp_path / "c.bin"
        rng.normal(0, 10, (77, 4)).astype(np.float32).tofile(p)
        want = tl.load_kitti_bin(str(p), max_points)
    elif case == "csv_ouster":
        p = tmp_path / "ouster.csv"
        data = rng.normal(0, 1000.0, (50, 12))
        with open(p, "w") as f:
            f.write("Timestamp,a,b,c,d,e,f,g,X(mm),Y(mm),Z(mm),Signal\n")
            for row in data:
                f.write(",".join(f"{v:.4f}" for v in row) + "\n")
        want = tl.load_csv(str(p), max_points)
    else:
        p = tmp_path / "cloud.txt"
        with open(p, "w") as f:
            for row in rng.normal(size=(33, 3)):
                f.write("\t".join(f"{v:.6f}" for v in row) + "\n")
        want = tl.load_csv(str(p), max_points)
    got, n = native.load_cloud(str(p), max_points)
    assert got.dtype == np.float32 and got.shape == (max_points, 3)
    assert n == int(np.any(want != 0, axis=1).sum())
    np.testing.assert_array_equal(got, want)


def test_load_cloud_matches_jax_extension(lib, tmp_path, rng):
    from icet_tpu.native import ensure_built

    jnative = ensure_built(quiet=True)
    assert jnative is not None
    for i, ext in enumerate([".npy", ".bin", ".csv"]):
        p = tmp_path / f"{i}{ext}"
        if ext == ".npy":
            np.save(p, rng.normal(size=(40, 3)))
        elif ext == ".bin":
            rng.normal(size=(40, 4)).astype(np.float32).tofile(p)
        else:
            np.savetxt(p, rng.normal(size=(40, 3)), delimiter=",")
        got, n = native.load_cloud(str(p), 64)
        want, m = jnative.load_cloud(str(p), 64)
        assert n == m
        np.testing.assert_array_equal(got, want)


def test_load_errors(lib, tmp_path):
    p = tmp_path / "bad.npy"
    p.write_bytes(b"not numpy at all")
    with pytest.raises(OSError, match="not a .npy"):
        native.load_cloud(str(p), 10)
    with pytest.raises(OSError, match="cannot open"):
        native.load_cloud(str(tmp_path / "missing.npy"), 10)


@pytest.mark.parametrize("n_threads,depth", [(1, 1), (3, 3), (4, 8)])
def test_prefetcher_ordered_matches_replay(lib, tmp_path, rng, n_threads, depth):
    for i in range(9):
        np.save(tmp_path / f"{i:03d}.npy", rng.normal(0, 10, (50 + i, 3)).astype(np.float32))
    src = native.NativeReplaySource(str(tmp_path), max_points=64, n_threads=n_threads,
                                    depth=depth)
    got = list(src)
    want = list(ReplaySource(str(tmp_path), max_points=64))
    assert len(got) == len(want) == 9
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_prefetcher_loop_repeat_and_error(lib, tmp_path, rng):
    for i in range(2):
        np.save(tmp_path / f"{i}.npy", rng.normal(size=(10, 3)))
    assert len(list(native.NativeReplaySource(str(tmp_path), max_points=16, loop=True,
                                              repeat=3))) == 6
    (tmp_path / "2.npy").write_bytes(b"broken")
    # A read error stops the queue (a producer may hit it before the
    # consumer reaches that frame, as in the JAX package's extension).
    q = native.make_prefetcher(sorted(str(p) for p in tmp_path.glob("*.npy")), 16)
    with pytest.raises(OSError, match="2.npy"):
        for _ in range(3):
            q.next_scan()
    q.close()
    with pytest.raises(RuntimeError, match="closed"):
        q.next_scan()
    with pytest.raises(FileNotFoundError):
        native.NativeReplaySource(str(tmp_path / "none*.bin"))


def test_prefetcher_early_close_joins_producers(lib, tmp_path, rng):
    """Closing with producers blocked on a full queue returns (they are
    woken and joined) and a fresh queue over the same files works."""
    paths = []
    for i in range(12):
        p = tmp_path / f"{i:03d}.bin"
        rng.normal(size=(200, 4)).astype(np.float32).tofile(p)
        paths.append(str(p))
    for _ in range(5):
        q = native.make_prefetcher(paths, 256, n_threads=4, depth=2)
        first, n = q.next_scan()
        assert n == 200
        q.close()
    np.testing.assert_array_equal(first, jl.load_kitti_bin(paths[0], 256))
