"""The port's file loaders against the JAX package's: each loader reads the
same written file to the identical array, bit for bit (both are numpy
code; the port keeps its own copy)."""

import pickle

import numpy as np
import pytest
import torch

from icet_tpu.datasets import loaders as jl
from icet_tpu.datasets import replay as jreplay
from icet_tpu_torch.datasets import loaders as tl
from icet_tpu_torch.datasets import replay as treplay

torch.set_num_threads(2)


def _same(a, b):
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype,n,max_points", [
    (np.float32, 120, 256), (np.float64, 120, 256), (np.float32, 300, 100),
])
def test_load_npy(tmp_path, rng, dtype, n, max_points):
    p = tmp_path / "a.npy"
    np.save(p, rng.normal(0, 10, (n, 3)).astype(dtype))
    _same(tl.load_npy(str(p), max_points), jl.load_npy(str(p), max_points))


@pytest.mark.parametrize("strict", [False, True])
def test_load_kitti_bin(tmp_path, rng, strict):
    p = tmp_path / "c.bin"
    rng.normal(0, 10, (77, 4)).astype(np.float32).tofile(p)
    _same(tl.load_kitti_bin(str(p), 128, strict=strict),
          jl.load_kitti_bin(str(p), 128, strict=strict))
    # over max_points: the stride subsample, or a refusal in strict mode
    if strict:
        for mod in (tl, jl):
            with pytest.raises(ValueError, match="max_points"):
                mod.load_kitti_bin(str(p), 50, strict=True)
    else:
        _same(tl.load_kitti_bin(str(p), 50), jl.load_kitti_bin(str(p), 50))


def test_load_kitti_bin_refusals(tmp_path, rng):
    torn = tmp_path / "torn.bin"
    torn.write_bytes(rng.normal(size=(5, 4)).astype(np.float32).tobytes()[:-4])
    nan = tmp_path / "nan.bin"
    rec = rng.normal(size=(5, 4)).astype(np.float32)
    rec[2, 1] = np.nan
    rec.tofile(nan)
    for mod in (tl, jl):
        with pytest.raises(ValueError, match="16-byte"):
            mod.load_kitti_bin(str(torn), 16)
        with pytest.raises(ValueError, match="non-finite"):
            mod.load_kitti_bin(str(nan), 16, strict=True)
    # lenient mode keeps the NaN row, as the JAX package does
    _same(tl.load_kitti_bin(str(nan), 16), jl.load_kitti_bin(str(nan), 16))


@pytest.mark.parametrize("kind", ["xyz_space", "xyz_comma", "ouster_auto", "ouster_fmt"])
def test_load_csv(tmp_path, rng, kind):
    p = tmp_path / "cloud.csv"
    if kind.startswith("ouster"):
        data = rng.normal(0, 1000.0, (40, 12))
        data[7, 9] = np.nan
        with open(p, "w") as f:
            f.write("Timestamp,a,b,c,d,e,f,g,X(mm),Y(mm),Z(mm),Signal\n")
            f.write("units,,,,,,,,mm,mm,mm,\n")
            for row in data:
                f.write(",".join(f"{v:.4f}" for v in row) + "\n")
    else:
        sep = " " if kind == "xyz_space" else ","
        with open(p, "w") as f:
            for row in rng.normal(size=(33, 3)):
                f.write(sep.join(f"{v:.6f}" for v in row) + "\n")
    fmt = "ouster" if kind == "ouster_fmt" else "auto"
    _same(tl.load_csv(str(p), 64, fmt=fmt), jl.load_csv(str(p), 64, fmt=fmt))


@pytest.mark.parametrize("binary", [False, True])
def test_load_ply(tmp_path, rng, binary):
    from icet_tpu_torch.viz import save_ply

    pts = rng.normal(size=(50, 3)).astype(np.float32)
    p = tmp_path / "cloud.ply"
    if binary:
        save_ply(str(p), pts, (rng.random((50, 3)) * 255).astype(np.uint8))
    else:
        with open(p, "w") as f:
            f.write("ply\nformat ascii 1.0\nelement vertex 50\nproperty float x\n"
                    "property float y\nproperty float z\nproperty float intensity\n"
                    "end_header\n")
            for x, y, z in pts:
                f.write(f"{x:.6f} {y:.6f} {z:.6f} 1.0\n")
    _same(tl.load_ply(str(p), 64), jl.load_ply(str(p), 64))


def test_load_codd_hdf5(tmp_path, rng):
    import h5py

    pts = rng.normal(size=(2, 2, 40, 4)).astype(np.float32)
    p = tmp_path / "codd.hdf5"
    with h5py.File(p, "w") as hf:
        hf.create_dataset("point_cloud", data=pts)
    _same(tl.load_codd_hdf5(str(p), frame=1, vehicle=1, max_points=64),
          jl.load_codd_hdf5(str(p), frame=1, vehicle=1, max_points=64))
    _same(tl.load_cloud(str(p), 64), jl.load_cloud(str(p), 64))


def test_load_pixset_pkl(tmp_path, rng):
    rec = np.rec.fromarrays(rng.normal(size=(5, 30)), names="x,y,z,i,t")
    p = tmp_path / "scan.pkl"
    with open(p, "wb") as f:
        pickle.dump(rec, f)
    _same(tl.load_pixset_pkl(str(p), 64), jl.load_pixset_pkl(str(p), 64))


def test_load_ford_mat(tmp_path, rng):
    from scipy.io import savemat

    p = tmp_path / "Scan0001.mat"
    savemat(p, {"SCAN": {"XYZ": rng.normal(size=(3, 25))}})
    _same(tl.load_ford_mat(str(p), 64), jl.load_ford_mat(str(p), 64))


def test_load_cloud_and_sequence(tmp_path, rng):
    paths = []
    for i, ext in enumerate([".npy", ".bin", ".txt"]):
        p = tmp_path / f"{i}{ext}"
        if ext == ".npy":
            np.save(p, rng.normal(size=(20, 3)).astype(np.float32))
        elif ext == ".bin":
            rng.normal(size=(20, 4)).astype(np.float32).tofile(p)
        else:
            np.savetxt(p, rng.normal(size=(20, 3)))
        paths.append(str(p))
    for a, b in zip(tl.load_sequence(paths, 32), jl.load_sequence(paths, 32)):
        _same(a, b)
    bad = tmp_path / "x.xyz"
    bad.write_text("1 2 3\n")
    for mod in (tl, jl):
        with pytest.raises(ValueError, match="unknown"):
            mod.load_cloud(str(bad))


def test_replay_source(tmp_path, rng):
    for i in range(4):
        np.save(tmp_path / f"{i:03d}.npy", rng.normal(size=(30 + i, 3)).astype(np.float32))
    t = treplay.ReplaySource(str(tmp_path), max_points=64, loop=True)
    j = jreplay.ReplaySource(str(tmp_path), max_points=64, loop=True)
    assert len(t) == len(j) == 4 and t.paths == j.paths
    got = [s for _, s in zip(range(6), t)]  # loops past the end
    want = [s for _, s in zip(range(6), j)]
    for a, b in zip(got, want):
        _same(a, b)
    with pytest.raises(FileNotFoundError):
        treplay.ReplaySource(str(tmp_path / "none*.npy"))
