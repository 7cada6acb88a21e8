"""The port's visualization and export layer against the JAX package's:
the HTML viewer files byte-equal for the same inputs, the ellipsoid
wireframes and voxel-frustum corners equal, PLY exports byte-equal, every
``plot_*`` writing a PNG; and ``measurement_jacobian`` against the JAX
package's."""

import base64
import dataclasses
import filecmp
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu import viz as jviz
from icet_tpu import viz_html as jhtml
from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.datasets.synthetic import scan_pair_with_ground_truth
from icet_tpu.ops import geometry as jgeo
from icet_tpu.ops import grid as jgrid
from icet_tpu_torch import viz as tviz
from icet_tpu_torch import viz_html as thtml
from icet_tpu_torch.convert import config_from_icet
from icet_tpu_torch.ops import geometry as tgeo
from icet_tpu_torch.ops import grid as tgrid

torch.set_num_threads(2)

CFG = JConfig(n_theta=24, n_phi=8, phi_min=np.pi / 3, phi_max=2 * np.pi / 3,
              n_iters=3, min_pts=10, min_range=1.0)


def _scene(path):
    text = open(path).read()
    start = text.index("const SCENE = ") + len("const SCENE = ")
    return json.loads(text[start:text.index(";\n", start)])


@pytest.mark.parametrize("as_tensor", [False, True])
def test_save_html_byte_equal(tmp_path, rng, as_tensor):
    pts1 = rng.normal(size=(500, 3)).astype(np.float32) + 5.0
    pts2 = rng.normal(size=(300, 3)).astype(np.float32)
    pts2[3] = np.nan
    pts2[4] = 0.0
    trail = np.cumsum(rng.normal(size=(20, 3)), axis=0)
    kw = dict(labels=["a", "b"], line_labels=["trail"], max_pts=200, title="t<1>",
              colors=[(0.1, 0.2, 0.3)], point_size=3.0)
    wrap = (lambda a: torch.from_numpy(np.asarray(a))) if as_tensor else (lambda a: a)
    t = thtml.save_html(str(tmp_path / "t.html"), [wrap(pts1), wrap(pts2)],
                        lines=[wrap(trail)], **kw)
    j = jhtml.save_html(str(tmp_path / "j.html"), [pts1, pts2], lines=[trail], **kw)
    assert filecmp.cmp(t, j, shallow=False)


def test_save_map_html_byte_equal(tmp_path, rng):
    pts = rng.normal(0, 20, (4000, 3)).astype(np.float32)
    trail = np.cumsum(np.ones((10, 3)), axis=0)
    for trail_arg in (trail, None):
        t = thtml.save_map_html(str(tmp_path / "t.html"), torch.from_numpy(pts), trail_arg,
                                max_pts=1000)
        j = jhtml.save_map_html(str(tmp_path / "j.html"), pts, trail_arg, max_pts=1000)
        assert filecmp.cmp(t, j, shallow=False)


def test_save_registration_html(tmp_path):
    """The aligned layer is transformed by each package's own
    ``transform_points``: equal to float32 rounding (1e-5 m at these
    ranges); the other layers and the file at X = 0 byte-equal."""
    s1, s2 = scan_pair_with_ground_truth(np.array([0.2, 0, 0, 0, 0, 0.0]), seed=0,
                                         n_beams=16, n_azimuth=128)
    X = np.array([0.2, -0.1, 0.05, 0.01, -0.02, 0.03], np.float32)
    t = thtml.save_registration_html(str(tmp_path / "t.html"), s1, torch.from_numpy(s2),
                                     torch.from_numpy(X))
    j = jhtml.save_registration_html(str(tmp_path / "j.html"), s1, s2, jnp.asarray(X))
    ts, js = _scene(t), _scene(j)
    assert [L["label"] for L in ts["layers"]] == [L["label"] for L in js["layers"]]
    for a, b in zip(ts["layers"], js["layers"]):
        da = np.frombuffer(base64.b64decode(a["data"]), "<f4")
        db = np.frombuffer(base64.b64decode(b["data"]), "<f4")
        np.testing.assert_allclose(da, db, rtol=0, atol=1e-5)
    t0 = thtml.save_registration_html(str(tmp_path / "t0.html"), s1, s2, np.zeros(6))
    j0 = jhtml.save_registration_html(str(tmp_path / "j0.html"), s1, s2, jnp.zeros(6))
    assert filecmp.cmp(t0, j0, shallow=False)


def test_ellipsoid_wireframe_equal(rng):
    A = rng.normal(size=(3, 3))
    cov = A @ A.T + 0.1 * np.eye(3)
    mean = np.array([1.0, -2.0, 3.0])
    got = thtml.ellipsoid_wireframe(torch.from_numpy(mean), torch.from_numpy(cov), 2.0, 16)
    want = jhtml.ellipsoid_wireframe(mean, cov, 2.0, 16)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [{}, {"radial_mode": "fixed", "n_shells": 4}])
def test_voxel_corners_equal(rng, kw):
    jcfg = CFG.replace(**kw)
    tcfg = config_from_icet(dataclasses.asdict(jcfg))
    V = jcfg.n_voxels
    r0 = rng.uniform(1, 20, V + 1).astype(np.float32)
    bounds = np.stack([r0, r0 + rng.uniform(0.5, 5, V + 1).astype(np.float32)], -1)
    got = tgrid.voxel_corners(torch.from_numpy(bounds), tcfg).numpy()
    want = np.asarray(jgrid.voxel_corners(jnp.asarray(bounds), jcfg))
    assert got.shape == want.shape == (V, 8, 3)
    np.testing.assert_array_equal(got, want)


def test_measurement_jacobian(rng):
    """Products and sums of float32 trig values taken in another order:
    within 1e-6 relative to the largest entry."""
    mu = rng.normal(0, 20, (50, 3)).astype(np.float32)
    for angs in (np.zeros(3, np.float32), np.array([0.1, -0.2, 0.3], np.float32)):
        got = tgeo.measurement_jacobian(torch.from_numpy(mu), torch.from_numpy(angs)).numpy()
        want = np.asarray(jgeo.measurement_jacobian(jnp.asarray(mu), jnp.asarray(angs)))
        assert got.shape == want.shape == (50, 3, 6)
        np.testing.assert_array_equal(got[..., :3], want[..., :3])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("with_color", [False, True])
def test_save_ply_byte_equal(tmp_path, rng, with_color):
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    pts[7] = np.inf
    cols = (rng.random((49, 3)) * 255).astype(np.uint8) if with_color else None
    t = tviz.save_ply(str(tmp_path / "t.ply"), torch.from_numpy(pts), cols)
    j = jviz.save_ply(str(tmp_path / "j.ply"), pts, cols)
    assert filecmp.cmp(t, j, shallow=False)


def test_plot_artifacts(tmp_path):
    from icet_tpu_torch.solver import prepare_reference

    scan1, scan2 = scan_pair_with_ground_truth(np.array([0.2, 0, 0, 0, 0, 0.0]), seed=0,
                                               n_beams=16, n_azimuth=128)
    p1 = tviz.plot_clouds(str(tmp_path / "clouds.png"), [scan1, torch.from_numpy(scan2)],
                          labels=["scan1", "scan2"], title="clouds")
    p2 = tviz.plot_registration(str(tmp_path / "reg.png"), scan1, scan2,
                                torch.tensor([0.2, 0, 0, 0, 0, 0]))
    model = prepare_reference(torch.from_numpy(scan1),
                              config_from_icet(dataclasses.asdict(CFG)))
    p3 = tviz.plot_voxel_model(str(tmp_path / "voxels.png"), model, max_ellipsoids=40,
                               title="voxels")
    poses = [torch.eye(4) for _ in range(3)]
    p4 = tviz.plot_trajectory(str(tmp_path / "traj.png"), poses, [np.eye(4)] * 3)
    p5 = tviz.plot_map(str(tmp_path / "map.png"), torch.from_numpy(scan1),
                       trail=torch.zeros(4, 3))
    for p in (p1, p2, p3, p4, p5):
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
        assert os.path.getsize(p) > 5000
