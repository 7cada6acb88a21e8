"""The port's moment scatter (``moment_method="pallas"``) against the JAX
package's Pallas moment kernel in interpret mode.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against ``index_add_`` there).  Here the wrapper's plain version, which it
takes for CPU tensors, is held against ``icet_tpu``'s
``voxel_moment_sums(method="pallas")`` to 1e-5 (float32 sums of a few
dozen terms in another order), and the whole registration at
``moment_method="pallas"`` against the JAX package's, to the tolerances of
tests/test_torch_solver.py (fixed radial mode: ``pred_stds`` to 1e-3, as
there).  Grids as there: 25 azimuth bins against a 256-column sweep keep
every point off the bin edges.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu import solver as js
from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.datasets.synthetic import scan_pair_with_ground_truth
from icet_tpu.ops import moments as jmom
from icet_tpu_torch import solver as ts
from icet_tpu_torch.convert import config_from_icet
from icet_tpu_torch.ops import moment_scatter as tsc
from icet_tpu_torch.ops import moments as tmom

torch.set_num_threads(2)

CFG = JConfig(n_theta=25, n_phi=8, phi_min=math.pi / 3, phi_max=2 * math.pi / 3,
              n_iters=7, min_pts=15, min_range=1.0, moment_method="pallas")
X_TRUE = np.array([0.3, -0.1, 0.02, 0.01, -0.01, 0.03])


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def pair():
    return scan_pair_with_ground_truth(X_TRUE, seed=3, n_beams=32, n_azimuth=256)


@pytest.mark.parametrize("V", [52, 2400], ids=["V52", "V2400"])
def test_voxel_moment_sums_pallas(pair, V):
    rng = np.random.default_rng(V)
    pts = pair[0][:3000]
    n = pts.shape[0]
    vid = rng.integers(0, V + 1, n).astype(np.int32)
    member = (rng.random(n) > 0.2) & (vid < V)
    anchors = (rng.normal(size=(V + 1, 3)) * 5).astype(np.float32)
    want = np.asarray(jmom.voxel_moment_sums(jnp.asarray(pts), jnp.asarray(vid),
                                             jnp.asarray(member), jnp.asarray(anchors), V,
                                             method="pallas"))
    got = tmom.voxel_moment_sums(_t(pts), _t(vid), _t(member), _t(anchors), V,
                                 method="pallas").numpy()
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[:, 10:] == 0).all() and (got[-1] == 0).all()


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(0)
    vid = _t(rng.integers(0, 11, 500).astype(np.int32))
    feats = _t(rng.normal(size=(500, 16)).astype(np.float32))
    before = tsc.moment_scatter_sums.launches
    got = tsc.moment_scatter_sums(vid, feats, 10)
    want = torch.zeros(11, 16).index_add_(0, vid.long(), feats)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert tsc.moment_scatter_sums.launches == before  # no kernel launch on the CPU


def test_wrapper_checks():
    vid = torch.tensor([0, 3, 10], dtype=torch.int32)
    feats = torch.zeros(3, 16)
    with pytest.raises(ValueError):
        tsc.moment_scatter_sums(vid.to("meta"), feats.to("meta"), 10)
    tsc._check(vid, feats)
    # Ids outside [0, V] are no longer refused: they are dropped, as the
    # TPU kernel drops them, and the other rows are summed as before.
    ones = torch.ones(3, 16)
    for bad_vid in (torch.tensor([0, 3, 11], dtype=torch.int32),  # id > V
                    torch.tensor([-1, 3, 4], dtype=torch.int32)):  # id < 0
        tsc._check(bad_vid, ones)
        got = tsc.moment_scatter_sums(bad_vid, ones, 10)
        kept = (bad_vid >= 0) & (bad_vid <= 10)
        want = torch.zeros(11, 16).index_add_(0, bad_vid[kept].long(), ones[kept])
        assert got.shape == (11, 16)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        assert float(got[:, 0].sum()) == 2.0
    for bad_vid, bad_feats, exc in (
        (vid.long(), feats, TypeError),
        (vid, feats.double(), TypeError),
        (vid, torch.zeros(3, 10), ValueError),
        (vid, torch.zeros(16, 3).T, ValueError),  # not contiguous
        (vid, torch.zeros(49)[1:].reshape(3, 16), ValueError),  # not 16-byte aligned
    ):
        with pytest.raises(exc):
            tsc._check(bad_vid, bad_feats)


@pytest.mark.parametrize("radial", ["adaptive", "fixed"])
def test_register_pair_pallas(pair, radial):
    cfg = CFG.replace(radial_mode=radial, n_shells=12) if radial == "fixed" else CFG
    stds_rtol = 1e-3 if radial == "fixed" else 1e-4
    j = js.register_pair(jnp.asarray(pair[0]), jnp.asarray(pair[1]),
                         jnp.zeros(6, jnp.float32), cfg)
    t = ts.register_pair(pair[0], pair[1], np.zeros(6, np.float32),
                         config_from_icet(dataclasses.asdict(cfg)), device="cpu")
    jn, tn = np.asarray(j.diagnostics.n_corr), t.diagnostics.n_corr.numpy()
    margins = (
        f"|dX| {np.abs(t.X.numpy() - np.asarray(j.X)).max():.3e} (X port "
        f"{t.X.numpy()}, JAX {np.asarray(j.X)}), pred_stds ratio - 1 "
        f"{np.abs(t.pred_stds.numpy() / np.asarray(j.pred_stds) - 1).max():.3e}, "
        f"n_corr port {tn} JAX {jn}, iterations {t.iterations}"
    )
    np.testing.assert_allclose(t.X.numpy(), np.asarray(j.X), rtol=0, atol=1e-5,
                               err_msg=margins)
    np.testing.assert_allclose(t.pred_stds.numpy(), np.asarray(j.pred_stds), rtol=stds_rtol,
                               err_msg=margins)
    Q = np.asarray(j.Q)
    np.testing.assert_allclose(t.Q.numpy(), Q, rtol=0, atol=stds_rtol * np.abs(Q).max(),
                               err_msg=margins)
    np.testing.assert_array_equal(tn, jn, err_msg=margins)
    assert t.diagnostics.n_corr.numpy()[-1] > 20
