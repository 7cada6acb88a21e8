"""The port's ScanMatcher against the JAX package's
(``icet_tpu/scan_matcher.py``): statuses equal in all four cases, X to
1e-4, pred_stds to 1e-3 of the largest (float32 eigenvalue error of the 6x6
normal equations, amplified by their condition, moves the smallest
components by up to 0.4%), snail trails to 1e-4 m, aligned clouds to 3e-3 m (X's 1e-4 carried through
ranges of up to 30 m).  25 azimuth bins
against 256-column sweeps keep every point off the bin edges.
"""

import dataclasses
import math

import numpy as np
import torch

from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.datasets.synthetic import simulate_scan
from icet_tpu.scan_matcher import ScanMatcher as JScanMatcher
from icet_tpu_torch.convert import config_from_icet
from icet_tpu_torch.scan_matcher import ScanMatcher

torch.set_num_threads(2)

CFG = JConfig(n_theta=25, n_phi=8, phi_min=math.pi / 3, phi_max=2 * math.pi / 3,
              n_iters=7, min_pts=10, min_range=1.0)


def test_statuses_and_solutions_match_jax():
    scans = [
        np.zeros((2048, 3), np.float32),  # empty_cloud
        simulate_scan(seed=0, n_beams=32, n_azimuth=256),  # first_frame
        simulate_scan(pose_t=np.array([0.3, 0.0, 0.0]), seed=1, n_beams=32,
                      n_azimuth=256),  # ok
        simulate_scan(pose_t=np.array([0.5, 0.1, 0.0]), seed=2, n_beams=32,
                      n_azimuth=256),  # diverged: a 0.2 m step past a 0.1 m clamp
    ]
    jsm = JScanMatcher(CFG, min_points=100)
    tsm = ScanMatcher(config_from_icet(dataclasses.asdict(CFG)), min_points=100, device="cpu")
    want, got = [], []
    for k, s in enumerate(scans):
        if k == 3:
            jsm.divergence_clamp = tsm.divergence_clamp = 0.1
        want.append(jsm.step(s))
        got.append(tsm.step(s))
    assert [g.status for g in got] == [w.status for w in want] == [
        "empty_cloud", "first_frame", "ok", "diverged"]
    for g, w in zip(got, want):
        assert g.index == w.index
        np.testing.assert_allclose(g.X, w.X, rtol=0, atol=1e-4)
        np.testing.assert_allclose(g.pred_stds, w.pred_stds, rtol=0,
                                   atol=1e-3 * np.abs(w.pred_stds).max())
        np.testing.assert_allclose(g.trail, w.trail, rtol=0, atol=1e-4)
        assert (g.aligned is None) == (w.aligned is None)
        if g.aligned is not None:
            assert np.isfinite(g.aligned).all()
            # X's 1e-4 carried through ranges of up to 30 m.
            np.testing.assert_allclose(g.aligned, w.aligned, rtol=0, atol=3e-3)
    np.testing.assert_allclose(got[2].X[0], 0.3, atol=0.05)
    np.testing.assert_allclose(got[2].trail[0][0], -0.3, atol=0.05)  # the previous origin
    assert got[3].trail.shape == (2, 3)  # a diverged frame adds no trail point
