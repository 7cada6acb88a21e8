"""The moments pass's route (``solver.moment_route``): ``"auto"`` and
``"fused"`` take the fused kernel on every grid, in both radial modes and
at any table size (the shared table up to 5,774 voxels, the kernel's sorted
parts above and in fixed radial mode), as the TPU kernel takes them;
``"segsum"`` takes the plain route (PyTorch binning, then ``index_add_``
on the CPU and the moment scatter kernel on the card); ``"onehot"`` takes
the blocked one-hot products on every grid.

The 150x48 registration (V = 7,200, above the shared table's 5,774) runs on
the CPU against ``icet_tpu``'s segsum path.  Its sweep has 1,021 columns
against 150 azimuth bins, so no raw point lies within 1e-5 rad of a bin
edge (asserted; float32 rounding of an angle is below 1e-6 rad), and the
solver parity tolerances of ``test_torch_solver.py`` apply: X within 1e-5
absolute and ``pred_stds`` within 1e-4 relative at fixed run length.
``_edge_distance`` also measures, in fixed radial mode, each point's
distance to its radial shell's edges, where ``log`` may round differently
in the two packages.
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
from icet_tpu_torch import solver as ts
from icet_tpu_torch.config import ICETConfig
from icet_tpu_torch.convert import config_from_icet
from icet_tpu_torch.ops.fused_moments import MAX_SHARED_BYTES, large_table, shared_bytes

torch.set_num_threads(2)

BIG = JConfig(n_theta=150, n_phi=48, n_iters=5, min_pts=10, min_range=1.0)
X_TRUE = np.array([0.3, -0.1, 0.02, 0.01, -0.01, 0.03])


@pytest.mark.parametrize("kw,route", [
    ({}, "fused"),                                        # 75x24, V = 1,800
    ({"n_theta": 2887, "n_phi": 2}, "fused"),             # V = 5,774, the largest shared
    ({"n_theta": 75, "n_phi": 77}, "fused"),              # V = 5,775, sorted parts
    ({"n_theta": 150, "n_phi": 48}, "fused"),             # V = 7,200
    ({"moment_method": "fused", "n_theta": 150, "n_phi": 48}, "fused"),
    ({"radial_mode": "fixed"}, "fused"),                  # V = 90,000
    ({"moment_method": "fused", "radial_mode": "fixed"}, "fused"),
    ({"moment_method": "segsum"}, "plain"),
    ({"moment_method": "segsum", "radial_mode": "fixed"}, "plain"),
    ({"moment_method": "segsum", "n_theta": 150, "n_phi": 48}, "plain"),
    ({"moment_method": "pallas"}, "scatter"),
    ({"moment_method": "pallas", "n_theta": 150, "n_phi": 48}, "scatter"),
], ids=lambda v: v if isinstance(v, str) else "-".join(f"{k}={x}" for k, x in v.items()))
def test_moment_route(kw, route):
    cfg = ICETConfig(**kw)
    assert ts.moment_route(cfg) == route
    fits = shared_bytes(cfg.n_voxels) <= MAX_SHARED_BYTES
    assert fits == (cfg.n_voxels <= 5774)
    # Which of the fused kernel's branches the grid takes.
    assert large_table(cfg) == (not fits or cfg.radial_mode == "fixed")


def test_moment_route_refuses_unported():
    """``"onehot"`` takes its own route (the blocked one-hot products), on
    every grid, as the JAX package's ``_moment_method`` passes it through;
    an unknown method is refused."""
    for kw in ({}, {"n_theta": 150, "n_phi": 48}, {"radial_mode": "fixed"}):
        assert ts.moment_route(ICETConfig(moment_method="onehot", **kw)) == "onehot"
    with pytest.raises(ValueError):
        ts.moment_route(ICETConfig(moment_method="dense"))


@pytest.mark.parametrize("runner", ["OdometryPipeline", "MapMaker", "KeyframeOdometry"])
def test_runners_refuse_an_unknown_route_when_built(runner):
    """The streaming runners check the moments route when they are built,
    not at their first frame."""
    from icet_tpu_torch import keyframe, mapping, odometry

    make = {"OdometryPipeline": odometry.OdometryPipeline, "MapMaker": mapping.MapMaker,
            "KeyframeOdometry": keyframe.KeyframeOdometry}[runner]
    with pytest.raises(ValueError, match="unknown moment_method 'dense'"):
        make(ICETConfig(moment_method="dense"), device="cpu")


def _edge_distance(scan, cfg):
    """The least distance of a raw point past ``min_range`` to an azimuth or
    polar bin edge (rad), and in fixed radial mode also to its radial
    shell's edges (in units of the shell index, the quantity the binning
    floors)."""
    p = scan.astype(np.float64)
    r = np.linalg.norm(p, axis=1)
    ok = r >= cfg.min_range
    theta = np.mod(np.arctan2(p[ok, 1], p[ok, 0]), 2 * np.pi)
    phi = np.arccos(np.clip(p[ok, 2] / r[ok], -1, 1))
    wt = 2 * np.pi / cfg.n_theta
    wp = (cfg.phi_max - cfg.phi_min) / cfg.n_phi
    ft, fp = theta[theta > 0] / wt, (phi - cfg.phi_min) / wp
    d = min(np.min(np.abs(ft - np.round(ft))) * wt, np.min(np.abs(fp - np.round(fp))) * wp)
    if cfg.radial_mode == "fixed":
        fs = np.log(r[ok] / cfg.min_range) / np.log(cfg.shell_growth)
        d = min(d, np.min(np.abs(fs - np.round(fs))))
    return d


@pytest.mark.slow
def test_register_pair_large_grid_against_segsum():
    """A 150x48 grid registers through the fused route (the kernel's
    sorted parts on the card, its plain version here) and equals the JAX
    package's segsum solve (``"auto"`` in the port, ``"segsum"`` there)."""
    s1, s2 = scan_pair_with_ground_truth(X_TRUE, seed=3, n_beams=64, n_azimuth=1021)
    assert _edge_distance(s1, BIG) > 1e-5 and _edge_distance(s2, BIG) > 1e-5
    cfg = config_from_icet(dataclasses.asdict(BIG))
    assert cfg.n_voxels == 7200 and ts.moment_route(cfg) == "fused"
    j = js.register_pair(jnp.asarray(s1), jnp.asarray(s2), jnp.zeros(6, jnp.float32),
                         BIG.replace(moment_method="segsum"))
    t = ts.register_pair(s1, s2, np.zeros(6, np.float32), cfg, device="cpu")
    np.testing.assert_allclose(t.X.numpy(), np.asarray(j.X), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.pred_stds.numpy(), np.asarray(j.pred_stds), rtol=1e-4)
    np.testing.assert_array_equal(t.diagnostics.n_corr.numpy(),
                                  np.asarray(j.diagnostics.n_corr))
    assert t.diagnostics.n_corr.numpy()[-1] > 500
    np.testing.assert_allclose(t.X.numpy()[:3], X_TRUE[:3], atol=0.05)
    assert math.isfinite(float(t.Q.sum()))
