"""Full-width parity of the port with the JAX package: the 75x24 grid
(V = 1,800) on 65,536-point 64x1024 city-drive frames, the main path's
size.  75 azimuth bins against a 1024-column sweep keep every point off the
bin edges.  Tolerances as in tests/test_torch_solver.py (early exit: X
within 1e-4); moment sums hold the count column exact and the rest to
atol 2e-3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu import solver as js
from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.datasets.replay import CityDriveSource
from icet_tpu_torch import solver as ts
from icet_tpu_torch.convert import config_from_icet
from icet_tpu_torch.ops.fused_moments import fused_moment_sums_reference

torch.set_num_threads(2)

CFG = JConfig(n_iters=7, convergence_tol=1e-4, convergence_stat_scale=1.0)


@pytest.mark.slow
def test_full_width_frame_pair():
    scans = [s for s, _ in CityDriveSource(n_frames=2, speed=1.0, n_beams=64,
                                            n_azimuth=1024)]
    tcfg = config_from_icet(dataclasses.asdict(CFG))
    jm = js.prepare_reference_jit(jnp.asarray(scans[0]), CFG)
    tm = ts.prepare_reference(torch.from_numpy(scans[0]), tcfg)
    np.testing.assert_array_equal(tm.count.numpy(), np.asarray(jm.count))
    np.testing.assert_array_equal(tm.valid.numpy(), np.asarray(jm.valid))
    # bf16-rounded anchors: an ulp of float32 difference in sin/cos can
    # round to the neighbouring bf16 value (2^-8 relative).
    np.testing.assert_allclose(tm.anchors.numpy(), np.asarray(jm.anchors),
                               rtol=2**-7, atol=1e-5)
    np.testing.assert_allclose(tm.bounds.numpy(), np.asarray(jm.bounds), rtol=0, atol=1e-5)

    X = np.array([1.0, 0.05, 0.0, 0.0, 0.0, 0.02], np.float32)
    want = np.asarray(js._jnp_sums(jnp.asarray(scans[1]), jnp.asarray(X), jm.bounds,
                                   jm.anchors, CFG))
    got = fused_moment_sums_reference(
        torch.from_numpy(scans[1]), torch.from_numpy(X),
        torch.from_numpy(np.array(jm.bounds)), torch.from_numpy(np.array(jm.anchors)),
        tcfg).numpy()
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, :10], want[:, :10], rtol=0, atol=2e-3)

    j = js.register_pair(jnp.asarray(scans[0]), jnp.asarray(scans[1]),
                         jnp.zeros(6, jnp.float32), CFG)
    t = ts.register_pair(scans[0], scans[1], np.zeros(6), tcfg, device="cpu")
    np.testing.assert_allclose(t.X.numpy(), np.asarray(j.X), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.pred_stds.numpy(), np.asarray(j.pred_stds), rtol=1e-3)
    np.testing.assert_array_equal(t.diagnostics.n_corr.numpy(),
                                  np.asarray(j.diagnostics.n_corr))


@pytest.mark.slow
def test_full_width_keyframe_drive():
    """The keyframe runner at bench.py's keyframe config on the first 6
    frames of the 64x1024 drive: keyframe flags equal to the JAX package's
    host loop, world poses within 1e-3 m."""
    from icet_tpu import keyframe as jkf
    from icet_tpu.config import BlockMapConfig as JBlockMap
    from icet_tpu.config import KeyframeConfig as JKeyframe
    from icet_tpu_torch.config import BlockMapConfig, KeyframeConfig
    from icet_tpu_torch.keyframe import run_keyframe_device

    kf = dict(spawn_distance=3.0, spawn_angle=0.3, delta_clamp=2.5)
    scans = np.stack([s for s, _ in CityDriveSource(n_frames=6, speed=1.0, n_beams=64,
                                                     n_azimuth=1024)])
    want = jkf.KeyframeOdometry(CFG, JKeyframe(**kf), JBlockMap()).run(iter(scans))
    got, bm = run_keyframe_device(scans, config_from_icet(dataclasses.asdict(CFG)),
                                  KeyframeConfig(**kf), BlockMapConfig(), device="cpu")
    assert [g.is_keyframe for g in got] == [w.is_keyframe for w in want]
    assert any(g.is_keyframe for g in got) and not any(g.diverged for g in got)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.T_world, w.T_world, rtol=0, atol=1e-3)
    assert bm.n_blocks == 1 + sum(g.is_keyframe for g in got)
