"""The port's copy of the trajectory metrics (``utils/metrics.py``, numpy)
against ``icet_tpu/utils/metrics.py``: ATE, RPE and the TUM export are
equal on the same poses; ``FrameMetrics`` reads the port's
``RegistrationResult`` as the JAX package's reads the same numbers."""

import dataclasses
import io
import json
import types

import numpy as np
import pytest
import torch

from icet_tpu.utils import metrics as jm
from icet_tpu_torch import solver as ts
from icet_tpu_torch.config import ICETConfig
from icet_tpu_torch.datasets.synthetic import scan_pair_with_ground_truth
from icet_tpu_torch.keyframe import np_pose_matrix
from icet_tpu_torch.utils import metrics as tm

torch.set_num_threads(2)


def _trajectory(seed, n=12):
    rng = np.random.default_rng(seed)
    T, out = np.eye(4), []
    for _ in range(n):
        X = np.concatenate([rng.normal(0, 1, 3), rng.normal(0, 0.05, 3)])
        T = T @ np_pose_matrix(X)
        out.append(T.copy())
    return out


@pytest.mark.parametrize("delta", [1, 3])
def test_ate_rpe_equal(delta):
    est, ref = _trajectory(0), _trajectory(1)
    assert tm.ate_rmse(est, ref) == jm.ate_rmse(est, ref)
    for a, b in zip(tm.rpe(est, ref, delta), jm.rpe(est, ref, delta)):
        np.testing.assert_array_equal(a, b)


def test_save_tum_equal(tmp_path):
    poses = _trajectory(2) + [np.diag([-1.0, -1.0, 1.0, 1.0])]  # a trace <= 0 rotation
    tm.save_tum(str(tmp_path / "port.tum"), poses, times=np.arange(len(poses)) * 0.1)
    jm.save_tum(str(tmp_path / "jax.tum"), poses, times=np.arange(len(poses)) * 0.1)
    assert (tmp_path / "port.tum").read_text() == (tmp_path / "jax.tum").read_text()


def test_frame_metrics_from_port_result():
    """The port's record of its own result equals the JAX package's record
    of the same numbers (the result's fields as numpy arrays)."""
    cfg = ICETConfig(n_theta=25, n_phi=8, phi_min=np.pi / 3, phi_max=2 * np.pi / 3, n_iters=4,
                     min_pts=15, min_range=1.0)
    s1, s2 = scan_pair_with_ground_truth(np.array([0.3, -0.1, 0.02, 0.01, -0.01, 0.03]),
                                         seed=3, n_beams=32, n_azimuth=256)
    res = ts.register_pair(s1, s2, np.zeros(6, np.float32), cfg, device="cpu")
    as_np = types.SimpleNamespace(
        X=res.X.numpy(), pred_stds=res.pred_stds.numpy(),
        diagnostics=types.SimpleNamespace(
            **{k: v.numpy() for k, v in res.diagnostics._asdict().items()}))
    got = tm.FrameMetrics.from_result(7, res, solve_ms=1.5, diverged=False)
    want = jm.FrameMetrics.from_result(7, as_np, solve_ms=1.5, diverged=False)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_corr > 20 and not got.windowed_fallback
    buf = io.StringIO()
    log = tm.MetricsLog(buf)
    log.log(got)
    assert json.loads(buf.getvalue()) == dataclasses.asdict(got)
    assert log.records == [got]
