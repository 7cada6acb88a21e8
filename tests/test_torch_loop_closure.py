"""Loop closure in the port (``pose_graph.close_loops``) against
``icet_tpu.pose_graph.close_loops`` on the CPU, and the whole loop-closure
drive of ``tests/test_citydrive.py`` on the port.

The small drive is a ring of the city block at 4 m a frame (48x512 scans,
one lap in about 40 frames); the grid has 47 azimuth bins, prime against
the sweep's 512 columns.  Candidates come from the ground-truth positions,
warm-started at the true relative pose plus a fixed perturbation, and one
candidate is given a warm start 3 m and 0.3 rad off, which fails the
``|dx| <= 0.05`` gate in both packages (its last step is 0.41 m in the JAX
package).  The other candidates end with last steps below 1e-3 m there:
far from the gate on purpose, since a pair whose last step sits at the gate
can be kept by one package and dropped by the other on one ulp.  Tolerances: X within 1e-4 (the solver tests' early-exit
tolerance, the looser of the two), information within 1e-3 of its largest
entry.
"""

import dataclasses

import numpy as np
import pytest
import torch

from icet_tpu import pose_graph as jp
from icet_tpu.config import ICETConfig as JConfig
from icet_tpu_torch import pose_graph as tp
from icet_tpu_torch.convert import config_from_icet
from icet_tpu_torch.datasets.replay import CityDriveSource
from icet_tpu_torch.datasets.synthetic import Scene
from icet_tpu_torch.keyframe import np_pose_to_state

torch.set_num_threads(2)

CFG = JConfig(n_theta=47, n_phi=16, phi_min=np.pi / 3, phi_max=2 * np.pi / 3, n_iters=6,
              min_pts=20, min_range=1.0)
BAD = (3, 43)


@pytest.fixture(scope="module")
def ring():
    src = CityDriveSource(n_frames=52, speed=4.0, scene=Scene(), rect=(-24, 24, -19, 19),
                          n_beams=48, n_azimuth=512)
    scans, gt = zip(*list(src))
    ref = [np.linalg.inv(gt[0]) @ T for T in gt]
    cands = tp.detect_loop_candidates(np.stack([T[:3, 3] for T in ref]), 6.0, 20)[:8]
    assert BAD in cands
    rng = np.random.default_rng(0)
    x0 = {}
    for i, j in cands:
        x = np_pose_to_state(np.linalg.inv(ref[i]) @ ref[j]).astype(np.float32)
        x0[(i, j)] = x + np.concatenate([rng.normal(0, 0.1, 3),
                                         rng.normal(0, 0.005, 3)]).astype(np.float32)
    x0[BAD] = x0[BAD] + np.array([3.0, 0, 0, 0, 0, 0.3], np.float32)
    return list(scans), cands, x0


@pytest.mark.slow
def test_close_loops_matches_jax(ring):
    scans, cands, x0 = ring
    want = jp.close_loops(scans, cands, CFG, x0_fn=lambda i, j: x0[(i, j)])
    got = tp.close_loops(scans, cands, config_from_icet(dataclasses.asdict(CFG)),
                         x0_fn=lambda i, j: x0[(i, j)], device="cpu")
    assert [(i, j) for i, j, _, _ in got] == [(i, j) for i, j, _, _ in want]
    assert len(got) == len(cands) - 1 and BAD not in [(i, j) for i, j, _, _ in got]
    for (_, _, tx, ti), (_, _, jx, ji) in zip(got, want):
        np.testing.assert_allclose(tx, np.asarray(jx), rtol=0, atol=1e-4)
        ji = np.asarray(ji)
        np.testing.assert_allclose(ti, ji, rtol=0, atol=1e-3 * np.abs(ji).max())
        assert tx.dtype == np.float32 and ti.shape == (6, 6)


def test_close_loops_gate_and_empty(ring):
    scans, cands, x0 = ring
    cfg = config_from_icet(dataclasses.asdict(CFG))
    assert tp.close_loops(scans, [], cfg, device="cpu") == []
    # The last |dx| decides: the bad warm start keeps moving.
    res = tp.register(tp.prepare_reference(torch.from_numpy(scans[BAD[0]]), cfg),
                      torch.from_numpy(scans[BAD[1]]), torch.from_numpy(x0[BAD]), cfg,
                      want_static_mask=False)
    assert float(res.diagnostics.dx_norm[-1]) > 2 * tp.LOOP_DX_GATE
    assert tp.close_loops(scans, [BAD], cfg, x0_fn=lambda i, j: x0[(i, j)], device="cpu") == []


@pytest.mark.slow
def test_citydrive_loop_closure_on_the_port():
    """``tests/test_citydrive.py``'s drive and gates, through the port on
    the CPU: odometry, loop detection on the estimated trajectory,
    verification, and the block-sparse refinement."""
    from icet_tpu_torch.config import ICETConfig, OdometryConfig
    from icet_tpu_torch.odometry import OdometryPipeline
    from icet_tpu_torch.utils.metrics import ate_rmse, rpe

    src = CityDriveSource(n_frames=250, speed=1.0, scene=Scene(), rect=(-24, 24, -19, 19),
                          n_beams=48, n_azimuth=512)
    scans, gt = zip(*list(src))
    cfg = ICETConfig(n_theta=48, n_phi=16, phi_min=np.pi / 3, phi_max=2 * np.pi / 3,
                     n_iters=6, min_pts=20, min_range=1.0)
    pipe = OdometryPipeline(cfg, OdometryConfig(divergence_clamp=2.5), device="cpu")
    frames = [f for f in (pipe.step(s) for s in scans) if f is not None]
    assert len(frames) == len(scans) - 1 and not any(f.diverged for f in frames)
    est = [np.eye(4)] + [f.T_world for f in frames]
    ref = [np.linalg.inv(gt[0]) @ T for T in gt]
    ate_odo = ate_rmse(est, ref)
    t_err, r_err = rpe(est, ref)
    assert ate_odo < 0.35 and t_err.mean() < 0.01 and np.degrees(r_err.mean()) < 0.05

    cands = tp.detect_loop_candidates(np.stack([T[:3, 3] for T in est]), radius=6.0,
                                      min_gap=80)
    assert len(cands) >= 30

    def x0_fn(i, j):
        return np_pose_to_state(np.linalg.inv(est[i]) @ est[j]).astype(np.float32)

    loops = tp.close_loops(list(scans), cands, cfg, x0_fn=x0_fn, device="cpu")
    assert len(loops) >= 30, len(loops)
    states0, graph = tp.graph_from_odometry(frames, loop_factors=loops)
    opt = tp.optimize_poses_sparse(states0, graph, 10, 50, device="cpu")
    ate_ref = ate_rmse(list(tp.states_to_poses(opt)), ref)
    assert ate_ref < ate_odo and ate_ref < 0.15, (ate_ref, ate_odo)

