"""The port's keyframe odometry and keyframe block map against the JAX
package's (``icet_tpu/keyframe.py``).

The block-map operations take the JAX package's own uniforms
(``jax.random.uniform`` of the same keys), so their results must agree
exactly: the stratified draw's row indices and the inserted points to
float32 rounding of the transform (2e-5 m at these ranges).  The solves
run on a 25x8 grid against 256-column sweeps (25 bins are coprime with 256
columns, so no column sits on a bin edge) and are held as
tests/test_torch_solver.py holds a registration: X to 1e-4, pred_stds and
Q to 1e-3 relative (float32 sums in another order through a composed
covariance), health and spawn decisions equal.  Trajectories of the host
loop: keyframe indices and flags equal, T_world within 1e-3 m.  Map
CONTENTS are drawn from each package's own generator and compared only by
their counts.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu import keyframe as jkf
from icet_tpu.config import BlockMapConfig as JBlockMap
from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.config import KeyframeConfig as JKeyframe
from icet_tpu.datasets.replay import SyntheticTrajectorySource
from icet_tpu.solver import prepare_reference_jit
from icet_tpu_torch import keyframe as tkf
from icet_tpu_torch.config import BlockMapConfig, KeyframeConfig
from icet_tpu_torch.convert import (
    blockmap_from_numpy,
    blockmap_to_numpy,
    config_from_icet,
    voxel_model_from_numpy,
)

torch.set_num_threads(2)

CFG = JConfig(n_theta=25, n_phi=8, phi_min=math.pi / 3, phi_max=2 * math.pi / 3,
              n_iters=4, min_pts=15, min_range=1.0)
TCFG = config_from_icet(dataclasses.asdict(CFG))
KF = dict(spawn_distance=0.5, spawn_angle=0.15, delta_clamp=2.0)
BM = dict(n_blocks=3, block_capacity=2048, points_per_scan=400)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_bm(bm) -> dict:
    return {k: np.asarray(v) for k, v in bm._asdict().items()}


def _assert_bm_equal(tbm, jbm, atol=2e-5):
    got, want = blockmap_to_numpy(tbm), _np_bm(jbm)
    assert int(got["n_blocks"]) == int(want["n_blocks"])
    assert int(got["cursor"]) == int(want["cursor"])
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["poses"], want["poses"])
    np.testing.assert_allclose(got["points"], want["points"], rtol=0, atol=atol)


@pytest.fixture(scope="module")
def drive():
    src = SyntheticTrajectorySource(n_frames=6, speed=0.3, yaw_rate=0.02,
                                    n_beams=32, n_azimuth=256)
    return [(s.astype(np.float32), T) for s, T in src]


def test_np_pose_helpers_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(5):
        X = rng.uniform(-1, 1, 6)
        np.testing.assert_array_equal(tkf.np_pose_matrix(X), jkf.np_pose_matrix(X))
        T = tkf.np_pose_matrix(X)
        np.testing.assert_array_equal(tkf.np_pose_to_state(T), jkf.np_pose_to_state(T))
        np.testing.assert_allclose(tkf.np_pose_to_state(T), X, atol=1e-12)


def test_blockmap_insert_spawn_evict_match_jax():
    jcfg = JBlockMap(n_blocks=2, block_capacity=256, points_per_scan=100)
    tcfg = BlockMapConfig(n_blocks=2, block_capacity=256, points_per_scan=100)
    scan = (np.random.default_rng(0).normal(size=(500, 3)) * 5 + 10.0).astype(np.float32)
    scan[::7] = 0.05  # range-gated rows are write-masked
    X_rel = np.array([0.3, -0.2, 0.1, 0.02, -0.01, 0.05], np.float32)
    jbm, tbm = jkf.blockmap_init(jcfg), tkf.blockmap_init(tcfg)

    def insert(jbm, tbm, i, enabled=True):
        key = jax.random.PRNGKey(i)
        u = np.asarray(jax.random.uniform(key, (jcfg.points_per_scan,)))
        jbm = jkf._blockmap_insert(jbm, jnp.asarray(scan), jnp.asarray(X_rel), key, jcfg, 0.2,
                                   enabled=enabled)
        tbm = tkf._blockmap_insert(tbm, _t(scan), _t(X_rel), _t(u), tcfg, 0.2, enabled=enabled)
        return jbm, tbm

    # Before any spawn: dropped, but the cursor moves, as in the JAX package.
    jbm, tbm = insert(jbm, tbm, 0)
    _assert_bm_equal(tbm, jbm)
    assert int(tbm.valid.sum()) == 0 and tbm.cursor == 100

    def spawn(jbm, tbm, v):
        pose = np.full(6, v, np.float32)
        return jkf._blockmap_spawn(jbm, jnp.asarray(pose)), tkf._blockmap_spawn(tbm, _t(pose))

    # One block, filled past capacity (4 x 100 rows clipped to 256).
    jbm, tbm = spawn(jbm, tbm, 0.0)
    for i in range(4):
        jbm, tbm = insert(jbm, tbm, i + 1)
        _assert_bm_equal(tbm, jbm)
    assert tbm.cursor == 256 and 0 < int(tbm.valid.sum()) < 256
    jbm, tbm = insert(jbm, tbm, 9, enabled=False)
    _assert_bm_equal(tbm, jbm)
    # Blocks 1 and 2: the ring wraps and evicts block 0.
    jbm, tbm = spawn(jbm, tbm, 1.0)
    jbm, tbm = insert(jbm, tbm, 5)
    jbm, tbm = spawn(jbm, tbm, 2.0)
    _assert_bm_equal(tbm, jbm)
    assert tbm.n_blocks == 3 and int(tbm.valid[0].sum()) == 0


def test_blockmap_world_points_and_refresh_match_jax():
    jcfg = JBlockMap(n_blocks=4, block_capacity=512, points_per_scan=200)
    rng = np.random.default_rng(1)
    jbm = jkf.blockmap_init(jcfg)
    for k in range(3):
        jbm = jkf._blockmap_spawn(jbm, jnp.asarray(rng.uniform(-1, 1, 6).astype(np.float32)))
        jbm = jkf._blockmap_insert(jbm, jnp.asarray(rng.normal(size=(300, 3)).astype(np.float32)
                                                    * 3 + 5.0),
                                   jnp.zeros(6), jax.random.PRNGKey(k), jcfg, 0.2)
    tbm = blockmap_from_numpy(_np_bm(jbm))
    jp, jok = jkf.blockmap_world_points(jbm)
    tp, tok = tkf.blockmap_world_points(tbm)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=2e-5)

    states = rng.uniform(-1, 1, (3, 6)).astype(np.float32)
    jr = jkf.blockmap_refresh_poses(jbm, states)
    tr = tkf.blockmap_refresh_poses(tbm, states)
    np.testing.assert_array_equal(tr.poses.numpy(), np.asarray(jr.poses))
    np.testing.assert_allclose(tkf.blockmap_world_points(tr)[0].numpy(),
                               np.asarray(jkf.blockmap_world_points(jr)[0]), rtol=0, atol=2e-5)
    with pytest.raises(ValueError):
        tkf.blockmap_refresh_poses(tbm, states[:2])


@pytest.mark.parametrize("spawn", ["fixed", "auto"])
def test_keyframe_step_matches_jax(drive, spawn):
    """One step from a keyframe at frame 0 to frame 2, with a nonzero
    prediction and a latched health baseline."""
    jkcfg = JKeyframe(spawn=spawn, **KF)
    tkcfg = KeyframeConfig(spawn=spawn, **KF)
    jbcfg, tbcfg = JBlockMap(**BM), BlockMapConfig(**BM)
    scan0, scan = drive[0][0], drive[2][0]
    jmodel = prepare_reference_jit(jnp.asarray(scan0), CFG)
    tmodel = voxel_model_from_numpy({k: np.asarray(v) for k, v in jmodel._asdict().items()})
    x_prev = np.array([0.3, 0.0, 0.0, 0.0, 0.0, -0.02], np.float32)
    d_prev = np.array([0.28, 0.01, 0.0, 0.0, 0.0, -0.015], np.float32)
    health0 = np.array([60.0, 0.01], np.float32)
    key = jax.random.PRNGKey(4)
    u = np.asarray(jax.random.uniform(key, (BM["points_per_scan"],)))
    jbm = jkf._blockmap_spawn(jkf.blockmap_init(jbcfg), jnp.zeros(6, jnp.float32))
    tbm = blockmap_from_numpy(_np_bm(jbm))

    jres, jX, jd, jdiv, jspawn, jh, jbm = jkf.keyframe_step_jit(
        jmodel, jbm, jnp.asarray(scan), jnp.asarray(x_prev), jnp.asarray(d_prev), key,
        jnp.asarray(health0), CFG, jkcfg, jbcfg)
    tres, tX, td, tdiv, tspawn, th, tbm = tkf.keyframe_step(
        tmodel, tbm, _t(scan), _t(x_prev), _t(d_prev), _t(u), _t(health0), TCFG, tkcfg, tbcfg)

    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tres.X.numpy(), np.asarray(jres.X), rtol=0, atol=1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tres.pred_stds.numpy(), np.asarray(jres.pred_stds), rtol=1e-3)
    Q = np.asarray(jres.Q)
    np.testing.assert_allclose(tres.Q.numpy(), Q, rtol=0, atol=1e-3 * np.abs(Q).max())
    assert bool(tdiv) == bool(jdiv) is False
    assert tspawn == bool(jspawn)
    assert th[0].item() == float(jh[0]) > 0
    np.testing.assert_allclose(th[1].item(), float(jh[1]), rtol=1e-3)
    _assert_bm_equal(tbm, jbm, atol=1e-4)


def test_keyframe_odometry_matches_jax(drive):
    scans = [s for s, _ in drive]
    jkf_cfg, jbm_cfg = JKeyframe(**KF), JBlockMap(**BM)
    want_odo = jkf.KeyframeOdometry(CFG, jkf_cfg, jbm_cfg)
    want = want_odo.run(scans)
    odo = tkf.KeyframeOdometry(TCFG, KeyframeConfig(**KF), BlockMapConfig(**BM), device="cpu")
    got = odo.run(scans)
    assert len(got) == len(want) == len(scans) - 1
    assert odo.keyframe_indices == want_odo.keyframe_indices
    assert 2 <= len(odo.keyframe_indices) < len(scans)  # the drive spawns keyframes
    for g, w in zip(got, want):
        assert (g.index, g.is_keyframe, g.diverged) == (w.index, w.is_keyframe, w.diverged)
        np.testing.assert_allclose(g.T_world, w.T_world, rtol=0, atol=1e-3)
        np.testing.assert_allclose(g.X, w.X, rtol=0, atol=1e-3)
        assert int(g.n_corr) == int(w.n_corr)
    np.testing.assert_allclose(np.stack(odo.keyframe_states),
                               np.stack(want_odo.keyframe_states), rtol=0, atol=1e-3)
    assert odo.blockmap.n_blocks == int(want_odo.blockmap.n_blocks)
    assert odo.map_points().shape[0] == int(np.asarray(want_odo.blockmap.valid).sum())

    # The device runner reproduces the host loop (blocks of 2 frames).
    frames, bm = tkf.run_keyframe_device(np.stack(scans), TCFG, KeyframeConfig(**KF),
                                         BlockMapConfig(**BM), block=2, device="cpu")
    for g, r in zip(frames, got):
        assert (g.index, g.is_keyframe, g.diverged, g.iterations) == (
            r.index, r.is_keyframe, r.diverged, r.iterations)
        np.testing.assert_allclose(g.X_rel, r.X_rel, rtol=0, atol=1e-6)
        np.testing.assert_allclose(g.T_world, r.T_world, rtol=0, atol=1e-6)
        np.testing.assert_allclose(g.pred_stds, r.pred_stds, rtol=1e-5)
    assert bm.n_blocks == odo.blockmap.n_blocks
    assert int(bm.valid.sum()) == int(odo.blockmap.valid.sum())


def test_auto_spawn_health_triggers_wired(drive):
    """tests/test_keyframe.py's wiring case on the port: an impossible
    stds-growth threshold spawns on every frame after each keyframe's
    first; "fixed" with the same loose backstops spawns on none."""
    loose = dict(spawn_distance=100.0, spawn_angle=3.0, delta_clamp=2.0)
    bm = BlockMapConfig(n_blocks=4, block_capacity=1024, points_per_scan=128)
    scans = [s for s, _ in drive[:5]]
    hair = tkf.KeyframeOdometry(TCFG, KeyframeConfig(spawn="auto", stds_growth=1e-6, **loose),
                                bm, device="cpu")
    assert [f.is_keyframe for f in hair.run(scans)] == [False, True, False, True]
    fixed = tkf.KeyframeOdometry(TCFG, KeyframeConfig(spawn="fixed", **loose), bm, device="cpu")
    assert not any(f.is_keyframe for f in fixed.run(scans))


def test_keyframe_delta_guard(drive):
    """An impossible clamp sends every frame to the prediction (and, as a
    divergence, to a spawn); the pipeline keeps running."""
    odo = tkf.KeyframeOdometry(TCFG, KeyframeConfig(delta_clamp=1e-4),
                               BlockMapConfig(n_blocks=4, block_capacity=1024,
                                              points_per_scan=128), device="cpu")
    frames = odo.run(s for s, _ in drive[:4])
    assert all(f.diverged and f.is_keyframe for f in frames)
    assert all(np.isfinite(f.T_world).all() for f in frames)
    np.testing.assert_array_equal(frames[0].X_rel, np.zeros(6, np.float32))


def test_dnn_mode_refused_by_device_runner(drive):
    with pytest.raises(NotImplementedError):
        tkf.run_keyframe_device(np.stack([s for s, _ in drive[:2]]),
                                TCFG.replace(dnn_filter=True), device="cpu")


def test_keyframe_step_dnn_matches_jax(drive, monkeypatch):
    """One DNN-filtered step at S = 32 (the s100 weights in both packages,
    the JAX encoder as its fused kernel in interpret mode), as
    tests/test_torch_dnn_odometry.py holds the filtered pipeline: X within
    2e-3 (a bf16 rounding can move a voxel across the filter's threshold),
    flags equal."""
    import icet_tpu.filters as jf
    import icet_tpu.models.bias_net as jbn
    from icet_tpu_torch.filters import model_voxel_samples
    from icet_tpu_torch.models.bias_net import load_pretrained

    plain = jbn.apply_bias_net
    monkeypatch.setattr(jbn, "apply_bias_net", lambda net, params, x, **kw: plain(
        net, params, x, fused=True, interpret=True))
    cfg = CFG.replace(dnn_filter=True, dnn_start_iter=3, dnn_sample_pts=32)
    tcfg = config_from_icet(dataclasses.asdict(cfg))
    jnet, jparams = jbn.load_pretrained(100)
    jbcfg, tbcfg = JBlockMap(**BM), BlockMapConfig(**BM)
    key_scan, scan = drive[0][0], drive[2][0]
    jmodel = prepare_reference_jit(jnp.asarray(key_scan), cfg)
    tmodel = voxel_model_from_numpy({k: np.asarray(v) for k, v in jmodel._asdict().items()})
    x_prev = np.array([0.3, 0.0, 0.0, 0.0, 0.0, -0.02], np.float32)
    key = jax.random.PRNGKey(4)
    u = np.asarray(jax.random.uniform(key, (BM["points_per_scan"],)))
    jbm = jkf._blockmap_spawn(jkf.blockmap_init(jbcfg), jnp.zeros(6, jnp.float32))
    tbm = blockmap_from_numpy(_np_bm(jbm))

    jres, jX, jd, jdiv, jspawn, jh, jbm = jkf.keyframe_step_dnn_jit(
        jmodel, jbm, jnp.asarray(scan), jnp.asarray(key_scan),
        jf.model_voxel_samples_jit(jmodel, jnp.asarray(key_scan), cfg),
        jnp.asarray(x_prev), jnp.asarray(x_prev), key, jnp.zeros(2, jnp.float32),
        cfg, JKeyframe(**KF), jbcfg, jnet, jparams)
    tkey = _t(key_scan)
    tres, tX, td, tdiv, tspawn, th, tbm = tkf.keyframe_step_dnn(
        tmodel, tbm, _t(scan), tkey, model_voxel_samples(tmodel, tkey, tcfg), _t(x_prev),
        _t(x_prev), _t(u), torch.zeros(2), tcfg, KeyframeConfig(**KF), tbcfg,
        load_pretrained(100))

    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=0, atol=2e-3)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=2e-3)
    assert bool(tdiv) == bool(jdiv) is False
    assert tspawn == bool(jspawn)
    assert tres.iterations >= 2 and th[0].item() == float(jh[0]) > 0
    np.testing.assert_array_equal(tbm.valid.numpy(), np.asarray(jbm.valid))
    assert tbm.cursor == int(jbm.cursor)
