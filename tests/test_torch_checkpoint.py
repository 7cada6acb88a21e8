"""The port's runner checkpoints (``icet_tpu_torch/utils/checkpoint.py``):
resume as tests/test_utils.py resumes the JAX package's runners, and state
carried across from the JAX package.

An odometry or map checkpoint written by the JAX package loads into the
port, which continues to the trajectory the JAX package's resumed runner
takes (within the solver parity tolerance of tests/test_torch_solver.py:
X to 1e-4).  A keyframe checkpoint's random stream is package-specific:
the port refuses the JAX package's uint32 key and names the entry.  25
azimuth bins against 128- and 256-column sweeps keep points off the bin
edges.
"""

import dataclasses

import numpy as np
import pytest
import torch

from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.config import MapConfig as JMapConfig
from icet_tpu.datasets.synthetic import simulate_scan
from icet_tpu.mapping import MapMaker as JMapMaker
from icet_tpu.odometry import OdometryPipeline as JPipeline
from icet_tpu.utils import checkpoint as jck
from icet_tpu_torch.config import KeyframeConfig, MapConfig
from icet_tpu_torch.convert import config_from_icet
from icet_tpu_torch.keyframe import KeyframeOdometry
from icet_tpu_torch.mapping import MapMaker
from icet_tpu_torch.odometry import OdometryPipeline
from icet_tpu_torch.utils.checkpoint import (
    keyframe_state,
    load_checkpoint,
    map_state,
    odometry_state,
    restore_keyframe,
    restore_map,
    restore_odometry,
    save_checkpoint,
)

torch.set_num_threads(2)

JCFG = JConfig(n_theta=25, n_phi=8, phi_min=np.pi / 3, phi_max=2 * np.pi / 3, n_iters=3,
               min_pts=10, min_range=1.0)
CFG = config_from_icet(dataclasses.asdict(JCFG))


def _scans(n, step=0.2, seed=None, n_beams=16, n_azimuth=128):
    return [np.asarray(simulate_scan(pose_t=np.array([step * i, 0, 0]),
                                     seed=i if seed is None else seed,
                                     n_beams=n_beams, n_azimuth=n_azimuth), np.float32)
            for i in range(n)]


def test_odometry_checkpoint_resume(tmp_path):
    scans = _scans(4)
    pipe = OdometryPipeline(CFG, device="cpu")
    for s in scans[:2]:
        pipe.step(s)
    p = str(tmp_path / "odo.npz")
    save_checkpoint(p, odometry_state(pipe))
    pipe2 = OdometryPipeline(CFG, device="cpu")
    restore_odometry(pipe2, load_checkpoint(p))
    np.testing.assert_array_equal(pipe2.trajectory_pose, pipe.trajectory_pose)
    assert pipe2._index == pipe._index
    # The mirrors hold the restored pose: a recovery before the first
    # post-resume frame does not snap back to the origin.
    np.testing.assert_array_equal(pipe2._T_host, pipe.trajectory_pose)
    assert pipe2.step(scans[2]) is None  # re-seed
    f = pipe2.step(scans[3])
    assert f is not None and np.isfinite(f.X).all()


def test_jax_odometry_checkpoint_resumes_in_port(tmp_path):
    """A checkpoint the JAX package wrote resumes in the port, which then
    follows the JAX package's resumed trajectory."""
    scans = _scans(6, step=0.25, seed=7, n_beams=32, n_azimuth=256)
    jpipe = JPipeline(JCFG)
    for s in scans[:3]:
        jpipe.step(s)
    p = str(tmp_path / "jax_odo")
    jck.save_checkpoint(p, jck.odometry_state(jpipe))
    jres = JPipeline(JCFG)
    jck.restore_odometry(jres, jck.load_checkpoint(p))
    port = OdometryPipeline(CFG, device="cpu")
    restore_odometry(port, load_checkpoint(p))
    np.testing.assert_array_equal(port.trajectory_pose, np.asarray(jres.trajectory_pose))
    want = [f for f in (jres.step(s) for s in scans[3:]) if f is not None]
    got = [f for f in (port.step(s) for s in scans[3:]) if f is not None]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.index == w.index
        np.testing.assert_allclose(g.X, w.X, rtol=0, atol=1e-4)
        np.testing.assert_allclose(g.T_world, w.T_world, rtol=0, atol=1e-4)
    # The port's checkpoint of the resumed run has the JAX package's keys.
    q = str(tmp_path / "port_odo")
    save_checkpoint(q, odometry_state(port))
    back = jck.load_checkpoint(q)
    assert sorted(back) == sorted(jck.odometry_state(jres))
    np.testing.assert_allclose(back["T_world"], np.asarray(jres.trajectory_pose), atol=1e-4)


MAP = dict(capacity=5000, points_per_scan=500)


def test_map_checkpoint_resume(tmp_path):
    mcfg = MAP
    scans = _scans(2, step=0.0)
    mm = MapMaker(CFG, MapConfig(**mcfg), device="cpu")
    for s in scans:
        mm.step(s)
    p = str(tmp_path / "map.npz")
    save_checkpoint(p, map_state(mm))
    mm2 = MapMaker(CFG, MapConfig(**mcfg), device="cpu")
    restore_map(mm2, load_checkpoint(p))
    np.testing.assert_array_equal(mm2.map_points(), mm.map_points())
    np.testing.assert_array_equal(mm2.snail_trail(), mm.snail_trail())
    assert mm2._index == mm._index and mm2.state.write_ptr == mm.state.write_ptr


@pytest.mark.slow
def test_jax_map_checkpoint_resumes_in_port(tmp_path):
    mcfg = MAP
    scans = _scans(2, step=0.0)
    jmm = JMapMaker(JCFG, JMapConfig(**mcfg))
    for s in scans:
        jmm.step(s)
    q = str(tmp_path / "jax_map")
    jck.save_checkpoint(q, jck.map_state(jmm))
    mm3 = MapMaker(CFG, MapConfig(**mcfg), device="cpu")
    restore_map(mm3, load_checkpoint(q))
    np.testing.assert_array_equal(mm3.map_points(), jmm.map_points())
    np.testing.assert_array_equal(mm3.snail_trail(), jmm.snail_trail())
    assert mm3.step(scans[0]) is None  # re-seeds the model
    assert mm3.step(scans[1]).n_map_points > jmm.map_points().shape[0]


def test_keyframe_checkpoint_resume(tmp_path):
    kf_cfg = KeyframeConfig(spawn_distance=0.5, delta_clamp=2.0)
    scans = _scans(6, step=0.3, seed=7, n_beams=32, n_azimuth=256)
    ko = KeyframeOdometry(CFG, kf_cfg, device="cpu")
    frames = [ko.step(s) for s in scans[:4]]
    T_mid = frames[-1].T_world
    p = str(tmp_path / "kf.npz")
    save_checkpoint(p, keyframe_state(ko))
    state = load_checkpoint(p)
    assert state["key"].dtype == np.uint8
    ko2 = KeyframeOdometry(CFG, kf_cfg, device="cpu")
    restore_keyframe(ko2, state)
    assert ko2._index == ko._index
    torch.testing.assert_close(ko2.blockmap.points, ko.blockmap.points, rtol=0, atol=0)
    assert ko2.blockmap.n_blocks == ko.blockmap.n_blocks
    assert ko2.keyframe_indices == ko.keyframe_indices
    assert torch.equal(ko2._gen.get_state(), ko._gen.get_state())
    # The first scan after the resume re-seeds a keyframe at the restored
    # pose, then odometry goes on; that frame's own motion is not
    # registered, so the trajectory lags the truth by one step (0.3 m).
    assert ko2.step(scans[4]) is None
    np.testing.assert_allclose(ko2._T_key, T_mid, atol=0.05)
    f5 = ko2.step(scans[5])
    assert f5 is not None and not f5.diverged
    np.testing.assert_allclose(f5.T_world[0, 3], 1.2, atol=0.1)


def test_keyframe_checkpoint_refuses_a_jax_key(tmp_path):
    import jax

    ko = KeyframeOdometry(CFG, KeyframeConfig(delta_clamp=2.0), device="cpu")
    for s in _scans(2):
        ko.step(s)
    state = keyframe_state(ko)
    state["key"] = np.asarray(jax.random.PRNGKey(0))  # the JAX package's entry
    with pytest.raises(ValueError, match="'key'"):
        restore_keyframe(KeyframeOdometry(CFG, device="cpu"), state)
