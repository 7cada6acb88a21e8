"""The keyframe spawn decided on the device (``keyframe.keyframe_sequence_jit``)
on the CPU, where the frame's schedule runs as plain calls with its spawn
guard read on the host.

1. The compiled sequence runner equals the eager ``keyframe_sequence`` bit
   for bit over two blocks, the carry handed from one to the next: outputs,
   iterations, carry, model, the map's tables and its host counters, and
   the generator's state (both draw ``2 K`` uniforms a frame, the insert's
   then the spawn's).  At bench.py's ``KeyframeConfig`` on a 1 m a frame
   drive, a spawn every frame, no spawn, more spawns than blocks (the ring
   evicts) and a map sharded in two chunks.  The block reads once, the
   host writes nothing into the map, and the runner's host operations are
   those of the schedule.
2. The map-write stage: a chunk that does not hold the active block is left
   as it was; the one that does is opened and written as the eager spawn
   and insert write it; chunks on another device than the frame's take a
   copy of the staging there.
3. ``KeyframeOdometry``'s compiled step reads once a frame and writes
   nothing into the map from the host; its frames and map equal the eager
   functions chained with its semantics (``tests/eager_chains.py``); what
   it hands over equals the step's device outputs.
4. ``run_keyframe_device`` against the JAX package's, at
   tests/test_torch_compiled_keyframe.py's tolerances.
5. A mirror that disagrees with the block's keyframes raises.

25 azimuth bins against 256-column sweeps keep every point off the bin
edges (ROADMAP C1).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.datasets.replay import SyntheticTrajectorySource
from icet_tpu_torch import graphs
from icet_tpu_torch import keyframe as tkf
from icet_tpu_torch.config import BlockMapConfig, KeyframeConfig
from icet_tpu_torch.convert import config_from_icet
from tests import eager_chains

torch.set_num_threads(2)

CFG = JConfig(n_theta=25, n_phi=8, phi_min=math.pi / 3, phi_max=2 * math.pi / 3,
              n_iters=4, min_pts=15, min_range=1.0)
TCFG = config_from_icet(dataclasses.asdict(CFG))
#: bench.py:203-206
BENCH_KF = KeyframeConfig(spawn_distance=3.0, spawn_angle=0.3, delta_clamp=2.5)
BCFG = BlockMapConfig(n_blocks=4, block_capacity=2048, points_per_scan=500)

CASES = {
    "bench": (BENCH_KF, BCFG, False),
    "every_frame": (KeyframeConfig(delta_clamp=1e-4), BCFG, False),
    "no_spawn": (KeyframeConfig(spawn_distance=100.0, spawn_angle=3.0, delta_clamp=2.5), BCFG,
                 False),
    "evicting": (KeyframeConfig(delta_clamp=1e-4), BlockMapConfig(n_blocks=2, block_capacity=2048,
                                                                  points_per_scan=500), False),
    "sharded": (BENCH_KF, BCFG, True),
}


@pytest.fixture(scope="module")
def drive():
    src = SyntheticTrajectorySource(n_frames=10, speed=1.0, yaw_rate=0.02, n_beams=32,
                                    n_azimuth=256)
    return np.stack([s for s, _ in src]).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_equal(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a, b), what


def _whole(bm):
    return bm._replace(**{k: tkf.whole_table(getattr(bm, k)) for k in ("points", "valid",
                                                                        "poses")})


def _clone_bm(bm):
    return bm._replace(**{k: getattr(bm, k).clone() for k in ("points", "valid", "poses")})


def _shard(bm):
    from icet_tpu_torch.parallel.sharding import registration_mesh

    return tkf.shard_blockmap(bm, registration_mesh(2, 1, ["cpu"] * 2))


def _seeded(scan, bm_cfg, sharded):
    gen = torch.Generator().manual_seed(9)
    bm = tkf.blockmap_init(bm_cfg)
    if sharded:
        bm = _shard(bm)
    model, bm = tkf.keyframe_spawn(bm, _t(scan), torch.zeros(6),
                                   tkf._uniforms(gen, bm_cfg.points_per_scan, "cpu"), True, TCFG,
                                   bm_cfg)
    return model, bm, gen


def _run(compiled, drive, kf_cfg, bm_cfg, sharded):
    """Two blocks (frames 1-4, 5-9) from the same seed keyframe; returns the
    model, map, carry, outputs, iterations, generator and host operations
    of the blocks."""
    model, bm, gen = _seeded(drive[0], bm_cfg, sharded)
    z6 = torch.zeros(6)
    carry = (z6, z6, z6, torch.zeros(2), z6)
    outs, iters = [], []
    ops0 = dict(graphs.host_ops)
    for blk in (drive[1:5], drive[5:]):
        if compiled:
            (model, bm, c), o, it = tkf.keyframe_sequence_jit(
                _t(blk), model, bm, (*carry[:3], gen, *carry[3:]), TCFG, kf_cfg, bm_cfg,
                return_iterations=True)
            carry = (*c[:3], *c[4:])
        else:
            (model, bm, carry), o = tkf.keyframe_sequence(_t(blk), model, bm, carry, gen, TCFG,
                                                          kf_cfg, bm_cfg)
            d2, stds, world6, div, x2, n_corr, is_kf, it = o
            o = (d2, stds, world6, div, x2, is_kf, n_corr)
        outs.append(o)
        iters += [int(i) for i in it]
    ops = {k: graphs.host_ops[k] - ops0[k] for k in ops0}
    return model, bm, carry, outs, iters, gen, ops


@pytest.mark.parametrize("case", list(CASES))
def test_sequence_jit_equals_eager(drive, case):
    kf_cfg, bm_cfg, sharded = CASES[case]
    m_w, bm_w, c_w, o_w, i_w, gen_w, _ = _run(False, drive, kf_cfg, bm_cfg, sharded)
    m_g, bm_g, c_g, o_g, i_g, gen_g, ops = _run(True, drive, kf_cfg, bm_cfg, sharded)
    names = ("delta", "delta_stds", "world6", "diverged", "x_rel", "is_keyframe", "n_corr")
    for blk_g, blk_w in zip(o_g, o_w):
        for name, a, b in zip(names, blk_g, blk_w):
            _assert_equal(a, b.to(a.dtype), name)
    assert i_g == i_w
    for name, a, b in zip(m_w._fields, m_g, m_w):
        _assert_equal(a, b, name)
    for k in range(5):
        _assert_equal(c_g[k], c_w[k], f"carry[{k}]")
    assert isinstance(bm_g.points, tkf.BlockShards) == sharded
    for name in ("points", "valid", "poses"):
        _assert_equal(getattr(_whole(bm_g), name), getattr(_whole(bm_w), name), f"bm.{name}")
    assert (bm_g.n_blocks, bm_g.cursor) == (bm_w.n_blocks, bm_w.cursor)
    # Both routes drew 2 K uniforms a frame from the seed spawn's generator.
    ref = torch.Generator().manual_seed(9)
    tkf._uniforms(ref, bm_cfg.points_per_scan, "cpu")
    for _ in range(len(drive) - 1):
        tkf._uniforms(ref, 2 * bm_cfg.points_per_scan, "cpu")
    for gen in (gen_w, gen_g):
        _assert_equal(gen.get_state(), ref.get_state(), "generator state")
    # One read a block; the guard read on the host once a frame (the CPU
    # executor); one draw, one scan copy and one row copy a frame.
    frames = len(drive) - 1
    spawns = int(sum(int(o[5].sum()) for o in o_g))
    assert ops["block_reads"] == 2 and ops["spawn_reads"] == frames
    assert ops["draws"] == frames
    assert bm_g.n_blocks == 1 + spawns
    expect = {"bench": (2, frames - 1), "every_frame": (frames, frames),
              "no_spawn": (0, 0), "evicting": (frames, frames), "sharded": (2, frames - 1)}
    lo, hi = expect[case]
    assert lo <= spawns <= hi
    if case == "evicting":
        assert bm_g.n_blocks > bm_cfg.n_blocks
    if case == "sharded":
        # Both chunks hold written blocks.
        assert all(bool(c.any()) for c in bm_g.valid.chunks)
    mb = graphs.frame_graphs("cpu", drive.shape[1], TCFG).buffers.map
    assert mb.expect == tkf._map_state(bm_g) == tuple(mb.at.tolist())


@pytest.mark.parametrize("spawn", [False, True], ids=["insert", "spawn"])
@pytest.mark.parametrize("chunk", [0, 1, 2], ids=["before", "owner", "after"])
def test_map_write_stage_masks_chunks(drive, spawn, chunk):
    """Block 3 of a six-block map in three chunks of two: the middle chunk
    holds it."""
    rng = np.random.default_rng(3)
    bm_cfg = BlockMapConfig(n_blocks=6, block_capacity=256, points_per_scan=100)
    bm = tkf.blockmap_init(bm_cfg)._replace(n_blocks=3 if spawn else 4, cursor=0 if spawn else 40)
    bm.points.copy_(_t(rng.normal(size=bm.points.shape).astype(np.float32)))
    bm.valid.copy_(_t(rng.random(bm.valid.shape) < 0.5))
    bm.poses.copy_(_t(rng.normal(size=bm.poses.shape).astype(np.float32)))
    scan, X = _t(drive[1]), _t(np.array([0.2, 0.1, 0.0, 0.01, 0.0, 0.05], np.float32))
    u = torch.rand(100, generator=torch.Generator().manual_seed(7))
    pose = _t(np.array([1.0, 0.5, 0.0, 0.0, 0.0, 0.3], np.float32))
    want = _clone_bm(bm)
    if spawn:
        want = tkf._blockmap_spawn(want, pose)
        want = tkf._blockmap_insert(want, scan, torch.zeros(6), u, bm_cfg, TCFG.min_range)
    else:
        want = tkf._blockmap_insert(want, scan, X, u, bm_cfg, TCFG.min_range)
    mb = graphs.MapBuffers(6, 256, 100, "cpu")
    mb.at.copy_(torch.tensor(tkf._map_state(bm)))
    mb.su.copy_(u)
    if spawn:  # as _stage_spawn stages it, without the prepare
        mb.at[0].add_(1)
        mb.at[1].zero_()
        mb.spawn.fill_(True)
        mb.pose.copy_(pose)
        tkf._stage_insert(mb, scan, torch.zeros(6), TCFG.min_range, True, mb.su)
    else:
        mb.u.copy_(u)
        tkf._stage_insert(mb, scan, X, TCFG.min_range, True)
    got = _clone_bm(bm)
    rows = slice(2 * chunk, 2 * chunk + 2)
    mb.tables = (got.points[rows], got.valid[rows], got.poses[rows])
    tkf._stage_write(mb, 2 * chunk)
    for name in ("points", "valid", "poses"):
        a, w, old = (getattr(t, name)[rows] for t in (got, want, bm))
        _assert_equal(a, w if chunk == 1 else old, name)
    assert not torch.equal(want.valid[2:4], bm.valid[2:4])


@pytest.mark.parametrize("spawn", [False, True], ids=["insert", "spawn"])
def test_write_map_copies_the_staging_to_another_device(drive, spawn):
    """A frame set on another device than the map's chunks (``cpu:0``
    against ``cpu``): each chunk takes a copy of the packed staging into
    its own device's set and replays that set's map-write stage; the
    sharded map equals the eager spawn and insert's."""
    bm_cfg = BlockMapConfig(n_blocks=6, block_capacity=256, points_per_scan=100)
    bm = tkf.blockmap_init(bm_cfg)._replace(n_blocks=3 if spawn else 4, cursor=0 if spawn else 40)
    scan, X = _t(drive[1]), _t(np.array([0.2, 0.1, 0.0, 0.01, 0.0, 0.05], np.float32))
    u = torch.rand(100, generator=torch.Generator().manual_seed(7))
    pose = _t(np.array([1.0, 0.5, 0.0, 0.0, 0.0, 0.3], np.float32))
    want = _clone_bm(bm)
    if spawn:
        want = tkf._blockmap_spawn(want, pose)
        want = tkf._blockmap_insert(want, scan, torch.zeros(6), u, bm_cfg, TCFG.min_range)
    else:
        want = tkf._blockmap_insert(want, scan, X, u, bm_cfg, TCFG.min_range)
    fg = graphs.FrameGraphs(torch.device("cpu", 0), scan.shape[0], TCFG)
    mb = fg.map_buffers(6, 256, 100)
    mb.at.copy_(torch.tensor(tkf._map_state(bm)))
    mb.u.copy_(u)
    mb.su.copy_(u)
    if spawn:  # as _stage_spawn stages it, without the prepare
        mb.at[0].add_(1)
        mb.at[1].zero_()
        mb.spawn.fill_(True)
        mb.pose.copy_(pose)
        tkf._stage_insert(mb, scan, torch.zeros(6), TCFG.min_range, True, mb.su)
    else:
        tkf._stage_insert(mb, scan, X, TCFG.min_range, True)
    from icet_tpu_torch.parallel.sharding import registration_mesh

    got = tkf.shard_blockmap(_clone_bm(bm), registration_mesh(3, 1, ["cpu"] * 3))
    copies = graphs.host_ops["copies"]
    tkf._write_map(fg, got)
    other = graphs.frame_graphs("cpu", scan.shape[0], TCFG).buffers.map
    assert other is not mb and torch.equal(other.staging, mb.staging)
    assert graphs.host_ops["copies"] - copies == 3  # one staging copy a chunk
    for name in ("points", "valid", "poses"):
        _assert_equal(tkf.whole_table(getattr(got, name)), getattr(want, name), name)


@pytest.mark.parametrize("sharded", [False, True], ids=["whole", "sharded"])
def test_keyframe_odometry_reads_once_a_frame(drive, sharded):
    """The compiled frame reads its outputs once (``spawn_reads``) and the
    host issues no map write; the frames and map equal the eager chain's."""
    odo_g = tkf.KeyframeOdometry(TCFG, BENCH_KF, BCFG, device="cpu")
    if sharded:
        odo_g.blockmap = _shard(odo_g.blockmap)
    ops0 = dict(graphs.host_ops)
    got = odo_g.run(drive)
    ops = {k: graphs.host_ops[k] - ops0[k] for k in ops0}
    bm0 = tkf.blockmap_init(BCFG, "cpu")
    want, bm_w, keyframes = eager_chains.keyframe_odometry(
        _t(drive), TCFG, BENCH_KF, BCFG, blockmap=_shard(bm0) if sharded else bm0)
    assert ops["spawn_reads"] == len(drive) - 1
    assert 2 <= len(odo_g.keyframe_indices) < len(drive)
    assert odo_g.keyframe_indices == keyframes
    for g, w in zip(got, want):
        for name in ("X", "pred_stds", "T_world", "X_rel", "n_corr"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=name)
        assert (g.index, g.is_keyframe, g.diverged, g.iterations) == (
            w.index, w.is_keyframe, w.diverged, w.iterations)
    for name in ("points", "valid", "poses"):
        _assert_equal(getattr(_whole(odo_g.blockmap), name), getattr(_whole(bm_w), name),
                      f"bm.{name}")
    assert (odo_g.blockmap.n_blocks, odo_g.blockmap.cursor) == (bm_w.n_blocks, bm_w.cursor)


def test_step_hands_over_its_read(drive):
    """``host_out``: the step's one read, equal to its device outputs."""
    model, bm, gen = _seeded(drive[0], BCFG, False)
    z6 = torch.zeros(6)
    *step, host = tkf.keyframe_step_jit(model, bm, _t(drive[1]), z6, z6, gen, torch.zeros(2),
                                        TCFG, BENCH_KF, BCFG, host_out=True)
    res, X, delta, diverged, spawn, health, _ = step
    for name, t in (("X", X), ("delta", delta), ("pred_stds", res.pred_stds),
                    ("diverged", diverged), ("health", health), ("iterations", res.iterations)):
        np.testing.assert_array_equal(host[name], t.numpy(), err_msg=name)
    assert bool(host["spawn"]) is spawn
    assert len(tkf.keyframe_step_jit(model, bm, _t(drive[2]), X, delta, gen, health, TCFG,
                                     BENCH_KF, BCFG)) == 7


def test_mirror_disagreeing_with_the_block_raises(drive):
    """The block's end holds the device mirror to the keyframes it counted:
    a mirror that was not the host's raises (no silent repair)."""
    model, bm, gen = _seeded(drive[0], BCFG, False)
    z6 = torch.zeros(6)
    (model, bm, _), _ = tkf.keyframe_sequence_jit(
        _t(drive[1:3]), model, bm, (z6, z6, z6, gen, torch.zeros(2), z6), TCFG, BENCH_KF, BCFG)
    mb = graphs.frame_graphs("cpu", drive.shape[1], TCFG).buffers.map
    mb.at[0].fill_(3)  # the host still believes it holds its own value
    with pytest.raises(RuntimeError, match="mirror"):
        tkf.keyframe_sequence_jit(_t(drive[3:5]), model, bm, (z6, z6, z6, gen, torch.zeros(2),
                                                               z6), TCFG, BENCH_KF, BCFG)
    mb.expect = None


def test_run_keyframe_device_matches_jax(drive):
    """The port's ``run_keyframe_device`` (compiled, blocks of 3) against the
    JAX package's: keyframe indices and divergence flags equal, steps and
    poses to 1e-3 m (tests/test_torch_compiled_keyframe.py's
    ``test_keyframe_sequence_jit_matches_jax``); map contents come from
    each package's own random stream, their fill agrees in blocks."""
    from icet_tpu import keyframe as jkf
    from icet_tpu.config import BlockMapConfig as JBlockMap
    from icet_tpu.config import KeyframeConfig as JKeyframe

    jframes, jbm = jkf.run_keyframe_device(drive, CFG, JKeyframe(**dataclasses.asdict(BENCH_KF)),
                                           JBlockMap(**dataclasses.asdict(BCFG)), block=3)
    tframes, tbm = tkf.run_keyframe_device(drive, TCFG, BENCH_KF, BCFG, block=3, device="cpu")
    assert [f.index for f in tframes] == [f.index for f in jframes]
    assert [f.is_keyframe for f in tframes] == [f.is_keyframe for f in jframes]
    assert any(f.is_keyframe for f in tframes)
    assert [f.diverged for f in tframes] == [f.diverged for f in jframes]
    for t, j in zip(tframes, jframes):
        np.testing.assert_allclose(t.X, j.X, rtol=0, atol=1e-3)
        np.testing.assert_allclose(t.X_rel, j.X_rel, rtol=0, atol=1e-3)
        np.testing.assert_allclose(t.T_world, j.T_world, rtol=0, atol=1e-3)
        assert int(t.n_corr) == int(j.n_corr)
    assert (tbm.n_blocks, tbm.cursor) == (int(jbm.n_blocks), int(jbm.cursor))
