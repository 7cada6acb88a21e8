"""The port's compiled keyframe path (``keyframe.keyframe_step_jit``,
``keyframe_step_dnn_jit``, ``keyframe_spawn_jit``, ``keyframe_sequence_jit``;
``KeyframeOdometry`` and ``run_keyframe_device`` on it) on the CPU, where
its capture-safe stages run as plain calls on the static buffers of
``icet_tpu_torch.graphs``.

1. The insert staged on the device (slot and cursor from the device
   mirror, a row and a write flag for every candidate sample) and applied
   to the map equals the eager insert bit for bit at every cursor: an
   empty map, the clipped write across the block capacity, a full block,
   a disabled insert, more samples than rows.
2. The compiled functions equal the eager port bit for bit (same generator
   seed): the step's result, pose, delta, flags, health and block map; the
   spawn's model and map; the sequence's outputs, carry, model and map.
3. Against the JAX package's functions with the JAX package's draws passed
   in, as tests/test_torch_keyframe.py holds the eager port: X to 1e-4,
   pred_stds to 1e-3 relative, flags equal, the block map to 1e-4 m (2e-3
   and 1e-3 m for the DNN step, tests/test_torch_keyframe.py's bound for
   a filtered solve); the sequence runner's trajectory and keyframe
   indices (its map contents come from each package's own random stream).
4. ``KeyframeOdometry`` (plain and DNN) and ``run_keyframe_device`` take
   the compiled functions, the map sharded or not, and equal the eager
   functions chained with their semantics (``tests/eager_chains.py``) bit
   for bit; recovery drops the graph sets.

25 azimuth bins against 256-column sweeps keep every point off the bin
edges (ROADMAP C1).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icet_tpu.models.bias_net as jbn
from icet_tpu import keyframe as jkf
from icet_tpu.config import BlockMapConfig as JBlockMap
from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.config import KeyframeConfig as JKeyframe
from icet_tpu.datasets.replay import SyntheticTrajectorySource
from icet_tpu.solver import prepare_reference_jit as j_prepare
from icet_tpu_torch import filters as tf
from icet_tpu_torch import graphs
from icet_tpu_torch import keyframe as tkf
from icet_tpu_torch.config import BlockMapConfig, KeyframeConfig
from icet_tpu_torch.convert import blockmap_from_numpy, config_from_icet, voxel_model_from_numpy
from icet_tpu_torch.models.bias_net import load_pretrained
from icet_tpu_torch.solver import prepare_reference
from tests import eager_chains

torch.set_num_threads(2)

CFG = JConfig(n_theta=25, n_phi=8, phi_min=math.pi / 3, phi_max=2 * math.pi / 3,
              n_iters=4, min_pts=15, min_range=1.0)
TCFG = config_from_icet(dataclasses.asdict(CFG))
#: the DNN step at tests/test_torch_keyframe.py's filter start (n_pre 3): on
#: this 32-correspondence grid an earlier start leaves ~12 voxels after the
#: filter, where one voxel flipped by a bf16 rounding moves X by centimetres
DCFG = TCFG.replace(dnn_filter=True, dnn_start_iter=3, dnn_sample_pts=32)
KF = dict(spawn_distance=0.5, spawn_angle=0.15, delta_clamp=2.0)
BM = dict(n_blocks=3, block_capacity=1024, points_per_scan=400)
KCFG, BCFG = KeyframeConfig(**KF), BlockMapConfig(**BM)


@pytest.fixture(scope="module")
def drive():
    src = SyntheticTrajectorySource(n_frames=7, speed=0.3, yaw_rate=0.02,
                                    n_beams=32, n_azimuth=256)
    return np.stack([s for s, _ in src]).astype(np.float32)


@pytest.fixture(scope="module")
def net():
    return load_pretrained(100)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_equal(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a, b), what


def _bm_equal(got, want):
    for name in ("points", "valid", "poses"):
        _assert_equal(getattr(got, name), getattr(want, name), f"bm.{name}")
    assert (got.n_blocks, got.cursor) == (want.n_blocks, want.cursor)


def _clone_bm(bm):
    return bm._replace(points=bm.points.clone(), valid=bm.valid.clone(), poses=bm.poses.clone())


def _steps_equal(got, want):
    res_g, *rest_g, bm_g = got
    res_w, *rest_w, bm_w = want
    for name in ("X", "pred_stds", "Q", "static_mask"):
        _assert_equal(getattr(res_g, name), getattr(res_w, name), name)
    for name, a, b in zip(res_w.diagnostics._fields, res_g.diagnostics, res_w.diagnostics):
        _assert_equal(a, b, f"diagnostics.{name}")
    assert res_g.iterations == res_w.iterations
    for name, a, b in zip(("X_rel", "delta", "diverged", "spawn", "health"), rest_g, rest_w):
        if isinstance(b, bool):
            assert a is b, name
        else:
            _assert_equal(a, b, name)
    _bm_equal(bm_g, bm_w)


def _spawned(scan, bm_cfg=BCFG, seed=3):
    bm = tkf.blockmap_init(bm_cfg)
    u = torch.rand(bm_cfg.points_per_scan, generator=torch.Generator().manual_seed(seed))
    return tkf.keyframe_spawn(bm, _t(scan), torch.zeros(6), u, True, TCFG, bm_cfg)


# ---------------------------------------------------------------------------
# 1. The staged insert
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_blocks,cursor,enabled,k,p", [
    (0, 0, True, 400, 1024),      # no block open: nothing written, the cursor moves
    (1, 0, True, 400, 1024),
    (2, 700, True, 400, 1024),    # crosses the capacity: 324 rows written
    (2, 1023, True, 400, 1024),   # one row left
    (5, 1024, True, 400, 1024),   # full block
    (4, 300, False, 400, 1024),   # disabled: nothing moves
    (2, 100, True, 400, 256),     # more samples than rows
], ids=["empty", "first", "crossing", "last_row", "full", "disabled", "k_above_p"])
def test_masked_insert_equals_eager(drive, n_blocks, cursor, enabled, k, p):
    rng = np.random.default_rng(n_blocks + cursor)
    bm_cfg = BlockMapConfig(n_blocks=3, block_capacity=p, points_per_scan=k)
    bm = tkf.blockmap_init(bm_cfg)._replace(n_blocks=n_blocks, cursor=cursor)
    bm.points.copy_(_t(rng.normal(size=bm.points.shape).astype(np.float32)))
    bm.valid.copy_(_t(rng.random(bm.valid.shape) < 0.5))
    scan, X = _t(drive[1]), _t(np.array([0.2, 0.1, 0.0, 0.01, 0.0, 0.05], np.float32))
    u = torch.rand(k, generator=torch.Generator().manual_seed(7))
    want = tkf._blockmap_insert(_clone_bm(bm), scan, X, u, bm_cfg, TCFG.min_range, enabled)
    got = _clone_bm(bm)
    mb = graphs.MapBuffers(3, p, k, "cpu")
    mb.at.copy_(torch.tensor(tkf._map_state(bm)))
    mb.u.copy_(u)
    tkf._stage_insert(mb, scan, X, TCFG.min_range, torch.tensor(enabled))
    mb.tables = (got.points, got.valid, got.poses)
    tkf._stage_write(mb, 0)
    got = got._replace(cursor=int(mb.at[1]))
    _bm_equal(got, want)
    assert got.cursor == (min(cursor + k, p) if enabled else cursor)


# ---------------------------------------------------------------------------
# 2. Compiled against eager, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed_insert", [True, False])
@pytest.mark.parametrize("n_blocks", [0, 1, 3], ids=["first", "second", "evicting"])
def test_keyframe_spawn_jit_equals_eager(drive, seed_insert, n_blocks):
    _, bm = _spawned(drive[0])
    bm = bm._replace(n_blocks=n_blocks)
    world = _t(np.array([1.0, 0.5, 0.0, 0.0, 0.0, 0.3], np.float32))
    u = torch.rand(BM["points_per_scan"], generator=torch.Generator().manual_seed(5))
    m_w, bm_w = tkf.keyframe_spawn(_clone_bm(bm), _t(drive[2]), world, u, seed_insert, TCFG,
                                   BCFG)
    m_g, bm_g = tkf.keyframe_spawn_jit(_clone_bm(bm), _t(drive[2]), world, u, seed_insert,
                                       TCFG, BCFG)
    for name, a, b in zip(m_w._fields, m_g, m_w):
        _assert_equal(a, b, name)
    _bm_equal(bm_g, bm_w)


def _chain(step, drive, model, bm, dnn_args=(), net=None, gen_seed=2):
    """The host loop's chain of steps (without spawns) from frame 1 on:
    one generator's draws, health latched, the map carried."""
    gen = torch.Generator().manual_seed(gen_seed)
    x_rel, delta, h0 = torch.zeros(6), torch.zeros(6), torch.zeros(2)
    outs = []
    for k in range(1, 5):
        u = torch.rand(BM["points_per_scan"], generator=gen)
        args = (model, bm, _t(drive[k]), *dnn_args, x_rel, delta, u, h0)
        cfg = DCFG if net is not None else TCFG
        out = step(*args, cfg, KCFG, BCFG, *((net,) if net is not None else ()))
        res, x_rel, delta, _, _, health, bm = out
        h0 = tkf.update_health0(h0, health)
        outs.append(out)
    return outs


def test_keyframe_step_jit_equals_eager(drive):
    model, bm = _spawned(drive[0])
    want = _chain(tkf.keyframe_step, drive, model, _clone_bm(bm))
    got = _chain(tkf.keyframe_step_jit, drive, model, _clone_bm(bm))
    for g, w in zip(got, want):
        _steps_equal(g, w)
    spawns = [w[4] for w in want]
    assert any(spawns) and not all(spawns)  # both branches of the gated insert
    assert got[-1][-1].cursor == min(400 * (1 + spawns.count(False)), BM["block_capacity"])


def test_keyframe_step_dnn_jit_equals_eager(drive, net):
    model = prepare_reference(_t(drive[0]), DCFG)
    _, bm = _spawned(drive[0])
    samples = tf.model_voxel_samples(model, _t(drive[0]), DCFG)
    dnn = (_t(drive[0]), samples)
    want = _chain(tkf.keyframe_step_dnn, drive, model, _clone_bm(bm), dnn, net)
    got = _chain(tkf.keyframe_step_dnn_jit, drive, model, _clone_bm(bm), dnn, net)
    for g, w in zip(got, want):
        _steps_equal(g, w)
    assert all(w[0].iterations >= 2 for w in want)


def _eager_sequence(frames, model, bm, carry, cfg, kf_cfg, bm_cfg):
    x_rel, delta, world_key, gen, h0, prev_stds = carry
    (model, bm, c), outs = tkf.keyframe_sequence(frames, model, bm, (x_rel, delta, world_key, h0,
                                                                     prev_stds), gen, cfg, kf_cfg,
                                                 bm_cfg)
    d2, stds, world6, div, x2, n_corr, is_kf, iters = outs
    return (model, bm, c), (d2, stds, world6, div, x2, is_kf, n_corr), iters


@pytest.mark.parametrize("kf_cfg", [KCFG, KeyframeConfig(delta_clamp=1e-4)],
                         ids=["spawning", "every_frame"])
def test_keyframe_sequence_jit_equals_eager(drive, kf_cfg):
    """Two blocks, the carry handed from one to the next; with an
    impossible clamp every frame spawns, the first of each block too."""
    model0, bm0 = _spawned(drive[0])
    z6 = torch.zeros(6)
    results = []
    for run in (_eager_sequence, tkf.keyframe_sequence_jit):
        gen = torch.Generator().manual_seed(9)
        model, bm, carry = model0, _clone_bm(bm0), (z6, z6, z6, gen, torch.zeros(2), z6)
        outs_all, iters_all = [], []
        for blk in (drive[1:4], drive[4:]):
            kw = {} if run is _eager_sequence else {"return_iterations": True}
            (model, bm, carry), outs, iters = run(_t(blk), model, bm, carry, TCFG, kf_cfg, BCFG,
                                                  **kw)
            if run is _eager_sequence:
                carry = (*carry[:3], gen, *carry[3:])
            outs_all.append(outs)
            iters_all += [int(i) for i in iters]
        results.append((model, bm, carry, outs_all, iters_all))
    (m_w, bm_w, c_w, o_w, i_w), (m_g, bm_g, c_g, o_g, i_g) = results
    names = ("delta", "delta_stds", "world6", "diverged", "x_rel", "is_keyframe", "n_corr")
    for blk_g, blk_w in zip(o_g, o_w):
        assert len(blk_g) == 7
        for name, a, b in zip(names, blk_g, blk_w):
            _assert_equal(a, b.to(a.dtype) if name == "is_keyframe" else b, name)
    assert i_g == i_w
    for name, a, b in zip(m_w._fields, m_g, m_w):
        _assert_equal(a, b, name)
    _bm_equal(bm_g, bm_w)
    for k in (0, 1, 2, 4, 5):
        _assert_equal(c_g[k], c_w[k], f"carry[{k}]")
    spawns = torch.cat([o[5] for o in o_g])
    assert bool(spawns.all()) == (kf_cfg.delta_clamp < 1e-3) and bool(spawns.any())


def _shard(bm):
    """``bm`` with its block axis over three CPU devices (one block each)."""
    from icet_tpu_torch.parallel.sharding import registration_mesh

    return tkf.shard_blockmap(bm, registration_mesh(3, 1, ["cpu"] * 3))


def _whole(bm):
    return bm._replace(**{k: tkf.whole_table(getattr(bm, k)) for k in ("points", "valid",
                                                                        "poses")})


def test_sharded_map_step_and_spawn_equal_eager(drive):
    """Over a map sharded in three chunks, the compiled step (its insert
    into the chunk of block 1) and spawn (opening block 2, the third
    chunk) equal the eager functions on the same sharded map bit for bit;
    the map stays sharded."""
    model, bm = _spawned(drive[0])
    bm = bm._replace(n_blocks=2)
    want = _chain(tkf.keyframe_step, drive, model, _shard(_clone_bm(bm)))
    got = _chain(tkf.keyframe_step_jit, drive, model, _shard(_clone_bm(bm)))
    for g, w in zip(got, want):
        _steps_equal(g[:-1] + (_whole(g[-1]),), w[:-1] + (_whole(w[-1]),))
    bm_g, bm_w = got[-1][-1], want[-1][-1]
    assert isinstance(bm_g.points, tkf.BlockShards) and bm_g.cursor > 0
    world = _t(np.array([1.0, 0.5, 0.0, 0.0, 0.0, 0.3], np.float32))
    u = torch.rand(BM["points_per_scan"], generator=torch.Generator().manual_seed(5))
    m_w, s_w = tkf.keyframe_spawn(bm_w, _t(drive[5]), world, u, True, TCFG, BCFG)
    m_g, s_g = tkf.keyframe_spawn_jit(bm_g, _t(drive[5]), world, u, True, TCFG, BCFG)
    for name, a, b in zip(m_w._fields, m_g, m_w):
        _assert_equal(a, b, name)
    assert s_g.n_blocks == 3 and isinstance(s_g.valid, tkf.BlockShards)
    _bm_equal(_whole(s_g), _whole(s_w))


def test_sharded_map_sequence_equals_eager(drive):
    """``keyframe_sequence_jit`` over a sharded map, spawning into every
    chunk and wrapping, against the eager ``keyframe_sequence`` on the
    same sharded map."""
    model0, bm0 = _spawned(drive[0])
    z6 = torch.zeros(6)
    out = []
    for run in (_eager_sequence, tkf.keyframe_sequence_jit):
        carry = (z6, z6, z6, torch.Generator().manual_seed(9), torch.zeros(2), z6)
        kw = {} if run is _eager_sequence else {"return_iterations": True}
        (model, bm, _), outs, iters = run(_t(drive[1:]), model0, _shard(_clone_bm(bm0)), carry,
                                          TCFG, KeyframeConfig(delta_clamp=1e-4), BCFG, **kw)
        out.append((model, _whole(bm), outs, [int(i) for i in iters]))
    (m_w, bm_w, o_w, i_w), (m_g, bm_g, o_g, i_g) = out
    names = ("delta", "delta_stds", "world6", "diverged", "x_rel", "is_keyframe", "n_corr")
    for name, a, b in zip(names, o_g, o_w):
        _assert_equal(a, b.to(a.dtype), name)
    assert i_g == i_w and bm_g.n_blocks == len(drive) > BM["n_blocks"]
    for name, a, b in zip(m_w._fields, m_g, m_w):
        _assert_equal(a, b, name)
    _bm_equal(bm_g, bm_w)


# ---------------------------------------------------------------------------
# 3. Against the JAX package's functions, with its draws
# ---------------------------------------------------------------------------


def _jax_setup(scan0, cfg):
    jmodel = j_prepare(jnp.asarray(scan0), cfg)
    tmodel = voxel_model_from_numpy({k: np.asarray(v) for k, v in jmodel._asdict().items()})
    jbm = jkf._blockmap_spawn(jkf.blockmap_init(JBlockMap(**BM)), jnp.zeros(6, jnp.float32))
    tbm = blockmap_from_numpy({k: np.asarray(v) for k, v in jbm._asdict().items()})
    return jmodel, tmodel, jbm, tbm


def _bm_close(tbm, jbm, atol):
    assert (tbm.n_blocks, tbm.cursor) == (int(jbm.n_blocks), int(jbm.cursor))
    np.testing.assert_array_equal(tbm.valid.numpy(), np.asarray(jbm.valid))
    np.testing.assert_array_equal(tbm.poses.numpy(), np.asarray(jbm.poses))
    np.testing.assert_allclose(tbm.points.numpy(), np.asarray(jbm.points), rtol=0, atol=atol)


def test_keyframe_step_jit_matches_jax(drive):
    jmodel, tmodel, jbm, tbm = _jax_setup(drive[0], CFG)
    x_prev = np.array([0.3, 0.0, 0.0, 0.0, 0.0, -0.02], np.float32)
    d_prev = np.array([0.28, 0.01, 0.0, 0.0, 0.0, -0.015], np.float32)
    health0 = np.array([60.0, 0.01], np.float32)
    key = jax.random.PRNGKey(4)
    u = np.asarray(jax.random.uniform(key, (BM["points_per_scan"],)))
    jres, jX, jd, jdiv, jspawn, jh, jbm = jkf.keyframe_step_jit(
        jmodel, jbm, jnp.asarray(drive[2]), jnp.asarray(x_prev), jnp.asarray(d_prev), key,
        jnp.asarray(health0), CFG, JKeyframe(**KF), JBlockMap(**BM))
    tres, tX, td, tdiv, tspawn, th, tbm = tkf.keyframe_step_jit(
        tmodel, tbm, _t(drive[2]), _t(x_prev), _t(d_prev), _t(u), _t(health0), TCFG, KCFG,
        BCFG)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=0, atol=1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tres.pred_stds.numpy(), np.asarray(jres.pred_stds), rtol=1e-3)
    assert bool(tdiv) == bool(jdiv) is False and tspawn == bool(jspawn)
    assert th[0].item() == float(jh[0]) > 0
    _bm_close(tbm, jbm, 1e-4)


def test_keyframe_step_jit_sharded_map_matches_jax(drive):
    """The compiled step over the port's map sharded in three chunks
    against the JAX package's step over its map sharded by
    ``shard_blockmap`` on three virtual devices, at
    test_keyframe_step_jit_matches_jax's tolerances."""
    jmodel, tmodel, jbm, tbm = _jax_setup(drive[0], CFG)
    jbm = jkf.shard_blockmap(jbm, jax.sharding.Mesh(np.array(jax.devices()[:3]), ("dp",)))
    x_prev = np.array([0.3, 0.0, 0.0, 0.0, 0.0, -0.02], np.float32)
    d_prev = np.array([0.28, 0.01, 0.0, 0.0, 0.0, -0.015], np.float32)
    health0 = np.array([60.0, 0.01], np.float32)
    key = jax.random.PRNGKey(4)
    u = np.asarray(jax.random.uniform(key, (BM["points_per_scan"],)))
    jres, jX, jd, jdiv, jspawn, jh, jbm = jkf.keyframe_step_jit(
        jmodel, jbm, jnp.asarray(drive[2]), jnp.asarray(x_prev), jnp.asarray(d_prev), key,
        jnp.asarray(health0), CFG, JKeyframe(**KF), JBlockMap(**BM))
    tres, tX, td, tdiv, tspawn, th, tbm = tkf.keyframe_step_jit(
        tmodel, _shard(tbm), _t(drive[2]), _t(x_prev), _t(d_prev), _t(u), _t(health0), TCFG,
        KCFG, BCFG)
    assert isinstance(tbm.points, tkf.BlockShards)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=0, atol=1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tres.pred_stds.numpy(), np.asarray(jres.pred_stds), rtol=1e-3)
    assert bool(tdiv) == bool(jdiv) is False and tspawn == bool(jspawn)
    _bm_close(_whole(tbm), jbm, 1e-4)


@pytest.fixture
def fused_jax_encoder(monkeypatch):
    plain = jbn.apply_bias_net
    monkeypatch.setattr(jbn, "apply_bias_net", lambda n, p, x, **kw: plain(
        n, p, x, fused=True, interpret=True))


def test_keyframe_step_dnn_jit_matches_jax(drive, net, fused_jax_encoder):
    import icet_tpu.filters as jf

    cfg = CFG.replace(dnn_filter=True, dnn_start_iter=3, dnn_sample_pts=32)
    jnet, jparams = jbn.load_pretrained(100)
    jmodel, tmodel, jbm, tbm = _jax_setup(drive[0], cfg)
    x_prev = np.array([0.3, 0.0, 0.0, 0.0, 0.0, -0.02], np.float32)
    key = jax.random.PRNGKey(4)
    u = np.asarray(jax.random.uniform(key, (BM["points_per_scan"],)))
    jres, jX, jd, jdiv, jspawn, jh, jbm = jkf.keyframe_step_dnn_jit(
        jmodel, jbm, jnp.asarray(drive[2]), jnp.asarray(drive[0]),
        jf.model_voxel_samples_jit(jmodel, jnp.asarray(drive[0]), cfg),
        jnp.asarray(x_prev), jnp.asarray(x_prev), key, jnp.zeros(2, jnp.float32),
        cfg, JKeyframe(**KF), JBlockMap(**BM), jnet, jparams)
    samples = tf.model_voxel_samples_jit(tmodel, _t(drive[0]), DCFG)
    tres, tX, td, tdiv, tspawn, th, tbm = tkf.keyframe_step_dnn_jit(
        tmodel, tbm, _t(drive[2]), _t(drive[0]), samples, _t(x_prev), _t(x_prev), _t(u),
        torch.zeros(2), DCFG, KCFG, BCFG, net)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=0, atol=2e-3)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=2e-3)
    assert bool(tdiv) == bool(jdiv) is False and tspawn == bool(jspawn)
    assert th[0].item() == float(jh[0]) > 0
    _bm_close(tbm, jbm, 1e-3)


@pytest.mark.parametrize("seed_insert", [True, False])
def test_keyframe_spawn_jit_matches_jax(drive, seed_insert):
    jbm = jkf.blockmap_init(JBlockMap(**BM))
    tbm = tkf.blockmap_init(BCFG)
    world = np.array([1.0, 0.5, 0.0, 0.0, 0.0, 0.3], np.float32)
    key = jax.random.PRNGKey(8)
    u = np.asarray(jax.random.uniform(key, (BM["points_per_scan"],)))
    jm, jbm = jkf.keyframe_spawn_jit(jbm, jnp.asarray(drive[1]), jnp.asarray(world), key,
                                     jnp.asarray(seed_insert), CFG, JBlockMap(**BM))
    tm, tbm = tkf.keyframe_spawn_jit(tbm, _t(drive[1]), _t(world), _t(u), seed_insert, TCFG,
                                     BCFG)
    for k in ("count", "valid", "lmask"):
        np.testing.assert_array_equal(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)))
    _bm_close(tbm, jbm, 2e-5)


def test_keyframe_sequence_jit_matches_jax(drive):
    """The whole drive in one block from the JAX package's seed keyframe:
    steps and poses to 1e-3 m, keyframes and divergence flags equal."""
    jmodel, tmodel, jbm, tbm = _jax_setup(drive[0], CFG)
    z = jnp.zeros(6, jnp.float32)
    jcarry = (z, z, z, jax.random.PRNGKey(1), jnp.zeros(2, jnp.float32), z)
    (_, jbm2, _), jouts = jkf.keyframe_sequence_jit(
        jnp.asarray(drive[1:]), jmodel, jbm, jcarry, CFG, JKeyframe(**KF), JBlockMap(**BM))
    z6 = torch.zeros(6)
    tcarry = (z6, z6, z6, torch.Generator().manual_seed(1), torch.zeros(2), z6)
    (_, tbm2, _), touts = tkf.keyframe_sequence_jit(_t(drive[1:]), tmodel, tbm, tcarry, TCFG,
                                                    KCFG, BCFG)
    d2, stds, world6, div, x2, is_kf, n_corr = touts
    jd2, jstds, jworld6, jdiv, jx2, jis_kf, jn_corr = (np.asarray(o) for o in jouts)
    np.testing.assert_array_equal(is_kf.numpy(), jis_kf)
    np.testing.assert_array_equal(div.numpy(), jdiv)
    assert 1 <= int(is_kf.sum()) < len(drive) - 1
    np.testing.assert_allclose(d2.numpy(), jd2, rtol=0, atol=1e-3)
    np.testing.assert_allclose(world6.numpy(), jworld6, rtol=0, atol=1e-3)
    np.testing.assert_allclose(x2.numpy(), jx2, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(n_corr.numpy(), jn_corr)
    assert (tbm2.n_blocks, tbm2.cursor) == (int(jbm2.n_blocks), int(jbm2.cursor))


# ---------------------------------------------------------------------------
# 4. The runners
# ---------------------------------------------------------------------------


def _spy(monkeypatch, names):
    calls = []
    for name in names:
        real = getattr(tkf, name)

        def wrapped(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(tkf, name, wrapped)
    return calls


def _frames_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in ("X", "pred_stds", "T_world", "X_rel", "n_corr"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=name)
        assert (g.index, g.is_keyframe, g.diverged, g.iterations) == (
            w.index, w.is_keyframe, w.diverged, w.iterations)


@pytest.mark.parametrize("dnn", [False, True], ids=["plain", "dnn"])
def test_keyframe_odometry_routes_compiled(drive, net, monkeypatch, dnn):
    cfg = DCFG if dnn else TCFG
    monkeypatch.setitem(tf._PRETRAINED_CACHE, (32, "cpu"), net)
    step = "keyframe_step_dnn_jit" if dnn else "keyframe_step_jit"
    calls = _spy(monkeypatch, [step, "keyframe_spawn_jit", "keyframe_step", "keyframe_spawn"])
    odo = tkf.KeyframeOdometry(cfg, KCFG, BCFG, device="cpu")
    got = odo.run(drive)
    assert calls.count(step) == len(drive) - 1
    assert calls.count("keyframe_spawn_jit") == len(odo.keyframe_indices) >= 2
    assert "keyframe_step" not in calls and "keyframe_spawn" not in calls
    want, bm, keyframes = eager_chains.keyframe_odometry(_t(drive), cfg, KCFG, BCFG,
                                                          net if dnn else None)
    _frames_equal(got, want)
    assert odo.keyframe_indices == keyframes
    _bm_equal(odo.blockmap, bm)


def test_run_keyframe_device_routes_compiled(drive, monkeypatch):
    calls = _spy(monkeypatch, ["keyframe_sequence_jit", "keyframe_sequence"])
    got, bm_g = tkf.run_keyframe_device(drive, TCFG, KCFG, BCFG, block=3, device="cpu")
    assert calls == ["keyframe_sequence_jit", "keyframe_sequence_jit"]
    want, bm_w = eager_chains.keyframe_device(_t(drive), TCFG, KCFG, BCFG, block=3)
    _frames_equal(got, want)
    _bm_equal(bm_g, bm_w)
    # The device runner and the host loop spawn the same keyframes.
    odo = tkf.KeyframeOdometry(TCFG, KCFG, BCFG, device="cpu")
    host = odo.run(drive)
    assert [0] + [f.index for f in got if f.is_keyframe] == odo.keyframe_indices
    for g, h in zip(got, host):
        np.testing.assert_allclose(g.T_world, h.T_world, rtol=0, atol=1e-6)


def test_sharded_map_takes_the_compiled_step(drive, monkeypatch):
    """A map sharded over three devices takes the compiled step, and its
    frames and map equal the eager step's chain over the same sharded map
    bit for bit."""
    from icet_tpu_torch.parallel.sharding import registration_mesh

    calls = _spy(monkeypatch, ["keyframe_step_jit", "keyframe_step"])
    mesh = registration_mesh(3, 1, ["cpu"] * 3)
    odo = tkf.KeyframeOdometry(TCFG, KCFG, BCFG, device="cpu")
    odo.blockmap = tkf.shard_blockmap(odo.blockmap, mesh)
    got, bm_g = odo.run(drive[:4]), odo.blockmap
    assert calls == ["keyframe_step_jit"] * 3
    want, bm_w, _ = eager_chains.keyframe_odometry(
        _t(drive[:4]), TCFG, KCFG, BCFG,
        blockmap=tkf.shard_blockmap(tkf.blockmap_init(BCFG, "cpu"), mesh))
    _frames_equal(got, want)
    assert isinstance(bm_g.points, tkf.BlockShards)
    for name in ("points", "valid", "poses"):
        _assert_equal(tkf.whole_table(getattr(bm_g, name)), tkf.whole_table(getattr(bm_w, name)),
                      f"bm.{name}")
    assert (bm_g.n_blocks, bm_g.cursor) == (bm_w.n_blocks, bm_w.cursor)


def test_recovery_clears_the_graphs(drive):
    odo = tkf.KeyframeOdometry(TCFG, KCFG, BCFG, device="cpu", snapshot_every=1)
    for s in drive[:3]:
        odo.step(s)
    before = graphs.frame_graphs("cpu", drive.shape[1], TCFG)
    odo._recover()
    assert graphs.frame_graphs("cpu", drive.shape[1], TCFG) is not before
    odo.step(drive[3])
    assert odo.step(drive[4]) is not None
