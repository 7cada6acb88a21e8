"""The port's compiled DNN-filtered path (``filters.model_voxel_samples_jit``,
``odometry_step_dnn_jit``, ``register_pair_with_dnn``; ``OdometryPipeline``
with the filter) on the CPU, where its capture-safe stages run as plain
calls on the static buffers of ``icet_tpu_torch.graphs``.

1. ``sample_voxel_points`` (counts by ``index_add_``, unwritten points sent
   to a dump row) equals its earlier form (``torch.bincount`` and boolean
   masks, kept below) bit for bit, in every mode.
2. The compiled functions equal the eager port bit for bit: X, pred_stds,
   Q, every diagnostics column, the static mask, the iterations, the keep
   mask, both shifts, ``n_rejected``, the new model and samples; in-loop
   with ``n_post`` 1 and 3, one-shot, and ``n_iters = 1``.
3. ``odometry_step_dnn_jit`` stays within tests/test_torch_filters.py's
   tolerances of the JAX package's jitted ``odometry_step_dnn_jit`` (the
   s100 weights serve S = 32 in both; the JAX encoder is its fused kernel
   in interpret mode): X within 2e-3, which also covers C5 (the JAX jitted
   CPU program drops the bf16 rounding of the encoder's bias add), the new
   model's counts and validity and the new samples exact.
4. The pipeline's DNN route takes the compiled step and equals the eager
   route bit for bit; the hand-over leaves the next frame nothing to copy.
5. A graph set pins the encoder's weight image: evicting the image cache
   leaves the set's reference alive.

49 azimuth bins against 512-column sweeps keep every point off the bin
edges (ROADMAP C1).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icet_tpu.filters as jf
import icet_tpu.models.bias_net as jbn
from icet_tpu import solver as js
from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.datasets.replay import SyntheticTrajectorySource
from icet_tpu_torch import filters as tf
from icet_tpu_torch import graphs
from icet_tpu_torch import odometry as todo
from icet_tpu_torch import solver as ts
from icet_tpu_torch.convert import config_from_icet, voxel_model_from_numpy
from icet_tpu_torch.models.bias_net import load_pretrained
from icet_tpu_torch.ops import bias_encoder

torch.set_num_threads(2)

CFG = JConfig(n_theta=49, n_phi=16, phi_min=math.pi / 3, phi_max=2 * math.pi / 3,
              n_iters=6, min_pts=20, min_range=1.0, convergence_tol=1e-4,
              convergence_stat_scale=1.0, dnn_filter=True, dnn_start_iter=3,
              dnn_sample_pts=32)
TCFG = config_from_icet(dataclasses.asdict(CFG))
#: the filtered solve's modes: in-loop with n_post 3 and 1 (and the
#: moving-object schedule switching on inside the plain phase), one-shot,
#: n_iters = 1
MODES = {
    "in_loop_post3": TCFG,
    "in_loop_post1": TCFG.replace(dnn_start_iter=5, remove_moving=True, rm_start_iter=2,
                                  rm_residual_thresh=0.05, range_sigma=0.02),
    "one_shot": TCFG.replace(dnn_in_loop=False),
    "n_iters_1": TCFG.replace(n_iters=1),
}


@pytest.fixture(scope="module")
def scans():
    src = SyntheticTrajectorySource(n_frames=5, speed=0.2, yaw_rate=0.01,
                                    n_beams=48, n_azimuth=512)
    return np.stack([s for s, _ in src]).astype(np.float32)


@pytest.fixture(scope="module")
def net():
    return load_pretrained(100)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_equal(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a, b), what


def _results_equal(got, want):
    for name in ("X", "pred_stds", "Q", "static_mask"):
        _assert_equal(getattr(got, name), getattr(want, name), name)
    for name, a, b in zip(want.diagnostics._fields, got.diagnostics, want.diagnostics):
        _assert_equal(a, b, f"diagnostics.{name}")
    assert got.iterations == want.iterations


def _tuples_equal(got, want, what):
    for name, a, b in zip(getattr(want, "_fields", range(len(want))), got, want):
        _assert_equal(a, b, f"{what}.{name}")


# ---------------------------------------------------------------------------
# 1. The sampling pass without host reads
# ---------------------------------------------------------------------------


def _sample_voxel_points_earlier(points, vid, member, n_voxels, n_samples, mode="head",
                                 counts=None, fill_tail=True):
    """``filters.sample_voxel_points`` as it was before its counts came from
    ``index_add_`` and its writes from a dump row (the reference here)."""
    n = points.shape[0]
    vidm = torch.where(member, vid, n_voxels).long()
    if mode == "strided":
        if counts is None:
            counts = torch.zeros(n_voxels + 1, dtype=torch.int32, device=points.device)
            counts = counts.index_add_(0, vidm, torch.ones_like(vidm, dtype=torch.int32))
        order = torch.argsort(vidm, stable=True)
        offsets = torch.cumsum(counts, 0) - counts
        k = torch.arange(n_samples, dtype=torch.int64, device=points.device)[None, :]
        within = (k * torch.clamp(counts, min=1).long()[:, None]) // n_samples
        take = torch.clamp(offsets.long()[:, None] + within, 0, n - 1)
        return points[order[take]], counts
    S, v1 = n_samples, n_voxels + 1
    vs, order = torch.sort(vidm, stable=True)
    pts_s = points[order]
    counts = torch.bincount(vs, minlength=v1)
    rank = torch.arange(n, device=points.device) - (torch.cumsum(counts, 0) - counts)[vs]
    write = (vs < n_voxels) & (rank < S)
    tgt = vs[write] * S + rank[write]
    dtype = points.dtype if fill_tail else torch.bfloat16
    buf = torch.zeros((v1 * S, 3), dtype=dtype, device=points.device)
    buf[tgt] = pts_s[write].to(dtype)
    samples = buf.reshape(v1, S, 3)
    if not fill_tail:
        return samples, None
    row_ok = torch.any(samples != 0.0, dim=-1)
    samples = torch.where(row_ok[..., None], samples, samples[:, :1, :])
    return samples, row_ok.sum(dim=-1, dtype=torch.int32)


@pytest.mark.parametrize("case", ["drive", "crowded", "no_member", "one_point"])
@pytest.mark.parametrize("mode", ["head", "head_lean", "strided"])
def test_sample_voxel_points_equals_earlier(scans, case, mode):
    rng = np.random.default_rng(11)
    V, S = 40, 8
    pts = _t(scans[0][:4000])
    vid = _t(rng.integers(0, V + 1, size=pts.shape[0]).astype(np.int32))
    member = _t(rng.random(pts.shape[0]) < 0.8)
    if case == "crowded":  # every point in one voxel, far past S
        vid = torch.full_like(vid, 7)
    elif case == "no_member":
        member = torch.zeros_like(member)
    elif case == "one_point":
        pts, vid, member = pts[:1], vid[:1].clamp(max=V - 1), torch.ones(1, dtype=torch.bool)
    kw = {"head": {}, "head_lean": {"fill_tail": False}, "strided": {"mode": "strided"}}[mode]
    got = tf.sample_voxel_points(pts, vid, member, V, S, **kw)
    want = _sample_voxel_points_earlier(pts, vid, member, V, S, **kw)
    _assert_equal(got[0], want[0], "samples")
    if want[1] is None:
        assert got[1] is None
    else:
        _assert_equal(got[1], want[1], "counts")


# ---------------------------------------------------------------------------
# 2. Compiled against eager, bit for bit
# ---------------------------------------------------------------------------


def test_model_voxel_samples_jit_equals_eager(scans):
    model = ts.prepare_reference(_t(scans[0]), TCFG)
    got = tf.model_voxel_samples_jit(model, _t(scans[1]), TCFG)
    want = tf.model_voxel_samples(model, _t(scans[1]), TCFG)
    _tuples_equal(got, want, "samples")
    assert got[0].dtype == torch.bfloat16 and int(got[1].sum()) > 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_odometry_step_dnn_jit_equals_eager(scans, net, mode):
    """Three chained steps from the same model; the compiled chain passes
    its own outputs back (the hand-over), the eager one its own."""
    cfg = MODES[mode]
    m_e = ts.prepare_reference(_t(scans[0]), cfg)
    s_e = tf.model_voxel_samples(m_e, _t(scans[0]), cfg)
    m_c = ts.prepare_reference_jit(_t(scans[0]), cfg)
    s_c = tf.model_voxel_samples_jit(m_c, _t(scans[0]), cfg)
    x = torch.zeros(6)
    for k in range(1, 4):
        prev, scan = _t(scans[k - 1]), _t(scans[k])
        r_e, m_e, s_e, f_e = tf.odometry_step_dnn(m_e, prev, s_e, scan, x, cfg, net)
        r_c, m_c, s_c, f_c = tf.odometry_step_dnn_jit(m_c, prev, s_c, scan, x, cfg, net,
                                                      return_filter=True)
        _results_equal(r_c, r_e)
        _tuples_equal(m_c, m_e, "model")
        _tuples_equal(s_c, s_e, "samples")
        _tuples_equal(f_c, f_e, "filter")
        assert r_c.static_mask.shape == (0,)
        x = r_e.X
    assert int(f_e.n_rejected) > 0 or mode == "n_iters_1"
    if mode == "n_iters_1":
        assert r_c.iterations == 1
    three = tf.odometry_step_dnn_jit(m_c, None, s_c, _t(scans[4]), x, cfg, net)
    assert len(three) == 3  # the JAX package's (res, new_model, new_samples)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_register_pair_with_dnn_compiled_equals_eager(scans, net, monkeypatch, mode):
    """The pair entry takes the compiled route on a captured config (with
    the static mask); forcing the eager route gives the same bits."""
    cfg = MODES[mode]
    x0 = np.zeros(6, np.float32)
    captures = graphs.host_ops["copies"]
    got, f_got = tf.register_pair_with_dnn(scans[0], scans[1], x0, cfg, net, device="cpu")
    assert graphs.host_ops["copies"] > captures  # through the graph set's buffers
    monkeypatch.setattr(tf, "compiled_route", lambda c: False)
    want, f_want = tf.register_pair_with_dnn(scans[0], scans[1], x0, cfg, net, device="cpu")
    _results_equal(got, want)
    _tuples_equal(f_got, f_want, "filter")
    assert got.static_mask.shape == (scans.shape[1],) and bool(got.static_mask.any())


def test_pair_of_unequal_sizes(scans, net):
    """Scan 1 and scan 2 of different sizes: two graph sets, one result."""
    s2 = scans[1][::2].copy()
    x0 = np.zeros(6, np.float32)
    got, f_got = tf.register_pair_with_dnn(scans[0], s2, x0, TCFG, net, device="cpu")
    model = ts.prepare_reference(_t(scans[0]), TCFG)
    want, f_want = tf.register_with_dnn(model, _t(scans[0]), _t(s2), _t(x0), TCFG, net)
    _results_equal(got, want)
    _tuples_equal(f_got, f_want, "filter")


# ---------------------------------------------------------------------------
# 3. Against the JAX package's jitted step
# ---------------------------------------------------------------------------


@pytest.fixture
def fused_jax_encoder(monkeypatch):
    plain = jbn.apply_bias_net
    monkeypatch.setattr(jbn, "apply_bias_net", lambda n, p, x, **kw: plain(
        n, p, x, fused=True, interpret=True))


def _unpack_bf16_pairs(packed):
    p = np.asarray(packed).astype(np.uint32)
    words = [(p[..., 0] >> 16), p[..., 0] & 0xFFFF, p[..., 1] >> 16]
    return np.stack([(w << 16).astype(np.uint32).view(np.float32) for w in words], axis=-1)


@pytest.mark.parametrize("in_loop", [True, False], ids=["in_loop", "one_shot"])
def test_odometry_step_dnn_jit_matches_jax(scans, net, fused_jax_encoder, in_loop):
    cfg = CFG.replace(dnn_in_loop=in_loop)
    tcfg = config_from_icet(dataclasses.asdict(cfg))
    jnet, jparams = jbn.load_pretrained(100)
    jm = js.prepare_reference_jit(jnp.asarray(scans[0]), cfg)
    jsamp = jf.model_voxel_samples_jit(jm, jnp.asarray(scans[0]), cfg)
    model = voxel_model_from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()})
    samples = tf.model_voxel_samples_jit(model, _t(scans[0]), tcfg)
    np.testing.assert_array_equal(samples[0].float().numpy(), _unpack_bf16_pairs(jsamp[0]))
    x0 = np.zeros(6, np.float32)
    jres, jnew, jnew_s = jf.odometry_step_dnn_jit(
        jm, jnp.asarray(scans[0]), jsamp, jnp.asarray(scans[1]), jnp.asarray(x0), cfg,
        jnet, jparams)
    res, new, new_s = tf.odometry_step_dnn_jit(model, _t(scans[0]), samples, _t(scans[1]),
                                               _t(x0), tcfg, net)
    np.testing.assert_allclose(res.X.numpy(), np.asarray(jres.X), rtol=0, atol=2e-3)
    assert res.diagnostics.n_corr.shape == jres.diagnostics.n_corr.shape
    for k in ("count", "valid"):
        np.testing.assert_array_equal(getattr(new, k).numpy(), np.asarray(getattr(jnew, k)))
    np.testing.assert_array_equal(new_s[0].float().numpy(), _unpack_bf16_pairs(jnew_s[0]))
    np.testing.assert_array_equal(new_s[1].numpy(), np.asarray(jnew_s[1]))


# ---------------------------------------------------------------------------
# 4. The pipeline's DNN route
# ---------------------------------------------------------------------------


def test_pipeline_dnn_route_compiled_equals_eager(scans, net, monkeypatch):
    monkeypatch.setitem(tf._PRETRAINED_CACHE, (32, "cpu"), net)
    calls = []
    real = todo.odometry_step_dnn_jit

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(todo, "odometry_step_dnn_jit", spy)
    copies = graphs.host_ops["copies"]
    got = list(todo.OdometryPipeline(TCFG, device="cpu").run(scans))
    assert len(calls) == len(scans) - 1
    # A frame copies in the scan and x0 only (the model and samples were
    # handed over in the buffers), then copies out the result, the model,
    # the samples and the filter pass: 6.  The first scan's prepare and
    # samples take 5 more, and the first step copies those samples in.
    assert graphs.host_ops["copies"] - copies == 6 * len(got) + 6
    monkeypatch.setattr(todo, "compiled_route", lambda c: False)
    want = list(todo.OdometryPipeline(TCFG, device="cpu").run(scans))
    assert len(calls) == len(scans) - 1
    for g, w in zip(got, want):
        for name in ("X", "pred_stds", "T_world", "pose", "n_corr"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=name)
        assert (g.iterations, g.n_rejected, g.diverged) == (w.iterations, w.n_rejected,
                                                             w.diverged)
    assert any(f.n_rejected > 0 for f in got)


def test_pipeline_dnn_recovery_captures_anew(scans, net, monkeypatch):
    monkeypatch.setitem(tf._PRETRAINED_CACHE, (32, "cpu"), net)
    pipe = todo.OdometryPipeline(TCFG, device="cpu")
    pipe.step(scans[0])
    pipe.step(scans[1])
    before = graphs.frame_graphs("cpu", scans.shape[1], TCFG)
    pipe._recover()
    assert graphs.frame_graphs("cpu", scans.shape[1], TCFG) is not before
    assert pipe.step(scans[2]) is not None


def test_held_inputs_are_copied_when_changed(scans, net):
    """The hand-over skips a copy only for the very objects it left in the
    buffers, unchanged: an in-place edit, or another model, is copied in."""
    m = ts.prepare_reference_jit(_t(scans[0]), TCFG)
    s = tf.model_voxel_samples_jit(m, _t(scans[0]), TCFG)
    _, m1, s1 = tf.odometry_step_dnn_jit(m, None, s, _t(scans[1]), torch.zeros(6), TCFG, net)
    fg = graphs.frame_graphs("cpu", scans.shape[1], TCFG)
    assert fg.holds("model", m1) and fg.holds("samples", s1)
    m1.count.add_(0.0)  # a new version
    assert not fg.holds("model", m1)
    copies = graphs.host_ops["copies"]
    fg.load(model=m1, samples=s1)
    assert graphs.host_ops["copies"] - copies == 1
    r_c, _, _ = tf.odometry_step_dnn_jit(m1, None, s1, _t(scans[2]), torch.zeros(6), TCFG, net)
    r_e, _, _, _ = tf.odometry_step_dnn(m1, None, s1, _t(scans[2]), torch.zeros(6), TCFG, net)
    _results_equal(r_c, r_e)


# ---------------------------------------------------------------------------
# 5. The pinned weight image
# ---------------------------------------------------------------------------


def test_graph_set_pins_the_weight_image(scans, net):
    m = ts.prepare_reference_jit(_t(scans[0]), TCFG)
    s = tf.model_voxel_samples_jit(m, _t(scans[0]), TCFG)
    tf.odometry_step_dnn_jit(m, None, s, _t(scans[1]), torch.zeros(6), TCFG, net)
    fg = graphs.frame_graphs("cpu", scans.shape[1], TCFG)
    pinned = [img for n, img in fg.pinned if n is net]
    assert len(pinned) == 1
    img = pinned[0]
    # Evict every cached image: the set's reference keeps its image alive.
    for seed in range(bias_encoder.IMAGE_CACHE + 1):
        other = load_pretrained(100)
        for t in other.encoder_weights():
            t.add_(seed)
        bias_encoder.cached_image(other.encoder_weights())
    assert all(i is not img for _, _, i in bias_encoder._images)
    assert img.untyped_storage().nbytes() == bias_encoder.IMAGE_BYTES
    _assert_equal(img, bias_encoder.weight_image(net.encoder_weights()), "image")
    # The next frame pins the rebuilt image beside the first.
    tf.odometry_step_dnn_jit(m, None, s, _t(scans[2]), torch.zeros(6), TCFG, net)
    assert [i for n, i in fg.pinned if n is net][0] is img and len(fg.pinned) == 2


def test_counted_wrappers_include_the_encoder():
    assert bias_encoder.bias_encoder_pool in graphs.COUNTED
    assert set(graphs.warmup_launches) == {"fused_moment_sums", "bias_encoder_pool",
                                           "tridiag_factor", "tridiag_apply"}
