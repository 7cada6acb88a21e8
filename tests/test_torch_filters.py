"""The port's DNN perspective-shift filter against the JAX package.

Same numpy scans and the same bundled BiasNet weights into both (the s100
weights serve S = 32: the encoder max-pools over any number of points).
The JAX side's encoder runs as its fused Pallas kernel in interpret mode
(``apply_bias_net(fused=True, interpret=True)``, monkeypatched in as
tests/test_elastic.py patches the filters module), so both packages follow
the same bf16 semantics.  Grid: 49 azimuth bins against a 512-column sweep,
so no point sits on a bin edge.  Tolerances:

* samples and counts: exact (the same points, copied);
* ``register(it_offset=k)``: 1e-5, as tests/test_torch_solver.py;
* one filter pass on one model: ``icet_shift`` to 1e-5, ``dnn_shift`` to
  2e-2 (the bound of tests/test_models.py: bf16 roundings summed in
  another order can flip a max-pool winner); keep masks identical except
  on voxels whose disagreement lies within that voxel's ``dnn_shift``
  difference of the threshold, where rounding decides (1-3 of ~780 voxels
  at this size), and ``n_rejected`` within max(2, 5%);
* whole filtered registrations: X within 2e-3 and ``n_rejected`` within
  max(2, 5%) (a flipped winner can move a voxel across the threshold,
  which moves the solve by a fraction of a millimetre).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icet_tpu.filters as jf
import icet_tpu.models.bias_net as jbn
from icet_tpu import solver as js
from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.datasets.synthetic import scan_pair_with_ground_truth
from icet_tpu_torch import filters as tf
from icet_tpu_torch import solver as ts
from icet_tpu_torch.convert import config_from_icet, voxel_model_from_numpy
from icet_tpu_torch.models.bias_net import load_pretrained
from icet_tpu_torch.ops.linalg import small_matmul

torch.set_num_threads(2)

CFG = JConfig(n_theta=49, n_phi=16, phi_min=math.pi / 3, phi_max=2 * math.pi / 3,
              n_iters=6, min_pts=20, min_range=1.0, dnn_filter=True,
              dnn_start_iter=3, dnn_sample_pts=32)
X_TRUE = np.array([0.3, 0.1, 0.0, 0.0, 0.0, 0.01], np.float32)


def _tc(cfg):
    return config_from_icet(dataclasses.asdict(cfg))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def pair():
    return scan_pair_with_ground_truth(X_TRUE, seed=5, n_beams=48, n_azimuth=512)


@pytest.fixture(scope="module")
def nets():
    jnet, jparams = jbn.load_pretrained(100)
    return jnet, jparams, load_pretrained(100)


@pytest.fixture
def fused_jax_encoder(monkeypatch):
    """The JAX filter's encoder as its fused kernel in interpret mode (the
    filter imports ``apply_bias_net`` at call time)."""
    plain = jbn.apply_bias_net

    def fused(net, params, x, **kw):
        return plain(net, params, x, fused=True, interpret=True)

    monkeypatch.setattr(jbn, "apply_bias_net", fused)


def _unpack_bf16_pairs(packed):
    """The JAX package's (V+1, S, 2) u32 bf16-pair samples as float32 xyz."""
    p = np.asarray(packed).astype(np.uint32)
    words = [(p[..., 0] >> 16), p[..., 0] & 0xFFFF, p[..., 1] >> 16]
    return np.stack([(w << 16).astype(np.uint32).view(np.float32) for w in words], axis=-1)


@pytest.mark.parametrize("mode", ["head", "head_lean", "strided"])
def test_sample_voxel_points(mode):
    rng = np.random.default_rng(2)
    n, V, S = 600, 9, 8
    pts = (rng.normal(size=(n, 3)) * 20).astype(np.float32)
    vid = rng.integers(0, V + 1, n).astype(np.int32)
    member = (rng.random(n) > 0.1) & (vid < V)
    kw = {"mode": "strided"} if mode == "strided" else {"fill_tail": mode == "head"}
    js_, jc = jf.sample_voxel_points(jnp.asarray(pts), jnp.asarray(vid), jnp.asarray(member),
                                     V, S, **kw)
    ts_, tc = tf.sample_voxel_points(_t(pts), _t(vid), _t(member), V, S, **kw)
    if mode == "head_lean":
        assert jc is None and tc is None and ts_.dtype == torch.bfloat16
        np.testing.assert_array_equal(ts_.float().numpy(), _unpack_bf16_pairs(js_))
        return
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.fixture(scope="module")
def jax_model(pair):
    return js.prepare_reference_jit(jnp.asarray(pair[0]), CFG)


def _model(jm):
    return voxel_model_from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()})


def test_model_voxel_samples(pair, jax_model):
    jpacked, jcounts = jf.model_voxel_samples_jit(jax_model, jnp.asarray(pair[1]), CFG)
    tsamples, tcounts = tf.model_voxel_samples(_model(jax_model), _t(pair[1]), _tc(CFG))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(tsamples.float().numpy(), _unpack_bf16_pairs(jpacked))
    np.testing.assert_array_equal(
        tf._unpack_fill_samples(tsamples, tcounts).numpy(),
        np.asarray(jf._unpack_fill_samples(jpacked, jcounts)))
    assert (tcounts.numpy() == CFG.dnn_sample_pts).sum() > 20


@pytest.mark.parametrize("offset", [0, 2, 4])
def test_register_it_offset(pair, jax_model, offset):
    """Moving-object rejection from global iteration 3: with ``it_offset``
    the phase sees global indices, in the early exit's minimum too."""
    cfg = CFG.replace(dnn_filter=False, n_iters=3, remove_moving=True, rm_start_iter=3,
                      rm_residual_thresh=0.05, convergence_tol=1e-4,
                      convergence_stat_scale=1.0)
    reg = jax.jit(js.register, static_argnums=(3, 4, 6, 7))
    x0 = np.zeros(6, np.float32)
    j = reg(jax_model, jnp.asarray(pair[1]), jnp.asarray(x0), cfg, None, None, True, offset)
    t = ts.register(_model(jax_model), _t(pair[1]), _t(x0), _tc(cfg), it_offset=offset)
    np.testing.assert_allclose(t.X.numpy(), np.asarray(j.X), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.pred_stds.numpy(), np.asarray(j.pred_stds), rtol=1e-4)
    rejected = t.diagnostics.n_rejected_moving.numpy()
    np.testing.assert_array_equal(rejected, np.asarray(j.diagnostics.n_rejected_moving))
    np.testing.assert_array_equal(t.diagnostics.n_corr.numpy(),
                                  np.asarray(j.diagnostics.n_corr))
    np.testing.assert_array_equal(t.static_mask.numpy(), np.asarray(j.static_mask))
    assert (rejected.max() > 0) == (offset > 0)


def test_dnn_reject_mask(pair, jax_model, nets, fused_jax_encoder):
    jnet, jparams, tnet = nets
    X = np.array([0.29, 0.11, 0.0, 0.0, 0.0, 0.012], np.float32)
    aligned = np.asarray(js.transform_points(jnp.asarray(pair[1]), jnp.asarray(X)))
    j = jax.jit(jf.dnn_reject_mask, static_argnums=(0, 5))(
        jnet, jparams, jax_model, jnp.asarray(pair[0]), jnp.asarray(aligned), CFG)
    model = _model(jax_model)
    t = tf.dnn_reject_mask(tnet, model, _t(pair[0]), _t(aligned), _tc(CFG))
    np.testing.assert_allclose(t.icet_shift.numpy(), np.asarray(j.icet_shift),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.dnn_shift.numpy(), np.asarray(j.dnn_shift),
                               rtol=0, atol=2e-2)
    nj, nt = int(j.n_rejected), int(t.n_rejected)
    assert nj > 20 and abs(nt - nj) <= max(2, 0.05 * nj), (nt, nj)
    # The projector U diag(l) U^T has norm <= 1, so a voxel's disagreement
    # moves by at most the norm of its dnn_shift difference.
    proj = small_matmul(model.basis, model.lmask[:, :, None] * model.basis.transpose(1, 2))
    diff = torch.sum(proj * (t.icet_shift - t.dnn_shift)[:, None, :], dim=-1)
    margin = (diff.abs().amax(dim=-1) - CFG.dnn_thresh).abs().numpy()
    gap = np.linalg.norm(t.dnn_shift.numpy() - np.asarray(j.dnn_shift), axis=-1)
    flips = t.keep.numpy() != np.asarray(j.keep)
    assert flips.sum() <= 3 and (margin[flips] <= gap[flips] + 2e-5).all(), (
        np.nonzero(flips), margin[flips], gap[flips])


@pytest.mark.parametrize("mode", ["in_loop", "one_shot", "n_iters_1"])
def test_register_with_dnn(pair, nets, fused_jax_encoder, mode):
    jnet, jparams, tnet = nets
    cfg = {"in_loop": CFG, "one_shot": CFG.replace(dnn_in_loop=False),
           "n_iters_1": CFG.replace(n_iters=1)}[mode]
    x0 = np.zeros(6, np.float32)
    jres, jfilt = jf.register_pair_with_dnn(jnp.asarray(pair[0]), jnp.asarray(pair[1]),
                                           jnp.asarray(x0), cfg, jnet, jparams)
    tres, tfilt = tf.register_pair_with_dnn(pair[0], pair[1], x0, _tc(cfg), tnet,
                                           device="cpu")
    np.testing.assert_allclose(tres.X.numpy(), np.asarray(jres.X), rtol=0, atol=2e-3)
    nj, nt = int(jfilt.n_rejected), int(tfilt.n_rejected)
    assert nj > 0 and abs(nt - nj) <= max(2, 0.05 * nj), (nt, nj)
    np.testing.assert_allclose(tres.X.numpy()[:3], X_TRUE[:3], atol=0.05)
    assert tres.diagnostics.n_corr.shape == jres.diagnostics.n_corr.shape
    assert tres.static_mask.shape == jres.static_mask.shape
    assert tres.iterations == {"in_loop": 6, "one_shot": 6, "n_iters_1": 1}[mode]


def test_register_scans_honours_dnn_filter(pair, nets, monkeypatch):
    tnet = nets[2]
    monkeypatch.setitem(tf._PRETRAINED_CACHE, (CFG.dnn_sample_pts, "cpu"), tnet)
    cfg = _tc(CFG)
    x0 = np.zeros(6, np.float32)
    off = tf.register_scans(pair[0], pair[1], cfg=cfg.replace(dnn_filter=False), device="cpu")
    direct = ts.register_pair(pair[0], pair[1], x0, cfg.replace(dnn_filter=False), device="cpu")
    np.testing.assert_array_equal(off.X.numpy(), direct.X.numpy())
    on = tf.register_scans(pair[0], pair[1], cfg=cfg, device="cpu")
    want, filt = tf.register_pair_with_dnn(pair[0], pair[1], x0, cfg, tnet, device="cpu")
    np.testing.assert_array_equal(on.X.numpy(), want.X.numpy())
    assert int(filt.n_rejected) > 0
