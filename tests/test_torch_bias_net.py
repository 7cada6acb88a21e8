"""The port's BiasNet against the JAX package on the bundled weights.

The encoder kernel itself runs only on the card (``chip_smoke.py`` holds
it against its plain version there).  Here the plain version, which the
wrapper takes for CPU tensors, is held against the JAX package's fused
encoder (``apply_bias_net(fused=True, interpret=True)``) and its flax
apply, at 37 voxels x 200 points as tests/test_models.py holds them.
Tolerances: the weights carry across exactly; the input packing to 1e-6;
pooled codes within one bf16 ulp (rtol 2^-7) on >= 99.5% of entries (the
two packages sum the same bf16 products in float32 in other orders, which
can flip a rounding to bf16); outputs within 2e-2, the bound of
tests/test_models.py, for max-pool winners that such a flip changes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu.models import bias_net as jbn
from icet_tpu.utils.checkpoint import load_checkpoint as jload_checkpoint
from icet_tpu_torch.models import bias_net as tbn
from icet_tpu_torch.ops import bias_encoder as tenc
from icet_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(2)

WEIGHTS = str(tbn.WEIGHTS_DIR / "bias_net_s100.npz")


@pytest.fixture(scope="module")
def nets():
    jnet, jparams = jbn.load_pretrained(100)
    return jnet, jparams, tbn.load_pretrained(100)


@pytest.fixture(scope="module")
def x():
    """Voxel-centred metre-scale offsets + scan-id channel, 37 voxels (not a
    multiple of any tile) x 200 points."""
    rng = np.random.default_rng(5)
    xyz = rng.normal(size=(37, 200, 3)).astype(np.float32) * 0.5
    tag = np.tile(np.r_[-np.ones(100), np.ones(100)].astype(np.float32), (37, 1))
    return np.concatenate([xyz, tag[..., None]], axis=-1)


def _jax_pooled(jparams, x):
    """The JAX fused path's pooled codes: ``_dense_ln_relu`` per stage (XLA
    for stage 1, the kernel body for stages 2-3) and the max over points."""
    enc, _ = jbn._split_params(jparams)
    h = jnp.asarray(x).astype(jnp.bfloat16)
    for i in range(0, len(enc), 4):
        h = jbn._dense_ln_relu(h, *enc[i : i + 4])
    return np.asarray(jnp.max(h.astype(jnp.float32), axis=1))


def test_checkpoint_loader_copy():
    want = jload_checkpoint(WEIGHTS)
    got = load_checkpoint(WEIGHTS)
    assert got.keys() == want.keys() == {"params"}
    for layer, arrays in want["params"].items():
        for k, v in arrays.items():
            np.testing.assert_array_equal(got["params"][layer][k], v)


def test_params_conversion_exact(nets):
    _, jparams, tnet = nets
    enc, head = jbn._split_params(jparams)
    assert len(enc) == 12 and len(head) == 3

    def bf16(a):
        return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))

    for i in range(3):
        w, b, g, be = (np.asarray(a) for a in enc[4 * i : 4 * i + 4])
        np.testing.assert_array_equal(getattr(tnet, f"enc{i}_w").numpy(), w)
        np.testing.assert_array_equal(getattr(tnet, f"enc{i}_w_bf16").float().numpy(), bf16(w))
        np.testing.assert_array_equal(getattr(tnet, f"enc{i}_b_bf16").float().numpy(), bf16(b))
        np.testing.assert_array_equal(getattr(tnet, f"ln{i}_scale").numpy(), g)
        np.testing.assert_array_equal(getattr(tnet, f"ln{i}_bias").numpy(), be)
    for (w, b), (tw, tb) in zip(head, tnet.head_weights()):
        np.testing.assert_array_equal(tw.numpy(), np.asarray(w))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(b))
    # The layout the CUDA kernel reads: contiguous bf16 (in, out).
    for t, shape in zip(tnet.encoder_weights()[::4], [(4, 64), (64, 128), (128, 256)]):
        assert t.dtype == torch.bfloat16 and t.is_contiguous() and tuple(t.shape) == shape


def test_pack_voxel_samples():
    rng = np.random.default_rng(0)
    s1 = (rng.normal(size=(5, 16, 3)) + 1).astype(np.float32)
    s2 = (rng.normal(size=(5, 16, 3)) + 1).astype(np.float32)
    want = np.asarray(jbn.pack_voxel_samples(jnp.asarray(s1), jnp.asarray(s2)))
    got = tbn.pack_voxel_samples(torch.from_numpy(s1), torch.from_numpy(s2)).numpy()
    assert got.shape == (5, 32, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_encoder_codes_match_fused_semantics(nets, x):
    _, jparams, tnet = nets
    want = _jax_pooled(jparams, x)
    got = tenc.encoder_pool_reference(torch.from_numpy(x), tnet.encoder_weights()).numpy()
    assert got.shape == want.shape == (37, 256)
    close = np.abs(got - want) <= 2**-7 * np.abs(want)
    assert close.mean() >= 0.995, close.mean()


@pytest.mark.parametrize("ref", ["fused_interpret", "flax"])
def test_outputs_match(nets, x, ref):
    jnet, jparams, tnet = nets
    if ref == "flax":
        want = np.asarray(jnet.apply(jparams, jnp.asarray(x)))
    else:
        want = np.asarray(jbn.apply_bias_net(jnet, jparams, jnp.asarray(x), fused=True,
                                             interpret=True))
    got = tbn.apply_bias_net(tnet, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (37, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    np.testing.assert_array_equal(tnet(torch.from_numpy(x)).numpy(), got)


def test_wrapper_takes_plain_version_on_cpu(nets, x):
    tnet = nets[2]
    xt = torch.from_numpy(x)
    before = tenc.bias_encoder_pool.launches
    np.testing.assert_array_equal(
        tenc.bias_encoder_pool(xt, tnet.encoder_weights(), tile=8).numpy(),
        tenc.encoder_pool_reference(xt, tnet.encoder_weights()).numpy())
    assert tenc.bias_encoder_pool.launches == before  # no kernel launch on the CPU


def test_wrapper_checks(nets, x):
    w = nets[2].encoder_weights()
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError):
        tenc.bias_encoder_pool(xt.to("meta"), w)
    tenc._check(xt, w, 16)
    for bad in (
        lambda: tenc._check(xt, w, 12),  # not a kernel tile
        lambda: tenc._check(xt[..., :3].contiguous(), w, 16),
        lambda: tenc._check(xt.double(), w, 16),
        lambda: tenc._check(xt, w[:-1], 16),
        lambda: tenc._check(xt, [t.float() for t in w], 16),
    ):
        with pytest.raises(ValueError):
            bad()
