"""The Python side of the Hopper encoder kernel, and the encoder at the
point counts the kernel's row partition finds hardest, on the CPU.

The kernel itself runs only on the card (``chip_smoke.py`` holds it against
its plain version there at P in {1, 63, 64, 65, 200}, which checks its row
partition).  Here:

- the wgmma weight layout: packing and unpacking are an exact round trip,
  and each value sits where the 128-byte swizzle puts it; the weight image
  holds the packed W2/W3 and the float32 vectors the kernel reads, and is
  cached for the very weight tensors it was built from until one changes;
- the wrapper's refusals of misshapen inputs and weights;
- the plain version ``encoder_pool_reference`` against the JAX package's
  fused encoder (``apply_bias_net(fused=True, interpret=True)``) at
  P in {1, 63, 64, 65}: outputs within 2e-2 and pooled codes within one
  bf16 ulp on >= 99.5% of entries, the tolerances of
  tests/test_torch_bias_net.py (the two packages sum the same bf16 products
  in float32 in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu.models import bias_net as jbn
from icet_tpu_torch.models import bias_net as tbn
from icet_tpu_torch.ops import bias_encoder as tenc

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def nets():
    jnet, jparams = jbn.load_pretrained(100)
    return jnet, jparams, tbn.load_pretrained(100)


def _x(b, p, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(b, p, 3)).astype(np.float32) * 0.5
    tag = np.where(np.arange(p) < p // 2, -1.0, 1.0).astype(np.float32)
    return np.concatenate([xyz, np.broadcast_to(tag[None, :, None], (b, p, 1))], -1)


@pytest.mark.parametrize("shape", [(64, 128), (128, 256), (64, 8)])
def test_wgmma_layout_round_trip(shape):
    k, n = shape
    w = torch.from_numpy(np.random.default_rng(k + n).normal(size=shape).astype(np.float32))
    w = w.to(torch.bfloat16)
    w[0, 0], w[-1, -1] = float("inf"), -0.0
    flat = tenc.pack_wgmma_b(w)
    assert flat.shape == (k * n,) and flat.dtype == torch.bfloat16
    back = tenc.unpack_wgmma_b(flat, k, n)
    assert torch.equal(back.view(torch.int16), w.view(torch.int16))  # bit for bit
    # Every value sits where the 128-byte swizzle puts it.
    for kk in range(0, k, 7):
        for nn in range(0, n, 5):
            region, c, e = kk // 64, (kk % 64) // 8, kk % 8
            off = region * n * 64 + nn * 64 + (c ^ (nn % 8)) * 8 + e
            assert flat[off].view(torch.int16) == w[kk, nn].view(torch.int16)


def test_wgmma_layout_refuses_misfit_shapes():
    with pytest.raises(ValueError):
        tenc.pack_wgmma_b(torch.zeros((48, 128), dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        tenc.pack_wgmma_b(torch.zeros((64, 12), dtype=torch.bfloat16))


def test_weight_image(nets):
    w = nets[2].encoder_weights()
    img = tenc.weight_image(w)
    assert img.dtype == torch.uint8 and img.numel() == tenc.IMAGE_BYTES == 88_320
    n2, n3 = 64 * 128 * 2, 128 * 256 * 2
    w2 = tenc.unpack_wgmma_b(img[:n2].view(torch.bfloat16), 64, 128)
    w3 = tenc.unpack_wgmma_b(img[n2:n2 + n3].view(torch.bfloat16), 128, 256)
    assert torch.equal(w2, w[4]) and torch.equal(w3, w[8])
    vec = img[n2 + n3:].view(torch.float32)
    want = torch.cat([t.float().reshape(-1) for i, t in enumerate(w) if i not in (4, 8)])
    assert torch.equal(vec, want) and vec.numel() == 1600
    # The swizzled regions of the image start on 1,024-byte boundaries.
    assert n2 % 1024 == 0 and (n2 + n3) % 16 == 0


W3_BYTES = slice(64 * 128 * 2, 64 * 128 * 2 + 128 * 256 * 2)


def _w3(img):
    return tenc.unpack_wgmma_b(img[W3_BYTES].view(torch.bfloat16), 128, 256)


def test_weight_image_cache(nets):
    w = [t.clone() for t in nets[2].encoder_weights()]
    a = tenc._cached_image(w)
    assert tenc._cached_image(w) is a
    w[8][3, 7] = 1.5  # an in-place update bumps the tensor's version
    b = tenc._cached_image(w)
    assert b is not a
    assert torch.equal(_w3(b), w[8])


def test_weight_image_cache_new_tensors(nets):
    """Other tensors at the cached ones' addresses and versions (as when a
    freed weight set's memory goes to a new one) get an image of their own,
    and a new weight set after the old one is dropped gets its values."""
    w = [t.clone() for t in nets[2].encoder_weights()]
    a = tenc._cached_image(w)
    alias = [t.detach() for t in w]  # same memory, same version counter
    assert all(s.data_ptr() == t.data_ptr() and s._version == t._version
               for s, t in zip(alias, w))
    assert tenc._cached_image(alias) is not a
    del w, alias
    w2 = [t.clone() for t in nets[2].encoder_weights()]
    w2[8].neg_()
    assert torch.equal(_w3(tenc._cached_image(w2)), w2[8])
    assert torch.equal(tenc._cached_image(w2), tenc.weight_image(w2))


def test_weight_image_cache_is_bounded(nets):
    sets = [[t.clone() for t in nets[2].encoder_weights()] for _ in range(tenc.IMAGE_CACHE + 1)]
    first = tenc._cached_image(sets[0])
    for w in sets[1:]:
        tenc._cached_image(w)
    assert len(tenc._images) == tenc.IMAGE_CACHE  # the oldest set was let go
    assert tenc._cached_image(sets[-1]) is tenc._images[-1][2]
    assert tenc._cached_image(sets[0]) is not first


@pytest.mark.parametrize("p", [1, 63, 64, 65])
def test_reference_matches_fused_interpret(nets, p):
    jnet, jparams, tnet = nets
    x = _x(5, p, seed=10 + p)
    want = np.asarray(jbn.apply_bias_net(jnet, jparams, jnp.asarray(x), fused=True,
                                         interpret=True))
    got = tbn.apply_bias_net(tnet, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    enc, _ = jbn._split_params(jparams)
    h = jnp.asarray(x).astype(jnp.bfloat16)
    for i in range(0, len(enc), 4):
        h = jbn._dense_ln_relu(h, *enc[i:i + 4])
    codes = np.asarray(jnp.max(h.astype(jnp.float32), axis=1))
    mine = tenc.encoder_pool_reference(torch.from_numpy(x), tnet.encoder_weights()).numpy()
    assert (np.abs(mine - codes) <= 2.0**-7 * np.abs(codes)).mean() >= 0.995


def test_check_refusals(nets):
    w = nets[2].encoder_weights()
    x = torch.from_numpy(_x(4, 9))
    tenc._check(x, w, 8)
    unaligned = torch.zeros(4 * 9 * 4 + 1)[1:].view(4, 9, 4)  # contiguous, 4 B off
    assert unaligned.is_contiguous() and unaligned.data_ptr() % 16
    for bad in (
        lambda: tenc._check(unaligned, w, 8),
        lambda: tenc._check(x[:, :0], w, 8),      # P = 0
        lambda: tenc._check(x, w, 64),            # not a kernel tile
    ):
        with pytest.raises(ValueError):
            bad()
    assert tenc.encoder_blocks(1801, 132) == 132 and tenc.encoder_blocks(5, 132) == 5


@pytest.mark.parametrize("k", range(12))
def test_check_refuses_each_bad_weight(nets, k):
    """Weight ``k`` (stage k // 4: w, b, scale, beta) of the wrong dtype, of
    the wrong shape, or missing: each is refused."""
    w = list(nets[2].encoder_weights())
    x = torch.from_numpy(_x(4, 9))
    good = w[k]
    other = torch.float32 if good.dtype == torch.bfloat16 else torch.bfloat16
    for bad in (good.to(other), good[..., :-1], None):
        ws = w[:k] + ([] if bad is None else [bad]) + w[k + 1:]
        with pytest.raises(ValueError):
            tenc._check(x, ws, 16)
