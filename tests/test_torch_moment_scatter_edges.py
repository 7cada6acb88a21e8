"""Edge inputs of the moment scatter, and the launch plan of its one-launch
CUDA kernel, on the CPU.

``chip_smoke.py`` holds the kernel against its plain version on the card at
these kinds of input (shuffled ids, every point in one voxel, every id on
the sentinel, N = 1, a ragged N, ids outside ``[0, V]``).  Here the plain
version, ``moment_scatter_reference``, which the wrapper takes for CPU
tensors, is held against the TPU kernel ``pallas_moment_sums`` in Pallas
interpret mode: counts exactly, the other columns to 1e-5 (float32 sums of
a few dozen terms in another order).  Where every point lands in one row
the features are dyadic and every sum is exact, so there all columns agree
exactly.  The plan tests check the Python side of the kernel: its grid,
which table branch it takes, and the bit-identity of the plain version to
one ``index_add_`` when every id is in range.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu.ops.pallas_moments import pallas_moment_sums
from icet_tpu_torch.ops import moment_scatter as tsc

torch.set_num_threads(2)

V = 52
V_PAD = 128  # the TPU kernel's table: V + 1 rounded up to 128


def _inputs(name, rng):
    n = 1500
    vid = rng.integers(0, V + 1, n).astype(np.int32)
    feats = rng.normal(size=(n, 16)).astype(np.float32)
    feats[:, 0] = 1.0
    if name == "out_of_range":
        # -1 and v_pad + 5 match no column of the TPU kernel's one-hot; V + 1
        # lands in a padded row that it slices off.  All three are dropped.
        vid[rng.permutation(n)[:300]] = rng.choice([-1, V + 1, V_PAD + 5], 300)
    elif name == "one_voxel":
        vid[:] = 17
        feats = (rng.integers(-63, 64, size=(n, 16)) / 16.0).astype(np.float32)
        feats[:, 0] = 1.0
    elif name == "sentinel":
        vid[:] = V
    elif name == "n1":
        vid, feats = vid[:1], feats[:1]
    elif name == "ragged":
        vid, feats = vid[:1029], feats[:1029]  # no block size divides it
    return vid, feats


@pytest.mark.parametrize("name", ["out_of_range", "one_voxel", "sentinel", "n1", "ragged"])
def test_reference_matches_pallas_interpret(name):
    vid, feats = _inputs(name, np.random.default_rng(len(name)))
    want = np.asarray(pallas_moment_sums(jnp.asarray(vid), jnp.asarray(feats), V))
    got = tsc.moment_scatter_sums(torch.from_numpy(vid), torch.from_numpy(feats), V).numpy()
    assert got.shape == want.shape == (V + 1, 16)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    if name == "one_voxel":
        np.testing.assert_array_equal(got, want)
        assert got[17, 0] == vid.shape[0] and got[:, 0].sum() == vid.shape[0]
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if name == "out_of_range":
        kept = (vid >= 0) & (vid <= V)
        assert got[:, 0].sum() == kept.sum() < vid.shape[0]
    if name == "sentinel":
        assert got[V, 0] == vid.shape[0] and (got[:V] == 0).all()


def test_reference_is_index_add_when_ids_in_range():
    rng = np.random.default_rng(5)
    vid = torch.from_numpy(rng.integers(0, 1801, 20_000).astype(np.int32))
    feats = torch.from_numpy(rng.normal(size=(20_000, 16)).astype(np.float32))
    got = tsc.moment_scatter_reference(vid, feats, 1800)
    want = torch.zeros(1801, 16).index_add_(0, vid.long(), feats)
    assert got.shape == (1801, 16) and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 65536, 65537])
@pytest.mark.parametrize("n_voxels", [1800, tsc.SHARED_ROWS - 1, tsc.SHARED_ROWS, 90_000])
def test_launch_plan(n, n_voxels):
    blocks, per_block, shared = tsc.launch_plan(n, n_voxels, 132)
    assert shared == (n_voxels + 1 <= tsc.SHARED_ROWS)
    assert blocks * per_block >= n
    if shared:
        # One block an SM at most, none with less than one round, and none
        # left without points.
        assert blocks == max(1, min(132, -(-n // tsc.POINTS_PER_ROUND)))
        assert (blocks - 1) * per_block < max(n, 1)
    else:
        # Every SM zeroes its share of the large table, with points or not.
        assert blocks == 132 and per_block == -(-n // 132)


def test_shared_rows():
    # The largest shared table: V + 1 = 3,631 rows of 16 float32 beside the
    # kernel's static shared memory, within Hopper's 232,448 bytes a block.
    assert tsc.SHARED_ROWS == 3631
    assert tsc.SHARED_ROWS * 64 <= 232_448 - 8 < (tsc.SHARED_ROWS + 1) * 64
    assert tsc.launch_plan(1000, 1800, 132)[2] and not tsc.launch_plan(1000, 90_000, 132)[2]
