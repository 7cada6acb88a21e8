"""Small eigensolvers and the plane-form WLS assembly of the port against
the JAX package.

Both run the same Jacobi rotation schedule in float32, so eigenvectors
agree column for column, signs included.  Tolerances: eigenvalues 1e-5
relative to the largest, eigenvectors 1e-4 absolute (float32 rounding of a
few dozen rotations; random inputs keep eigenvalue gaps well above that),
normal equations 1e-4 relative to their largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu.ops import geometry as jgeo
from icet_tpu.ops import linalg as jlin
from icet_tpu.ops import wls_planes as jwls
from icet_tpu_torch.ops import geometry as tgeo
from icet_tpu_torch.ops import linalg as tlin
from icet_tpu_torch.ops import wls_planes as twls

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _sym(rng, batch, n, psd=False):
    A = rng.normal(size=batch + (n, n)).astype(np.float32)
    if psd:
        return (A @ np.swapaxes(A, -1, -2)).astype(np.float32)
    return (0.5 * (A + np.swapaxes(A, -1, -2))).astype(np.float32)


def _close_eig(got, want, w_tol=1e-5, v_tol=1e-4):
    (tw, tv), (jw, jv) = got, want
    scale = np.abs(jw).max()
    np.testing.assert_allclose(tw.numpy(), jw, rtol=0, atol=w_tol * scale)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=v_tol)


@pytest.mark.parametrize("n,batch", [(3, (64,)), (6, ()), (6, (8,))])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eigh_small(n, batch, seed):
    A = _sym(np.random.default_rng(seed), batch, n)
    want = [np.asarray(x) for x in jlin.eigh_small(jnp.asarray(A))]
    _close_eig(tlin.eigh_small(_t(A)), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("perturb", [1e-3, 0.3])
def test_eigh_small_warm_safe(seed, perturb):
    """Across these cases the first warm sweep sometimes converges and
    sometimes needs the second; both branches match the JAX package."""
    rng = np.random.default_rng(seed)
    A = _sym(rng, (), 6, psd=True)
    _, V0 = jlin.eigh_small(jnp.asarray(A))
    A2 = (A + perturb * _sym(rng, (), 6) * np.abs(A).max()).astype(np.float32)
    want = [np.asarray(x) for x in jlin.eigh_small_warm_safe(jnp.asarray(A2), V0)]
    _close_eig(tlin.eigh_small_warm_safe(_t(A2), _t(V0)), want)
    w3 = [np.asarray(x) for x in jlin.eigh_small_warm(jnp.asarray(A2), V0)]
    _close_eig(tlin.eigh_small_warm(_t(A2), _t(V0)), w3)


@pytest.mark.parametrize("seed", [0, 1])
def test_psd_pinv_and_small_matmul(seed):
    rng = np.random.default_rng(seed)
    A = _sym(rng, (32,), 3, psd=True)
    A[:8, :, 2] = A[:8, 2, :] = 0.0  # rank-deficient cases
    want = np.asarray(jlin.psd_pinv(jnp.asarray(A)))
    got = tlin.psd_pinv(_t(A)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    B = _sym(rng, (32,), 3)
    np.testing.assert_allclose(
        tlin.small_matmul(_t(A), _t(B)).numpy(),
        np.asarray(jlin.small_matmul(jnp.asarray(A), jnp.asarray(B))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("layout", ["aos", "cov6"])
def test_eigh3_planes(seed, layout):
    rng = np.random.default_rng(seed)
    C = _sym(rng, (200,), 3, psd=True)
    C[:20] = np.diag([4.0, 1.0, 1e-4]).astype(np.float32)  # planar voxels
    if layout == "cov6":
        C = np.stack([C[:, 0, 0], C[:, 1, 1], C[:, 2, 2], C[:, 0, 1], C[:, 0, 2],
                      C[:, 1, 2]], -1)
    want = [np.asarray(x) for x in jax.jit(jwls.eigh3_planes)(jnp.asarray(C))]
    got = twls.eigh3_planes(_t(C))
    _close_eig(got, want)


def _wls_inputs(seed, V=60):
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.normal(size=(V, 3, 3)))[0].astype(np.float32)
    lmask = (rng.random((V, 3)) > 0.2).astype(np.float32)
    cov1 = _sym(rng, (V,), 3, psd=True) * 0.01
    cov2 = _sym(rng, (V,), 3, psd=True) * 0.01
    cov6 = np.stack([cov2[:, 0, 0], cov2[:, 1, 1], cov2[:, 2, 2], cov2[:, 0, 1],
                     cov2[:, 0, 2], cov2[:, 1, 2]], -1).astype(np.float32)
    count1 = rng.integers(1, 200, V).astype(np.float32)
    count2 = rng.integers(1, 200, V).astype(np.float32)
    mean1 = (rng.normal(size=(V, 3)) * 10).astype(np.float32)
    mean2 = (mean1 + rng.normal(size=(V, 3)) * 0.05).astype(np.float32)
    angs = rng.uniform(-0.1, 0.1, 3).astype(np.float32)
    cm = (rng.random(V) > 0.3).astype(np.float32)
    extra = rng.normal(size=(V, 3)).astype(np.float32)
    return basis, lmask, cov1, count1, cov2, cov6, count2, mean1, mean2, angs, cm, extra


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cov2_layout", ["aos", "cov6"])
def test_assemble_normal_equations(seed, cov2_layout):
    (basis, lmask, cov1, count1, cov2, cov6, count2, mean1, mean2, angs, cm,
     extra) = _wls_inputs(seed)
    c2 = cov2 if cov2_layout == "aos" else cov6
    jdR = jgeo.rotation_jacobian(jnp.asarray(angs))
    want = jax.jit(jwls.assemble_normal_equations, static_argnums=(10,))(
        *(jnp.asarray(a) for a in (basis, lmask, cov1, count1, c2, count2, mean1,
                                   mean2)), jdR, jnp.asarray(cm), 1e-7,
        jnp.asarray(extra))
    got = twls.assemble_normal_equations(
        *(_t(a) for a in (basis, lmask, cov1, count1, c2, count2, mean1, mean2)),
        tgeo.rotation_jacobian(_t(angs)), _t(cm), 1e-7, extra_dz=_t(extra))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())
    np.testing.assert_allclose(
        twls.residual_compact_planes(_t(basis), _t(lmask), _t(mean1), _t(mean2)).numpy(),
        np.asarray(jwls.residual_compact_planes(*(jnp.asarray(a) for a in (
            basis, lmask, mean1, mean2)))), rtol=0, atol=1e-6)
