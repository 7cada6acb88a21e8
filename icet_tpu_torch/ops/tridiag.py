"""The pose graph's block-tridiagonal backbone: its block Cholesky and the
two block substitution sweeps that apply its inverse, 6x6 float32 blocks
over K poses.

``tridiag_factor`` and ``tridiag_apply`` launch the CUDA kernels of
``csrc/tridiag_backbone.cu`` on CUDA tensors, one launch a call, and take
the plain versions, :func:`tridiag_factor_reference` and
:func:`tridiag_apply_reference` (the step-by-step recurrences), only for
CPU tensors.  They replace ``icet_tpu/pose_graph.py::_tridiag_factor`` and
``_tridiag_apply`` (:193-245), which run under ``lax.scan``: no Pallas
kernel, but one device loop that plain PyTorch would split into several
launches a step.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icet_tpu_torch import _build

#: block size (a pose's six degrees of freedom)
B = 6
#: steps a stage of the kernels' shared-memory ring, and its stages
#: (``kChunk`` and ``kStages`` in ``csrc/tridiag_backbone.cu``): the edges
#: that the tests and ``chip_smoke.py`` hold the kernels at
CHUNK, STAGES = 32, 4


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of the symmetrised ``(A + A^T) / 2`` (batched),
    as ``jnp.linalg.cholesky`` symmetrises its input; NaN where the factor
    fails, as the JAX package's (a failed LAPACK factor is NaN there).  No
    read back to the host."""
    L, info = torch.linalg.cholesky_ex((A + A.transpose(-1, -2)) / 2)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))


def spd_inv6(S: torch.Tensor) -> torch.Tensor:
    """Inverse of SPD 6x6 blocks (batched) through the Cholesky factor:
    ``L^-T L^-1``; NaN where the factor fails."""
    L = cholesky(S)
    eye = torch.eye(B, dtype=S.dtype, device=S.device).expand_as(S)
    inv_c = torch.linalg.solve_triangular(L, eye, upper=False)
    return inv_c.transpose(-1, -2) @ inv_c


def tridiag_factor_reference(diag_d: torch.Tensor, E: torch.Tensor):
    """Plain version of :func:`tridiag_factor`: the recurrence
    ``S_k = D_k - E_{k-1}^T S_{k-1}^{-1} E_{k-1}``, one step at a time.
    Returns ``S_inv (K, 6, 6)`` and ``U_k = S_k^{-1} E_k (K-1, 6, 6)``.  A
    block whose inverse is not finite (round-off made it not SPD) takes the
    inverse of ``D_k`` and ``U = 0`` (block-Jacobi for that block)."""
    K = diag_d.shape[0]
    S_prev = spd_inv6(diag_d[0])
    S_inv, U = [S_prev], []
    for k in range(1, K):
        D_k, E_prev = diag_d[k], E[k - 1]
        u = S_prev @ E_prev
        S_k_inv = spd_inv6(D_k - E_prev.T @ u)
        ok = torch.isfinite(S_k_inv).all()
        S_k_inv = torch.where(ok, S_k_inv, spd_inv6(D_k))
        u = torch.where(ok, u, torch.zeros_like(u))
        S_inv.append(S_k_inv)
        U.append(u)
        S_prev = S_k_inv
    U = torch.stack(U) if U else diag_d.new_zeros((0, B, B))
    return torch.stack(S_inv), U


def tridiag_apply_reference(S_inv: torch.Tensor, U: torch.Tensor, r: torch.Tensor):
    """Plain version of :func:`tridiag_apply`: ``y = M^-1 r`` for ``r (K,
    6)`` by the forward sweep ``z_k = r_k - U_{k-1}^T z_{k-1}`` and the
    backward sweep ``y_k = S_inv_k z_k - U_k y_{k+1}``."""
    K = r.shape[0]
    z = [r[0]]
    for k in range(1, K):
        z.append(r[k] - U[k - 1].T @ z[-1])
    Sz = torch.einsum("kab,kb->ka", S_inv, torch.stack(z))
    y = [Sz[K - 1]]
    for k in range(K - 2, -1, -1):
        y.append(Sz[k] - U[k] @ y[-1])
    return torch.stack(y[::-1])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("tridiag_backbone")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.icet_tridiag_factor.argtypes = [p, p, i, p, p, p]
    lib.icet_tridiag_factor.restype = i
    lib.icet_tridiag_apply.argtypes = [p, p, p, i, p, p]
    lib.icet_tridiag_apply.restype = i
    lib.icet_cuda_error_string.argtypes = [i]
    lib.icet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(K: int, **tensors) -> torch.device:
    shapes = {"diag_d": (K, B, B), "S_inv": (K, B, B), "E": (K - 1, B, B),
              "U": (K - 1, B, B), "r": (K, B)}
    if K < 1 or K * B * B >= 2**31:
        raise ValueError(f"K = {K} poses is out of the kernel's range")
    dev = None
    for name, t in tensors.items():
        dev = dev or t.device
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must have shape {shapes[name]}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"no tridiagonal backbone kernel for device {dev}")
    return dev


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().icet_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def tridiag_factor(diag_d: torch.Tensor, E: torch.Tensor):
    """Block Cholesky of the SPD block-tridiagonal backbone with damped
    diagonal blocks ``diag_d (K, 6, 6)`` and super-diagonal blocks ``E
    (K-1, 6, 6)``: ``(S_inv (K, 6, 6), U (K-1, 6, 6))``.

    CUDA tensors go to the kernel, one launch a call
    (``tridiag_factor.launches`` counts its launches); CPU tensors go to
    :func:`tridiag_factor_reference`."""
    if diag_d.device.type == "cpu" and E.device.type == "cpu":
        return tridiag_factor_reference(diag_d, E)
    K = diag_d.shape[0]
    dev = _check(K, diag_d=diag_d, E=E)
    S_inv = torch.empty((K, B, B), dtype=torch.float32, device=dev)
    U = torch.empty((K - 1, B, B), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.icet_tridiag_factor(diag_d.data_ptr(), E.data_ptr(), K,
                                      S_inv.data_ptr(), U.data_ptr(), stream)
    _raise_on(err, "tridiagonal factor")
    tridiag_factor.launches += 1
    return S_inv, U


def tridiag_apply(S_inv: torch.Tensor, U: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``y = M^-1 r (K, 6)`` for the backbone factored by
    :func:`tridiag_factor`.

    CUDA tensors go to the kernel, one launch a call
    (``tridiag_apply.launches`` counts its launches); CPU tensors go to
    :func:`tridiag_apply_reference`."""
    if S_inv.device.type == "cpu" and U.device.type == "cpu" and r.device.type == "cpu":
        return tridiag_apply_reference(S_inv, U, r)
    K = r.shape[0]
    dev = _check(K, S_inv=S_inv, U=U, r=r)
    y = torch.empty((K, B), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.icet_tridiag_apply(S_inv.data_ptr(), U.data_ptr(), r.data_ptr(), K,
                                     y.data_ptr(), stream)
    _raise_on(err, "tridiagonal apply")
    tridiag_apply.launches += 1
    return y


#: launches of the CUDA kernels (plain-version calls on CPU tensors do not count)
tridiag_factor.launches = 0
tridiag_apply.launches = 0
