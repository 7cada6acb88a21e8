"""The Gauss-Newton iteration's 6x6 eigensystem and its pruned update: from
H^T W H, H^T W dz, X and (warm) the previous eigenbasis to the eigenvalues,
the eigenbasis, the kept axes, X + dx and the iteration's diagnostics.

``gn_eigh6`` launches the CUDA kernel ``csrc/gn_eigh6.cu`` on CUDA tensors,
one launch an iteration, and takes the plain version, ``gn_eigh6_reference``,
only for CPU tensors.  The kernel replaces no TPU kernel: the JAX package
leaves the round-robin Jacobi (``ops/linalg.py``: ``eigh_small``,
``eigh_small_warm_safe``) to XLA, and on this card the unfused chain is ~17
tiny launches a round, ~690 a cold eigensystem and ~220 a warm one.  The
kernel runs the plain version's rotations term by term: its sums of
products are added in an order it fixes (cuBLAS, behind the plain version
on the card, adds them in its own), the same bits every launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icet_tpu_torch import _build
from icet_tpu_torch.ops.linalg import eigh_small, eigh_small_warm_safe, inverse_where

#: 32-bit words of the kernel's output (``kOut*`` in the kernel): w6 (6,),
#: U2 (6, 6), X + dx (6,), the condition, |dx|, the dropped axes (int32),
#: keep (6 bytes)
OUT_W, OUT_U, OUT_X, OUT_COND, OUT_DX_NORM, OUT_DROPPED, OUT_KEEP = 0, 6, 42, 48, 49, 50, 51
OUT_WORDS = 53
#: threads of the kernel's one block: one a matrix entry (``kThreads``)
THREADS = 36
_P, _F = ctypes.c_void_p, ctypes.c_float
#: ``icet_gn_eigh6``'s parameters: H^T W H, H^T W dz, X, the warm basis (or
#: null), the condition cutoff, the output and the stream
ARGTYPES = (_P, _P, _P, _P, _F, _P, _P)


def gn_eigh6_reference(HTWH, HTWdz, X, U2_warm, condition_cutoff: float):
    """Plain PyTorch version of :func:`gn_eigh6`."""
    if U2_warm is None:
        w6, U2 = eigh_small(HTWH)
    else:
        w6, U2 = eigh_small_warm_safe(HTWH, U2_warm)
    cond_full = torch.abs(w6[-1]) / torch.clamp(torch.abs(w6[0]), min=1e-30)
    keep = (torch.abs(w6[-1]) <= condition_cutoff * torch.abs(w6)) & (
        torch.abs(w6) > 1e-30
    )
    dx = U2 @ (inverse_where(w6, keep) * (U2.T @ HTWdz))
    return (X + dx, w6, keep, U2, cond_full, torch.linalg.norm(dx),
            torch.sum(~keep, dtype=torch.int32))


def unpack(out: torch.Tensor):
    """The kernel's outputs as views of its ``(OUT_WORDS,)`` float32 buffer,
    in :func:`gn_eigh6`'s order."""
    keep = out.view(torch.uint8)[4 * OUT_KEEP:4 * OUT_KEEP + 6].view(torch.bool)
    dropped = out[OUT_DROPPED:OUT_DROPPED + 1].view(torch.int32).reshape(())
    return (out[OUT_X:OUT_X + 6], out[OUT_W:OUT_W + 6], keep,
            out[OUT_U:OUT_U + 36].view(6, 6), out[OUT_COND], out[OUT_DX_NORM], dropped)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("gn_eigh6")
    lib.icet_gn_eigh6.argtypes = list(ARGTYPES)
    lib.icet_gn_eigh6.restype = ctypes.c_int
    lib.icet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.icet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(HTWH, HTWdz, X, U2_warm) -> None:
    tensors = {"HTWH": (HTWH, (6, 6)), "HTWdz": (HTWdz, (6,)), "X": (X, (6,))}
    if U2_warm is not None:
        tensors["U2_warm"] = (U2_warm, (6, 6))
    for name, (t, shape) in tensors.items():
        if t.device != HTWH.device:
            raise ValueError(f"{name} is on {t.device}, HTWH on {HTWH.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def gn_eigh6(HTWH, HTWdz, X, U2_warm, condition_cutoff: float):
    """One iteration's eigensystem and pruned update: ``(X + dx (6,), w6
    (6,) ascending, keep (6,) bool, U2 (6, 6) eigenvectors as columns,
    cond_full, |dx|, dropped axes int32)``.  Cold (``U2_warm`` None):
    ``eigh_small`` at 8 sweeps; warm: ``eigh_small_warm_safe`` from
    ``U2_warm``.  An axis is kept where ``|w_max| <= condition_cutoff * |w|``
    and ``|w| > 1e-30``; ``dx = U2 (w^-1 on the kept axes) U2^T HTWdz``.

    CUDA tensors go to the kernel, one launch a call and no read back to
    the host (``gn_eigh6.launches`` counts its launches); CPU tensors go to
    :func:`gn_eigh6_reference`.
    """
    if HTWH.device.type == "cpu":
        return gn_eigh6_reference(HTWH, HTWdz, X, U2_warm, condition_cutoff)
    if HTWH.device.type != "cuda":
        raise ValueError(f"no eigensystem kernel for device {HTWH.device}")
    _check(HTWH, HTWdz, X, U2_warm)
    HTWH, HTWdz, X = HTWH.contiguous(), HTWdz.contiguous(), X.contiguous()
    if U2_warm is not None:
        U2_warm = U2_warm.contiguous()
    out = torch.empty(OUT_WORDS, dtype=torch.float32, device=HTWH.device)
    lib = _lib()
    with torch.cuda.device(HTWH.device):
        err = lib.icet_gn_eigh6(
            HTWH.data_ptr(), HTWdz.data_ptr(), X.data_ptr(),
            None if U2_warm is None else U2_warm.data_ptr(), condition_cutoff,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        msg = lib.icet_cuda_error_string(err).decode()
        raise RuntimeError(f"eigensystem kernel launch failed: {msg} ({err})")
    gn_eigh6.launches += 1
    return unpack(out)


#: launches of the CUDA kernel (plain-version calls on CPU tensors do not count)
gn_eigh6.launches = 0
