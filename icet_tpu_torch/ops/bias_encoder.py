"""The BiasNet encoder and max-pool: three Dense+LayerNorm+ReLU stages in
bf16 over every point of every voxel, then the max over the points.

``bias_encoder_pool`` launches the CUDA kernel ``csrc/bias_encoder.cu`` on
CUDA tensors and takes the plain version, :func:`encoder_pool_reference`,
only for CPU tensors.  It replaces the TPU kernel
``icet_tpu/models/bias_net.py::_encoder_kernel`` (wrapper
``apply_bias_net(fused=True)``) and its tile variants
``tools/bench_encoder_variants.py::kern`` (the ``tile`` argument here).
Unlike the TPU split, stage 1 runs inside the kernel too.

Each stage rounds as ``icet_tpu``'s ``_dense_ln_relu`` does: the product
of bf16 operands accumulated in float32, rounded to bf16; plus the bf16
bias, rounded to bf16 again; LayerNorm in float32 with the variance
``max(E[a^2] - mu^2, 0)`` and eps 1e-6, then the float32 scale and bias;
ReLU, rounded to bf16.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icet_tpu_torch import _build

#: input width (xyz + scan tag) and the encoder's stage widths
IN_DIM = 4
FEATURES = (64, 128, 256)
#: voxels a block: the tile sizes of the TPU kernel's variants
TILES = (8, 16, 32)
LN_EPS = 1e-6


def dense_ln_relu_reference(h, w_bf16, b_bf16, scale, bias) -> torch.Tensor:
    """One stage on bf16 rows ``h (..., C)``: returns bf16 ``(..., F)``.

    ``h.float() @ w.float()`` multiplies bf16 values exactly and sums in
    float32 (no bf16 ``matmul``, whose CPU accumulation is unspecified)."""
    a = (h.float() @ w_bf16.float()).to(torch.bfloat16)
    a = (a.float() + b_bf16.float()).to(torch.bfloat16).float()
    mu = a.mean(dim=-1, keepdim=True)
    var = torch.clamp((a * a).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    y = (a - mu) * (1.0 / torch.sqrt(var + LN_EPS))
    y = y * scale + bias
    return torch.relu(y).to(torch.bfloat16)


def encoder_pool_reference(x: torch.Tensor, weights) -> torch.Tensor:
    """Plain PyTorch version: ``(B, P, 4)`` float32 -> ``(B, 256)`` float32
    pooled codes.  ``weights`` is ``[w_bf16, b_bf16, scale, bias]`` per
    stage, ``w`` laid out ``(in, out)``."""
    h = x.to(torch.bfloat16)
    for i in range(0, len(weights), 4):
        h = dense_ln_relu_reference(h, *weights[i : i + 4])
    return h.float().amax(dim=-2)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("bias_encoder")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.icet_bias_encoder.argtypes = [p, i, i, *([p] * 12), p, i, p]
    lib.icet_bias_encoder.restype = i
    lib.icet_cuda_error_string.argtypes = [i]
    lib.icet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, weights, tile: int) -> None:
    if tile not in TILES:
        raise ValueError(f"tile must be one of {TILES}, got {tile}")
    if x.dtype != torch.float32 or x.ndim != 3 or x.shape[2] != IN_DIM or x.shape[1] < 1:
        raise ValueError(f"x must be float32 (B, P>=1, {IN_DIM}), got {x.dtype} {tuple(x.shape)}")
    if x.shape[0] * x.shape[1] * IN_DIM >= 2**31:
        raise ValueError("too many points for 32-bit indexing")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if len(weights) != 4 * len(FEATURES):
        raise ValueError(f"expected {4 * len(FEATURES)} weight tensors, got {len(weights)}")
    dims = (IN_DIM,) + FEATURES
    for s, (c, f) in enumerate(zip(dims[:-1], dims[1:])):
        shapes = ((c, f), (f,), (f,), (f,))
        dtypes = (torch.bfloat16, torch.bfloat16, torch.float32, torch.float32)
        for k, (shape, dtype) in enumerate(zip(shapes, dtypes)):
            t = weights[4 * s + k]
            if t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape:
                raise ValueError(
                    f"stage {s} weight {k} must be {dtype} {shape} on {x.device}, "
                    f"got {t.dtype} {tuple(t.shape)} on {t.device}"
                )
            if not t.is_contiguous() or t.data_ptr() % 32:
                raise ValueError(f"stage {s} weight {k} must be contiguous and 32-byte aligned")


def bias_encoder_pool(x: torch.Tensor, weights, tile: int = 16) -> torch.Tensor:
    """``(B, 256)`` float32 max-pooled encoder codes of ``x (B, P, 4)``.

    CUDA tensors go to the kernel, ``tile`` voxels a block
    (``bias_encoder_pool.launches`` counts its launches); CPU tensors go to
    :func:`encoder_pool_reference`.
    """
    if x.device.type == "cpu":
        return encoder_pool_reference(x, weights)
    if x.device.type != "cuda":
        raise ValueError(f"no encoder kernel for device {x.device}")
    _check(x, weights, tile)
    b, p, _ = x.shape
    out = torch.empty((b, FEATURES[-1]), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.icet_bias_encoder(
            x.data_ptr(), b, p, *(w.data_ptr() for w in weights),
            out.data_ptr(), tile, stream,
        )
    if err != 0:
        msg = lib.icet_cuda_error_string(err).decode()
        raise RuntimeError(f"bias encoder kernel launch failed: {msg} ({err})")
    bias_encoder_pool.launches += 1
    return out


#: launches of the CUDA kernel (plain-version calls on CPU tensors do not count)
bias_encoder_pool.launches = 0
