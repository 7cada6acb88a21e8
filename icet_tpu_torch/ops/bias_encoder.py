"""The BiasNet encoder and max-pool: three Dense+LayerNorm+ReLU stages in
bf16 over every point of every voxel, then the max over the points.

``bias_encoder_pool`` launches the CUDA kernel ``csrc/bias_encoder.cu`` on
CUDA tensors and takes the plain version, :func:`encoder_pool_reference`,
only for CPU tensors.  It replaces the TPU kernel
``icet_tpu/models/bias_net.py::_encoder_kernel`` (wrapper
``apply_bias_net(fused=True)``) and its tile variants
``tools/bench_encoder_variants.py::kern`` (the ``tile`` argument here).
Unlike the TPU split, stage 1 runs inside the kernel too.  The kernel
reads its weights as one image (:func:`weight_image`: W2 and W3 in wgmma's
swizzled layout), which the wrapper builds once per set of weight tensors.

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
#: voxels a work item: the tile sizes of the TPU kernel's variants
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
    lib.icet_bias_encoder.argtypes = [p, i, i, p, p, i, i, p]
    lib.icet_bias_encoder.restype = i
    lib.icet_bias_encoder_image_bytes.argtypes = []
    lib.icet_bias_encoder_image_bytes.restype = i
    if lib.icet_bias_encoder_image_bytes() != IMAGE_BYTES:
        raise RuntimeError("the weight image and the kernel disagree on its size")
    lib.icet_cuda_error_string.argtypes = [i]
    lib.icet_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------------------
# The weight image: W2 and W3 in wgmma's K-major 128-byte-swizzled layout
# (csrc/hopper.cuh), then W1 and the per-stage vectors as float32.
# ---------------------------------------------------------------------------

#: k values a swizzled region holds (128 bytes of bf16 a row)
SWIZZLE_K = 64


def _swizzle_index(n: int, device) -> torch.Tensor:
    """``(n, 8)`` chunk index: row ``r``'s chunk ``c`` pairs with chunk
    ``c ^ (r % 8)`` (an involution, so it packs and unpacks)."""
    r = torch.arange(n, device=device).unsqueeze(1)
    c = torch.arange(8, device=device).unsqueeze(0)
    return torch.bitwise_xor(c, r % 8)


def pack_wgmma_b(w: torch.Tensor) -> torch.Tensor:
    """``(K, N)`` bf16 -> flat ``K * N`` bf16 in wgmma's K-major layout with
    the 128-byte swizzle: K in regions of 64, each ``N`` rows of 64 values
    (row ``n`` holds column ``n`` of ``w``), the 8-value chunk ``c`` of row
    ``n`` stored at chunk ``c ^ (n % 8)``."""
    k, n = w.shape
    if k % SWIZZLE_K or n % 8:
        raise ValueError(f"wgmma B must be (64 m, 8 m'), got {tuple(w.shape)}")
    regions = w.t().reshape(n, k // SWIZZLE_K, 8, 8).permute(1, 0, 2, 3)
    idx = _swizzle_index(n, w.device).view(1, n, 8, 1).expand(k // SWIZZLE_K, n, 8, 8)
    return torch.gather(regions, 2, idx).contiguous().reshape(-1)


def unpack_wgmma_b(flat: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """The ``(K, N)`` matrix of a :func:`pack_wgmma_b` image."""
    regions = flat.reshape(k // SWIZZLE_K, n, 8, 8)
    idx = _swizzle_index(n, flat.device).view(1, n, 8, 1).expand(k // SWIZZLE_K, n, 8, 8)
    return torch.gather(regions, 2, idx).permute(1, 0, 2, 3).reshape(n, k).t().contiguous()


#: bytes of the image: W2 and W3 in bf16, then 1,600 float32 (W1 4x64 and
#: the bias, scale and beta of the three stages)
IMAGE_BYTES = 2 * (FEATURES[0] * FEATURES[1] + FEATURES[1] * FEATURES[2]) + 4 * (
    IN_DIM * FEATURES[0] + 3 * sum(FEATURES))


def weight_image(weights) -> torch.Tensor:
    """The kernel's ``IMAGE_BYTES``-byte weight image (uint8) of
    ``[w, b, scale, beta]`` per stage: :func:`pack_wgmma_b` of W2 and W3,
    then W1 (in, out) row-major, b1, scale1, beta1, b2, ..., beta3 as
    float32 (the bf16 values widened exactly)."""
    w1, b1, g1, e1, w2, b2, g2, e2, w3, b3, g3, e3 = weights
    mats = torch.cat([pack_wgmma_b(w2), pack_wgmma_b(w3)]).view(torch.uint8)
    vec = torch.cat([t.float().reshape(-1) for t in (w1, b1, g1, e1, b2, g2, e2, b3, g3, e3)])
    return torch.cat([mats, vec.view(torch.uint8)])


#: weight sets whose image is kept
IMAGE_CACHE = 8
#: ``(weight tensors, their versions, image)``, the newest last
_images: list[tuple[tuple[torch.Tensor, ...], tuple[int, ...], torch.Tensor]] = []


def _cached_image(weights) -> torch.Tensor:
    """:func:`weight_image`, built once per set of weight tensors.  An entry
    holds the tensors themselves, so no other tensor can take their memory
    while it lives, and it is used only for those very tensors at the
    versions it was built from: an in-place update rebuilds it."""
    weights = tuple(weights)
    versions = tuple(t._version for t in weights)
    for ws, vs, img in _images:
        if vs == versions and all(a is b for a, b in zip(ws, weights)):
            return img
    img = weight_image(weights)
    _images.append((weights, versions, img))
    del _images[:-IMAGE_CACHE]
    return img


def encoder_blocks(b: int, sm_count: int) -> int:
    """Blocks of one launch: one an SM, at most one a voxel."""
    return max(1, min(b, sm_count))


def _check(x: torch.Tensor, weights, tile: int) -> None:
    if tile not in TILES:
        raise ValueError(f"tile must be one of {TILES}, got {tile}")
    if x.dtype != torch.float32 or x.ndim != 3 or x.shape[2] != IN_DIM or x.shape[1] < 1:
        raise ValueError(f"x must be float32 (B, P>=1, {IN_DIM}), got {x.dtype} {tuple(x.shape)}")
    if x.shape[0] * x.shape[1] * IN_DIM >= 2**31:
        raise ValueError("too many points for 32-bit indexing")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
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


def bias_encoder_pool(x: torch.Tensor, weights, tile: int = 16) -> torch.Tensor:
    """``(B, 256)`` float32 max-pooled encoder codes of ``x (B, P, 4)``.

    CUDA tensors go to the kernel, ``tile`` voxels a work item
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
        image = _cached_image(weights)
        blocks = encoder_blocks(b, _sm_count(torch.cuda.current_device()))
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.icet_bias_encoder(
            x.data_ptr(), b, p, image.data_ptr(), out.data_ptr(), tile, blocks, stream,
        )
    if err != 0:
        msg = lib.icet_cuda_error_string(err).decode()
        raise RuntimeError(f"bias encoder kernel launch failed: {msg} ({err})")
    bias_encoder_pool.launches += 1
    return out


#: launches of the CUDA kernel (plain-version calls on CPU tensors do not count)
bias_encoder_pool.launches = 0
