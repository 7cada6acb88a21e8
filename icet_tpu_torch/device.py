"""Device selection and float32 precision for the port's entry points.

Entry points run on CUDA unless the caller names another device; asking for
CUDA on a machine without it raises instead of slipping to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def set_fp32_precision() -> None:
    """Keep float32 products in full float32 (no TF32), as the JAX package
    pins ``Precision.HIGHEST`` on every product touching coordinates."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means CUDA.

    Raises RuntimeError when CUDA is asked for and not available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    set_fp32_precision()
    return dev


def as_points(x, device: torch.device) -> torch.Tensor:
    """An (N, 3) cloud (numpy or tensor) as a contiguous float32 tensor."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return x.to(device=device, dtype=torch.float32).contiguous()
