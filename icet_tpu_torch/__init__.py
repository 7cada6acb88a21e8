"""ICET on PyTorch and CUDA: the port of ``icet_tpu`` to an NVIDIA H100.

Distribution-to-distribution LiDAR registration with spherical
shadow-mitigation voxels, and the frame-to-frame odometry around it.  The
per-point pass of every solver iteration is a hand-written CUDA kernel
(``csrc/fused_moments.cu``, built by nvcc at first use); everything around
it is plain PyTorch.  Entry points run on CUDA unless the caller passes
``device="cpu"``.  This package imports neither JAX nor ``icet_tpu``.
"""

from icet_tpu_torch.config import (
    BlockMapConfig,
    ICETConfig,
    KeyframeConfig,
    MapConfig,
    OdometryConfig,
    PROFILES,
)
from icet_tpu_torch.odometry import (
    OdometryFrame,
    OdometryPipeline,
    run_odometry,
    run_odometry_device,
)
from icet_tpu_torch.solver import (
    IterationDiag,
    RegistrationResult,
    VoxelModel,
    odometry_step,
    prepare_reference,
    register,
    register_pair,
)

__all__ = [
    "BlockMapConfig",
    "ICETConfig",
    "IterationDiag",
    "KeyframeConfig",
    "MapConfig",
    "OdometryConfig",
    "OdometryFrame",
    "OdometryPipeline",
    "PROFILES",
    "RegistrationResult",
    "VoxelModel",
    "odometry_step",
    "prepare_reference",
    "register",
    "register_pair",
    "run_odometry",
    "run_odometry_device",
]
