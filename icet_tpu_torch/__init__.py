"""ICET on PyTorch and CUDA: the port of ``icet_tpu`` to an NVIDIA H100.

Distribution-to-distribution LiDAR registration with spherical
shadow-mitigation voxels, the frame-to-frame and keyframe odometry around
it, the keyframe block map, the ring-map MapMaker, the ScanMatcher, the
DNN perspective-shift filter and the training of its network, and the
pose-graph back end with loop closure.  The per-point pass of every solver
iteration (``csrc/fused_moments.cu``), the filter's BiasNet encoder
(``csrc/bias_encoder.cu``), the ``moment_method="pallas"`` scatter
(``csrc/moment_scatter.cu``), the windowed moments pass
(``csrc/fused_moments_windowed.cu``) and the pose graph's backbone factor
and sweeps (``csrc/tridiag_backbone.cu``) are hand-written CUDA kernels,
built by nvcc at first use; everything around them is plain PyTorch.  Entry points run on CUDA unless the caller passes
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
from icet_tpu_torch.filters import register_scans
from icet_tpu_torch.keyframe import BlockMap, KeyframeOdometry, run_keyframe_device
from icet_tpu_torch.mapping import MapMaker
from icet_tpu_torch.models.bias_net import train_bias_net
from icet_tpu_torch.models.train_data import train_bias_net_mixed
from icet_tpu_torch.odometry import (
    OdometryFrame,
    OdometryPipeline,
    run_odometry,
    run_odometry_device,
)
from icet_tpu_torch.pose_graph import (
    PoseGraph,
    close_loops,
    detect_loop_candidates,
    graph_from_odometry,
    optimize_poses,
    optimize_poses_sparse,
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
from icet_tpu_torch.scan_matcher import ScanMatcher

__all__ = [
    "BlockMap",
    "BlockMapConfig",
    "ICETConfig",
    "IterationDiag",
    "KeyframeConfig",
    "KeyframeOdometry",
    "MapConfig",
    "MapMaker",
    "OdometryConfig",
    "OdometryFrame",
    "OdometryPipeline",
    "PROFILES",
    "PoseGraph",
    "RegistrationResult",
    "ScanMatcher",
    "VoxelModel",
    "close_loops",
    "detect_loop_candidates",
    "graph_from_odometry",
    "odometry_step",
    "optimize_poses",
    "optimize_poses_sparse",
    "prepare_reference",
    "register",
    "register_pair",
    "register_scans",
    "run_keyframe_device",
    "run_odometry",
    "run_odometry_device",
    "train_bias_net",
    "train_bias_net_mixed",
]
