"""Configuration for the PyTorch/CUDA port of the ICET registration engine.

A field-for-field copy of ``icet_tpu/config.py`` (same names, same defaults,
same ``PROFILES``), kept as a copy rather than an import because importing
anything under ``icet_tpu`` imports JAX.  Field semantics are documented on
the JAX package's dataclasses; the comments here note only what a field
means for the port.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ICETConfig:
    """Static configuration for one registration solve."""

    # ---- spherical voxel grid ------------------------------------------------
    n_theta: int = 75
    n_phi: int = 24
    phi_min: float = 0.0
    phi_max: float = math.pi

    # ---- radial voxelization mode -------------------------------------------
    #: "adaptive" (per-spike radial clustering) or "fixed" (geometric shells).
    #: The fused moments kernel takes both: fixed mode's 90,000-row table
    #: by its sorted parts (the moment scatter kernel's large-table branch).
    radial_mode: str = "adaptive"
    n_shells: int = 50

    # ---- radial clustering (shadow-mitigation voxels) -----------------------
    min_pts: int = 25
    cluster_gap: float = 0.1
    cluster_buffer: float = 0.1

    # ---- point / voxel validity gates ---------------------------------------
    min_range: float = 0.2
    min_outer_range: float = 0.1

    # ---- solver -------------------------------------------------------------
    n_iters: int = 7
    #: early exit once |dx| falls below this (0 = fixed n_iters)
    convergence_tol: float = 0.0
    #: early exit once |dx| falls below this multiple of |pred_stds| (0 = off)
    convergence_stat_scale: float = 0.0
    sigma_scale: float = 2.0
    #: "endpoint" (sigma endpoint test) or "ndt" (eigenvalue threshold)
    suppression: str = "endpoint"
    condition_cutoff: float = 1e6
    pinv_rcond: float = 1e-7
    clip_fill: float = 0.0
    range_sigma: float = 0.0

    # ---- moving-object rejection --------------------------------------------
    remove_moving: bool = False
    rm_start_iter: int = 4
    rm_residual_thresh: float = 0.3
    rm_yaw_thresh: float = 0.1

    # ---- DNN perspective-shift filter ---------------------------------------
    dnn_filter: bool = False
    dnn_start_iter: int = 7
    dnn_thresh: float = 0.05
    dnn_sample_pts: int = 100
    dnn_refine_steps: int = 1
    dnn_in_loop: bool = True

    # ---- implementation knobs -----------------------------------------------
    #: "auto"/"fused": the fused CUDA kernel on CUDA tensors, its plain
    #: PyTorch version on CPU tensors; "segsum": PyTorch binning, summed by
    #: the moment scatter kernel on CUDA and ``index_add_`` on the CPU;
    #: "pallas": PyTorch transform and binning, then the moment scatter
    #: kernel; "onehot": the same binning, then blocked one-hot products of
    #: ``moment_block`` points in float32 (``torch.matmul``, any device).
    moment_method: str = "auto"
    moment_block: int = 1024

    @property
    def n_voxels(self) -> int:
        if self.radial_mode == "fixed":
            return self.n_shells * self.n_theta * self.n_phi
        return self.n_theta * self.n_phi

    @property
    def n_angular(self) -> int:
        """Voxels per radial shell (= all voxels in adaptive mode)."""
        return self.n_theta * self.n_phi

    @property
    def shell_growth(self) -> float:
        """Geometric shell spacing factor making cells ~cubic."""
        return 1.0 + math.atan(2.0 * math.pi / self.n_theta)

    def replace(self, **kw) -> "ICETConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    """Frame-loop configuration."""

    warm_start: bool = True
    #: "previous" or "extrapolate" (constant-acceleration composition)
    warm_start_mode: str = "previous"
    #: zero the frame's transform if any component exceeds this
    divergence_clamp: float = 0.3
    sensor_hz: float = 10.0


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """HD-map accumulator configuration."""

    capacity: int = 600_000
    points_per_scan: int = 2_000


@dataclasses.dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe odometry configuration.  ``ovf_spawn`` never fires on the
    port: its moments kernel has no window, so there is no overflow to
    spawn on (as in the JAX package off the TPU)."""

    spawn: str = "auto"
    stds_growth: float = 2.5
    ovf_spawn: int = 512
    spawn_distance: float = 2.0
    spawn_angle: float = 0.25
    min_corr_fraction: float = 0.35
    delta_clamp: float = 0.3


@dataclasses.dataclass(frozen=True)
class BlockMapConfig:
    """Keyframe block map configuration."""

    n_blocks: int = 64
    block_capacity: int = 16_384
    points_per_scan: int = 1_000


PROFILES = {
    "mapping": ICETConfig(n_iters=12, min_range=0.2),
    "odometry": ICETConfig(
        n_iters=7, min_range=2.0, convergence_tol=1e-4,
        convergence_stat_scale=1.0,
    ),
    "odometry_guarded": ICETConfig(
        n_iters=7, min_range=2.0, convergence_tol=1e-4,
        convergence_stat_scale=1.0, clip_fill=0.6, condition_cutoff=1e4,
    ),
    "notebook": ICETConfig(
        n_theta=50,
        n_phi=15,
        phi_min=3 * math.pi / 8,
        phi_max=7 * math.pi / 8,
        n_iters=5,
        cluster_gap=0.5,
        cluster_buffer=0.1,
        min_range=0.2,
        sigma_scale=3.0,
        condition_cutoff=1e7,
        remove_moving=True,
    ),
}
