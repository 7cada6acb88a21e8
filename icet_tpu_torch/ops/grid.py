"""Spherical voxel grid: flat voxel ids, shell bounds, anchors.

Layout as in ``icet_tpu/ops/grid.py``: ``vid = iphi * n_theta + itheta``
(plus ``shell * n_angular`` in fixed radial mode); out-of-band and
out-of-range points take the sentinel id ``V``, the extra last row of every
per-voxel table.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from icet_tpu_torch.config import ICETConfig
from icet_tpu_torch.ops.geometry import TWO_PI, spherical_to_cart


def voxel_ids(rtp: torch.Tensor, cfg: ICETConfig) -> torch.Tensor:
    """Flat voxel id per spherical point ``(..., 3) -> (...,) int32``."""
    r, theta, phi = rtp[..., 0], rtp[..., 1], rtp[..., 2]
    itheta = torch.clamp(
        (theta / TWO_PI * cfg.n_theta).to(torch.int32), 0, cfg.n_theta - 1
    )
    phi_span = cfg.phi_max - cfg.phi_min
    fphi = (phi - cfg.phi_min) / phi_span * cfg.n_phi
    iphi = torch.floor(fphi).to(torch.int32)
    in_band = (iphi >= 0) & (iphi < cfg.n_phi) & (r >= cfg.min_range)
    vid = iphi * cfg.n_theta + itheta
    if cfg.radial_mode == "fixed":
        safe_r = torch.clamp(r, min=cfg.min_range)
        shell = torch.floor(
            torch.log(safe_r / cfg.min_range) / math.log(cfg.shell_growth)
        ).to(torch.int32)
        in_band = in_band & (shell >= 0) & (shell < cfg.n_shells)
        shell = torch.clamp(shell, 0, cfg.n_shells - 1)
        vid = shell * cfg.n_angular + vid
    return torch.where(in_band, vid, cfg.n_voxels).to(torch.int32)


def shell_edges(cfg: ICETConfig, device=None) -> torch.Tensor:
    """Radial shell edges ``(n_shells + 1,)`` for fixed mode."""
    k = np.arange(cfg.n_shells + 1, dtype=np.float64)
    edges = (cfg.min_range * cfg.shell_growth**k).astype(np.float32)
    return torch.from_numpy(edges).to(device)


def fixed_shell_bounds(cfg: ICETConfig, device=None) -> torch.Tensor:
    """(V+1, 2) bounds for fixed mode: each voxel spans its shell."""
    edges = shell_edges(cfg, device)
    inner = torch.repeat_interleave(edges[:-1], cfg.n_angular)
    outer = torch.repeat_interleave(edges[1:], cfg.n_angular)
    bounds = torch.stack([inner, outer], dim=-1)
    return torch.cat([bounds, bounds.new_zeros((1, 2))], dim=0)


def voxel_angle_centers(cfg: ICETConfig, device=None):
    """Bin-center ``(theta, phi)`` per voxel id, each ``(V,)``."""
    ang = torch.arange(cfg.n_voxels, dtype=torch.int32, device=device) % cfg.n_angular
    itheta = ang % cfg.n_theta
    iphi = ang // cfg.n_theta
    theta_c = (itheta.to(torch.float32) + 0.5) / cfg.n_theta * TWO_PI
    phi_span = cfg.phi_max - cfg.phi_min
    phi_c = cfg.phi_min + (iphi.to(torch.float32) + 0.5) / cfg.n_phi * phi_span
    return theta_c, phi_c


def voxel_anchors(bounds: torch.Tensor, cfg: ICETConfig) -> torch.Tensor:
    """Cartesian anchor per voxel ``(V+1, 3)`` (sentinel row 0): the radial
    midpoint of the bounds on the voxel's angular bin center, rounded to
    bf16 as the JAX package rounds it (part of the reference's numbers)."""
    theta_c, phi_c = voxel_angle_centers(cfg, bounds.device)
    r_mid = 0.5 * (bounds[: cfg.n_voxels, 0] + bounds[: cfg.n_voxels, 1])
    anchors = spherical_to_cart(torch.stack([r_mid, theta_c, phi_c], dim=-1))
    anchors = torch.cat([anchors, anchors.new_zeros((1, 3))], dim=0)
    return anchors.to(torch.bfloat16).float()


def voxel_corners(bounds: torch.Tensor, cfg: ICETConfig) -> torch.Tensor:
    """Spherical-space corner coordinates ``(V, 8, 3)`` of each voxel
    frustum, ``(r, theta, phi)`` over r in the bounds, then theta, then
    phi (visualisation and export; the reference's get_corners_cluster,
    ICET_spherical.py:864-882)."""
    dev = bounds.device
    ang = torch.arange(cfg.n_voxels, dtype=torch.int32, device=dev) % cfg.n_angular
    itheta = (ang % cfg.n_theta).to(torch.float32)
    iphi = (ang // cfg.n_theta).to(torch.float32)
    th0 = itheta / cfg.n_theta * TWO_PI
    th1 = (itheta + 1.0) / cfg.n_theta * TWO_PI
    phi_span = cfg.phi_max - cfg.phi_min
    ph0 = cfg.phi_min + iphi / cfg.n_phi * phi_span
    ph1 = cfg.phi_min + (iphi + 1.0) / cfg.n_phi * phi_span
    r0 = bounds[: cfg.n_voxels, 0]
    r1 = bounds[: cfg.n_voxels, 1]
    corners = [torch.stack([r, th, ph], dim=-1)
               for r in (r0, r1) for th in (th0, th1) for ph in (ph0, ph1)]
    return torch.stack(corners, dim=1)
