"""Headless visualization + export layer; a matplotlib copy of
``icet_tpu/viz.py``.  Its functions take numpy arrays or tensors (on any
device), each moved to the host once.

matplotlib is imported when this module is: ``import icet_tpu_torch`` does
not import it, and the entry points import it only under ``--viz``.

The reference's L4 is an interactive vedo/VTK window (draw methods inside
ICET_spherical.py:718-772,827-861,1091-1203) and an OpenGL demo whose
``visualization.h`` is missing from the repo (SURVEY.md known defects).
A GPU server has no display, so this layer renders headless artifacts instead:

* matplotlib PNG snapshots: clouds, registration overlays, voxel
  distribution ellipsoids (the reference's ``draw_ell``), cluster frusta
  corners, the HD map + snail trail;
* PLY export of clouds/maps for external viewers.
"""

from __future__ import annotations

import numpy as np
import torch

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def _ax3d(figsize=(9, 9)):
    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(111, projection="3d")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    return fig, ax


def _host(x) -> np.ndarray:
    """``x`` as a numpy array: a tensor is copied to the host once."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _subsample(pts, n):
    pts = _host(pts)
    pts = pts[np.linalg.norm(pts, axis=1) > 1e-6]
    if len(pts) > n:
        idx = np.linspace(0, len(pts) - 1, n).astype(int)
        pts = pts[idx]
    return pts


def plot_clouds(path, clouds, colors=None, labels=None, max_pts=20000, title=None):
    """Scatter one or more clouds (reference draw_cloud,
    ICET_spherical.py:1312-1322)."""
    fig, ax = _ax3d()
    colors = colors or ["#c05050", "#5050c0", "#50a050", "#b0a020"]
    for i, c in enumerate(clouds):
        p = _subsample(c, max_pts // max(len(clouds), 1))
        ax.scatter(
            p[:, 0], p[:, 1], p[:, 2], s=0.5, c=colors[i % len(colors)],
            label=(labels[i] if labels else None), alpha=0.6,
        )
    if labels:
        ax.legend()
    if title:
        ax.set_title(title)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_registration(path, scan1, scan2, X, max_pts=20000):
    """Before/after overlay of a registration result."""
    from icet_tpu_torch.ops.geometry import transform_points

    scan1, scan2 = _host(scan1), _host(scan2)
    moved = transform_points(torch.as_tensor(np.asarray(scan2, np.float32)),
                             torch.as_tensor(np.asarray(_host(X), np.float32))).numpy()
    fig = plt.figure(figsize=(16, 8))
    for k, (pair, name) in enumerate(
        [((scan1, scan2), "before"), ((scan1, moved), "after")]
    ):
        ax = fig.add_subplot(1, 2, k + 1, projection="3d")
        for c, col in zip(pair, ["#c05050", "#5050c0"]):
            p = _subsample(c, max_pts // 2)
            ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=0.4, c=col, alpha=0.5)
        ax.set_title(name)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def _ellipsoid_mesh(mean, cov, scale=2.0, res=10):
    w, v = np.linalg.eigh(cov)
    w = np.clip(w, 0, None)
    u = np.linspace(0, 2 * np.pi, res)
    t = np.linspace(0, np.pi, res)
    sphere = np.stack(
        [
            np.outer(np.cos(u), np.sin(t)),
            np.outer(np.sin(u), np.sin(t)),
            np.outer(np.ones_like(u), np.cos(t)),
        ],
        axis=-1,
    )
    ell = sphere * (scale * np.sqrt(w))[None, None, :]
    ell = ell @ v.T + mean
    return ell


def plot_voxel_model(path, model, max_ellipsoids=300, scale=2.0, title=None):
    """Draw the fitted voxel Gaussians of the port's ``VoxelModel`` as
    ellipsoids (reference draw_ell, ICET_spherical.py:827-851),
    colour-coding fully-kept vs axis-suppressed voxels."""
    valid = _host(model.valid)
    means = _host(model.mean)[valid]
    covs = _host(model.cov)[valid]
    lmask = _host(model.lmask)[valid]
    if len(means) > max_ellipsoids:
        sel = np.linspace(0, len(means) - 1, max_ellipsoids).astype(int)
        means, covs, lmask = means[sel], covs[sel], lmask[sel]
    fig, ax = _ax3d()
    for m, c, l in zip(means, covs, lmask):
        suppressed = l.sum() < 3
        e = _ellipsoid_mesh(m, c, scale=scale)
        ax.plot_surface(
            e[..., 0], e[..., 1], e[..., 2],
            color="#d08030" if suppressed else "#3070c0",
            alpha=0.25, linewidth=0,
        )
    if title:
        ax.set_title(title)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_map(path, map_points, trail=None, max_pts=40000, title="HD map"):
    """Map + snail-trail snapshot (reference /hd_map + /snail_trail_topic)."""
    fig, ax = _ax3d()
    p = _subsample(map_points, max_pts)
    ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=0.4, c=p[:, 2], cmap="viridis",
               alpha=0.5)
    if trail is not None and len(trail):
        t = _host(trail)
        ax.plot(t[:, 0], t[:, 1], t[:, 2], "r.-", markersize=4, linewidth=1.5)
    ax.set_title(title)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_trajectory(path, poses, ref_poses=None, title="trajectory"):
    """2D top-down trajectory plot with optional ground truth."""
    fig, ax = plt.subplots(figsize=(8, 8))
    t = np.asarray([_host(p)[:3, 3] for p in poses])
    ax.plot(t[:, 0], t[:, 1], "b.-", label="estimate")
    if ref_poses is not None:
        r = np.asarray([_host(p)[:3, 3] for p in ref_poses])
        ax.plot(r[:, 0], r[:, 1], "g--", label="ground truth")
    ax.axis("equal")
    ax.grid(True, alpha=0.3)
    ax.legend()
    ax.set_title(title)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def save_ply(path, points, colors=None):
    """Export a cloud to binary-little-endian PLY for external viewers."""
    pts = np.asarray(_host(points), np.float32)
    pts = pts[np.isfinite(pts).all(axis=1)]
    n = len(pts)
    has_color = colors is not None
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
               "property float x", "property float y", "property float z"]
        if has_color:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr += ["end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        if has_color:
            cols = np.asarray(_host(colors), np.uint8)
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec["xyz"] = pts
            rec["rgb"] = cols[: n]
            f.write(rec.tobytes())
        else:
            f.write(pts.tobytes())
    return path
