"""Training data for the perspective-shift bias network
(``icet_tpu/models/train_data.py``).

Two sources:

* synthetic planar patches (``bias_net.make_patch_batch``);
* raycast voxel pairs (here): two simulated lidar scans of one scene from
  different sensor poses, voxelised with the solver's own preparation, so
  the samples carry real perspective-shift support changes; each batch
  injects a known translation as the regression target.

The scans and scenes come from numpy's rng, as in the JAX package, so the
voxel samples can be held against its own.  The preparation uses the
config's ``moment_method="segsum"``: the plain ``index_add_`` sums on any
device, as the JAX package's segsum is XLA and not a Pallas kernel.  Batch
draws come from a ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch

from icet_tpu_torch.config import ICETConfig
from icet_tpu_torch.datasets.synthetic import Scene, scan_pair_with_ground_truth
from icet_tpu_torch.device import as_points, resolve_device
from icet_tpu_torch.filters import sample_voxel_points
from icet_tpu_torch.models.bias_net import (
    create_train_state,
    make_patch_batch,
    pack_voxel_samples,
    train_step,
)
from icet_tpu_torch.ops.clustering import membership
from icet_tpu_torch.ops.geometry import cart_to_spherical, transform_points
from icet_tpu_torch.ops.grid import voxel_ids
from icet_tpu_torch.solver import prepare_reference


def _voxel_samples(points, model, cfg: ICETConfig, n_samples: int):
    """Each voxel's first ``n_samples`` member points of ``points`` against
    ``model``'s bounds: ``((V+1, S, 3), counts (V+1,))``."""
    rtp = cart_to_spherical(points)
    vid = voxel_ids(rtp, cfg)
    member = membership(vid, rtp[..., 0], rtp[..., 0] >= cfg.min_range, model.bounds,
                        cfg.n_voxels)
    return sample_voxel_points(points, vid, member, cfg.n_voxels, n_samples)


def training_scene(rng: np.random.Generator) -> Scene:
    """A random scene for bias-net training from a zoo: box fields, a
    picket fence before a far wall (the coherent occlusion-shadow case),
    near-wall corridors, and the default scene.  Draws as the JAX package
    draws, so one numpy seed gives both packages the same scene."""
    kind = rng.integers(0, 4)
    if kind == 3:  # the default scene
        return Scene()
    if kind == 0:  # box field
        boxes = []
        for _ in range(rng.integers(6, 14)):
            cx, cy = rng.uniform(-18, 18, 2)
            if abs(cx) < 2.5 and abs(cy) < 2.5:
                continue
            w, d, h = rng.uniform(0.8, 3.5, 3)
            boxes.append((cx - w / 2, cx + w / 2, cy - d / 2, cy + d / 2,
                          -2.0, -2.0 + 2 * h))
        return Scene(boxes=tuple(boxes))
    if kind == 1:  # picket fence + far wall
        fx = rng.uniform(5.0, 10.0)
        wall = rng.uniform(30.0, 70.0)
        pitch = rng.uniform(1.0, 2.5)
        half_w = rng.uniform(0.15, 0.4)
        pillars = tuple(
            (fx - 0.2, fx + 0.2, y - half_w, y + half_w, -2.0, 5.0)
            for y in np.arange(-14.0, 14.01, pitch)
        )
        extra = ((-6.0, -4.0, -6.0, -4.0, -2.0, 2.0),
                 (-10.0, -8.0, 5.0, 7.0, -2.0, 3.0))
        return Scene(
            walls=((0, wall, -1), (0, -30.0, 1), (1, 25.0, -1), (1, -25.0, 1)),
            boxes=pillars + extra,
        )
    # near-wall corridor
    wy = rng.uniform(1.5, 3.5)
    return Scene(
        walls=((1, wy, -1), (1, -rng.uniform(3.0, 25.0), 1),
               (0, 30.0, -1), (0, -30.0, 1)),
        boxes=(
            (6.0, 8.0, -8.0, -6.0, -2.0, 3.0),
            (-9.0, -7.0, -7.0, -5.0, -2.0, 2.0),
            (12.0, 14.0, -12.0, -10.0, -2.0, 4.0),
        ),
    )


def _default_cfg() -> ICETConfig:
    return ICETConfig(
        n_theta=48, n_phi=16, phi_min=np.pi / 3, phi_max=2 * np.pi / 3,
        min_pts=20, min_range=1.0, moment_method="segsum",
    )


def _pair_samples(scan1, scan2, X_true, cfg, samples_per_voxel, min_pts, dev):
    """Aligned voxel samples of one scan pair: scan 2 moved by ``X_true``
    into scan 1's frame, both sampled against scan 1's voxel model; the
    voxels valid in the model with ``min_pts`` points in both scans."""
    s1d = as_points(scan1, dev)
    s2d = transform_points(as_points(scan2, dev),
                           torch.as_tensor(np.asarray(X_true, np.float32), device=dev))
    model = prepare_reference(s1d, cfg)
    s1, n1 = _voxel_samples(s1d, model, cfg, samples_per_voxel)
    s2, n2 = _voxel_samples(s2d, model, cfg, samples_per_voxel)
    ok = model.valid & (n1 >= min_pts) & (n2 >= min_pts)
    return s1[ok].cpu().numpy(), s2[ok].cpu().numpy()


def make_raycast_voxel_pairs(
    n_pairs: int = 6,
    samples_per_voxel: int = 100,
    min_pts: int = 30,
    seed: int = 0,
    cfg: ICETConfig | None = None,
    scene_zoo: bool = True,
    device: str | torch.device | None = None,
):
    """``(s1 (B, S, 3), s2 (B, S, 3))`` numpy voxel samples of the same
    surfaces seen from two sensor poses, aligned by the exact ground truth
    (their residual translation is about 0; callers inject targets).  Each
    pair's pose, scene (``scene_zoo``: :func:`training_scene`, else the
    default scene) and scans come from ``numpy.random.default_rng(seed)``.
    Voxelised on ``device`` (CUDA unless told otherwise)."""
    dev = resolve_device(device)
    cfg = cfg or _default_cfg()
    rng = np.random.default_rng(seed)
    all1, all2 = [], []
    for k in range(n_pairs):
        X_true = np.concatenate(
            [rng.uniform(-0.5, 0.5, 3), rng.uniform(-0.02, 0.02, 3)]
        ).astype(np.float32)
        scene = training_scene(rng) if scene_zoo else None
        scan1, scan2 = scan_pair_with_ground_truth(X_true, scene=scene, seed=seed + 17 * k)
        s1, s2 = _pair_samples(scan1, scan2, X_true, cfg, samples_per_voxel, min_pts, dev)
        all1.append(s1)
        all2.append(s2)
    return np.concatenate(all1), np.concatenate(all2)


def make_real_pair_voxel_samples(
    scan1: np.ndarray,
    scan2: np.ndarray,
    X_true: np.ndarray,
    cfg: ICETConfig,
    samples_per_voxel: int = 100,
    min_pts: int = 30,
    device: str | torch.device | None = None,
):
    """Voxel samples ``(s1, s2)`` of a recorded scan pair with a known
    transform, built as :func:`make_raycast_voxel_pairs` builds each pair:
    any per-voxel offset left after the true alignment is perspective-shift
    bias.  On ``device`` (CUDA unless told otherwise)."""
    dev = resolve_device(device)
    return _pair_samples(scan1, scan2, X_true, cfg, samples_per_voxel, min_pts, dev)


def raycast_batch_iter(
    s1,
    s2,
    generator: torch.Generator,
    batch: int = 256,
    shift_scale: float = 0.3,
    device: str | torch.device | None = None,
):
    """Endless ``(inputs (B, 2S, 4), targets (B, 3))`` from voxel pairs:
    each batch draws ``batch`` voxels with replacement and shifts sample 2
    by a fresh target, uniform in ``+-shift_scale``.  Draws come from
    ``generator`` on its own device; batches go to ``device`` (the
    generator's by default)."""
    gdev = generator.device
    dev = gdev if device is None else torch.device(device)
    s1 = torch.as_tensor(np.asarray(s1, np.float32), device=dev)
    s2 = torch.as_tensor(np.asarray(s2, np.float32), device=dev)
    n = s1.shape[0]
    while True:
        idx = torch.randint(0, n, (batch,), generator=generator, device=gdev).to(dev)
        d = (torch.rand((batch, 3), generator=generator, device=gdev) * 2.0 - 1.0) * shift_scale
        d = d.to(dev)
        yield pack_voxel_samples(s1[idx], s2[idx] + d[:, None, :]), d


def train_bias_net_mixed(
    steps: int = 1200,
    batch: int = 256,
    sample_pts: int = 100,
    lr: float = 1e-3,
    seed: int = 0,
    n_pairs: int = 6,
    extra_pairs=None,
    device: str | torch.device | None = None,
):
    """Train on alternating batches of raycast voxel pairs (even steps)
    and synthetic patches (odd steps) on ``device`` (CUDA unless told
    otherwise).  ``extra_pairs``: optional ``(s1, s2)`` voxel samples
    appended to the raycast pool, e.g. from
    :func:`make_real_pair_voxel_samples`.  Returns ``(state, losses, (s1,
    s2))``; the draws come from one generator on the device seeded with
    ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = create_train_state(gen, lr, sample_pts, dev)
    s1, s2 = make_raycast_voxel_pairs(n_pairs=n_pairs, samples_per_voxel=sample_pts,
                                      seed=seed, device=dev)
    if extra_pairs is not None:
        s1 = np.concatenate([s1, np.asarray(extra_pairs[0], np.float32)])
        s2 = np.concatenate([s2, np.asarray(extra_pairs[1], np.float32)])
    ray_iter = raycast_batch_iter(s1, s2, gen, batch, device=dev)
    losses = []
    for i in range(steps):
        if i % 2 == 0:
            inputs, targets = next(ray_iter)
        else:
            inputs, targets = make_patch_batch(gen, batch, sample_pts, dev)
        state, loss = train_step(state, inputs, targets)
        losses.append(float(loss))
    return state, losses, (s1, s2)
