"""The eager references of the port's runners.

Each function chains the eager functions with one runner's semantics and
nothing more (no recovery, no frame log, no snapshots) and returns the
runner's frame records (:func:`close_loops` the loop factors of
``pose_graph.close_loops``).  The runners run the compiled entry points; the
tests and ``chip_smoke.py`` hold them to these chains bit for bit.  Each
runner's chain runs on the device of its scans, an ``(F, N, 3)`` float32
tensor.

Not collected by pytest; imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from icet_tpu_torch.device import as_points
from icet_tpu_torch.filters import model_voxel_samples, odometry_step_dnn
from icet_tpu_torch.keyframe import (
    KeyframeFrame,
    blockmap_init,
    keyframe_sequence,
    keyframe_spawn,
    keyframe_step,
    keyframe_step_dnn,
    np_pose_matrix,
    np_pose_to_state,
    update_health0,
)
from icet_tpu_torch.mapping import MapFrame, init_map, map_step, map_update
from icet_tpu_torch.odometry import OdometryFrame, warm_start_seed
from icet_tpu_torch.ops.geometry import compose_pose, pose_to_state
from icet_tpu_torch.ops.linalg import psd_pinv
from icet_tpu_torch.pose_graph import LOOP_DX_GATE
from icet_tpu_torch.solver import odometry_step, prepare_reference, register_pair_impl


def _seed(x_prev, x_prev2, odo_cfg):
    if odo_cfg.warm_start:
        return warm_start_seed(x_prev, x_prev2, odo_cfg.warm_start_mode)
    return torch.zeros_like(x_prev)


def odometry(scans, cfg, odo_cfg, net=None):
    """``OdometryPipeline``'s frames: ``odometry_step`` (with ``net``,
    ``odometry_step_dnn`` sampling the previous scan) from the warm-start
    seed, the divergence guard, the world pose and the velocity history."""
    dev = scans.device
    model = prepare_reference(scans[0], cfg)
    samples = None if net is None else model_voxel_samples(model, scans[0], cfg)
    x_prev = x_prev2 = torch.zeros(6, device=dev)
    T = torch.eye(4, device=dev)
    frames = []
    for k in range(1, scans.shape[0]):
        x0 = _seed(x_prev, x_prev2, odo_cfg)
        filt = None
        if net is None:
            res, model = odometry_step(model, scans[k], x0, cfg)
        else:
            res, model, samples, filt = odometry_step_dnn(model, scans[k - 1], samples,
                                                          scans[k], x0, cfg, net)
        diverged = bool(torch.any(torch.abs(res.X) > odo_cfg.divergence_clamp))
        X = torch.zeros(6, device=dev) if diverged else res.X
        T = compose_pose(T, X)
        x_prev, x_prev2 = X, (X if diverged else x_prev)
        X_np = X.cpu().numpy()
        frames.append(OdometryFrame(
            index=k, X=X_np, pred_stds=res.pred_stds.cpu().numpy(), T_world=T.cpu().numpy(),
            pose=pose_to_state(T).cpu().numpy(), twist=X_np * odo_cfg.sensor_hz,
            diverged=diverged, n_corr=res.diagnostics.n_corr.cpu().numpy(), solve_ms=0.0,
            iterations=int(res.iterations),
            n_rejected=0 if filt is None else int(filt.n_rejected), dnn_filter=filt,
        ))
    return frames


def odometry_device(scans, cfg, odo_cfg, block=64):
    """``run_odometry_device``'s frames: the pipeline's chain without the
    filter, its velocity history restarting at each ``block``-frame
    block, read back once a block."""
    dev = scans.device
    model = prepare_reference(scans[0], cfg)
    x = torch.zeros(6, device=dev)
    T = torch.eye(4, device=dev)
    frames = []
    for s in range(1, scans.shape[0], block):
        x_prev = x_prev2 = x
        outs = []
        for k in range(s, min(s + block, scans.shape[0])):
            res, model = odometry_step(model, scans[k], _seed(x_prev, x_prev2, odo_cfg), cfg)
            diverged = torch.any(torch.abs(res.X) > odo_cfg.divergence_clamp)
            X = torch.where(diverged, torch.zeros_like(res.X), res.X)
            T = compose_pose(T, X)
            x_prev, x_prev2 = X, torch.where(diverged, X, x_prev)
            outs.append((X, res.pred_stds, diverged, T, res.iterations))
        x = x_prev
        Xs, stds, divs, Ts = (torch.stack([o[i] for o in outs]).cpu().numpy() for i in range(4))
        frames += [OdometryFrame(
            index=s + j, X=Xs[j], pred_stds=stds[j], T_world=Ts[j],
            pose=pose_to_state(torch.from_numpy(Ts[j])).numpy(),
            twist=Xs[j] * odo_cfg.sensor_hz, diverged=bool(divs[j]),
            n_corr=np.zeros(0, np.int32), solve_ms=0.0, iterations=int(o[4]),
        ) for j, o in enumerate(outs)]
    return frames


def map_maker(scans, cfg, map_cfg, odo_cfg, seed=0):
    """``MapMaker``'s frames and its final ring map: one draw of a scan's
    uniforms a frame, the seed frame's prepare and ``map_update`` at
    X = 0, then ``map_step`` a frame."""
    dev = scans.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = init_map(map_cfg, device=dev)
    u = torch.rand(scans.shape[1], generator=gen, device=dev)
    model = prepare_reference(scans[0], cfg)
    state = map_update(state, scans[0], torch.zeros(6, device=dev), u, map_cfg, cfg.min_range)
    frames = []
    for k in range(1, scans.shape[0]):
        u = torch.rand(scans.shape[1], generator=gen, device=dev)
        res, X, diverged, state, model = map_step(model, state, scans[k], u,
                                                  odo_cfg.divergence_clamp, cfg, map_cfg)
        frames.append(MapFrame(
            index=k, X=X.cpu().numpy(), pred_stds=res.pred_stds.cpu().numpy(),
            diverged=bool(diverged), n_map_points=int(state.valid.sum()),
            iterations=int(res.iterations),
        ))
    return frames, state


def keyframe_odometry(scans, cfg, kf_cfg, bm_cfg, net=None, seed=0, blockmap=None):
    """``KeyframeOdometry``'s frames, final block map and keyframe indices:
    a spawn at the identity, then ``keyframe_step`` a frame (with ``net``,
    ``keyframe_step_dnn`` sampling the keyframe) and a spawn where the step
    asks for one; the step's uniforms, then the spawn's, drawn from one
    generator.  ``blockmap`` (an empty map, sharded or not) replaces the
    runner's own empty map."""
    dev = scans.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    K = bm_cfg.points_per_scan
    bm = blockmap_init(bm_cfg, dev) if blockmap is None else blockmap

    def spawn(bm, k, T_world):
        state = torch.from_numpy(np_pose_to_state(T_world).astype(np.float32)).to(dev)
        model, bm = keyframe_spawn(bm, scans[k], state, torch.rand(K, generator=gen, device=dev),
                                   True, cfg, bm_cfg)
        samples = None if net is None else model_voxel_samples(model, scans[k], cfg)
        return model, samples, bm

    model, samples, bm = spawn(bm, 0, np.eye(4))
    T_key, keyframes = np.eye(4), [0]
    x_rel = delta = torch.zeros(6, device=dev)
    health0 = torch.zeros(2, device=dev)
    stds_rel = np.zeros(6, np.float32)
    frames = []
    for k in range(1, scans.shape[0]):
        u = torch.rand(K, generator=gen, device=dev)
        if net is None:
            step = keyframe_step(model, bm, scans[k], x_rel, delta, u, health0, cfg, kf_cfg,
                                 bm_cfg)
        else:
            step = keyframe_step_dnn(model, bm, scans[k], scans[keyframes[-1]], samples, x_rel,
                                     delta, u, health0, cfg, kf_cfg, bm_cfg, net)
        res, x_rel, delta, diverged, spawned, health, bm = step
        health0 = update_health0(health0, health)
        X_rel, cur_stds = x_rel.cpu().numpy(), res.pred_stds.cpu().numpy()
        T_world = T_key @ np_pose_matrix(X_rel)
        frames.append(KeyframeFrame(
            index=k, X=delta.cpu().numpy(), pred_stds=np.sqrt(cur_stds**2 + stds_rel**2),
            T_world=T_world, diverged=bool(diverged), X_rel=X_rel, is_keyframe=spawned,
            n_corr=health[0].cpu().numpy().astype(np.int32), iterations=int(res.iterations),
        ))
        if spawned:
            model, samples, bm = spawn(bm, k, T_world)
            T_key = T_world
            keyframes.append(k)
            x_rel = torch.zeros(6, device=dev)
            health0 = torch.zeros(2, device=dev)
            stds_rel = np.zeros(6, np.float32)
        else:
            stds_rel = cur_stds
    return frames, bm, keyframes


def keyframe_device(scans, cfg, kf_cfg, bm_cfg, block=64, seed=0):
    """``run_keyframe_device``'s frames and final block map: the seed spawn,
    then ``keyframe_sequence`` a ``block``-frame block, read back once a
    block."""
    dev = scans.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    zero6 = torch.zeros(6, device=dev)
    u = torch.rand(bm_cfg.points_per_scan, generator=gen, device=dev)
    model, bm = keyframe_spawn(blockmap_init(bm_cfg, dev), scans[0], zero6, u, True, cfg, bm_cfg)
    carry = (zero6, zero6, zero6, torch.zeros(2, device=dev), zero6)
    frames = []
    for s in range(1, scans.shape[0], block):
        (model, bm, carry), outs = keyframe_sequence(scans[s:s + block], model, bm, carry, gen,
                                                     cfg, kf_cfg, bm_cfg)
        d2, stds, world6, div, x2, n_corr, is_kf, iters = (o.cpu().numpy() for o in outs)
        frames += [KeyframeFrame(
            index=s + j, X=d2[j], pred_stds=stds[j], T_world=np_pose_matrix(world6[j]),
            diverged=bool(div[j]), X_rel=x2[j], is_keyframe=bool(is_kf[j]),
            n_corr=np.asarray(n_corr[j]), iterations=int(iters[j]),
        ) for j in range(d2.shape[0])]
    return frames, bm


def close_loops(scans, candidates, cfg, x0_fn=None, batch=16, device="cpu"):
    """``pose_graph.close_loops``'s factors: ``register_pair_impl`` a pair
    on ``device`` without the static mask, warm-started at ``x0_fn(i, j)``,
    each chunk of ``batch`` pairs read back at once, the ``|dx|`` gate."""
    factors = []
    for k0 in range(0, len(candidates), batch):
        chunk = candidates[k0:k0 + batch]
        res = []
        for i, j in chunk:
            x0 = np.zeros(6, np.float32) if x0_fn is None else x0_fn(i, j)
            res.append(register_pair_impl(
                as_points(scans[i], device), as_points(scans[j], device),
                torch.as_tensor(np.asarray(x0, np.float32), device=device), cfg,
                want_static_mask=False))
        host = torch.cat([torch.stack([r.X for r in res]),
                          psd_pinv(torch.stack([r.Q for r in res])).reshape(len(chunk), 36),
                          torch.stack([r.diagnostics.dx_norm[-1] for r in res])[:, None]],
                         1).cpu().numpy()
        for b, (i, j) in enumerate(chunk):
            d = host[b, 42]
            if np.isfinite(d) and d <= LOOP_DX_GATE:
                factors.append((i, j, host[b, :6], host[b, 6:42].reshape(6, 6)))
    return factors
