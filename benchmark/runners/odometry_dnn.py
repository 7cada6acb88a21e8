"""Runner of the DNN-filtered streaming odometry configuration: the
program's ``OdometryPipeline`` with the filter on, one ``step`` a scan, and
the check of what it produced against the plain reference
(:mod:`benchmark.reference.dnn_filter`).

As in ``runners/odometry.py``, a compared frame is solved again from its
two scans and the program's previous solution (the warm start), and its
world pose is the program's previous pose composed with the reference's
solution; each quantity is compared by its second largest gap over the
frames.  Besides the solution, its stds and the pose, the check compares
every filter pass of each compared frame: the network's shifts and ICET's
mean-residual shifts on the candidate voxels (the network's continuous
output, as a model's logits are compared) and the keep flags.

The reference follows the program's flag where the two differ and the
program's flag is the threshold rule on the program's own shifts
(``dnn_filter.follow``): the encoder's bf16 roundings, which the
program's kernel and the reference take in their own orders, move a
shift near the threshold across it, and the solution after such a flip
moves as far as a lower precision moves it.  A flag that differs
otherwise is a mismatch.  A frame's shift gap is its second largest over
the voxels (``*_gap2``; the largest is reported): a point within float32
roundings of a voxel's edge falls in it on one side and not on the other,
which moves that voxel's mean and sample by centimetres.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark import stats
from benchmark.common import gap_lines, sample, solver_config, summarize
from benchmark.reference import dnn_filter as dref
from benchmark.reference import icet as ref


class Session:
    def __init__(self, config: dict, device):
        from icet_tpu_torch.config import OdometryConfig
        from icet_tpu_torch.odometry import OdometryPipeline

        odo = OdometryConfig(divergence_clamp=config["divergence_clamp"],
                             warm_start=config["warm_start"],
                             warm_start_mode=config["warm_start_mode"],
                             sensor_hz=config["sensor"]["rate_hz"])
        self.pipe = OdometryPipeline(solver_config(config), odo, device=device)

    def step(self, scan: np.ndarray):
        f = self.pipe.step(scan)
        if f is None:
            return None
        # Every filter pass's flags and shifts, on the host: the check
        # compares them after the run.
        filt = f.dnn_filter
        return {"X": f.X, "pred_stds": f.pred_stds, "T_world": f.T_world,
                "iterations": f.iterations, "diverged": f.diverged,
                "n_rejected": f.n_rejected, "keeps": filt.keeps.cpu().numpy(),
                "dnn_shifts": filt.dnn_shifts.cpu().numpy(),
                "icet_shifts": filt.icet_shifts.cpu().numpy()}

    def snapshot(self):
        return None

    def close(self):
        from icet_tpu_torch import graphs

        graphs.clear(self.pipe.device)
        del self.pipe


def build(config: dict, device, seed: int) -> Session:
    from icet_tpu_torch.odometry import OdometryFrame

    if config["warm_start"] and config["warm_start_mode"] != "previous":
        raise ValueError("the reference check follows the 'previous' warm start only")
    dref.filter_of(config)
    if "dnn_filter" not in {f.name for f in dataclasses.fields(OdometryFrame)}:
        raise RuntimeError("the program's odometry frames do not return the filter's "
                           "passes, which the check compares")
    return Session(config, device)


def _voxel_gaps(values, refs, candidates) -> torch.Tensor:
    """``(V+1,)``: each voxel's largest |value - reference| over the passes
    in which it is a candidate (0 where it is none)."""
    return torch.stack([torch.where(c, torch.abs(v - r).amax(dim=-1), 0.0)
                        for v, r, c in zip(values, refs, candidates)]).amax(dim=0)


def judge(ctx, snapshot, seed: int, p: ref.Precision = ref.FP32) -> dict:
    """Of every sampled frame against the reference's (which takes the
    program's flags that follow from the program's shifts): the solution,
    its predicted stds, the world pose, the network's and ICET's shifts
    on the candidate voxels of every pass (a voxel's largest gap over the
    passes; the frame's largest and second largest voxel), the keep flags
    that differ without following from the program's shifts, and the
    flags taken from the program (reported); each as the second largest
    over the frames, the median and the largest.  Then the frames whose
    iterations differ, and the ATE over the window's first 24 frames
    against the exact poses.  Each with its limit where the configuration
    gives one (the others are reported, not compared)."""
    g, f = dref.grid_of(ctx.config), dref.filter_of(ctx.config)
    net = dref.net_of(dref.load_weights(), ctx.device)
    clamp = ctx.config["divergence_clamp"]
    dev = ctx.device
    recs = ctx.records
    per = {k: [] for k in ("x_gap", "std_gap", "pose_gap", "shift_gap", "shift_gap2", "icet_gap",
                           "icet_gap2", "mask_mismatch", "mask_adopted")}
    iters_mismatch = 0
    for i in sample(ctx, seed):
        out, prev = recs[i]["out"], recs[i - 1]["out"]
        scan_prev = torch.from_numpy(ctx.lap.scans[recs[i - 1]["lap"]]).to(dev)
        scan = torch.from_numpy(ctx.lap.scans[recs[i]["lap"]]).to(dev)
        x0 = torch.zeros(6, device=dev) if prev is None else torch.from_numpy(prev["X"]).to(dev)
        T_prev = (torch.eye(4, device=dev) if prev is None
                  else torch.from_numpy(prev["T_world"]).to(dev))
        model = ref.prepare(scan_prev, g, p)
        samples1 = dref.head_samples(scan_prev, model.bounds, g, f.sample_pts)
        program = tuple(torch.as_tensor(out[k]).to(dev)
                        for k in ("keeps", "dnn_shifts", "icet_shifts"))
        sol, passes = dref.register(model, samples1, scan, x0, g, f, net, p, program)
        _, X = ref.guard(sol.X, clamp)
        T = ref.compose_pose(T_prev, X, p).cpu().numpy()
        X, stds = X.cpu().numpy(), sol.pred_stds.cpu().numpy()
        per["x_gap"].append(float(np.max(np.abs(out["X"] - X))))
        per["std_gap"].append(float(np.max(np.abs(out["pred_stds"] - stds)
                                           / np.maximum(stds, 1e-12))))
        per["pose_gap"].append(float(np.max(np.abs(out["T_world"] - T))))
        cands = [q.candidates for q in passes]
        for name, values, refs in (("shift", program[1], [q.dnn_shift for q in passes]),
                                   ("icet", program[2], [q.icet_shift for q in passes])):
            top = torch.topk(_voxel_gaps(values, refs, cands), 2).values.tolist()
            per[f"{name}_gap"].append(top[0])
            per[f"{name}_gap2"].append(top[1])
        per["mask_mismatch"].append(float(sum(int(q.mismatched.sum()) for q in passes)))
        per["mask_adopted"].append(float(sum(int(q.adopted.sum()) for q in passes)))
        iters_mismatch += int(out["iterations"] != sol.iterations)
    for line in gap_lines(per):
        ctx.note(line)
    gaps = summarize(per)
    gaps["iters_mismatch"] = float(iters_mismatch)
    head = [r for r in ctx.window if r["out"] is not None][:24]
    ate = stats.ate_rmse([r["out"]["T_world"] for r in head],
                         [ctx.lap.poses[r["lap"]] for r in head])
    gaps["ate_24_cm"] = ate * 100.0
    return {k: {"value": v, "limit": ctx.config["limits"].get(k)} for k, v in gaps.items()}


def chain(config: dict, lap, seed: int, n: int, device, p: ref.Precision):
    """The reference in the program's place over ``n`` frames from the
    lap's start: ``(records, snapshot)`` as a run records them."""
    g, f = dref.grid_of(config), dref.filter_of(config)
    net = dref.net_of(dref.load_weights(), device)
    scans = [torch.from_numpy(lap.scans[(lap.start + k) % len(lap.scans)]).to(device)
             for k in range(n)]
    X = torch.zeros(6, device=device)
    T = torch.eye(4, device=device)
    records = [{"lap": lap.start, "out": None, "latency": 0.0, "window": False}]
    for k in range(1, n):
        model = ref.prepare(scans[k - 1], g, p)
        samples1 = dref.head_samples(scans[k - 1], model.bounds, g, f.sample_pts)
        sol, passes = dref.register(model, samples1, scans[k], X, g, f, net, p)
        _, X = ref.guard(sol.X, config["divergence_clamp"])
        T = ref.compose_pose(T, X, p)
        out = {"X": X.cpu().numpy(), "pred_stds": sol.pred_stds.cpu().numpy(),
               "T_world": T.cpu().numpy(), "iterations": sol.iterations,
               "keeps": torch.stack([q.keep for q in passes]).cpu().numpy(),
               "dnn_shifts": torch.stack([q.dnn_shift for q in passes]).cpu().numpy(),
               "icet_shifts": torch.stack([q.icet_shift for q in passes]).cpu().numpy()}
        records.append({"lap": (lap.start + k) % len(lap.scans), "out": out, "latency": 0.0,
                        "window": True})
    return records, None
