"""Runner of the streaming odometry configurations: the program's
``OdometryPipeline``, one ``step`` a scan, and the check of what it
produced against the plain reference.

The reference follows the program's state where the state is carried from
frame to frame: a compared frame is solved again from the two scans and
the program's previous solution (the warm start), and its world pose is
the program's previous pose composed with the reference's solution.  The
run's first registration starts from zero and its pose from the identity,
so the start is checked without any program state.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import stats
from benchmark.common import gap_lines, sample, solver_config, summarize
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
        return {"X": f.X, "pred_stds": f.pred_stds, "T_world": f.T_world,
                "iterations": f.iterations, "diverged": f.diverged}

    def snapshot(self):
        return None

    def close(self):
        from icet_tpu_torch import graphs

        graphs.clear(self.pipe.device)
        del self.pipe


def build(config: dict, device, seed: int) -> Session:
    if config["warm_start"] and config["warm_start_mode"] != "previous":
        raise ValueError("the reference check follows the 'previous' warm start only")
    return Session(config, device)


def judge(ctx, snapshot, seed: int, p: ref.Precision = ref.FP32) -> dict:
    """The solution, its predicted stds and the world pose of every sampled
    frame against the reference's, as the second largest gap over the
    frames (one frame may stand apart; each other has to agree) and the
    median; the frames whose iterations differ from the reference's; and
    the trajectory's ATE over the window's first 24 frames against the
    exact poses (the algorithm's accuracy on the lap, which the reference
    shares).  Each with its limit where the configuration gives one (the
    others, and the per-frame gaps, are reported, not compared)."""
    g = ref.grid_of(ctx.config)
    clamp = ctx.config["divergence_clamp"]
    dev = ctx.device
    recs = ctx.records
    per = {"x_gap": [], "std_gap": [], "pose_gap": []}
    iters_mismatch = 0
    for i in sample(ctx, seed):
        out, prev = recs[i]["out"], recs[i - 1]["out"]
        scan_prev = torch.from_numpy(ctx.lap.scans[recs[i - 1]["lap"]]).to(dev)
        scan = torch.from_numpy(ctx.lap.scans[recs[i]["lap"]]).to(dev)
        x0 = torch.zeros(6, device=dev) if prev is None else torch.from_numpy(prev["X"]).to(dev)
        T_prev = (torch.eye(4, device=dev) if prev is None
                  else torch.from_numpy(prev["T_world"]).to(dev))
        sol = ref.register(ref.prepare(scan_prev, g, p), scan, x0, g, p)
        _, X = ref.guard(sol.X, clamp)
        T = ref.compose_pose(T_prev, X, p).cpu().numpy()
        X, stds = X.cpu().numpy(), sol.pred_stds.cpu().numpy()
        per["x_gap"].append(float(np.max(np.abs(out["X"] - X))))
        per["std_gap"].append(float(np.max(np.abs(out["pred_stds"] - stds)
                                           / np.maximum(stds, 1e-12))))
        per["pose_gap"].append(float(np.max(np.abs(out["T_world"] - T))))
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
    g = ref.grid_of(config)
    scans = [torch.from_numpy(lap.scans[(lap.start + k) % len(lap.scans)]).to(device)
             for k in range(n)]
    X = torch.zeros(6, device=device)
    T = torch.eye(4, device=device)
    records = [{"lap": lap.start, "out": None, "latency": 0.0, "window": False}]
    for k in range(1, n):
        sol = ref.register(ref.prepare(scans[k - 1], g, p), scans[k], X, g, p)
        _, X = ref.guard(sol.X, config["divergence_clamp"])
        T = ref.compose_pose(T, X, p)
        out = {"X": X.cpu().numpy(), "pred_stds": sol.pred_stds.cpu().numpy(),
               "T_world": T.cpu().numpy(), "iterations": sol.iterations}
        records.append({"lap": (lap.start + k) % len(lap.scans), "out": out, "latency": 0.0,
                        "window": True})
    return records, None
