"""Runner of the HD-map configurations: the program's ``MapMaker``, one
``step`` a scan, and the check of what it produced against the plain
reference.

Every mapping solve starts from zero, so a compared frame is solved again
from its two scans alone.  The ring map is rebuilt from the scans, the
downsample's uniforms (drawn again from the seed, as the MapMaker draws
them: one ``torch.rand`` of a scan's rows a frame on the device) and the
solution of every frame, which the reference takes from the program's
outputs: the ring follows the program's solutions, and the solutions are
checked on their own at the sampled frames.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import icet as ref
from benchmark.common import gap_lines, sample, solver_config, summarize


class Session:
    def __init__(self, config: dict, device, seed: int):
        from icet_tpu_torch.config import MapConfig, OdometryConfig
        from icet_tpu_torch.mapping import MapMaker

        self.maker = MapMaker(solver_config(config),
                              MapConfig(capacity=config["capacity"],
                                        points_per_scan=config["points_per_scan"]),
                              OdometryConfig(divergence_clamp=config["divergence_clamp"]),
                              seed=seed, device=device, snapshot_every=config["snapshot_every"])

    def step(self, scan: np.ndarray):
        f = self.maker.step(scan)
        if f is None:
            return None
        return {"X": f.X, "pred_stds": f.pred_stds, "diverged": f.diverged}

    def snapshot(self) -> dict:
        st = self.maker.state
        return {"points": st.points.cpu(), "valid": st.valid.cpu(), "write_ptr": st.write_ptr}

    def close(self):
        from icet_tpu_torch import graphs

        graphs.clear(self.maker.device)
        del self.maker


def build(config: dict, device, seed: int) -> Session:
    return Session(config, device, seed)


def judge(ctx, snapshot, seed: int, p: ref.Precision = ref.FP32) -> dict:
    """The solution and its predicted stds at the sampled frames (a quarter
    of them frames after which the MapMaker copies its ring to the host),
    as the second largest gap over the frames and the median, and the
    ring's points, validity and cursor after the run; each with its limit
    where the configuration gives one."""
    cfg = ctx.config
    g = ref.grid_of(cfg)
    dev = ctx.device
    recs = ctx.records
    per = {"x_gap": [], "std_gap": []}
    every = cfg["snapshot_every"]
    snapshots = {i for i in range(len(recs)) if (i + 1) % every == 0}
    for i in sample(ctx, seed, {"snapshots": snapshots}):
        out = recs[i]["out"]
        scan_prev = torch.from_numpy(ctx.lap.scans[recs[i - 1]["lap"]]).to(dev)
        scan = torch.from_numpy(ctx.lap.scans[recs[i]["lap"]]).to(dev)
        sol = ref.register(ref.prepare(scan_prev, g, p), scan, torch.zeros(6, device=dev), g, p)
        _, X = ref.guard(sol.X, cfg["divergence_clamp"])
        stds = sol.pred_stds.cpu().numpy()
        per["x_gap"].append(float(np.max(np.abs(out["X"] - X.cpu().numpy()))))
        per["std_gap"].append(float(np.max(np.abs(out["pred_stds"] - stds)
                                           / np.maximum(stds, 1e-12))))
    for line in gap_lines(per):
        ctx.note(line)
    gaps = summarize(per)

    cap, per_scan = cfg["capacity"], cfg["points_per_scan"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    points = torch.zeros((cap, 3), device=dev)
    valid = torch.zeros(cap, dtype=torch.bool, device=dev)
    ptr = 0
    for r in recs:
        scan = torch.from_numpy(ctx.lap.scans[r["lap"]]).to(dev)
        u = torch.rand(scan.shape[0], generator=gen, device=dev)
        X = torch.zeros(6, device=dev) if r["out"] is None else torch.from_numpy(
            r["out"]["X"]).to(dev)
        points, valid, ptr = ref.ring_update(points, valid, scan, X, u, cap, per_scan,
                                             cfg["min_range"], ptr, p)
    points, valid = points.cpu(), valid.cpu()
    gaps["ring_gap"] = float(torch.max(torch.abs(snapshot["points"] - points)))
    gaps["valid_mismatch"] = float(torch.sum(snapshot["valid"] != valid))
    gaps["cursor_gap"] = float(abs(snapshot["write_ptr"] - ptr))
    return {k: {"value": v, "limit": cfg["limits"].get(k)} for k, v in gaps.items()}


def chain(config: dict, lap, seed: int, n: int, device, p: ref.Precision):
    """The reference in the program's place over ``n`` frames from the
    lap's start: ``(records, snapshot)`` as a run records them."""
    g = ref.grid_of(config)
    cap, per_scan = config["capacity"], config["points_per_scan"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    points = torch.zeros((cap, 3), device=device)
    valid = torch.zeros(cap, dtype=torch.bool, device=device)
    ptr, prev, records = 0, None, []
    for k in range(n):
        idx = (lap.start + k) % len(lap.scans)
        scan = torch.from_numpy(lap.scans[idx]).to(device)
        u = torch.rand(scan.shape[0], generator=gen, device=device)
        out, X = None, torch.zeros(6, device=device)
        if prev is not None:
            sol = ref.register(ref.prepare(prev, g, p), scan, X, g, p)
            _, X = ref.guard(sol.X, config["divergence_clamp"])
            out = {"X": X.cpu().numpy(), "pred_stds": sol.pred_stds.cpu().numpy()}
        points, valid, ptr = ref.ring_update(points, valid, scan, X, u, cap, per_scan,
                                             config["min_range"], ptr, p)
        records.append({"lap": idx, "out": out, "latency": 0.0, "window": k > 0})
        prev = scan
    return records, {"points": points.cpu(), "valid": valid.cpu(), "write_ptr": ptr}
