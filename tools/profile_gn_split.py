#!/usr/bin/env python3
"""Device time of one Gauss-Newton iteration, split by function.

Builds two consecutive scans of the benchmark's lap (``benchmark/lap.py``,
the OS1-64 pattern), fits the model to the first at each benchmark
configuration (``benchmark/configs/*.json``), solves once to warm up, then
runs ``--iters`` warm iterations eagerly (``solver._iteration`` from the
solution and its eigenbasis) under ``torch.profiler``, each function of the
iteration inside a ``record_function`` region of its own.  Prints one JSON
line a configuration: for each region the device ms and the kernels
launched an iteration, and their share of the iteration's.  Regions:
``moments`` (scan 2's moment sums), ``finalize``, ``residual``,
``assembly`` (``assemble_normal_equations``), ``gn_assembly`` (its kernel
wrapper, where the program has one), ``eigh`` (the 6x6 eigensystem),
``dR`` (the rotation derivative), ``rest`` (the iteration less all these).
Run from the repository root, on a machine with a CUDA card:

    python3 tools/profile_gn_split.py [--iters 5]

It imports nothing of JAX or of ``icet_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import lap as lapgen  # noqa: E402
from benchmark.common import solver_config  # noqa: E402
from icet_tpu_torch import solver  # noqa: E402

#: region -> the solver module's names it wraps (those the module has)
REGIONS = {
    "moments": ("_sums",),
    "finalize": ("finalize_moments_planes",),
    "residual": ("residual_compact_planes",),
    "assembly": ("assemble_normal_equations",),
    "gn_assembly": ("gn_assembly",),
    "eigh": ("eigh_small", "eigh_small_warm_safe"),
    "dR": ("rotation_jacobian",),
}
CONFIGS = ("os1-64.odo", "os1-64.map")


def two_scans(device, first: int = 100) -> tuple[torch.Tensor, torch.Tensor]:
    """Frames ``first`` and ``first + 1`` of the stream traffic's lap, as
    the OS1-64 sees them (no range noise)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "traffic", "stream.json")) as f:
        traffic = json.load(f)
    with open(os.path.join(root, "benchmark", "configs", "os1-64.odo.json")) as f:
        sensor = json.load(f)["sensor"]
    circuit = lapgen.Circuit(tuple(traffic["rect"]), traffic["corner_radius"])
    step = circuit.length / int(traffic["frames_per_lap"])
    R, t = zip(*(circuit.pose(step * i) for i in (first, first + 1)))
    R = torch.from_numpy(np.stack(R)).to(device)
    t = torch.from_numpy(np.stack(t)).to(device)
    d = lapgen.beam_directions(sensor["n_beams"], sensor["n_azimuth"], sensor["elev_min"],
                               sensor["elev_max"], device)
    rng = lapgen.raycast(R, t, d, lapgen.city_boxes(int(traffic["scene_seed"])),
                         traffic["ground_z"], traffic["max_range"])
    scans = (d[None] * rng[..., None]).float()
    return scans[0].contiguous(), scans[1].contiguous()


@contextlib.contextmanager
def regions():
    """Wrap each function of :data:`REGIONS` in ``record_function``."""
    saved = {}

    def wrap(region, fn):
        def inner(*a, **k):
            with torch.profiler.record_function(f"gn.{region}"):
                return fn(*a, **k)
        return inner

    for region, names in REGIONS.items():
        for name in names:
            if hasattr(solver, name):
                saved[name] = getattr(solver, name)
                setattr(solver, name, wrap(region, saved[name]))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(solver, name, fn)


def _device(e) -> tuple[float, int]:
    """Device microseconds and kernels of ``e`` and everything under it."""
    us = sum(k.duration for k in e.kernels)
    n = len(e.kernels)
    for c in e.cpu_children:
        cu, cn = _device(c)
        us += cu
        n += cn
    return us, n


def split(cfg, scan1, scan2, iters: int) -> dict:
    model = solver.prepare_reference(scan1, cfg)
    res = solver.register(model, scan2, torch.zeros(6, device=scan1.device), cfg,
                          want_static_mask=False)
    X = res.X.clone()
    _, _, _, _, U2, _, _ = solver._iteration(model, scan2, X, 1, cfg)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with regions(), torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            with torch.profiler.record_function("gn.iteration"):
                out = solver._iteration(model, scan2, X, 1, cfg, None, U2)
        torch.cuda.synchronize()
    totals: dict = {}
    for e in prof.events():
        if e.name.startswith("gn."):
            us, n = _device(e)
            t = totals.setdefault(e.name[3:], [0.0, 0])
            t[0] += us
            t[1] += n
    it_us, it_n = totals.pop("iteration", [0.0, 0])
    out_rows = {}
    rest_us, rest_n = it_us, it_n
    for region, (us, n) in totals.items():
        rest_us -= us
        rest_n -= n
        out_rows[region] = {"ms": us / iters / 1e3, "kernels": n / iters,
                            "share": us / it_us if it_us else None}
    out_rows["rest"] = {"ms": rest_us / iters / 1e3, "kernels": rest_n / iters,
                        "share": rest_us / it_us if it_us else None}
    return {"iteration_ms": it_us / iters / 1e3, "iteration_kernels": it_n / iters,
            "regions": out_rows, "n_corr": int(out[5][0])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    scan1, scan2 = two_scans(dev)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in CONFIGS:
        with open(os.path.join(root, "benchmark", "configs", f"{name}.json")) as f:
            cfg = solver_config(json.load(f))
        row = split(cfg, scan1, scan2, args.iters)
        print(json.dumps({"config": name, "card": card, "torch": torch.__version__, **row}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
