"""The control of a cell's ``correct``: the plain reference put in the
program's place, computed in the nearest precision below the
configuration's (float32 without TF32, so TF32: every matrix product's
operands rounded to ten mantissa bits), over as many frames as a run
compares, and judged by the cell's own check.  It has to come out as not
correct.  Not run by the benchmark's runs; on the card:

    python3 benchmark/control.py --workload <name> --seeds 11,12,13

One JSON line a seed: the numbers compared, each with its limit.
``--precision fp32`` runs the same chain in float32, which the check has
to pass with every gap 0 (the check judging its own reference).
"""

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def control(root: Path, workload: str, seed: int, frames: int | None, precision: str,
            device) -> dict:
    import torch

    from benchmark import harness, lap as lapgen
    from benchmark.reference import icet as ref

    cell = harness.find_cell(root, workload)
    p = ref.TF32 if precision == "tf32" else ref.FP32
    torch.backends.cuda.matmul.allow_tf32 = p.tf32
    lap = lapgen.make_lap(cell.traffic, cell.config["sensor"], seed, device)
    n = frames or cell.config["sample_frames"] + 6
    records, snapshot = cell.runner.chain(cell.config, lap, seed, n, device, p)
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = SimpleNamespace(config=cell.config, lap=lap, records=records,
                          window=[r for r in records if r["window"]], device=device,
                          note=harness.note)
    checks = cell.runner.judge(ctx, snapshot, seed)
    failed = [k for k, c in checks.items()
              if c["limit"] is not None and not c["value"] <= c["limit"]]
    return {"workload": workload, "seed": seed, "precision": precision, "frames": n,
            "correct": not failed, "failed": failed, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--precision", choices=("tf32", "fp32"), default="tf32")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    for s in args.seeds.split(","):
        out = control(ROOT, args.workload, int(s), args.frames, args.precision, device)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
