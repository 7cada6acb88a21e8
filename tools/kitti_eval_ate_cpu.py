#!/usr/bin/env python3
"""The KITTI evaluation of ``chip_smoke.py`` phase 22 on the CPU: the JAX
package's ``examples/eval_kitti.py`` (the reference) and, with
``--port``, the port's ``icet_tpu_torch.examples.eval_kitti`` on its CPU
path, on the same fixture.

The fixture is the one phase 22 writes: the 24-frame city drive at
KITTI scale, ``CityDriveSource(n_frames=24, speed=1.0, n_beams=64,
n_azimuth=2048)`` (131,072 rays a sweep), written as a KITTI odometry
sequence by ``icet_tpu_torch.examples.make_kitti_sequence --calib``
(camera-frame poses and a non-identity ``calib.txt``; the writer and the
drive are bit-identical to the JAX package's, tests/test_torch_kitti.py
and tests/test_torch_package.py).  Each mode runs ``eval_kitti`` at its
defaults (75x24 grid, 7 iterations, ``--max-points 131072``) with
``--clamp 2.5``: plain, ``--keyframe`` and ``--dnn``.

``chip_smoke.py`` gates the card's ATE in each mode at the JAX package's
figure printed here plus 0.5 cm.  Run from the repository root:

    JAX_PLATFORMS=cpu python3 tools/kitti_eval_ate_cpu.py [--port] [--eager-reference]

``--eager-reference`` runs the JAX package under ``jax.disable_jit()``
(see ``tools/dnn_drive_ate_cpu.py``: its jitted CPU program drops a bf16
rounding of the BiasNet).  The last line is one JSON object
``{mode: {"jax": summary, "port": summary, "jax_s": s, "port_s": s}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: the fixture: make_kitti_sequence's arguments, shared with chip_smoke.py
FIXTURE = ["--frames", "24", "--speed", "1.0", "--beams", "64", "--azimuth", "2048",
           "--calib"]
#: eval_kitti's arguments in every mode (the sequence and poses added)
EVAL = ["--clamp", "2.5"]
MODES = {"plain": [], "keyframe": ["--keyframe"], "dnn": ["--dnn"]}


def write_fixture(out_dir: str) -> str:
    from icet_tpu_torch.examples import make_kitti_sequence

    return make_kitti_sequence.run(
        make_kitti_sequence.build_parser().parse_args(["--out", out_dir, *FIXTURE]))["dir"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true", help="also run the port's CPU path")
    ap.add_argument("--eager-reference", action="store_true",
                    help="run the JAX package without jit (jax.disable_jit)")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import examples.eval_kitti as jek
    from tools.dnn_drive_ate_cpu import reference_mode

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        seq = write_fixture(os.path.join(tmp, "seq"))
        print(f"fixture written in {time.perf_counter() - t0:.1f} s")
        base = ["--sequence", seq, "--poses", os.path.join(seq, "poses.txt"), *EVAL]
        for mode, extra in MODES.items():
            row = {}
            t0 = time.perf_counter()
            with reference_mode(args.eager_reference):
                row["jax"] = jek.run(jek.build_parser().parse_args(base + extra))
            row["jax_s"] = round(time.perf_counter() - t0, 1)
            if args.port:
                import torch

                from icet_tpu_torch.examples import eval_kitti

                torch.set_num_threads(min(8, os.cpu_count() or 1))
                t0 = time.perf_counter()
                row["port"] = eval_kitti.run(eval_kitti.build_parser().parse_args(
                    base + extra + ["--device", "cpu", "--prefetch", "on"]))
                row["port"].pop("stages")
                row["port_s"] = round(time.perf_counter() - t0, 1)
            print(f"{mode}: {json.dumps(row)}")
            out[mode] = row
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
