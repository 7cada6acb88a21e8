#!/usr/bin/env python3
"""Builds kernel #6, the Gauss-Newton normal-equation assembly
(``csrc/gn_assembly.cu``), and runs ``chip_smoke.py``'s phase 31 alone: the
kernel against its plain version at 75x24, 150x48 and fixed radial mode in
every branch, rows alone bit for bit, graph replays, the launches of a
compiled solve, and its ms beside its bound and the plain chain's.  The
quickest check of that one source on the card.  Inputs: the first two
frames of ``chip_smoke.py``'s drive (64x1024 city drive, 1 m a frame).
Prints the card's name and power limit, and as the last line one JSON
object with the numbers.  From the repository root, on a machine with an
NVIDIA GPU:

    python3 tools/check_gn_assembly.py
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import SmokeFailure, device_line, phase_gn_assembly  # noqa: E402
from icet_tpu_torch.config import ICETConfig  # noqa: E402
from icet_tpu_torch.datasets.replay import CityDriveSource  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("check_gn_assembly: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = device_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    src = CityDriveSource(n_frames=2, speed=1.0, n_beams=64, n_azimuth=1024)
    s1, s2 = (torch.from_numpy(np.asarray(s, np.float32)).to(dev) for s, _ in src)
    cfg = ICETConfig(n_iters=7, convergence_tol=1e-4, convergence_stat_scale=1.0)
    try:
        out = phase_gn_assembly(s1, s2, cfg, dev, card)
    except SmokeFailure as e:
        print(f"check_gn_assembly FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"card": card, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
