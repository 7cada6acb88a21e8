#!/usr/bin/env python3
"""Builds kernel #7, the Gauss-Newton 6x6 eigensystem and its pruned update
(``csrc/gn_eigh6.cu``), and runs ``chip_smoke.py``'s phase 32 alone: the
kernel against its plain version on the iterations of lap solves at 75x24
and 150x48, on random SPD matrices at condition numbers 1e2-1e9 and on one
with a repeated eigenvalue, cold and warm; two launches and two graph
replays bit for bit; the launches a frame of the compiled odometry and
mapping runners; its ms cold and warm beside the plain chain's.  The
quickest check of that one source on the card.  Prints the card's name and
power limit, and as the last line one JSON object with the numbers.  From
the repository root, on a machine with an NVIDIA GPU:

    python3 tools/check_gn_eigh6.py
"""

from __future__ import annotations

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import SmokeFailure, device_line, phase_gn_eigh6  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("check_gn_eigh6: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = device_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    try:
        out = phase_gn_eigh6(dev, card)
    except SmokeFailure as e:
        print(f"check_gn_eigh6 FAILED: {e}", file=sys.stderr)
        return 1
    out["outcomes"] = {str(k): v for k, v in out["outcomes"].items()}
    print(json.dumps({"card": card, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
