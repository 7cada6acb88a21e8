#!/usr/bin/env python3
"""Builds kernel #8, the prepare's voxel-model fit (``csrc/model_fit.cu``),
and runs ``chip_smoke.py``'s phase 33 alone: the kernels against their plain
version on the fits of lap frames at 75x24, 150x48 and fixed radial mode,
with the NDT test and with the clip-fill guard, and on fits whose safeguard
commits 0, 1 and 2 extra sweeps, every field of the model bit for bit; two
launches and two graph replays bit for bit; the launches a frame of the
compiled odometry, filtered odometry and mapping runners; its ms at 1,801,
7,201 and 90,001 rows beside the plain chain's.  The quickest check of that
one source on the card.  Prints the card's name and power limit, and as
the last line one JSON object with the numbers.  From the repository root,
on a machine with an NVIDIA GPU:

    python3 tools/check_model_fit.py
"""

from __future__ import annotations

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import SmokeFailure, device_line, phase_model_fit  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("check_model_fit: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = device_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    try:
        out = phase_model_fit(dev, card)
    except SmokeFailure as e:
        print(f"check_model_fit FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"card": card, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
