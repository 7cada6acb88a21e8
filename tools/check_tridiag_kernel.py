#!/usr/bin/env python3
"""Build the pose graph's backbone kernels (``csrc/tridiag_backbone.cu``)
and hold them against their plain versions on random SPD block chains, then
time them at K = 10,000: the quickest check of that one source on the card.

Chains of K = 1, 2, 3, 130, 1,000 and 10,000 blocks: diagonal blocks
``A A^T + 20 I`` with the 1e8 gauge prior on block 0, super-diagonal
blocks of scale 2, and (K > 5) block 5's Schur complement made indefinite
(``D_5 = I``, ``E_4 = 100 I``), which takes the block-Jacobi fallback.
Prints each K's error relative to each block's largest entry and the
wall times of one kernel and one plain call, then three CUDA-event times
of the factor and the apply at K = 10,000.  Run from the repository root
on a machine with a GPU:

    python3 tools/check_tridiag_kernel.py
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from icet_tpu_torch import _build  # noqa: E402
from icet_tpu_torch.ops import tridiag as td  # noqa: E402


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    n = torch.clamp(b.abs().amax(dim=1), min=1e-30)
    return float(((a - b).abs().amax(dim=1) / n).max())


def main() -> int:
    if not torch.cuda.is_available():
        print("check_tridiag_kernel: CUDA is not available", file=sys.stderr)
        return 1
    print(_build.build(["tridiag_backbone"]).get("tridiag_backbone", "")[-2000:])
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for K in (1, 2, 3, 130, 1000, 10000):
        A = rng.normal(size=(K, 6, 6)).astype(np.float32)
        D = A @ A.transpose(0, 2, 1) + 20 * np.eye(6, dtype=np.float32)
        E = (rng.normal(size=(K - 1, 6, 6)) * 2).astype(np.float32)
        D[0] += 1e8 * np.eye(6, dtype=np.float32)
        if K > 5:
            D[5] = np.eye(6)  # force the fallback at block 5 (S_5 not SPD)
            E[4] = 100 * np.eye(6)
        Dt, Et = torch.from_numpy(D).to(dev), torch.from_numpy(E).to(dev)
        t0 = time.perf_counter()
        S, U = td.tridiag_factor(Dt, Et)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        Sr, Ur = td.tridiag_factor_reference(Dt, Et)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        r = torch.from_numpy(rng.normal(size=(K, 6)).astype(np.float32)).to(dev)
        y = td.tridiag_apply(S, U, r)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        yr = td.tridiag_apply_reference(Sr, Ur, r)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        print(f"K={K}: S rel {rel(S, Sr):.2e} U rel {rel(U, Ur):.2e} y rel {rel(y, yr):.2e} "
              f"finite {bool(torch.isfinite(S).all())} times kernel {t1 - t0:.4f}/"
              f"{t3 - t2:.4f} s plain {t2 - t1:.3f}/{t4 - t3:.3f} s")
    for _ in range(3):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        S, U = td.tridiag_factor(Dt, Et)
        ev[1].record()
        ev[2].record()
        y = td.tridiag_apply(S, U, r)
        ev[3].record()
        torch.cuda.synchronize()
        print("K=10000 factor ms", ev[0].elapsed_time(ev[1]), "apply ms",
              ev[2].elapsed_time(ev[3]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
