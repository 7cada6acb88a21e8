#!/usr/bin/env python3
"""Builds the pose graph's backbone kernels (``csrc/tridiag_backbone.cu``),
holds them against their plain versions on the card and, with ``--parent``,
times them in turns against an earlier tree's: the quickest check of that
one source on the card.

Inputs: ``chip_smoke.backbone_cases()`` (K = 1, 2, 3, the edges of the
kernels' ring stage and ring, forced block-Jacobi fallbacks, inputs one
float into their buffers, each chain with the 1e8 gauge prior) and phase
16's 10,000-pose graph (``chip_smoke.ring_graph``) with its first 1,000
poses.  For each: the
errors of S_inv, U and y relative to each block's largest entry against the
plain versions in float32 (``chip_smoke.py``'s gate, ``TRI_RTOL``) and in
float64 (the exact recurrence: it tells the kernel's own error from the
plain version's), and the fallbacks each took.

With ``--parent DIR`` (an earlier tree unpacked into a directory that
.gitignore lists), that tree's ``tridiag_backbone.cu`` is built with this
tree's nvcc flags and called through the same C interface; the two versions
are checked against each other on the graph, then the factor and the apply
at K = 1,000 and 10,000 are timed in turns, earlier, this, this, earlier
(CUDA events, the median of rounds of back-to-back calls), in one process
on one card.  Prints the card's name and power limit, and as the last line
one JSON object with every number.  From the repository root, on a machine
with an NVIDIA GPU:

    mkdir -p _checkout/parent && git archive <commit> | tar -x -C _checkout/parent
    python3 tools/check_tridiag_kernel.py [--parent _checkout/parent]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    RING_POSES,
    TRI_RTOL,
    backbone_cases,
    backbone_chain,
    block_rel_err,
    device_line,
    median_ms,
    on_device,
    ptxas_usage,
    ring_graph,
)
from icet_tpu_torch import _build  # noqa: E402
from icet_tpu_torch.ops import tridiag as td  # noqa: E402


class Version:
    """One build of ``tridiag_backbone.cu`` behind its C interface
    (``icet_tridiag_factor``, ``icet_tridiag_apply``, the same in every
    version of the source so far): factor and apply on the current stream."""

    def __init__(self, lib: ctypes.CDLL):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.icet_tridiag_factor.argtypes = [p, p, i, p, p, p]
        lib.icet_tridiag_apply.argtypes = [p, p, p, i, p, p]
        self.lib = lib

    def factor(self, D, E):
        K = D.shape[0]
        S = torch.empty((K, 6, 6), device=D.device)
        U = torch.empty((K - 1, 6, 6), device=D.device)
        err = self.lib.icet_tridiag_factor(D.data_ptr(), E.data_ptr(), K, S.data_ptr(),
                                           U.data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"factor launch failed ({err})"
        return S, U

    def apply(self, S, U, r):
        y = torch.empty_like(r)
        err = self.lib.icet_tridiag_apply(S.data_ptr(), U.data_ptr(), r.data_ptr(), r.shape[0],
                                          y.data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"apply launch failed ({err})"
        return y


def build_parent(parent: str) -> Version:
    src = os.path.join(parent, "icet_tpu_torch", "csrc", "tridiag_backbone.cu")
    out_dir = os.path.join(ROOT, "_checkout", "parent_build")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "tridiag_backbone.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the earlier tridiag_backbone.cu:\n{proc.stdout}"
                           f"{proc.stderr}")
    for name, usage in ptxas_usage({"parent": proc.stdout + proc.stderr}).items():
        print(f"earlier ptxas {name}: {usage}")
    return Version(ctypes.CDLL(lib))


def errors(S, U, y, ref):
    Sr, Ur, yr = ref
    return [block_rel_err(S, Sr), block_rel_err(U, Ur), block_rel_err(y[None], yr[None])]


def fallbacks(U) -> list:
    return [k + 1 for k in range(U.shape[0]) if bool((U[k] == 0).all())]


def check_case(name, D, E, r, record) -> bool:
    S, U = td.tridiag_factor(D, E)
    y = td.tridiag_apply(S, U, r)
    plain = td.tridiag_factor_reference(D, E)
    plain = (*plain, td.tridiag_apply_reference(*plain, r))
    exact = td.tridiag_factor_reference(D.double(), E.double())
    exact = tuple(t.float() for t in (*exact, td.tridiag_apply_reference(*exact, r.double())))
    torch.cuda.synchronize()
    e32, e64 = errors(S, U, y, plain), errors(S, U, y, exact)
    p64 = errors(*plain, exact)
    ok = max(e32) <= TRI_RTOL and fallbacks(U) == fallbacks(plain[1])
    record[name] = dict(vs_plain=e32, vs_exact=e64, plain_vs_exact=p64,
                        fallbacks=fallbacks(U), plain_fallbacks=fallbacks(plain[1]), ok=ok)
    print(f"{name}: vs plain S/U/y {e32[0]:.3e} {e32[1]:.3e} {e32[2]:.3e}; vs exact "
          f"{e64[0]:.3e} {e64[1]:.3e} {e64[2]:.3e}; plain vs exact {p64[0]:.3e} {p64[1]:.3e} "
          f"{p64[2]:.3e}; fallbacks {fallbacks(U)[:8]} (plain {fallbacks(plain[1])[:8]}) "
          f"{'ok' if ok else 'FAILED'}")
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an earlier tree, to time its kernels against these")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("check_tridiag_kernel: CUDA is not available", file=sys.stderr)
        return 1
    card = device_line()
    for name, usage in ptxas_usage(_build.build(["tridiag_backbone"])).items():
        print(f"ptxas {name}: {usage}")
    dev = torch.device("cuda")
    record, ok = {}, True
    for K, forced, offset in backbone_cases():
        D, E, r = (on_device(x, dev, offset) for x in backbone_chain(K, K, forced))
        ok &= check_case(f"K={K} forced {list(forced)} offset {offset}", D, E, r, record)
    from icet_tpu_torch.pose_graph import _sparse_normals

    ring0, ring, _ = ring_graph(RING_POSES)
    b, D10, _, _, E10 = _sparse_normals(torch.from_numpy(ring0).to(dev), ring.to(dev), 1e8,
                                        1e-6)
    inputs = {}
    for K in (1000, RING_POSES):
        D, E, r = D10[:K].contiguous(), E10[:K - 1].contiguous(), (-b[:K]).contiguous()
        ok &= check_case(f"ring K={K}", D, E, r, record)
        inputs[K] = (D, E, r)

    times = {}
    if args.parent:
        this = Version(td._lib())
        earlier = build_parent(args.parent)
        D, E, r = inputs[RING_POSES]
        S0, U0 = earlier.factor(D, E)
        S1, U1 = this.factor(D, E)
        y0, y1 = earlier.apply(S0, U0, r), this.apply(S1, U1, r)
        torch.cuda.synchronize()
        between = errors(S1, U1, y1, (S0, U0, y0))
        record["this_vs_earlier"] = between
        print(f"this vs earlier at K={RING_POSES}: S/U/y {between[0]:.3e} {between[1]:.3e} "
              f"{between[2]:.3e}")
        ok &= max(between) <= 2 * TRI_RTOL
        for K in (1000, RING_POSES):
            D, E, r = inputs[K]
            S, U = this.factor(D, E)
            reps = 5 if K == RING_POSES else 20
            for label, v in (("earlier", earlier), ("this", this), ("this", this),
                             ("earlier", earlier)):
                f = median_ms(lambda: v.factor(D, E), reps=reps, rounds=3)
                a = median_ms(lambda: v.apply(S, U, r), reps=4 * reps, rounds=3)
                times.setdefault(f"{label} K={K}", []).append([f, a])
                print(f"{label} K={K}: factor {f:.4f} ms, apply {a:.4f} ms")
    print(card)
    print(json.dumps({"card": card, "ok": bool(ok), "cases": record, "times_ms": times}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
