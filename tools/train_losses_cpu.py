#!/usr/bin/env python3
"""BiasNet training losses on the CPU for the two cases ``chip_smoke.py``
phase 15 trains on the card: the JAX package (``icet_tpu``, the reference)
and, with ``--port``, the PyTorch port on its CPU path.

* mixed: ``train_bias_net_mixed`` at its published size (features (64,
  128, 256), head (128, 64), batch 256, S = 100, lr 1e-3, ``n_pairs=6``,
  seed 0), cut to ``--steps`` steps (default 100, the card's cut);
* patches: ``tests/test_models.py::test_train_step_decreases_loss``'s case,
  40 steps of ``train_step`` on ``make_patch_batch`` at batch 128, S = 32.

The two packages draw from different generators (``jax.random`` and
``torch.Generator``), so their losses agree in distribution, not step by
step.  Prints, for each case, the first and last loss and the means of the
first and last ten steps.  Run from the repository root:

    JAX_PLATFORMS=cpu python3 tools/train_losses_cpu.py [--port] [--steps 100]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def summary(losses, seconds: float) -> dict:
    losses = [float(v) for v in losses]
    return {"first": losses[0], "last": losses[-1], "first10_mean": float(np.mean(losses[:10])),
            "last10_mean": float(np.mean(losses[-10:])), "steps": len(losses), "s": seconds}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true", help="also run the port's CPU path")
    ap.add_argument("--steps", type=int, default=100, help="steps of the mixed case")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from icet_tpu.models import bias_net as jb
    from icet_tpu.models import train_data as jt

    out = {"icet_tpu": {}}
    t0 = time.perf_counter()
    _, _, losses, _ = jt.train_bias_net_mixed(steps=args.steps, batch=256, sample_pts=100,
                                              lr=1e-3, seed=0, n_pairs=6)
    out["icet_tpu"]["mixed"] = summary(losses, time.perf_counter() - t0)
    t0 = time.perf_counter()
    model, tx, state = jb.create_train_state(jax.random.PRNGKey(0), sample_pts=32)
    key, losses = jax.random.PRNGKey(1), []
    for _ in range(40):
        key, sub = jax.random.split(key)
        inputs, targets = jb.make_patch_batch(sub, batch=128, sample_pts=32)
        state, loss = jb.train_step(model, tx, state, inputs, targets)
        losses.append(float(loss))
    out["icet_tpu"]["patches"] = summary(losses, time.perf_counter() - t0)
    print(json.dumps({"icet_tpu": out["icet_tpu"]}), flush=True)

    if args.port:
        import torch

        from icet_tpu_torch.models import bias_net as tb
        from icet_tpu_torch.models import train_data as tt

        torch.set_num_threads(min(8, os.cpu_count() or 1))
        out["icet_tpu_torch_cpu"] = {}
        t0 = time.perf_counter()
        _, losses, _ = tt.train_bias_net_mixed(steps=args.steps, batch=256, sample_pts=100,
                                               lr=1e-3, seed=0, n_pairs=6, device="cpu")
        out["icet_tpu_torch_cpu"]["mixed"] = summary(losses, time.perf_counter() - t0)
        t0 = time.perf_counter()
        _, losses = tb.train_bias_net(torch.Generator().manual_seed(0), steps=40, batch=128,
                                      sample_pts=32, device="cpu")
        out["icet_tpu_torch_cpu"]["patches"] = summary(losses, time.perf_counter() - t0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
