"""Train the perspective-shift bias network and save deployable weights;
the port's counterpart of ``examples/train_bias_net.py``.

Mixes synthetic planar patches with raycast voxel pairs (real perspective
shift from two sensor poses of the same simulated scene).  The weights are
written in the JAX package's npz layout, which ``load_pretrained(path=...)``
of either package reads.  ``--out`` defaults to a file in the working
directory: the bundled weights of ``icet_tpu/models/weights/`` are data of
the JAX package, and this command never writes there unless told to.

Usage: python -m icet_tpu_torch.examples.train_bias_net [--steps 1500] [--out weights.npz]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from icet_tpu_torch.examples import add_device_arg

#: the bundled real Ouster pair that ``--real-pairs`` distils
REAL_PAIR = ("sample_data/frame_804.npy", "sample_data/frame_805.npy")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--out", default="bias_net_trained.npz")
    add_device_arg(ap)
    ap.add_argument(
        "--real-pairs", default=None, metavar="REFERENCE_SRC",
        help="distill the reference's bundled REAL Ouster pair "
             "(<REFERENCE_SRC>/sample_data/frame_804.npy and frame_805.npy) "
             "into training: solve it with ICET (self-labeling), align by "
             "the solution, and mix its voxel samples into the raycast pool",
    )
    return ap


def run(args) -> dict:
    """Train and write ``args.out``; returns ``{steps, first_loss,
    last_loss, seconds, out}`` (``last_loss`` the mean of the last 100)."""
    from icet_tpu_torch.convert import bias_net_params_to_numpy
    from icet_tpu_torch.device import resolve_device
    from icet_tpu_torch.models.train_data import train_bias_net_mixed
    from icet_tpu_torch.utils.checkpoint import save_checkpoint

    dev = resolve_device(args.device)
    extra = None
    if args.real_pairs:
        paths = [os.path.join(args.real_pairs, p) for p in REAL_PAIR]
        missing = [p for p in paths if not os.path.isfile(p)]
        if missing:
            raise FileNotFoundError(
                f"--real-pairs: {missing} not found; the real Ouster pair "
                "ships with the reference ICET sources (src/sample_data/), "
                "which are not present here"
            )
        extra = _real_pair_samples(paths, dev)

    t0 = time.time()
    state, losses, _ = train_bias_net_mixed(
        steps=args.steps, batch=args.batch, n_pairs=args.pairs,
        extra_pairs=extra, device=dev,
    )
    secs = time.time() - t0
    print(
        f"trained {args.steps} steps in {secs:.0f}s; "
        f"loss {losses[0]:.3f} -> {np.mean(losses[-100:]):.4f}"
    )
    save_checkpoint(args.out, bias_net_params_to_numpy(state.model))
    print(f"wrote {args.out}")
    return {"steps": args.steps, "first_loss": float(losses[0]),
            "last_loss": float(np.mean(losses[-100:])), "seconds": round(secs, 1),
            "out": args.out}


def _real_pair_samples(paths, dev):
    """Self-labelled voxel samples of the real pair: registered at the
    canonical grid, aligned by the solution (the JAX example's
    ``--real-pairs``)."""
    from icet_tpu_torch.config import ICETConfig
    from icet_tpu_torch.datasets.loaders import detect_beam_count, to_beam_major
    from icet_tpu_torch.models.train_data import make_real_pair_voxel_samples
    from icet_tpu_torch.solver import register_pair

    f1, f2 = (np.load(p).astype(np.float32) for p in paths)
    nb = detect_beam_count(f1) or 64
    f1, f2 = to_beam_major(f1, nb), to_beam_major(f2, nb)
    cfg = ICETConfig(n_iters=7)
    res = register_pair(f1, f2, np.zeros(6, np.float32), cfg, device=dev)
    X = res.X.cpu().numpy()
    extra = make_real_pair_voxel_samples(f1, f2, X, cfg, device=dev)
    print(f"real-pair distillation: {extra[0].shape[0]} voxel pairs "
          f"(teacher X = {np.round(X, 4)})")
    return extra


def main() -> None:
    print(json.dumps(run(build_parser().parse_args())))


if __name__ == "__main__":
    main()
