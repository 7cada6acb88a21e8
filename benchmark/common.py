"""What the runners share: the program's solver configuration of a
configuration file, the frames a check compares and the summary of their
gaps."""

from __future__ import annotations

import dataclasses

import numpy as np


def solver_config(config: dict):
    """The program's ``ICETConfig`` of a configuration file."""
    from icet_tpu_torch.config import ICETConfig

    names = {f.name for f in dataclasses.fields(ICETConfig)}
    return ICETConfig(**{k: v for k, v in config.items() if k in names})


def corner_frames(lap) -> set[int]:
    """Lap frames whose heading differs from the frame before: the turns."""
    R = lap.poses[:, :3, :3]
    turned = np.abs(R - np.roll(R, 1, axis=0)).max(axis=(1, 2)) > 1e-9
    return {int(i) for i in np.flatnonzero(turned)}


def sample(ctx, seed: int, strata: dict | None = None) -> list[int]:
    """Positions in ``ctx.records`` to compare, drawn from the seed: the
    run's first registration, a quarter of ``sample_frames`` from each
    stratum (a name and the set of record positions in it; the turns of
    the lap always among them), and the rest from every window frame."""
    window = [i for i, r in enumerate(ctx.records) if r["window"] and r["out"] is not None]
    corners = corner_frames(ctx.lap)
    strata = dict({"turns": {i for i in window if ctx.records[i]["lap"] in corners}},
                  **(strata or {}))
    rng = np.random.default_rng(seed)
    n = min(ctx.config["sample_frames"], len(window))
    picked: set[int] = set()
    for members in strata.values():
        pool = sorted(set(window) & set(members))
        k = min(n // 4, len(pool))
        picked.update(int(i) for i in rng.choice(pool, size=k, replace=False))
    rest = sorted(set(window) - picked)
    k = min(n - len(picked), len(rest))
    picked.update(int(i) for i in rng.choice(rest, size=k, replace=False))
    first = next(i for i, r in enumerate(ctx.records) if r["out"] is not None)
    return [first] + sorted(picked - {first})


def summarize(per: dict) -> dict:
    """Of each list of per-frame gaps: ``<name>_2nd``, the second largest
    (one frame may stand apart, every other must agree), ``<name>_med`` and
    ``<name>_max``."""
    out = {}
    for name, values in per.items():
        v = sorted(values, reverse=True)
        out[f"{name}_2nd"] = float(v[1] if len(v) > 1 else v[0])
        out[f"{name}_med"] = float(np.median(v))
        out[f"{name}_max"] = float(v[0])
    return out


def gap_lines(per: dict) -> list[str]:
    """Each per-frame gap list, largest first, for the run's earlier lines."""
    return [f"{name} by frame, largest first: "
            + " ".join(f"{x:.3e}" for x in sorted(v, reverse=True)) for name, v in per.items()]
