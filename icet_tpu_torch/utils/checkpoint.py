"""Read the JAX package's flat npz checkpoints (``icet_tpu/utils/checkpoint.py``
format): keys ``a/b/c`` become nested dicts of numpy arrays."""

from __future__ import annotations

import numpy as np


def load_checkpoint(path: str) -> dict:
    """Load a flat checkpoint back into a nested dict of numpy arrays."""
    path = str(path)
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    out: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out
