"""The JAX package's flat npz checkpoints (``icet_tpu/utils/checkpoint.py``
format), written and read with numpy: keys ``a/b/c`` of nested dicts, plus
a ``.manifest.json`` of each key's shape and dtype beside the npz.  A file
written here loads through the JAX package's ``load_checkpoint`` and
``load_pretrained``, and the reverse."""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> dict:
    """Nested dicts (or NamedTuples) of arrays -> ``{"a/b/c": ndarray}``;
    tensors are copied to host numpy."""
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_asdict"):
        items = tree._asdict().items()
    else:
        return {prefix or "value": _as_numpy(tree)}
    out = {}
    for k, v in items:
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "_asdict"):
            out.update(_flatten(v, key))
        else:
            out[key] = _as_numpy(v)
    return out


def _as_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path: str, state: dict) -> None:
    """Write a nested dict of arrays (numpy or tensors; scalars allowed) as
    an npz and its manifest.  ``path`` gains ``.npz`` if it lacks it."""
    path = str(path)
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(state)
    np.savez_compressed(path, **flat)
    with open(path + ".manifest.json", "w") as f:
        json.dump(
            {k: {"shape": list(v.shape), "dtype": str(v.dtype)} for k, v in flat.items()},
            f,
            indent=1,
        )


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
