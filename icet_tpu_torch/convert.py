"""Carry state between the JAX package and the port.

The system has no weights: its state is the voxel model and the config.
These helpers move both across as plain numpy arrays and dictionaries, so
a test can hand the JAX package's own prepared model to the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from icet_tpu_torch.config import ICETConfig
from icet_tpu_torch.solver import VoxelModel


def voxel_model_from_numpy(arrays: dict, device="cpu") -> VoxelModel:
    """A :class:`VoxelModel` from a dict of numpy arrays keyed by field name
    (e.g. ``{k: np.asarray(v) for k, v in jax_model._asdict().items()}``)."""
    fields = {}
    for name in VoxelModel._fields:
        dtype = torch.bool if name == "valid" else torch.float32
        a = torch.from_numpy(np.array(arrays[name]))
        fields[name] = a.to(device=device, dtype=dtype)
    return VoxelModel(**fields)


def voxel_model_to_numpy(model: VoxelModel) -> dict:
    """The model's fields as a dict of numpy arrays."""
    return {k: v.cpu().numpy() for k, v in model._asdict().items()}


def config_from_icet(fields: dict) -> ICETConfig:
    """The port's :class:`ICETConfig` from the JAX package's config as a
    dict (``dataclasses.asdict(cfg)``); raises on a field the port lacks."""
    names = {f.name for f in dataclasses.fields(ICETConfig)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"fields the port's ICETConfig lacks: {sorted(unknown)}")
    return ICETConfig(**fields)
