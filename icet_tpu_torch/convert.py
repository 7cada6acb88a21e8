"""Carry state between the JAX package and the port.

The system's state is the voxel model and the config, the DNN filter's
BiasNet weights, the keyframe block map and the MapMaker's ring map.  These
helpers move them across as plain numpy arrays and dictionaries, so a test
can hand the JAX package's own prepared model or map to the port.
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


def _state_from_numpy(cls, arrays: dict, device) -> tuple:
    """``cls`` from numpy arrays by field name: 0-d counters as host ints."""
    fields = {}
    for name in cls._fields:
        a = np.asarray(arrays[name])
        if a.ndim == 0:
            fields[name] = int(a)
        else:
            dtype = torch.bool if a.dtype == np.bool_ else torch.float32
            fields[name] = torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)
    return cls(**fields)


def _state_to_numpy(state) -> dict:
    return {k: (np.asarray(v, np.int32) if isinstance(v, int) else v.cpu().numpy())
            for k, v in state._asdict().items()}


def blockmap_from_numpy(arrays: dict, device="cpu"):
    """A :class:`~icet_tpu_torch.keyframe.BlockMap` from a dict of numpy
    arrays keyed by field name (e.g. ``{k: np.asarray(v) for k, v in
    jax_blockmap._asdict().items()}``); the counters become host ints."""
    # Imported here: keyframe.py imports filters.py, which imports this module.
    from icet_tpu_torch.keyframe import BlockMap

    return _state_from_numpy(BlockMap, arrays, device)


def blockmap_to_numpy(bm) -> dict:
    """The block map's fields as numpy arrays (counters as int32 scalars)."""
    return _state_to_numpy(bm)


def map_state_from_numpy(arrays: dict, device="cpu"):
    """A :class:`~icet_tpu_torch.mapping.MapState` from a dict of numpy
    arrays keyed by field name; the ring cursor and trail length become
    host ints."""
    from icet_tpu_torch.mapping import MapState

    return _state_from_numpy(MapState, arrays, device)


def map_state_to_numpy(state) -> dict:
    """The ring map's fields as numpy arrays (counters as int32 scalars)."""
    return _state_to_numpy(state)


def bias_net_params_from_numpy(tree: dict) -> dict:
    """The state dict of ``models.bias_net.BiasNet`` from the JAX package's
    flax parameter tree (``{"params": {"Dense_i": {kernel (in, out), bias},
    "LayerNorm_i": {scale, bias}}}``, as ``load_checkpoint`` reads it).

    Split as ``icet_tpu``'s ``_split_params``: one encoder stage per
    ``LayerNorm_i`` (with ``Dense_i``), the remaining ``Dense_i`` the head.
    Encoder kernels and biases are kept in float32 and, pre-rounded, in
    bf16 (kernels in the ``(in, out)`` layout the CUDA kernel reads; the
    kernel reads only the bf16 copies); LayerNorm scale and bias and the
    head in float32."""
    p = tree["params"]

    def f32(a):
        return torch.from_numpy(np.array(a, np.float32))

    state, i = {}, 0
    while f"LayerNorm_{i}" in p:
        w = f32(p[f"Dense_{i}"]["kernel"])
        state[f"enc{i}_w"] = w
        state[f"enc{i}_w_bf16"] = w.to(torch.bfloat16)
        b = f32(p[f"Dense_{i}"]["bias"])
        state[f"enc{i}_b"] = b
        state[f"enc{i}_b_bf16"] = b.to(torch.bfloat16)
        state[f"ln{i}_scale"] = f32(p[f"LayerNorm_{i}"]["scale"])
        state[f"ln{i}_bias"] = f32(p[f"LayerNorm_{i}"]["bias"])
        i += 1
    j = 0
    while f"Dense_{i}" in p:
        state[f"head{j}_w"] = f32(p[f"Dense_{i}"]["kernel"])
        state[f"head{j}_b"] = f32(p[f"Dense_{i}"]["bias"])
        i += 1
        j += 1
    return state


def bias_net_params_to_numpy(module) -> dict:
    """The JAX package's flax parameter tree, float32 numpy, from a port
    BiasNet (the serving ``models.bias_net.BiasNet`` or the trainable
    ``models.bias_net.TrainableBiasNet``): ``{"params": {"Dense_i":
    {kernel (in, out), bias}, "LayerNorm_i": {scale, bias}}}``, the encoder
    stages first, then the head, numbered as flax numbers them."""
    sd = module.state_dict()

    def f32(name):
        return sd[name].detach().to(torch.float32).cpu().numpy()

    p, i = {}, 0
    while f"enc{i}_w" in sd:
        p[f"Dense_{i}"] = {"kernel": f32(f"enc{i}_w"), "bias": f32(f"enc{i}_b")}
        p[f"LayerNorm_{i}"] = {"scale": f32(f"ln{i}_scale"), "bias": f32(f"ln{i}_bias")}
        i += 1
    j = 0
    while f"head{j}_w" in sd:
        p[f"Dense_{i + j}"] = {"kernel": f32(f"head{j}_w"), "bias": f32(f"head{j}_b")}
        j += 1
    return {"params": p}


def config_from_icet(fields: dict) -> ICETConfig:
    """The port's :class:`ICETConfig` from the JAX package's config as a
    dict (``dataclasses.asdict(cfg)``); raises on a field the port lacks."""
    names = {f.name for f in dataclasses.fields(ICETConfig)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"fields the port's ICETConfig lacks: {sorted(unknown)}")
    return ICETConfig(**fields)
