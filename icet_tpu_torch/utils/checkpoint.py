"""The JAX package's flat npz checkpoints (``icet_tpu/utils/checkpoint.py``
format), written and read with numpy: keys ``a/b/c`` of nested dicts, plus
a ``.manifest.json`` of each key's shape and dtype beside the npz.  A file
written here loads through the JAX package's ``load_checkpoint`` and
``load_pretrained``, and the reverse.

The runners' state functions (``odometry_state``/``restore_odometry``,
``map_state``/``restore_map``, ``keyframe_state``/``restore_keyframe``)
write the JAX package's keys and shapes: an odometry or map checkpoint
written by either package resumes in the other.  A keyframe checkpoint's
tables carry across; its random stream is package-specific."""

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


# ---------------------------------------------------------------------------
# Runner state (icet_tpu/utils/checkpoint.py:79-191): the same keys and
# shapes, so a checkpoint of one package's odometry or map resumes in the
# other's.  Restored tensors land on the runner's device.
# ---------------------------------------------------------------------------


def odometry_state(pipe) -> dict:
    """An ``OdometryPipeline``'s resumable state: world pose, last solution
    and frame index."""
    return {
        "T_world": _as_numpy(pipe._T_world),
        "X_prev": _as_numpy(pipe._X_prev),
        "index": np.asarray(pipe._index),
    }


def restore_odometry(pipe, state: dict) -> None:
    """Resume ``pipe`` from :func:`odometry_state`'s dict.  The first scan
    after it re-seeds the reference model (its own motion is not
    registered); the recovery mirrors take the restored pose."""
    dev = pipe.device
    pipe._T_world = torch.as_tensor(np.asarray(state["T_world"], np.float32)).to(dev)
    pipe._X_prev = torch.as_tensor(np.asarray(state["X_prev"], np.float32)).to(dev)
    pipe._X_prev2 = pipe._X_prev
    pipe._index = int(state["index"])
    pipe._model = None
    pipe._scan_prev = None
    pipe._samples_prev = None
    pipe._T_host = np.asarray(state["T_world"], np.float32)
    pipe._X_host = np.asarray(state["X_prev"], np.float32)
    pipe._last_scan = None  # a scan from before the restore belongs to another run


def map_state(mm) -> dict:
    """A ``MapMaker``'s resumable state: the ring map, its cursor, the
    snail trail and the frame index."""
    s = mm.state
    return {
        "points": _as_numpy(s.points),
        "valid": _as_numpy(s.valid),
        "write_ptr": np.asarray(s.write_ptr, np.int32),
        "trail": _as_numpy(s.trail),
        "trail_len": np.asarray(s.trail_len, np.int32),
        "index": np.asarray(mm._index),
    }


def restore_map(mm, state: dict) -> None:
    """Resume ``mm`` from :func:`map_state`'s dict; the first scan after it
    re-seeds the reference model."""
    from icet_tpu_torch.mapping import MapState

    dev = mm.device
    mm.state = MapState(
        points=torch.as_tensor(np.asarray(state["points"], np.float32)).to(dev),
        valid=torch.as_tensor(np.asarray(state["valid"], bool)).to(dev),
        write_ptr=int(state["write_ptr"]),
        trail=torch.as_tensor(np.asarray(state["trail"], np.float32)).to(dev),
        trail_len=int(state["trail_len"]),
    )
    mm._index = int(state["index"])
    mm._model = None


def keyframe_state(ko) -> dict:
    """A ``KeyframeOdometry``'s resumable state: the block map, the pose
    chain and the random stream.  ``key`` holds the port's
    ``torch.Generator`` state (``get_state()``, uint8); the JAX package's
    ``key`` is a uint32 PRNG key, so the random stream does not carry
    across packages (the tables do)."""
    from icet_tpu_torch.keyframe import whole_table

    bm = ko.blockmap
    kf_states = (np.stack(ko.keyframe_states) if ko.keyframe_states
                 else np.zeros((0, 6), np.float32))
    return {
        "bm_points": _as_numpy(whole_table(bm.points)),
        "bm_valid": _as_numpy(whole_table(bm.valid)),
        "bm_poses": _as_numpy(whole_table(bm.poses)),
        "bm_n_blocks": np.asarray(bm.n_blocks, np.int32),
        "bm_cursor": np.asarray(bm.cursor, np.int32),
        "T_key": np.asarray(ko._T_key),
        "x_rel": _as_numpy(ko._x_rel),
        "delta": _as_numpy(ko._delta),
        # _stds_rel and _health0 are not kept: the resume spawn resets both.
        "index": np.asarray(ko._index),
        "key": ko._gen.get_state().numpy(),
        "kf_states": kf_states,
        "kf_indices": np.asarray(ko.keyframe_indices, np.int64),
    }


def restore_keyframe(ko, state: dict, replay_overlap: bool = False) -> None:
    """Resume ``ko`` from :func:`keyframe_state`'s dict.

    The voxel model is not kept (the block map holds the keyframe scan only
    downsampled): the first scan after the restore spawns a keyframe at the
    restored world pose, and its own motion is not registered.  Resuming on
    the checkpointed frame itself (``replay_overlap=True``) closes that
    gap; the flag also skips the resume spawn's seed insert, whose points
    the restored map already holds.  Raises ValueError when ``key`` is not
    a generator state (a JAX package checkpoint's uint32 PRNG key)."""
    from icet_tpu_torch.keyframe import BlockMap, np_pose_matrix

    key = np.asarray(state["key"])
    if key.dtype != np.uint8:
        raise ValueError(
            f"checkpoint entry 'key' is a {key.dtype} array of shape {key.shape}, not a "
            "torch.Generator state (uint8): a JAX package keyframe checkpoint's random "
            "stream does not load into the port"
        )
    dev = ko.device
    ko.blockmap = BlockMap(
        points=torch.as_tensor(np.asarray(state["bm_points"], np.float32)).to(dev),
        valid=torch.as_tensor(np.asarray(state["bm_valid"], bool)).to(dev),
        poses=torch.as_tensor(np.asarray(state["bm_poses"], np.float32)).to(dev),
        n_blocks=int(state["bm_n_blocks"]),
        cursor=int(state["bm_cursor"]),
    )
    ko._T_key = np.asarray(state["T_key"], np.float64)
    ko._x_rel = torch.as_tensor(np.asarray(state["x_rel"], np.float32)).to(dev)
    ko._delta = torch.as_tensor(np.asarray(state["delta"], np.float32)).to(dev)
    ko._index = int(state["index"])
    ko._gen.set_state(torch.from_numpy(key.copy()))
    ko.keyframe_states = [s for s in np.asarray(state["kf_states"], np.float32)]
    ko.keyframe_indices = [int(i) for i in np.asarray(state["kf_indices"])]
    ko._model = None
    ko._key_scan = None
    ko._key_samples = None
    ko._resume_seed_insert = not replay_overlap
    # The next scan spawns at the restored pose, not at the origin.
    ko._resume_T = ko._T_key @ np_pose_matrix(_as_numpy(ko._x_rel))
