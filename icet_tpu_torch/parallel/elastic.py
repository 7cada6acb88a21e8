"""Elastic execution: device health probes and re-sharding on device loss
(``icet_tpu/parallel/elastic.py``).

:func:`probe_devices` runs a tiny operation on every device at once, each
on its own daemon thread, and reports the devices that finish within the
deadline; :class:`ElasticRegistrationRunner` keeps batched, sharded
registration running when a step fails by rebuilding the largest usable
mesh from the devices that still answer.

What in-process recovery can cover on CUDA: failures that leave the
process's CUDA context usable (a refused launch, an out-of-memory, a
failure raised by the host code around the kernels, a device the probe
stops reaching).  A sticky error (an illegal address, an Xid) poisons the
context of the whole process: every later CUDA call fails, the probe
reports every device of that context unhealthy, and the retry raises.
Recovering from those takes a new process.
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np
import torch

from icet_tpu_torch.config import ICETConfig
from icet_tpu_torch.parallel.sharding import (
    _local_devices,
    make_sharded_register,
    registration_mesh,
    shard_scan_batch,
)

_log = logging.getLogger(__name__)


def _default_probe_op(d) -> bool:
    return float(torch.ones(8, device=d).sum().item()) == 8.0


def probe_devices(devices=None, timeout_s: float = 60.0, _op=None) -> list:
    """The devices of ``devices`` (default: every local CUDA device) on
    which ``_op(device) -> bool`` returns True within ``timeout_s``.

    Every device is probed at once, each on a daemon thread; a probe that
    neither returns nor raises by the deadline counts as unhealthy and its
    thread is abandoned (it leaks one blocked thread) rather than allowed
    to hang the caller.  ``_op`` defaults to ``torch.ones(8).sum() == 8``
    on the device."""
    devices = list(devices) if devices is not None else _local_devices()
    op = _op or _default_probe_op
    results: dict[int, bool] = {}

    def work(i, d):
        try:
            ok = bool(op(d))
        except Exception:  # a failing device is what the probe reports
            ok = False
        results[i] = ok  # one store per key

    threads = [threading.Thread(target=work, args=(i, d), daemon=True)
               for i, d in enumerate(devices)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout_s
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    return [d for i, d in enumerate(devices) if results.get(i)]


def best_mesh_shape(n_devices: int, prefer_dp: int) -> tuple[int, int]:
    """Largest ``(dp, sp)`` grid with ``dp <= prefer_dp`` dividing
    ``n_devices``."""
    for dp in range(min(prefer_dp, n_devices), 0, -1):
        if n_devices % dp == 0:
            return dp, n_devices // dp
    return 1, max(n_devices, 1)


class ElasticRegistrationRunner:
    """Sharded batched registration that survives device loss.

    Usage::

        runner = ElasticRegistrationRunner(cfg, prefer_dp=2)
        res = runner.run(scans1, scans2, x0s)   # (B, N, 3) host arrays

    The batch is padded to the mesh's divisors (the last pair repeated,
    zero points appended; the result is cut back to B).  When a step
    raises, the runner re-probes its devices: if every one still answers,
    the error is not a device's and is raised; otherwise the mesh is
    rebuilt from the healthy ones and the step retried (``rebuilds``
    counts the rebuilds).  Devices may repeat (one card standing in for
    several).  The failures this covers are those that leave the CUDA
    context usable; after a sticky error the probe finds no device and the
    run raises (see the module's docstring)."""

    def __init__(
        self,
        cfg: ICETConfig,
        prefer_dp: int = 1,
        devices=None,
        max_retries: int = 2,
    ):
        self.cfg = cfg
        self.prefer_dp = prefer_dp
        self.max_retries = max_retries
        self.rebuilds = 0
        self._devices = list(devices) if devices else _local_devices()
        self._build()

    def _build(self) -> None:
        if not self._devices:
            raise RuntimeError("no healthy devices remain")
        dp, sp = best_mesh_shape(len(self._devices), self.prefer_dp)
        self.mesh = registration_mesh(dp=dp, sp=sp, devices=self._devices[: dp * sp])
        self._step = make_sharded_register(self.cfg, self.mesh)

    def refresh(self, devices=None) -> None:
        """Re-probe ``devices`` (default: every local CUDA device) and
        rebuild the mesh from the healthy ones."""
        self._devices = probe_devices(devices)
        self._build()
        self.rebuilds += 1

    @property
    def shape(self) -> tuple[int, int]:
        return (self.mesh.shape["dp"], self.mesh.shape["sp"])

    def _pad(self, scans1, scans2, x0s):
        dp, sp = self.shape
        b, n = scans1.shape[0], scans1.shape[1]
        pad_b = (-b) % dp
        pad_n = (-n) % sp
        if pad_b:
            def rep(a):
                return np.concatenate([a, np.repeat(a[-1:], pad_b, 0)], 0)

            scans1, scans2, x0s = rep(scans1), rep(scans2), rep(x0s)
        if pad_n:
            z = np.zeros((scans1.shape[0], pad_n, 3), scans1.dtype)
            scans1 = np.concatenate([scans1, z], 1)
            scans2 = np.concatenate([scans2, z], 1)
        return scans1, scans2, x0s, b

    def run(self, scans1, scans2, x0s):
        """Register a ``(B, N, 3)`` batch; returns a RegistrationResult of
        numpy arrays with a leading B axis."""
        scans1 = np.asarray(scans1, np.float32)
        scans2 = np.asarray(scans2, np.float32)
        x0s = np.asarray(x0s, np.float32)
        last_err = None
        for _ in range(self.max_retries + 1):
            s1, s2, s0, b = self._pad(scans1, scans2, x0s)
            try:
                res = self._step(*shard_scan_batch(s1, s2, s0, self.mesh))
                return type(res)(*(_host(v, b) for v in res))
            except Exception as e:  # a device failure or a real error: probe decides
                _log.warning("sharded step failed on mesh %s; probing", self.shape, exc_info=True)
                last_err = e
                healthy = probe_devices(self._devices)
                if len(healthy) == len(self._devices):
                    raise
                self._devices = healthy
                self._build()
                self.rebuilds += 1
        raise RuntimeError(f"elastic retries exhausted ({self.rebuilds} rebuilds)") from last_err


def _host(v, b: int):
    """A result field as numpy, cut to the first ``b`` rows."""
    if isinstance(v, tuple):
        return type(v)(*(_host(u, b) for u in v))
    return v.detach().cpu().numpy()[:b]


__all__ = [
    "ElasticRegistrationRunner",
    "best_mesh_shape",
    "probe_devices",
]
