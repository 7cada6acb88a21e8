"""The port's timing and tracing (``utils/profiling.py``) on the CPU: the
stage timer's spans and summary (the JAX package's keys), the per-call
time over back-to-back calls (the host clock for CPU tensors; the device
follows the inputs and is never chosen silently) and the Chrome trace."""

import json
import time

import numpy as np
import pytest
import torch

from icet_tpu.utils import profiling as jp
from icet_tpu_torch.utils import profiling as tp

torch.set_num_threads(2)


def test_stage_timer():
    timer = tp.StageTimer()
    x = torch.ones(4)
    for _ in range(3):
        with timer.stage("a", sync_on=x):
            time.sleep(0.005)
    with timer.stage("b", sync_on=[x, {"y": x}]):
        pass
    with timer.stage("c", sync_on="cpu"):
        pass
    s = timer.summary()
    assert s["a"]["n"] == 3 and s["a"]["mean_ms"] >= 5.0
    assert s["b"]["n"] == s["c"]["n"] == 1
    j = jp.StageTimer()
    with j.stage("a"):
        pass
    assert set(s["a"]) == set(j.summary()["a"])


def test_stage_timer_records_a_raising_block():
    timer = tp.StageTimer()
    with pytest.raises(ValueError):
        with timer.stage("boom"):
            raise ValueError("inside")
    assert timer.summary()["boom"]["n"] == 1


def test_device_time_ms_cpu():
    a = torch.randn(64, 64)
    calls = []

    def fn(m):
        calls.append(1)
        return m @ m

    ms = tp.device_time_ms(fn, a, inner=4, trials=3)
    assert np.isfinite(ms) and ms > 0
    assert len(calls) == 1 + 4 * 3  # one warm-up call, then trials x inner


def test_device_time_ms_refuses_unplaced_inputs():
    with pytest.raises(ValueError, match="one device"):
        tp.device_time_ms(lambda: None, inner=1, trials=1)
    with pytest.raises(ValueError, match="one device"):
        tp.device_time_ms(lambda a, b: None, torch.ones(1), torch.ones(1, device="meta"),
                          inner=1, trials=1)


def test_trace_writes_chrome_trace(tmp_path):
    a = torch.randn(32, 32)
    with tp.trace(str(tmp_path / "tr")) as path:
        for _ in range(3):
            a = torch.tanh(a @ a)
    with open(path) as f:
        doc = json.load(f)
    names = {e.get("name", "") for e in doc["traceEvents"]}
    assert any("mm" in n for n in names), sorted(names)[:20]
