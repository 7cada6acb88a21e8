"""A configuration, a traffic mix and a metric added as new files, with
``BENCHMARK.json`` entries and no edit to any file that is there, are found
by name and run."""

from __future__ import annotations

import json
import time

import torch

from benchmark import harness

RUNNER = '''
import numpy as np


class Session:
    def __init__(self):
        self.n = 0

    def step(self, scan):
        self.n += 1
        return {"X": np.zeros(6, np.float32), "iterations": 1, "points": len(scan)}

    def snapshot(self):
        return {"n": self.n}

    def close(self):
        pass


def build(config, device, seed):
    return Session()


def judge(ctx, snapshot, seed):
    seen = abs(snapshot["n"] - len(ctx.records))
    return {"frames_seen": {"value": float(seen), "limit": 0.0}}
'''

METRIC = '''
def read(ctx):
    return float(len(ctx.profile.frames)) if ctx.profile is not None else None
'''


def add_cell(root):
    bench = root / "benchmark"
    traffic = json.loads((bench / "traffic" / "stream.json").read_text())
    traffic.update(frames_per_lap=16, corner_radius=4.0)
    (bench / "traffic" / "short_lap.json").write_text(json.dumps(traffic))
    config = {"runner": "echo", "sensor": {"n_beams": 8, "n_azimuth": 64, "elev_min": -0.4,
                                           "elev_max": 0.1, "rate_hz": 10.0},
              "min_warmup_frames": 2, "profile_frames": 2}
    (bench / "configs" / "echo.json").write_text(json.dumps(config))
    (bench / "runners" / "echo.py").write_text(RUNNER)
    (bench / "metrics" / "frames_profiled.py").write_text(METRIC)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "echo", "source": "a test", "file":
                            "benchmark/configs/echo.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "echo.short", "config": "echo", "traffic": "short_lap",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "frames_profiled", "unit": "frames", "better": "higher",
                              "source": "program_counter", "layer": "runners",
                              "moves": "frames_per_s", "workloads": ["echo.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def test_new_files_are_found_by_name(tiny):
    before = {p: p.read_bytes() for p in (tiny / "benchmark").rglob("*") if p.is_file()}
    add_cell(tiny)
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"

    cell = harness.find_cell(tiny, "echo.short")
    assert cell.runner.__file__.endswith("runners/echo.py")
    assert cell.traffic["frames_per_lap"] == 16
    assert [m["name"] for m in cell.per_layer] == ["frames_profiled"]
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s", "setup_s"}

    dev = torch.device("cpu")
    plain = harness.run_cell(cell, 2**31 + 1, 0.5, False, dev, time.perf_counter())
    assert plain["correct"] and set(plain["metrics"]) == {"frames_per_s", "setup_s"}
    traced = harness.run_cell(cell, 2**31 + 1, 0.5, True, dev, time.perf_counter())
    assert traced["correct"]
    assert traced["metrics"] == {"frames_profiled": {"value": 2.0, "unit": "frames"}}
    assert list(traced)[-1] == "checks"


def test_the_cells_metrics_are_the_ones_that_list_it(tiny):
    cell = harness.find_cell(tiny, "map-os1.stream")
    names = {m["name"] for m in cell.per_layer}
    assert "gn_iters_per_frame" not in names
    assert {"k1_roofline", "busy_ms_per_frame", "graph_capture_s"} <= names
    odo = harness.find_cell(tiny, "odo-os1.stream")
    assert "gn_iters_per_frame" in {m["name"] for m in odo.per_layer}
