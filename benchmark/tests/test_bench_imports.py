"""Nothing a run loads has the top-level name ``jax``, ``jaxlib``, ``flax``
or ``icet_tpu`` (compared whole: the program's ``icet_tpu_torch`` begins
with ``icet_tpu``), and a run without a card or without the program prints
no result."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from conftest import ROOT

DRIVE = """
import json, sys, time
from pathlib import Path
root = Path(sys.argv[1])
sys.path.insert(0, str(root))
import torch
from benchmark import harness
for name in ("odo-os1.stream", "map-os1.stream"):
    cell = harness.find_cell(root, name)
    harness.run_cell(cell, 2**31 + 3, 0.5, True, torch.device("cpu"), time.perf_counter())
print(json.dumps(sorted(sys.modules)))
"""


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("icet_tpu_torch", "icet_tpu_torch.graphs", "jaxtyping", "flax_like"):
        monkeypatch.setitem(sys.modules, name, sys)
    for name in ("jax", "jaxlib", "flax", "icet_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
        monkeypatch.delitem(sys.modules, name + ".sub", raising=False)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "icet_tpu.solver", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.forbidden_modules() == ["icet_tpu", "jaxlib"]


def test_a_run_loads_no_jax_and_no_icet_tpu(tiny):
    out = subprocess.run([sys.executable, "-c", DRIVE, str(tiny)], capture_output=True,
                         text=True, timeout=600, cwd=tiny)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}
    assert "icet_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "odo-os1.stream",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=cwd)


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: test_bench_card runs the cell on it")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_no_result_with_only_the_benchmarks_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
