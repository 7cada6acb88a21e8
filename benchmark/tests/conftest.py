"""CPU tests of the benchmark (``python -m pytest benchmark/tests``).

Tests marked ``card`` need a CUDA device and skip without one; whether
there is one is decided inside the ``card`` fixture, never at import.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: a size a test run holds: 32 beams x 256 azimuths, a 25x24 grid
TINY_SENSOR = {"n_beams": 32, "n_azimuth": 256}
TINY_CONFIG = {"n_theta": 25, "n_phi": 24, "min_pts": 10, "sample_frames": 8,
               "profile_frames": 3, "min_warmup_frames": 3}
TINY_MAP = {"capacity": 20_000, "points_per_scan": 500, "snapshot_every": 5}
#: the solution's and stds' limits at that size: ten times the
#: card's (32 beams fit coarser voxels, and the program's plain version on
#: the CPU sums in float32 in index order, so sound tiny runs read above
#: the card's limits; every fault and the control read far more)
TINY_LIMIT_SCALE = {"x_gap_2nd": 10.0, "std_gap_2nd": 10.0}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")
    if os.environ.get("PYTEST_XDIST_WORKER"):
        import torch

        torch.set_num_threads(2)  # workers share the cores


_LAPS: dict = {}


@pytest.fixture(autouse=True)
def reuse_laps(monkeypatch):
    """Each lap raycast once a test process: a lap is a function of its
    traffic, sensor, seed and device."""
    from benchmark import lap as lapgen

    make = lapgen.make_lap

    def cached(traffic, sensor, seed, device, **kw):
        key = (json.dumps(traffic, sort_keys=True), json.dumps(sensor, sort_keys=True), seed,
               str(device), json.dumps(kw, sort_keys=True))
        if key not in _LAPS:
            _LAPS[key] = make(traffic, sensor, seed, device, **kw)
        return _LAPS[key]

    cached.__wrapped__ = make
    monkeypatch.setattr(lapgen, "make_lap", cached)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here; run on the card")
    return torch.device("cuda", 0)


def make_tiny_checkout(dest: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``benchmark/`` with the tiny sensor
    and grid (the lap keeps its 0.25 m a frame), beside a link to the
    program."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dest / "icet_tpu_torch").symlink_to(ROOT / "icet_tpu_torch")
    for path in (dest / "benchmark" / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c["sensor"].update(TINY_SENSOR)
        c.update(TINY_CONFIG)
        c["limits"] = {k: v * TINY_LIMIT_SCALE.get(k, 1.0) for k, v in c["limits"].items()}
        if "capacity" in c:
            c.update(TINY_MAP)
        path.write_text(json.dumps(c, indent=1))
    return dest


@pytest.fixture
def tiny(tmp_path) -> Path:
    return make_tiny_checkout(tmp_path / "checkout")
