"""The control at a size a test holds: the plain reference in the program's
place with TF32 products fails the cell's check; in float32 every gap of
the check is 0 (the check judging its own reference)."""

from __future__ import annotations

import pytest
import torch

from benchmark import control


@pytest.mark.parametrize("workload", ["odo-os1.stream", "map-os1.stream"])
def test_tf32_control_is_not_correct(tiny, workload):
    out = control.control(tiny, workload, 2**31 + 11, None, "tf32", torch.device("cpu"))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", ["odo-os1.stream", "map-os1.stream"])
def test_float32_reference_passes_its_own_check(tiny, workload):
    out = control.control(tiny, workload, 2**31 + 11, 8, "fp32", torch.device("cpu"))
    # The ATE is the trajectory's error against the exact poses, not a gap.
    assert all(c["value"] == 0.0 for k, c in out["checks"].items() if k != "ate_24_cm")


@pytest.mark.card
def test_tf32_control_on_the_card(card, tiny):
    for workload in ("odo-os1.stream", "map-os1.stream"):
        assert not control.control(tiny, workload, 2**31 + 11, None, "tf32", card)["correct"]
