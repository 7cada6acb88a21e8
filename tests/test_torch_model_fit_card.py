"""Kernel #8 on the card: ``chip_smoke.py`` phase 33 as a test.

The kernels against their plain version on the fits of lap frames at
75x24, 150x48 and fixed radial mode, with the NDT test and with the
clip-fill guard, and on fits whose safeguard commits 0, 1 and 2 extra
sweeps (one held only by the sentinel, one only by an invalid row): every
field of the model bit for bit; two launches and two graph replays bit for
bit; two device operations a fit; the compiled odometry, filtered odometry
and mapping runners launch them twice a frame.  Skips without a CUDA
device; run on the card with ``python -m pytest
tests/test_torch_model_fit_card.py -m card``.  This file does not import the
reference package.
"""

from __future__ import annotations

import pytest
import torch

torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here; run on the card")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_model_fit_against_the_plain_version(card):
    from chip_smoke import device_line, phase_model_fit
    from icet_tpu_torch.ops.model_fit import LAUNCHES

    out = phase_model_fit(card, device_line())
    assert {0, 1, 2} <= set(out["extras"].values())
    for counts in out["launches"].values():
        assert all(k == LAUNCHES for k in counts[2:])
