"""Kernel #6 on the card: ``chip_smoke.py`` phase 31 as tests.

The kernel against its plain version at 75x24, 150x48 and fixed radial
mode in every branch: ``corr``, ``n_corr`` and ``n_rejected`` equal; the
sums within ``chip_smoke.GN_RTOL`` (1e-5) of their largest entry, the sums
over rows being added in another order; two launches and two graph
replays equal bit for bit; rows held alone equal bit for bit; a compiled
solve launches it once an iteration.  Skips without a CUDA device; run on
the card with ``python -m pytest tests/test_torch_gn_assembly_card.py -m
card``.  This file does not import the reference package.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here; run on the card")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_gn_assembly_against_the_plain_version(card):
    from chip_smoke import device_line, phase_gn_assembly
    from icet_tpu_torch.config import ICETConfig
    from icet_tpu_torch.datasets.replay import CityDriveSource

    src = CityDriveSource(n_frames=2, speed=1.0, n_beams=64, n_azimuth=1024)
    s1, s2 = (torch.from_numpy(np.asarray(s, np.float32)).to(card) for s, _ in src)
    cfg = ICETConfig(n_iters=7, convergence_tol=1e-4, convergence_stat_scale=1.0)
    out = phase_gn_assembly(s1, s2, cfg, card, device_line())
    assert out["rel"] <= 1e-5
