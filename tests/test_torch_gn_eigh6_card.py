"""Kernel #7 on the card: ``chip_smoke.py`` phase 32 as a test.

The kernel against its plain version on the iterations of lap solves at
75x24 and 150x48, on random SPD matrices at condition numbers 1e2-1e9 and
on one with a repeated eigenvalue, cold and warm with both outcomes of the
warm test: w6 within 1e-6 of max |w|, keep and the dropped count equal, the
reconstructions, the separated eigenvectors (column for column, up to
sign) and X + dx within their limits; two launches and two graph replays
equal bit for bit; the compiled odometry runner launches it 7 times a frame
and the mapping runner 12.  Skips without a CUDA device; run on the card
with ``python -m pytest tests/test_torch_gn_eigh6_card.py -m card``.  This
file does not import the reference package.
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
def test_gn_eigh6_against_the_plain_version(card):
    from chip_smoke import EIGH6_W_RTOL, device_line, phase_gn_eigh6

    out = phase_gn_eigh6(card, device_line())
    assert out["worst"]["w"] <= EIGH6_W_RTOL
    assert out["outcomes"][True] > 0 and out["outcomes"][False] > 0
    assert all(k == 7 for k in out["launches"]["odometry"][2:])
    assert all(k == 12 for k in out["launches"]["mapping"][2:])
