"""The DNN filter's device time and counts on the card.

``OdometryPipeline`` with the filter in the loop (12 iterations, the last
5 filtered, 2 refinement passes, the bundled weights) over the first frames
of the 64x1024 city drive at 75x24 bins: each filtered frame logs the
value ``dnn_filter``, the device time between the timing events its graph
records around the five passes, less than its ``dnn`` replay's, and no
span of it (the spans' device times do not overlap); #4's launches a frame
are 10 once the graphs are captured; with the log off the same graph
replays, and the frames equal the logged ones bit for bit.  Skips without a CUDA device; run on the card
with ``python -m pytest tests/test_torch_dnn_spans_card.py -m card``.  This
file does not import the reference package.
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
def test_filter_spans_and_counters_on_the_card(card):
    from icet_tpu_torch import graphs
    from icet_tpu_torch.config import ICETConfig, OdometryConfig
    from icet_tpu_torch.datasets.replay import CityDriveSource
    from icet_tpu_torch.odometry import OdometryPipeline
    from icet_tpu_torch.utils.profiling import frame_log

    cfg = ICETConfig(n_iters=12, min_range=2.0, dnn_filter=True, dnn_start_iter=7,
                     dnn_refine_steps=2, dnn_in_loop=True)
    scans = [np.asarray(s, np.float32) for s, _ in
             CityDriveSource(n_frames=6, speed=1.0, n_beams=64, n_azimuth=1024)]

    def drive(logged: bool):
        graphs.clear(card)
        frame_log.reset()
        frame_log.enabled = logged
        try:
            pipe = OdometryPipeline(cfg, OdometryConfig(divergence_clamp=2.5), device=card)
            return [pipe.step(s) for s in scans]
        finally:
            frame_log.enabled = True

    logged = drive(True)
    rec = frame_log.records()
    names, values = rec["names"], rec["value_names"]
    col = {n: rec["values"][:, values.index(n)] for n in values}
    assert col["encoder_launches"][3:].tolist() == [10] * (len(scans) - 3)
    for i in range(1, len(scans)):
        n = rec["n_spans"][i]
        which = [names[k] for k in rec["name"][i, :n]]
        assert "dnn_filter" not in which and which.count("dnn") == 1
        ms = col["dnn_filter"][i]
        assert np.isfinite(ms) and 0 < ms < rec["device_ms"][i, which.index("dnn")]
        assert col["n_rejected"][i] == logged[i].n_rejected
        assert col["filter_passes"][i] == 5

    quiet = drive(False)
    assert len(frame_log.records()["seq"]) == 0
    for a, b in zip(logged[1:], quiet[1:]):
        assert np.array_equal(a.X, b.X) and np.array_equal(a.pred_stds, b.pred_stds)
        assert torch.equal(a.dnn_filter.keeps, b.dnn_filter.keeps)
        assert torch.equal(a.dnn_filter.dnn_shifts, b.dnn_filter.dnn_shifts)
        assert torch.equal(a.dnn_filter.icet_shifts, b.dnn_filter.icet_shifts)
