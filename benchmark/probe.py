"""What the benchmark reads from the program: its own counters.

``icet_tpu_torch.graphs.host_ops`` (graph replays, flag and block reads,
copies, draws, captures), ``graphs.capture_stats`` (seconds capturing and
instantiating CUDA graphs) and the launches of kernel #1 that the
``fused_moment_sums`` wrapper counts (exact after ``graphs.settle()``, one
host read; so a probe is taken outside the timed window only).
"""

from __future__ import annotations


def read() -> dict:
    from icet_tpu_torch import graphs
    from icet_tpu_torch.ops.fused_moments import fused_moment_sums

    host_ops = dict(graphs.host_ops)  # before settle() adds its own read
    graphs.settle()
    return {"host_ops": host_ops, "capture": dict(graphs.capture_stats),
            "k1_launches": fused_moment_sums.launches}


def captured() -> int:
    """Graphs captured so far (no host read of the device)."""
    from icet_tpu_torch import graphs

    return graphs.capture_stats["graphs"]
