"""The benchmark of ``icet_tpu_torch`` on an NVIDIA H100 (``run.py``)."""
