"""The port's user entry points, counterparts of the JAX package's
``examples/``: run as ``python -m icet_tpu_torch.examples.<name>``.

Each module exposes ``build_parser()`` and ``run(args) -> dict``, so tests
and ``chip_smoke.py`` call them in process, and a ``main()`` that prints
the summary.  Every entry point runs on CUDA (``--device cuda``, the
default) and raises when CUDA is missing; ``--device cpu`` runs it on the
CPU.  Only ``--viz`` imports ``icet_tpu_torch.viz`` (matplotlib).
"""


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the solver runs (default cuda; raises "
                         "without it)")
