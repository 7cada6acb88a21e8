"""Run one cell of ``BENCHMARK.json`` once, from the root of a checkout:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result object; the numbers that
decide ``correct`` are the last lines of standard error.  Every build and
kernel cache stays inside the checkout, at fixed paths.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
# One process with few threads: the program's host work is a few small
# tensor operations a frame, and idle pool threads only add jitter.
os.environ["OMP_NUM_THREADS"] = "1"
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from pathlib import Path

    from benchmark.harness import main

    sys.exit(main(sys.argv[1:], T_START, Path(ROOT)))
