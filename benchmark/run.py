"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout of the repository.  Needs the CUDA cards the
cell asks for: without them it prints no result and exits with 2.
"""

import time

T_START = time.perf_counter()  # the process's start, for setup_s

import os  # noqa: E402
import sys  # noqa: E402

# the kernels' build directory is the checkout's own (``build/``, fixed by
# gmpi_tpu_torch/ops/_build.py); keep any library that reads these from
# loading JAX, and keep caches under the run's own home
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
