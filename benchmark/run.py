"""Run one cell of the benchmark (see `harness/cli.py`):

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program (`slam1_tpu_torch/`)
and a CUDA card. The program's kernels build into its fixed directory
inside the checkout (`slam1_tpu_torch/build/`) at the first run; any
Triton cache goes to `.bench_cache/` there.
"""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".bench_cache",
                                              "triton")

from benchmark.harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
