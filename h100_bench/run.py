"""The benchmark of ``toycluster_tpu_torch`` on NVIDIA H100 cards.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

run from the root of a checkout.  ``BENCHMARK.json`` names the cells;
``benchlib/main.py`` says what a run does.  Exits 2, printing no result,
without a CUDA device or with fewer than the cell asks for, and 3 if the
run loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every build and kernel cache in the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[:0] = [str(HERE), str(ROOT)]

from benchlib.main import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:], T_START))
