"""The readings that set the judge's limits, on the card at a cell's own
size: sound runs of the program, the control and the planted faults
(``benchlib/controls.py``), each for several seeds in one process.

    python3 h100_bench/control.py --workload <cell> --modes <mode> [...]
        --seeds <n> [<n> ...] [--seconds <s>] [--out <file.jsonl>]

Each seed is one run of the cell (warm-up, a window of ``--seconds``,
default 0: one IC, the judge), its set judged under each of ``--modes``
(``frozen`` alone, or any of the others together); one JSON line a seed
and mode goes to standard output and to ``--out``.  Benchmark runs never
run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[:0] = [str(HERE), str(ROOT)]

from benchlib import spec  # noqa: E402
from benchlib.controls import MODES, run_modes  # noqa: E402


def main(argv):
    p = argparse.ArgumentParser(prog="h100_bench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--modes", choices=MODES, nargs="+", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    t = T_START
    for seed in args.seeds:
        cell = spec.cell(args.workload, 0)
        for mode, r in run_modes(args.modes, cell, seed, args.seconds,
                                 "cuda", t).items():
            line = json.dumps({
                "workload": args.workload, "mode": mode, "seed": seed,
                "correct": r["correct"], "ics": r["attempted"],
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "values": {k: v["value"] for k, v in r["checks"].items()}})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as fd:
                    fd.write(line + "\n")
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
