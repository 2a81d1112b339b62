"""The readings that the limits of `correct` are set from: a cell's
compared numbers on many seeds, in one process (set-up once), with the
program as its configuration states and, with --control, with the
program's own lower-precision path (float16 histories, bfloat16 stencil
storage), which the limits have to fail:

    python3 portbench/readings.py --workload <cell> --seconds 2 --seeds 1 2 3 [--control]

One JSON line a seed: the numbers, and frames or requests in the window.
Needs a CUDA card."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH_DIR))

CONTROL = {"history_dtype": "float16", "eaw_bf16": True}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from portbench.lib import cells, check
    from portbench.lib.bench import Bench
    from portbench.run import NOISE_PATH

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    cell = cells.resolve(args.workload, cells.load_benchmark())
    limits = check.limits_of(cell.name)
    bench = Bench(cell, "cuda", option_overrides=CONTROL if args.control else None)
    bench.setup()
    for seed in args.seeds:
        t0 = time.perf_counter()
        bench.warm()
        record = bench.window(seed, args.seconds)
        bench.collect(seed, limits)
        t1 = time.perf_counter()
        numbers = bench.check(limits, NOISE_PATH)
        print(json.dumps({"cell": cell.name, "seed": seed,
                          "precision": "control" if args.control else "config",
                          "numbers": numbers, "frames": record["frames"],
                          "run_s": t1 - t0, "check_s": time.perf_counter() - t1}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
