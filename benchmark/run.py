"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload stream432 --seed 7 --seconds 10 \
        --trace 0

Exits non-zero, printing no result, without enough CUDA cards, when a
module of JAX or of the JAX package is loaded, or when the port is not
beside this folder."""

import os
import sys
import time

T_START = time.time()  # the set-up clock starts before any import

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmark import harness

    sys.exit(harness.main(sys.argv[1:], T_START))
