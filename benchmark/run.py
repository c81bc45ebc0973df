"""Run one cell of the port's benchmark once, on the card it starts on.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the result as the last line of standard output, and each number
compared with the plain reference beside its limit as the last lines of
standard error.  Exits non-zero, with no result, without enough CUDA
devices, and if the process holds JAX or the JAX package at the end.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import env  # noqa: E402

env.pin_caches()

from benchmark import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(sys.argv[1:], T_START))
