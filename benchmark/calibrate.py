"""Readings for a cell's limits, many seeds in one process: each seed's
set-up and a short window at the cell's own size, then the numbers the
check compares, judged on the program's answers and on the control's
(the reference in the lower precision, in the program's place), with
``--faults`` on runs whose timed call is broken underneath, and with
``--planted`` on the sound run's answers with a fault planted on them.

    python benchmark/calibrate.py --workload tncg-lastfm.fit \\
        --seeds 11,12,13 --seconds 1 [--faults unchanged,half,altered] \\
        [--planted unchanged.users,half.users,altered.users]

Prints one JSON line a seed and reading.  The benchmark's own runs do
not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import env  # noqa: E402

env.pin_caches()

from benchmark import core, faults  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--faults", default="")
    ap.add_argument("--planted", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = core.find_cell(core.load_spec(), args.workload)
    kind = cell.traffic["kind"]
    for seed in [int(s) for s in args.seeds.split(",")]:
        res = core.readings(cell, seed, args.seconds, args.device,
                            planted=list(filter(None,
                                                args.planted.split(","))))
        print(json.dumps({"seed": seed, "run": "sound", **res}), flush=True)
        for name in filter(None, args.faults.split(",")):
            res = core.readings(cell, seed, args.seconds, args.device,
                                faults.make(kind, name))
            print(json.dumps({"seed": seed, "run": f"fault:{name}", **res}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
