"""The readings that the limits of ``correct`` are set from, at a cell's own
size on the card, many seeds in one process (set-up's build and CUDA
start paid once):

    python3 -m pio_bench.readings --workload sasrec-ml20m.train --seeds 11,12,13 \\
        --seconds 3 [--control] [--fault half_batch] [--out FILE]

Each seed's run prints one JSON line of its checks (with ``--control``
also the control's, ``control.<name>``: the reference in TF32 in the
program's place; with ``--fault`` the program broken underneath). The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    from pio_bench import harness

    harness.use_checkout_caches(ROOT)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            result = harness.execute(ROOT, args.workload, seed, args.seconds, False,
                                     control=args.control, fault=args.fault)
            line = json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                               "correct": result["correct"], "checks": result["checks"],
                               "metrics": result["metrics"], "run_s": time.perf_counter() - t0})
            print(line, flush=True)
            if out is not None:
                out.write(line + "\n")
                out.flush()
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
