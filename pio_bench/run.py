"""Run one cell of the benchmark of ``predictionio_tpu_torch`` on the card.

    python3 -m pio_bench.run --workload sasrec-ml20m.train --seed 7 --seconds 10 --trace 0

from the root of a checkout. It draws the cell's events from ``--seed``,
loads and warms the program, measures for about ``--seconds`` seconds,
checks what the window produced against the plain reference, and prints
as the last line of standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device`` (with ``--trace
1`` also ``busy_s`` and ``window_s``), with ``--trace 1`` ``breakdown``,
and last ``checks``, each compared number beside its limit; the same
numbers end standard error. It exits non-zero and prints no result where
the card is missing, the program cannot load, or a module of the JAX
package or of JAX was loaded.
"""

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from pio_bench import harness

    harness.use_checkout_caches(ROOT)
    import torch

    chips = int(harness.workload_entry(harness.load_spec(ROOT), args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.execute(ROOT, args.workload, args.seed % 2 ** 64, args.seconds,
                             bool(args.trace), started=_STARTED)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded modules it may not: {', '.join(found)}", file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
