"""``pio top``: live qps/latency/queue/batch view over running services.

Copy of ``predictionio_tpu/tools/top_command.py``: a thin CLI shell
around ``obs/top.py`` (the poll/compute/render pieces live there so they
are testable without a terminal). Point it at any mix of query servers
and event servers::

    python -m predictionio_tpu_torch.tools.cli top http://localhost:8000 http://localhost:7070
"""

from __future__ import annotations

import argparse


def register(sub: argparse._SubParsersAction) -> None:
    top = sub.add_parser(
        "top",
        help="live service stats: qps, p50/p99, error rate, ingest queue"
        " depth, batch occupancy, slowest traces (polls /metrics +"
        " /traces.json)",
    )
    top.add_argument(
        "urls",
        nargs="*",
        default=["http://localhost:8000"],
        help="service base URLs (default: the query server on :8000)",
    )
    top.add_argument(
        "--interval", type=float, default=2.0,
        help="seconds between polls (rates are deltas between polls)",
    )
    top.add_argument(
        "--iterations", type=int, default=0,
        help="stop after N frames (0 = run until interrupted)",
    )
    top.add_argument(
        "--no-clear", action="store_true",
        help="append frames instead of redrawing (log-friendly)",
    )
    top.set_defaults(func=cmd_top)


def cmd_top(args: argparse.Namespace) -> int:
    from predictionio_tpu_torch.obs.top import run_top

    try:
        run_top(
            args.urls or ["http://localhost:8000"],
            interval=args.interval,
            iterations=args.iterations,
            clear=not args.no_clear,
        )
    except KeyboardInterrupt:
        pass
    return 0
