"""The port's ``pio`` console.

Port of ``predictionio_tpu/tools/cli.py``: ``version``, ``status`` and
``main`` here, every other verb registered through
``tools/commands.py``, one module for each of the reference's:

    python -m predictionio_tpu_torch.tools.cli status
    python -m predictionio_tpu_torch.tools.cli template get recommendation DIR --app-name MyApp
    python -m predictionio_tpu_torch.tools.cli app new MyApp
    python -m predictionio_tpu_torch.tools.cli build --engine-dir DIR
    python -m predictionio_tpu_torch.tools.cli start-all
    python -m predictionio_tpu_torch.tools.cli train --engine-dir DIR [--device cuda|cpu]
    python -m predictionio_tpu_torch.tools.cli deploy --engine-dir DIR [--device cuda|cpu]
    python -m predictionio_tpu_torch.tools.cli undeploy --port 8000
    python -m predictionio_tpu_torch.tools.cli stop-all

- ``app`` / ``accesskey`` (``tools/app_commands.py``), ``import`` /
  ``export`` (``tools/import_export.py``);
- ``train``, ``deploy``, ``undeploy``, ``retrain``, ``eval`` and
  ``batchpredict`` (``tools/engine_commands.py``);
- ``eventserver``, ``dashboard``, ``adminserver`` and ``shell``
  (``tools/server_commands.py``);
- ``build``, ``run`` and ``template list|get``
  (``tools/build_commands.py``); ``start-all`` / ``stop-all``
  (``tools/daemon_commands.py``); ``top`` (``tools/top_command.py``).

- ``check`` (``tools/engine_commands.py``): the port's static analysis,
  ``predictionio_tpu_torch/analysis/``, over ``predictionio_tpu_torch/``
  (the C, R and P rule families; catalog
  ``docs/static_analysis_torch.md``). Like the reference's it imports
  nothing of the package it analyzes, so it runs without torch.

Storage is configured as the reference's is (``PIO_STORAGE_*``; by
default sqlite under ``$PIO_FS_BASEDIR``), so both packages may share
one store. The ported templates are picked by ``engineFactory`` or,
without one, by the first algorithm's name (``controller/engine.py``).

``status`` probes the card in a bounded subprocess, as the reference
probes its accelerator: ``torch.cuda.device_count()`` and the first
card's name. The reference's probe walks a backend ladder
(``utils/platform.py``, ``utils/jax_compat.py``) and trains on the CPU
when no accelerator answers; the port has no such ladder and no
fallback: without a card ``train``, ``deploy``, ``retrain``, ``eval``
and ``batchpredict`` raise unless ``--device cpu`` is given, and
``status`` says so.

``load_variant``, ``train``, ``build_query_server``,
``_parse_passthrough`` and ``_launch_conf`` live in
``tools/engine_commands.py`` and are importable from here too.
"""

from __future__ import annotations

import argparse
import os
import sys

from predictionio_tpu_torch.tools.engine_commands import (  # noqa: F401
    _launch_conf,
    _parse_passthrough,
    build_query_server,
    load_variant,
    train,
)
from predictionio_tpu_torch.version import __version__

#: the devices the probe subprocess reports: ``PIO_ACCEL|cuda|N|NAME``
_PROBE = (
    "import torch\n"
    "n = torch.cuda.device_count()\n"
    "print('PIO_ACCEL|cuda|' + str(n) + '|' + (torch.cuda.get_device_name(0) if n else ''))\n"
)

_NO_CARD = ("train, deploy, retrain, eval and batchpredict raise unless"
            " --device cpu is given")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="pio",
        description="predictionio_tpu_torch: the PyTorch and CUDA port",
    )
    sub = parser.add_subparsers(dest="command")

    sub.add_parser("version", help="print version")

    status = sub.add_parser("status", help="verify configuration and storage connectivity")
    status.set_defaults(func=cmd_status)

    from predictionio_tpu_torch.tools import commands

    commands.register(sub)
    return parser


def accelerator_line() -> str:
    """``status``'s accelerator line, from a probe in a subprocess
    bounded by ``PIO_STATUS_PROBE_TIMEOUT_S`` (default 60 s): a wedged
    driver must not hang the command a user runs to debug it."""
    import subprocess

    try:
        proc = subprocess.run(
            [sys.executable, "-c", _PROBE],
            capture_output=True,
            text=True,
            timeout=float(os.environ.get("PIO_STATUS_PROBE_TIMEOUT_S", "60")),
        )
    except subprocess.TimeoutExpired:
        return ("Accelerator: probe timed out -- the CUDA driver may be wedged; "
                + _NO_CARD)
    fields = next(
        (line.split("|", 3) for line in proc.stdout.splitlines()
         if line.startswith("PIO_ACCEL|")),
        None,
    )
    if fields is None:
        return "Accelerator: probe failed -- " + _NO_CARD
    if int(fields[2]) == 0:
        return "Accelerator: none (no CUDA device) -- " + _NO_CARD
    return f"Accelerator: {fields[1]} x{fields[2]} ({fields[3]})"


def cmd_status(args: argparse.Namespace) -> int:
    from predictionio_tpu_torch.data import storage

    print(f"pio (predictionio_tpu_torch) {__version__}")
    print(accelerator_line())
    print("Storage configuration:")
    for repo, cfg in storage.config_summary().items():
        detail = ", ".join(f"{k}={v}" for k, v in cfg.items() if k not in ("source",))
        print(f"  {repo}: source={cfg['source']} ({detail})")
    failures = storage.verify_all_data_objects()
    if failures:
        print("Storage check FAILED:")
        for failure in failures:
            print(f"  - {failure}")
        return 1
    print("Storage check OK. Your system is all ready to go.")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 2
    if args.command == "version":
        print(__version__)
        return 0
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
