"""``pio eventserver / dashboard / adminserver / shell``.

Port of ``predictionio_tpu/tools/server_commands.py``. ``load_plugins``,
``cmd_dashboard``, ``cmd_adminserver`` and ``cmd_shell`` are the
reference's, and so is ``cmd_eventserver``: ``eventserver`` runs the
port's event server (``data/api/eventserver.py``) with the reference's
flags, defaults and choices: ``--ingest-mode sync|wal``, the WAL knobs
``--ingest-queue-size``, ``--group-commit-ms``, ``--fsync-policy``,
``--wal-dir`` and ``--wal-partitions`` (into
``data/ingest.py::IngestConfig``), ``--slow-commit-ms`` (one span summary
for each slower group commit), ``--frontend-workers M``, TLS, plugins and
tracing.
"""

from __future__ import annotations

import argparse

from predictionio_tpu_torch.obs.logs import add_logging_arguments


def register(sub: argparse._SubParsersAction) -> None:
    es = sub.add_parser("eventserver", help="start the Event Server")
    es.add_argument("--ip", default="0.0.0.0")
    es.add_argument("--port", type=int, default=7070)
    es.add_argument("--stats", action="store_true", help="enable /stats.json")
    es.add_argument("--ssl-cert", default=None, help="PEM cert: serve HTTPS")
    es.add_argument("--ssl-key", default=None, help="PEM key (if not in cert)")
    es.add_argument("--plugin", action="append", default=[], metavar="MODULE:CLASS",
                    help="EventServerPlugin to load (repeatable)")
    es.add_argument("--ingest-mode", choices=("sync", "wal"), default="sync",
                    help="sync: one storage commit per event; wal: acknowledge after"
                    " the WAL's group-commit fsync, flush to storage behind it")
    es.add_argument("--ingest-queue-size", type=int, default=2048,
                    help="bounded ingest queue; a full queue returns 429 (wal mode)")
    es.add_argument("--group-commit-ms", type=float, default=5.0,
                    help="max wait to grow a commit batch (wal mode)")
    es.add_argument("--fsync-policy", choices=("always", "interval", "never"),
                    default="always", help="WAL durability vs throughput trade-off")
    es.add_argument("--wal-dir", default=None,
                    help="WAL directory (default $PIO_FS_BASEDIR/wal)")
    es.add_argument("--wal-partitions", type=int, default=1, metavar="P",
                    help="with --ingest-mode wal: hash-sharded WAL partitions, each"
                    " with its own writer and fsync stream")
    es.add_argument("--frontend-workers", type=int, default=0, metavar="M",
                    help="multi-process tier: M SO_REUSEPORT frontend processes"
                    " parse HTTP and feed this process's ingest over shared-memory"
                    " rings (sync dispatch, 32 in flight); 0 serves single-process")
    es.add_argument("--no-tracing", action="store_true",
                    help="disable the span tracer (/traces.json reports enabled=false)")
    es.add_argument("--trace-sample", type=float, default=None, metavar="RATE",
                    help="head-sampling rate (0..1) for headerless root traces")
    es.add_argument("--slow-commit-ms", type=float, default=None, metavar="MS",
                    help="log one span-summary line for any group commit slower than"
                    " this (off by default)")
    add_logging_arguments(es)
    es.set_defaults(func=cmd_eventserver)

    db = sub.add_parser("dashboard", help="start the evaluation dashboard")
    db.add_argument("--ip", default="0.0.0.0")
    db.add_argument("--port", type=int, default=9000)
    add_logging_arguments(db)
    db.set_defaults(func=cmd_dashboard)

    admin = sub.add_parser("adminserver", help="start the admin REST server")
    admin.add_argument("--ip", default="0.0.0.0")
    admin.add_argument("--port", type=int, default=7071)
    add_logging_arguments(admin)
    admin.set_defaults(func=cmd_adminserver)

    shell = sub.add_parser("shell", help="interactive console with the runtime preloaded")
    shell.set_defaults(func=cmd_shell)


def load_plugins(specs: list[str]) -> list:
    """Instantiate ``module.path:ClassName`` EventServerPlugin specs."""
    import importlib

    plugins = []
    for spec in specs:
        module_path, sep, class_name = spec.partition(":")
        if not sep or not module_path or not class_name:
            raise SystemExit(f"--plugin {spec!r}: expected MODULE:CLASS")
        try:
            cls = getattr(importlib.import_module(module_path), class_name)
        except (ImportError, AttributeError) as exc:
            raise SystemExit(f"--plugin {spec!r}: {exc}")
        plugins.append(cls())
    return plugins


def cmd_eventserver(args: argparse.Namespace) -> int:
    from predictionio_tpu_torch.data.api.eventserver import run_event_server
    from predictionio_tpu_torch.data.ingest import IngestConfig
    from predictionio_tpu_torch.obs.logs import configure_logging

    configure_logging(args.log_format)
    run_event_server(
        host=args.ip, port=args.port, stats=args.stats,
        ssl_cert=args.ssl_cert, ssl_key=args.ssl_key,
        plugins=load_plugins(args.plugin),
        ingest_config=IngestConfig(
            mode=args.ingest_mode,
            queue_size=args.ingest_queue_size,
            group_commit_ms=args.group_commit_ms,
            fsync_policy=args.fsync_policy,
            wal_dir=args.wal_dir,
            wal_partitions=args.wal_partitions,
        ),
        tracing=False if args.no_tracing else None,
        trace_sample=args.trace_sample,
        slow_commit_ms=args.slow_commit_ms,
        frontend_workers=args.frontend_workers,
    )
    return 0


def cmd_dashboard(args: argparse.Namespace) -> int:
    from predictionio_tpu_torch.obs.logs import configure_logging
    from predictionio_tpu_torch.tools.dashboard import run_dashboard

    configure_logging(args.log_format)
    run_dashboard(host=args.ip, port=args.port)
    return 0


def cmd_adminserver(args: argparse.Namespace) -> int:
    from predictionio_tpu_torch.obs.logs import configure_logging
    from predictionio_tpu_torch.tools.adminserver import run_admin_server

    configure_logging(args.log_format)
    run_admin_server(host=args.ip, port=args.port)
    return 0


def cmd_shell(args: argparse.Namespace) -> int:
    from predictionio_tpu_torch.tools.shell import run_shell

    return run_shell()
