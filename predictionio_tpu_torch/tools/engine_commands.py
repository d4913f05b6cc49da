"""``pio train / deploy / undeploy / retrain / eval / batchpredict``.

Port of ``predictionio_tpu/tools/engine_commands.py``. The verbs call the
port's workflow in-process:

- ``train`` reads the variant (``--variant``, default
  ``ENGINE_DIR/engine.json``; ``--engine-json`` is the same flag): the
  template's DataSource reads the store, and the run is recorded as an
  engine instance with its model blob (``workflow/core_workflow.py``).
  ``--snapshot-mode use|refresh`` serves the read from the on-disk
  training snapshot (``data/snapshot.py``). ``--als-feed
  resident|streamed`` (runtime conf ``pio.als_feed``) overrides the
  engine.json's ``alsFeed``: with ``"reader": "streaming"`` and a
  snapshot, ``streamed`` packs the snapshot into an on-disk block store
  (the generation's ``blocks/`` directory) and trains through
  ``als_fit_streamed``, one B1 launch per block. ``--als-solver
  auto|xla|pallas`` (runtime conf ``pio.als_solver``) overrides the
  engine.json's ``alsSolver``: ``xla`` trains through the unfused plain
  half-step, ``auto`` and ``pallas`` through B1. ``--profile [DIR]`` (default
  ``ENGINE_DIR/pio-profile``) writes a ``torch.profiler`` Chrome trace of
  the training call and the telemetry journal (ALS: one line per
  iteration with edges/sec and achieved GB/s) into DIR.
  With ``--events FILE --model-out DIR`` it reads a JSON-lines events
  file instead (the ``pio import`` wire shape) and writes the model
  directory with the template's ``save_model``, recording nothing;
  its checkpoints go to ``DIR/checkpoints`` while it runs. The entries
  after ``--`` and ``--coordinator`` / ``--num-processes`` /
  ``--process-id`` set the multi-process launch (``_launch_conf``).
- ``deploy`` serves the latest COMPLETED instance of the variant (or
  ``--engine-instance-id``), loading its blob, or with ``--model DIR`` a
  model directory. It warms the template's device state up before it
  answers. The engine.json's algorithm params configure serving (so a
  serving knob such as ``retrieval`` may change after training); the
  model comes from the instance. ``--model-version N`` serves version N
  of the variant's model registry (``online/registry.py``) and exits with
  the registry's message when N is missing or corrupt. Every deploy of a
  variant takes ``POST /models/swap`` to a registry version. Queries go
  through the micro-batcher (``--batch-window-ms``, ``--max-batch-size``,
  ``--batch-buckets``; ``--max-batch-size 1`` answers one ``predict`` per
  request). ``--frontend-workers N`` puts N ``SO_REUSEPORT`` frontend
  processes before this process's scorer (``serving/procserver.py``);
  ``--scorer-shards N`` runs the sharded fabric instead: N scorer
  processes, each holding its hash partition of the user table on
  ``--device`` (``serving/fabric.py``). The reference's feedback, TLS and
  tracing flags are the same.
- ``undeploy`` is the reference's: ``POST /stop`` to a deployed server,
  the ``--ssl`` scheme first and the other only after a TLS-looking
  failure.
- ``retrain`` (``online/loop.py``) tails the event server's WAL
  (``eventserver --ingest-mode wal``), refreshes the training snapshot,
  folds the touched users into the model (B1 on the card), publishes a
  registry version and hot-swaps the ``--notify`` servers (default
  ``http://localhost:8000``; ``--notify ''`` publishes only). One cycle,
  or with ``--follow`` until interrupted; past the staleness budget it
  trains in full from the store. ``--scorer-shards N`` also publishes N
  per-shard blobs for a ``deploy --scorer-shards N`` fabric.
- ``eval --replay`` (``eval/replay.py``) cuts the store's timeline,
  trains on the prefix (or ``--model-version N`` pins a registry
  version), scores every held-out user in one ``batch_predict`` pass and
  prints the JSON report with the scan-vs-mips retrieval guard; ``eval
  EVALUATION [GENERATOR]`` runs a user module's ``Evaluation`` built of
  the port's ``controller/metrics.py`` over its template's ``read_eval``
  folds and records an evaluation instance. A bad metric, a malformed
  split, a template without the hook or a missing registry version
  exits 2 with a one-line error; an object that is not the port's
  ``Evaluation`` / ``EngineParamsGenerator`` (one of the JAX package)
  is refused.
- ``batchpredict`` (``workflow/batch_predict.py``) scores a JSON-lines
  query file through an instance's model, 4,096 queries a
  ``batch_predict`` call.

``train``, ``deploy``, ``retrain``, ``eval`` and ``batchpredict`` run on
the card unless ``--device cpu``; without a card they raise. Each verb
imports the workflow (and so torch) when it runs, not when the console
starts: the console's other verbs and its daemons start without torch.

- ``check`` (``pio check``) runs the port's static analysis,
  ``predictionio_tpu_torch/analysis/``, with the reference's flags
  (``analysis/engine.py::add_check_arguments``): the C, R and P rule
  families over ``predictionio_tpu_torch/`` with the port's baseline,
  ``--changed`` for the pre-commit hook (``tools/precommit.py``),
  ``--self-check``, ``--explain RULE``, ``--protocol-report`` and SARIF
  output. The reference's J and S families and ``--mesh-report`` lint
  JAX sites the port has none of: a J or S id exits 2 with the catalog
  of known rules, and ``--mesh-report`` exits 2. The analyzer imports
  neither torch nor jax.
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import TYPE_CHECKING

from predictionio_tpu_torch.obs.logs import add_logging_arguments, configure_logging

if TYPE_CHECKING:
    from predictionio_tpu_torch.controller.engine import Template
    from predictionio_tpu_torch.workflow.json_extractor import EngineVariant
    from predictionio_tpu_torch.workflow.microbatch import BatchConfig

def register(sub: argparse._SubParsersAction) -> None:
    train_p = sub.add_parser("train", help="train an engine variant")
    _add_variant_args(train_p)
    train_p.add_argument("--batch", default="", help="batch label recorded on the instance")
    train_p.add_argument("--skip-sanity-check", action="store_true")
    train_p.add_argument("--resume", action="store_true",
                         help="continue a crashed run from its step checkpoints")
    train_p.add_argument("--snapshot-mode", choices=("off", "use", "refresh"),
                         default=None,
                         help="training-snapshot cache: 'use' replays the on-disk"
                         " columnar spill (building it on first run), 'refresh' first"
                         " appends events ingested since; default off")
    train_p.add_argument("--snapshot-dir", default=None,
                         help="snapshot root (default $PIO_FS_BASEDIR/snapshots)")
    train_p.add_argument("--als-solver", choices=("auto", "xla", "pallas"), default=None,
                         help="ALS half-step tail: 'pallas' and 'auto' = the fused"
                         " gather->Gram/rhs kernel (B1, csrc/als_gram.cu) on the card,"
                         " 'xla' = the unfused gather + batched products"
                         " (gram_rhs_plain). Overrides the engine.json alsSolver"
                         " param for this run")
    train_p.add_argument("--als-feed", choices=("resident", "streamed"), default=None,
                         help="how ALS reads its training data: 'resident' packs"
                         " host arrays, 'streamed' (with \"reader\": \"streaming\" and"
                         " --snapshot-mode use|refresh) trains from an on-disk block"
                         " store with bounded host memory. Overrides the engine.json"
                         " alsFeed param for this run")
    train_p.add_argument("--events", default=None,
                         help="read this JSON-lines events file instead of the store")
    train_p.add_argument("--model-out", default=None,
                         help="with --events: the model directory to write")
    train_p.add_argument("--profile", nargs="?", const="__default__", default=None,
                         metavar="DIR",
                         help="write a torch.profiler Chrome trace (*.pt.trace.json,"
                         " Perfetto / chrome://tracing) of the training call AND a"
                         " per-step telemetry journal (wall time, edges/sec, achieved"
                         " GB/s) into DIR (default: <engine-dir>/pio-profile)")
    train_p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                         help="multi-process launch: rank 0's rendezvous address"
                         " (else pio.coordinator in sparkConf, else $PIO_COORDINATOR)")
    train_p.add_argument("--num-processes", type=int, default=None, metavar="N",
                         help="multi-process launch: ranks in all (else"
                         " pio.num_processes, else $PIO_NUM_PROCESSES)")
    train_p.add_argument("--process-id", type=int, default=None, metavar="R",
                         help="multi-process launch: this process's rank (else"
                         " pio.process_id, else $PIO_PROCESS_ID); rank 0 records"
                         " the instance and writes the model")
    add_logging_arguments(train_p)
    train_p.add_argument("passthrough", nargs="*",
                         help="runtime conf after --, e.g. -- --mesh-shape 2,1"
                         " --dcn-mesh-shape 1,1 --mesh-axes data,model")
    train_p.set_defaults(func=cmd_train)

    deploy = sub.add_parser("deploy", help="serve /queries.json for a trained engine")
    _add_variant_args(deploy)
    deploy.add_argument("--engine-instance-id", default=None,
                        help="serve this instance (default: the latest COMPLETED)")
    deploy.add_argument("--model", default=None,
                        help="serve this save_model directory instead of an instance")
    deploy.add_argument("--model-version", type=int, default=None, metavar="N",
                        help="serve version N of the variant's model registry (as"
                        " published by `retrain`); a missing or corrupt one fails")
    deploy.add_argument("--ip", default="127.0.0.1")
    deploy.add_argument("--port", type=int, default=8000)
    deploy.add_argument("--feedback", action="store_true")
    deploy.add_argument("--event-server-ip", default="localhost")
    deploy.add_argument("--event-server-port", type=int, default=7070)
    deploy.add_argument("--event-server-scheme", default="http",
                        choices=("http", "https"),
                        help="https when the event server uses --ssl-cert")
    deploy.add_argument("--accesskey", default="")
    deploy.add_argument("--ssl-cert", default=None, help="PEM cert: serve HTTPS")
    deploy.add_argument("--ssl-key", default=None, help="PEM key (if not in cert)")
    deploy.add_argument(
        "--batch-window-ms", type=float, default=2.0,
        help="micro-batching latency deadline: how long a query may wait "
        "for batchmates (0 disables batching)",
    )
    deploy.add_argument(
        "--max-batch-size", type=int, default=64,
        help="micro-batching flush size (1 disables batching)",
    )
    deploy.add_argument(
        "--batch-buckets", default="1,4,16,64,128",
        help="comma-separated padded batch shapes; a batch pads up to the "
        "smallest bucket that holds it",
    )
    deploy.add_argument(
        "--frontend-workers", type=int, default=0, metavar="N",
        help="multi-process serving tier: N SO_REUSEPORT frontend "
        "processes parse/validate HTTP and feed this process's scorer "
        "through shared-memory rings; 0 (default) serves single-process",
    )
    deploy.add_argument(
        "--scorer-shards", type=int, default=0, metavar="N",
        help="sharded serving fabric: hash-partition the user factor"
        " table across N scorer processes (item-side state replicated),"
        " each hot-swapping per shard behind the SO_REUSEPORT frontend"
        " tier; 0/1 (default) serves unsharded. PIO_SHARD_BUDGET_BYTES"
        " caps the blob a shard may load",
    )
    deploy.add_argument(
        "--frontend-ring-slots", type=int, default=128, metavar="SLOTS",
        help="per-worker request/completion ring capacity; a full request "
        "ring answers 429 + Retry-After (scorer backpressure)",
    )
    deploy.add_argument(
        "--frontend-max-inflight", type=int, default=16, metavar="N",
        help="concurrent requests the scorer admits before letting the "
        "rings back up (the backpressure horizon and the micro-batcher's "
        "coalescing ceiling; with --dispatch sync, also the dispatcher "
        "thread count)",
    )
    deploy.add_argument(
        "--dispatch", choices=("async", "sync"), default="async",
        help="scorer dispatch model with --frontend-workers: 'async' "
        "(ring consumer submits straight into the micro-batcher; zero "
        "dispatcher threads and 2 wakeups on the query path) or 'sync' "
        "(dispatcher thread pool; also used whenever batching is disabled)",
    )
    deploy.add_argument(
        "--pin-cpus", action=argparse.BooleanOptionalAction,
        default=os.environ.get("PIO_PIN_CPUS", "") not in ("", "0"),
        help="sched_setaffinity: pin each frontend worker to one core "
        "from the top of the affinity set, the scorer keeps the rest "
        "(default from PIO_PIN_CPUS=1; --no-pin-cpus overrides it); "
        "needs --frontend-workers and >=2 cores",
    )
    deploy.add_argument(
        "--no-tracing", action="store_true",
        help="disable the span tracer (/traces.json reports enabled=false)",
    )
    deploy.add_argument(
        "--trace-sample", type=float, default=None, metavar="RATE",
        help="head-sampling rate (0..1) for headerless root traces;"
        " requests with a traceparent header always trace (default:"
        " $PIO_TRACE_SAMPLE or 0.125)",
    )
    deploy.add_argument(
        "--slow-query-ms", type=float, default=None, metavar="MS",
        help="log one span-summary line for any query trace slower than"
        " this (off by default)",
    )
    add_logging_arguments(deploy)
    deploy.set_defaults(func=cmd_deploy)

    retrain = sub.add_parser(
        "retrain",
        help="continuous learning: tail the ingest WAL, fold new events into"
        " the model, hot-swap running query servers (--follow loops; without"
        " it one catch-up cycle runs)",
    )
    _add_variant_args(retrain)
    retrain.add_argument("--follow", action="store_true",
                         help="keep following the WAL until interrupted")
    retrain.add_argument("--interval", type=float, default=2.0, metavar="SEC",
                         help="seconds between WAL polls in --follow mode")
    retrain.add_argument("--notify", action="append", default=[], metavar="URL",
                         help="query server base URL to hot-swap after each publish"
                         " (repeatable; default http://localhost:8000; --notify ''"
                         " for batch mode, where publishing is the boundary)")
    retrain.add_argument("--wal-dir", default=None,
                         help="ingest WAL directory to tail (default"
                         " $PIO_FS_BASEDIR/wal)")
    retrain.add_argument("--registry-dir", default=None,
                         help="model registry root (default $PIO_FS_BASEDIR/registry)")
    retrain.add_argument("--registry-keep", type=int, default=5, metavar="N",
                         help="retained model versions (each is a rollback target)")
    retrain.add_argument("--max-touched-frac", type=float, default=0.2, metavar="F",
                         help="staleness budget: touched-user fraction beyond which a"
                         " full retrain replaces fold-in")
    retrain.add_argument("--max-item-growth-frac", type=float, default=0.05,
                         metavar="F",
                         help="staleness budget: new-item fraction beyond which a"
                         " full retrain replaces fold-in")
    retrain.add_argument("--no-full-retrain", action="store_true",
                         help="never escalate to a full retrain (keep serving stale)")
    retrain.add_argument("--max-cycles", type=int, default=0, metavar="N",
                         help="stop after N cycles (0 = until interrupted)")
    retrain.add_argument("--scorer-shards", type=int, default=0, metavar="N",
                         help="publish per-shard model blobs alongside the full blob"
                         " so a `deploy --scorer-shards N` fabric swaps without"
                         " loading the full model in one shard; fold-in republishes"
                         " only the shards whose users were touched (0 = full blob"
                         " only)")
    add_logging_arguments(retrain)
    retrain.set_defaults(func=cmd_retrain)

    undeploy = sub.add_parser("undeploy", help="stop a deployed engine server")
    undeploy.add_argument("--ip", default="localhost")
    undeploy.add_argument("--port", type=int, default=8000)
    undeploy.add_argument("--ssl", action="store_true",
                          help="server was deployed with --ssl-cert")
    undeploy.set_defaults(func=cmd_undeploy)

    ev = sub.add_parser(
        "eval",
        help="run an evaluation (dotted Evaluation, or --replay for the"
        " time-travel offline replay harness)",
    )
    ev.add_argument("evaluation", nargs="?", default=None,
                    help="dotted path to an Evaluation object/callable (omit with"
                    " --replay)")
    ev.add_argument("paramsgen", nargs="?", default=None,
                    help="dotted path to an EngineParamsGenerator")
    _add_variant_args(ev)
    ev.add_argument("--output-path", default=None, help="also write results JSON here")
    ev.add_argument("--replay", action="store_true",
                    help="offline replay evaluation: cut the event timeline at a"
                    " boundary, train on the prefix (or pin a registry version),"
                    " score every held-out user in one batched pass, report ranking"
                    " metrics + the scan-vs-mips retrieval guard as JSON")
    ev.add_argument("--split-time", default=None, metavar="ISO8601",
                    help="replay boundary: train < t, holdout >= t (e.g."
                    " 2024-03-01T00:00:00Z; naive times are UTC)")
    ev.add_argument("--split-frac", type=float, default=None, metavar="F",
                    help="replay boundary as a fraction of the time-sorted event"
                    " stream (0 < F < 1; default 0.8 when --split-time is absent)")
    ev.add_argument("--k", type=int, default=10,
                    help="ranking cutoff for metrics and queries (default 10)")
    ev.add_argument("--metrics", default=None,
                    help="comma-separated metric names (default: all; the"
                    " unknown-metric error lists the catalog)")
    ev.add_argument("--model-version", type=int, default=None, metavar="N",
                    help="evaluate an exact model-registry version (what `deploy"
                    " --model-version N` would serve) instead of training on the"
                    " prefix; the report's model block carries its lineage")
    ev.add_argument("--registry-dir", default=None,
                    help="model registry root for --model-version"
                    " (default $PIO_FS_BASEDIR/registry)")
    ev.add_argument("--snapshot-mode", choices=("off", "use", "refresh"), default=None,
                    help="training-snapshot cache for the replay read (same"
                    " semantics as `train --snapshot-mode`)")
    ev.add_argument("--snapshot-dir", default=None,
                    help="snapshot root (default $PIO_FS_BASEDIR/snapshots)")
    ev.add_argument("--no-retrieval-guard", action="store_true",
                    help="skip the scan-vs-mips shortlist-recall/identity guard"
                    " (runs by default when the algorithm has a retrieval surface)")
    ev.set_defaults(func=cmd_eval)

    from predictionio_tpu_torch.analysis.engine import add_check_arguments

    check = sub.add_parser(
        "check",
        help="static analysis of the port: interprocedural concurrency, "
        "resource and cross-process protocol lint (thread roles, locksets, "
        "race detection; rule catalog: docs/static_analysis_torch.md, or "
        "--explain RULE)",
    )
    add_check_arguments(check)
    check.set_defaults(func=cmd_check)

    bp = sub.add_parser("batchpredict", help="bulk offline predictions")
    _add_variant_args(bp)
    bp.add_argument("--input", required=True, help="JSON-lines query file")
    bp.add_argument("--output", required=True, help="JSON-lines prediction output")
    bp.add_argument("--engine-instance-id", default=None,
                    help="score with this instance (default: the latest COMPLETED)")
    bp.set_defaults(func=cmd_batchpredict)


def load_variant(engine_json: str) -> tuple[EngineVariant, Template]:
    """The parsed engine.json and its template."""
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    variant = load_engine_variant(engine_json)
    return variant, variant.template


def build_trainer(engine_json: str, events_path: str | None = None, *,
                  device: str | None = None):
    """The engine.json, read once, and its template's train-path
    components: ``(variant, template, datasource, preparator,
    algorithm)``; the DataSource reads ``events_path``, or the store
    without one. The algorithm resolves the device, so without a card
    and without ``device="cpu"`` this raises."""
    from predictionio_tpu_torch.workflow.core_workflow import build_components
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    variant = load_engine_variant(engine_json)
    return (variant, *build_components(variant, device=device, events_path=events_path))


def train(engine_json: str, events_path: str, model_out: str, *,
          resume: bool = False, device: str | None = None,
          als_feed: str | None = None, launch: dict | None = None,
          als_solver: str | None = None):
    """``train --events FILE --model-out DIR``: read the file, prepare,
    fit, save the model directory; returns the trained model.
    ``als_feed`` sets ``pio.als_feed`` (``--als-feed``), ``als_solver``
    ``pio.als_solver`` (``--als-solver``); ``launch`` the
    ``pio.*`` launch keys (``_launch_conf``). In a multi-process launch
    every rank reads the file and trains, and rank 0 alone writes the
    checkpoints and the model directory."""
    from predictionio_tpu_torch.controller.base import TrainContext
    from predictionio_tpu_torch.parallel.distributed import launch_process_id
    from predictionio_tpu_torch.workflow.core_workflow import train_model

    variant, template, datasource, preparator, algorithm = build_trainer(
        engine_json, events_path, device=device
    )
    if als_feed:
        variant.runtime_conf["pio.als_feed"] = als_feed
    if als_solver:
        variant.runtime_conf["pio.als_solver"] = als_solver
    variant.runtime_conf.update(launch or {})
    primary = launch_process_id(variant.runtime_conf) == 0
    checkpoint_dir = os.path.join(model_out, "checkpoints")
    ctx = TrainContext(
        device=algorithm.device, checkpoint_dir=checkpoint_dir, resume=resume,
        mesh_shape=variant.runtime_conf.get("pio.mesh_shape"),
        runtime_conf=dict(variant.runtime_conf),
    )
    model = train_model(ctx, datasource, preparator, algorithm)
    if primary:
        template.save_model(model, model_out)
        # a completed train's checkpoints must not be resumable into a later one
        shutil.rmtree(checkpoint_dir, ignore_errors=True)
    return model


def build_query_server(engine_json: str, model_path: str | None = None, *,
                       engine_instance_id: str | None = None,
                       model_version: int | None = None, ip: str = "127.0.0.1",
                       port: int = 8000, device: str | None = None,
                       batching: BatchConfig | None = None):
    """Everything single-process ``deploy`` does short of serving: load
    (a model directory, the resolved engine instance's blob, or registry
    version ``model_version``), warm up, bind. Queries go through the
    micro-batcher (``batching``, default ``BatchConfig()``: 64 queries, a
    2 ms window, buckets 1/4/16/64/128; ``BatchConfig(max_batch_size=1)``
    answers one ``predict`` per request). The server takes hot swaps to
    the variant's registry versions, each loaded and warmed up with the
    engine.json's algorithm params. Returns ``(server, service)``: call
    ``server.serve_forever()`` to serve, then ``server.shutdown()``,
    ``server.server_close()`` and ``service.close()`` (which answers every
    query still in a batch). Raises ``RegistryError`` for a missing or
    corrupt ``model_version``."""
    from predictionio_tpu_torch.workflow.create_server import create_query_server
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    thread, service = create_query_server(
        load_engine_variant(engine_json), ip, port, device=device,
        model_path=model_path, instance_id=engine_instance_id,
        model_version=model_version, batching=batching,
    )
    return thread.server, service


def _variant_path(args: argparse.Namespace) -> str:
    return args.variant or os.path.join(args.engine_dir, "engine.json")


def _add_variant_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--engine-dir", default=".",
                        help="engine directory (holds engine.json)")
    parser.add_argument("--variant", "--engine-json", dest="variant", default=None,
                        help="engine variant JSON (default ENGINE_DIR/engine.json)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")



def _parse_passthrough(tokens: list[str]) -> dict:
    """``-- --mesh-shape 2,4 --key value`` -> runtime conf entries (the
    reference's ``tools/engine_commands.py::_parse_passthrough``): each
    ``--key value`` becomes ``pio.key`` (dashes to underscores), a flag
    without a value ``"true"``; ``mesh_shape`` and ``dcn_mesh_shape``
    are lists of ints, ``mesh_axes`` a list of names."""
    conf = {}
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if tok.startswith("--"):
            key = tok[2:].replace("-", "_")
            if i + 1 < len(tokens) and not tokens[i + 1].startswith("--"):
                value = tokens[i + 1]
                i += 1
            else:
                value = "true"
            if key in ("mesh_shape", "dcn_mesh_shape"):
                conf[f"pio.{key}"] = [int(x) for x in value.split(",")]
            elif key == "mesh_axes":
                conf["pio.mesh_axes"] = value.split(",")
            else:
                conf[f"pio.{key}"] = value
        i += 1
    return conf


def _launch_conf(args: argparse.Namespace) -> dict:
    """The runtime conf a train's command line sets: the entries after
    ``--`` (``_parse_passthrough``), then the ``pio.*`` launch keys of
    the train flags (``--coordinator``, ``--num-processes``,
    ``--process-id``); unset flags leave the engine.json's ``sparkConf``
    and the ``PIO_*`` env to speak."""
    conf = _parse_passthrough(args.passthrough)
    for key, value in (("pio.coordinator", args.coordinator),
                       ("pio.num_processes", args.num_processes),
                       ("pio.process_id", args.process_id)):
        if value is not None:
            conf[key] = value
    return conf


def cmd_train(args: argparse.Namespace) -> int:
    from predictionio_tpu_torch.parallel.distributed import launch_process_id
    from predictionio_tpu_torch.workflow.core_workflow import WorkflowParams, run_train
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    configure_logging(args.log_format)
    if args.events is not None:
        if args.model_out is None:
            raise SystemExit("Error: --events needs --model-out")
        if args.profile:
            raise SystemExit("Error: --profile traces a train from the store; "
                             "leave out --events")
        model = train(_variant_path(args), args.events, args.model_out,
                      resume=args.resume, device=args.device, als_feed=args.als_feed,
                      launch=_launch_conf(args), als_solver=args.als_solver)
        print(f"trained a model of {len(model.item_ids)} items into "
              f"{args.model_out} ({args.device})", flush=True)
        return 0
    variant = load_engine_variant(_variant_path(args))
    variant.runtime_conf.update(_launch_conf(args))
    if args.profile:
        variant.runtime_conf["pio.profile"] = (
            os.path.join(args.engine_dir, "pio-profile")
            if args.profile == "__default__" else args.profile
        )
    if args.als_solver:
        variant.runtime_conf["pio.als_solver"] = args.als_solver
    if args.als_feed:
        variant.runtime_conf["pio.als_feed"] = args.als_feed
    _snapshot_args(args, variant)
    instance = run_train(
        variant,
        WorkflowParams(batch=args.batch, skip_sanity_check=args.skip_sanity_check,
                       resume=args.resume),
        device=args.device,
    )
    if launch_process_id(variant.runtime_conf) != 0:
        print(f"Training completed on rank {launch_process_id(variant.runtime_conf)}; "
              "rank 0 records the engine instance.", flush=True)
        return 0
    print(f"Training completed. Engine instance ID: {instance.id}", flush=True)
    return 0


def cmd_deploy(args: argparse.Namespace) -> int:
    from predictionio_tpu_torch.online.registry import RegistryError
    from predictionio_tpu_torch.workflow.create_server import (
        FeedbackConfig,
        run_query_server,
    )
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant
    from predictionio_tpu_torch.workflow.microbatch import BatchConfig

    configure_logging(args.log_format)
    feedback = None
    if args.feedback:
        feedback = FeedbackConfig(
            event_server_url=(
                f"{args.event_server_scheme}://"
                f"{args.event_server_ip}:{args.event_server_port}"
            ),
            access_key=args.accesskey,
        )
    try:
        buckets = tuple(
            int(b) for b in args.batch_buckets.split(",") if b.strip()
        )
    except ValueError:
        raise SystemExit(
            f"Error: --batch-buckets must be comma-separated integers, "
            f"got {args.batch_buckets!r}"
        )
    frontend = None
    if args.scorer_shards > 1 and (args.ssl_cert or args.ssl_key):
        raise SystemExit(
            "Error: --scorer-shards does not support TLS "
            "(--ssl-cert/--ssl-key); terminate TLS in front of the "
            "frontend tier or deploy single-process"
        )
    if args.frontend_workers > 0:
        if args.ssl_cert or args.ssl_key:
            raise SystemExit(
                "Error: --frontend-workers does not support TLS "
                "(--ssl-cert/--ssl-key); terminate TLS in front of the "
                "frontend tier or deploy single-process"
            )
        from predictionio_tpu_torch.serving.procserver import FrontendConfig

        frontend = FrontendConfig(
            workers=args.frontend_workers,
            ring_slots=args.frontend_ring_slots,
            max_inflight=args.frontend_max_inflight,
            dispatch=args.dispatch,
            pin_cpus=args.pin_cpus,
        )
    kw = {"device": args.device}
    if args.model is not None:
        kw["model_path"] = args.model
    try:
        run_query_server(
            load_engine_variant(_variant_path(args)),
            host=args.ip,
            port=args.port,
            instance_id=args.engine_instance_id,
            model_version=args.model_version,
            feedback=feedback,
            ssl_cert=args.ssl_cert,
            ssl_key=args.ssl_key,
            batching=BatchConfig(
                max_batch_size=args.max_batch_size,
                window_ms=args.batch_window_ms,
                buckets=buckets,
            ),
            tracing=False if args.no_tracing else None,
            trace_sample=args.trace_sample,
            slow_query_ms=args.slow_query_ms,
            frontend=frontend,
            scorer_shards=args.scorer_shards,
            **kw,
        )
    except RegistryError as exc:
        # --model-version names an exact artifact; a missing or corrupt one
        # must be an actionable error, never a silent fallback deploy
        raise SystemExit(f"Error: {exc}")
    return 0


def cmd_retrain(args: argparse.Namespace) -> int:
    import signal

    from predictionio_tpu_torch.online.foldin import StalenessBudget
    from predictionio_tpu_torch.online.loop import RetrainConfig, RetrainLoop
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    configure_logging(args.log_format)
    variant = load_engine_variant(_variant_path(args))
    notify = [u for u in (args.notify or ["http://localhost:8000"]) if u]
    config = RetrainConfig(
        interval_s=args.interval,
        wal_dir=args.wal_dir,
        registry_dir=args.registry_dir,
        registry_keep=args.registry_keep,
        notify_urls=notify,
        budget=StalenessBudget(
            max_touched_frac=args.max_touched_frac,
            max_item_growth_frac=args.max_item_growth_frac,
        ),
        max_cycles=args.max_cycles if args.follow else 1,
        allow_full_retrain=not args.no_full_retrain,
        scorer_shards=args.scorer_shards,
    )
    try:
        loop = RetrainLoop(variant, config, device=args.device)
    except (LookupError, ValueError) as exc:
        raise SystemExit(f"Error: {exc}")
    signal.signal(signal.SIGTERM, lambda *_: loop.stop())
    try:
        counts = loop.run_follow()
    except KeyboardInterrupt:
        counts = dict(loop.cycles)
    print(
        "Retrain loop finished: "
        + ", ".join(f"{k}={v}" for k, v in sorted(counts.items()) if v),
        flush=True,
    )
    return 0


def _snapshot_args(args: argparse.Namespace, variant: EngineVariant) -> None:
    """``--snapshot-mode`` / ``--snapshot-dir`` into the runtime conf,
    mirrored in the env for ctx-free layers (``PEventStore.dataset``)."""
    if args.snapshot_mode:
        variant.runtime_conf["pio.snapshot_mode"] = args.snapshot_mode
        os.environ["PIO_SNAPSHOT_MODE"] = args.snapshot_mode
    if args.snapshot_dir:
        variant.runtime_conf["pio.snapshot_dir"] = args.snapshot_dir
        os.environ["PIO_SNAPSHOT_DIR"] = args.snapshot_dir


def _resolve_dotted(dotted: str, engine_dir: str, want: type):
    """The ``want`` (the port's ``Evaluation`` or
    ``EngineParamsGenerator``) a dotted path names, calling it when it is
    a subclass or a factory function. Anything else -- one of the JAX
    package's objects among them -- is refused, never adapted."""
    from predictionio_tpu_torch.workflow.json_extractor import (
        EngineConfigError,
        resolve_dotted,
    )

    try:
        obj = resolve_dotted(dotted, engine_dir)
    except EngineConfigError as exc:
        raise SystemExit(f"Error: {exc}")
    if not isinstance(obj, want) and (
        (isinstance(obj, type) and issubclass(obj, want))
        or (callable(obj) and not isinstance(obj, type))
    ):
        obj = obj()
    if not isinstance(obj, want):
        kind = type(obj) if not isinstance(obj, type) else obj
        raise SystemExit(
            f"Error: {dotted!r} did not yield the port's {want.__name__} (got "
            f"{kind.__module__}.{kind.__qualname__}); build it from "
            "predictionio_tpu_torch.controller.metrics"
        )
    return obj


def _cmd_replay_eval(args: argparse.Namespace) -> int:
    import json

    from predictionio_tpu_torch.eval.replay import run_replay_eval
    from predictionio_tpu_torch.online.registry import RegistryError
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    variant = load_engine_variant(_variant_path(args))
    _snapshot_args(args, variant)
    try:
        report = run_replay_eval(
            variant,
            split_time=args.split_time,
            split_frac=args.split_frac,
            k=args.k,
            metrics=args.metrics,
            model_version=args.model_version,
            registry_dir=args.registry_dir,
            retrieval_guard=not args.no_retrieval_guard,
            device=args.device,
        )
    except (ValueError, NotImplementedError, RegistryError) as exc:
        # exit-2 contract: a bad metric name, malformed boundary,
        # unsupported template, or GC'd pinned version is an actionable
        # one-liner, never a traceback
        print(f"Error: {exc}")
        return 2
    text = json.dumps(report, indent=2, sort_keys=True)
    print(text)
    if args.output_path:
        with open(args.output_path, "w") as f:
            f.write(text + "\n")
        print(f"Results written to {args.output_path}")
    return 0


def cmd_eval(args: argparse.Namespace) -> int:
    from predictionio_tpu_torch.controller.engine import EngineParams
    from predictionio_tpu_torch.controller.metrics import (
        EngineParamsGenerator,
        Evaluation,
    )
    from predictionio_tpu_torch.workflow.core_workflow import run_evaluation

    if args.replay:
        return _cmd_replay_eval(args)
    if not args.evaluation:
        print(
            "Error: pio eval needs a dotted Evaluation path, or --replay"
            " for the offline replay harness"
        )
        return 2
    evaluation = _resolve_dotted(args.evaluation, args.engine_dir, Evaluation)
    if args.paramsgen:
        generator = _resolve_dotted(args.paramsgen, args.engine_dir,
                                    EngineParamsGenerator)
    else:
        generator = EngineParamsGenerator([EngineParams()])
    instance = run_evaluation(
        evaluation,
        generator,
        evaluation_class=args.evaluation,
        generator_class=args.paramsgen or "",
        device=args.device,
    )
    print(instance.evaluator_results)
    if args.output_path:
        with open(args.output_path, "w") as f:
            f.write(instance.evaluator_results_json)
        print(f"Results written to {args.output_path}")
    print(f"Evaluation instance ID: {instance.id}")
    return 0


def cmd_check(args: argparse.Namespace) -> int:
    from predictionio_tpu_torch.analysis.engine import run_with_args

    return run_with_args(args)


def cmd_batchpredict(args: argparse.Namespace) -> int:
    from predictionio_tpu_torch.workflow.batch_predict import run_batch_predict
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    variant = load_engine_variant(_variant_path(args))
    try:
        count = run_batch_predict(
            variant, args.input, args.output,
            instance_id=args.engine_instance_id, device=args.device,
        )
    except LookupError as exc:
        raise SystemExit(f"Error: {exc}")
    print(f"Batch predict completed: {count} queries -> {args.output}")
    return 0


def cmd_undeploy(args: argparse.Namespace) -> int:
    import ssl
    import urllib.request

    import http.client

    # try the flagged scheme first; fall back to the other scheme ONLY on
    # errors that look like a scheme mismatch (TLS handshake noise / bad
    # status line), so a plainly-down server reports its real error once
    schemes = ("https", "http") if args.ssl else ("http", "https")
    insecure = ssl.create_default_context()
    insecure.check_hostname = False
    insecure.verify_mode = ssl.CERT_NONE
    first_exc = None
    for attempt, scheme in enumerate(schemes):
        url = f"{scheme}://{args.ip}:{args.port}/stop"
        try:
            urllib.request.urlopen(
                urllib.request.Request(url, method="POST", data=b""),
                timeout=5,
                context=insecure if scheme == "https" else None,
            )
            print("Engine server stopping.")
            return 0
        except Exception as exc:
            if attempt == 0:
                first_exc = exc
                root = getattr(exc, "reason", exc)
                mismatch = isinstance(
                    root, (ssl.SSLError, http.client.BadStatusLine)
                )
                if not mismatch:
                    break
    print(
        f"Error: cannot reach engine server at {args.ip}:{args.port}: {first_exc}"
    )
    return 1
