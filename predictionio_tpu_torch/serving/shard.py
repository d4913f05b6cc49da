"""Scorer shard process of the sharded serving fabric.

Runs as its own process (``python -m predictionio_tpu_torch.serving.shard``),
spawned and supervised by
:class:`~predictionio_tpu_torch.serving.fabric.ShardFabric`. One shard is a
full single-process :class:`~predictionio_tpu_torch.workflow.create_server.
QueryService` -- models, micro-batcher, router, hot-swap protocol --
restricted to its hash partition of the user factor table
(``QueryService(shard=K, num_shards=N)``); item-side and replicated
state stay whole, so any query for an owned user answers byte-for-byte
what the unsharded server would.

Two faces:

- **Ring face** (the query path): an ATTACHED
  :class:`~predictionio_tpu_torch.serving.procserver.ScorerBridge` consumes
  one request ring per frontend worker (the fabric created the ring
  files; the frontends route each query here by
  ``shardmap.shard_of(user)``), feeding the micro-batcher through the
  same async fast path the unsharded scorer uses.
- **Control face**: a loopback-only HTTP listener on an ephemeral port
  (written to ``--portfile``) exposing the full control surface --
  ``/models/swap``, ``/models.json``, ``/metrics``, ``/reload`` -- which
  is how the fabric fans a swap epoch out per shard and scrapes
  per-shard gauges.

``SIGTERM`` is the graceful drain signal (the fabric stops the frontends
first, so nothing is in flight by the time it arrives); ``--model-version``
pins the startup epoch, which is how a respawned shard rejoins at the
fabric's last COMMITTED version instead of whatever is newest.

Port of ``predictionio_tpu/serving/shard.py`` onto the port's
``create_query_server`` and ``load_engine_variant``, with one flag more:
``--device`` (default ``cuda``; the fabric passes its own down), where
the shard's models score. On the card each shard process holds its own
CUDA context and its B2 launches show in its control face's
``/metrics`` as ``pio_kernel_launches_total{kernel="mips_block_topk"}``.
Shards are spawned by ``exec`` of a fresh interpreter, never forked.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading

logger = logging.getLogger("pio.shard")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--variant", required=True, help="engine.json path")
    ap.add_argument("--shard", type=int, required=True)
    ap.add_argument("--num-shards", type=int, required=True)
    ap.add_argument(
        "--ring", required=True, action="append",
        help="ring file path, one per frontend worker (fabric-created)",
    )
    ap.add_argument(
        "--wake-req", required=True,
        help="this shard's request wakeup spec (shared by all frontends)",
    )
    ap.add_argument(
        "--wake-cmp", required=True, action="append",
        help="completion wakeup spec, one per --ring in the same order",
    )
    ap.add_argument("--portfile", required=True)
    ap.add_argument("--model-version", type=int, default=None)
    ap.add_argument("--instance-id", default=None)
    ap.add_argument("--dispatch", default="async", choices=("async", "sync"))
    ap.add_argument("--max-inflight", type=int, default=16)
    ap.add_argument("--control-threads", type=int, default=2)
    ap.add_argument("--server-name", default="pio-queryserver")
    ap.add_argument("--batch-window-ms", type=float, default=None)
    ap.add_argument("--max-batch-size", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format=f"shard-{args.shard} %(levelname)s %(name)s: %(message)s",
    )
    if len(args.wake_cmp) != len(args.ring):
        raise SystemExit("--wake-cmp count must match --ring count")

    from predictionio_tpu_torch.serving import shmring
    from predictionio_tpu_torch.serving.procserver import (
        FrontendConfig,
        ScorerBridge,
    )
    from predictionio_tpu_torch.workflow.create_server import create_query_server
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant
    from predictionio_tpu_torch.workflow.microbatch import BatchConfig

    variant = load_engine_variant(args.variant)
    batching = None
    if args.batch_window_ms is not None or args.max_batch_size is not None:
        kw = {}
        if args.batch_window_ms is not None:
            kw["window_ms"] = args.batch_window_ms
        if args.max_batch_size is not None:
            kw["max_batch_size"] = args.max_batch_size
        batching = BatchConfig(**kw)
    # the control face binds loopback only: the fabric is the sole client
    thread, service = create_query_server(
        variant, host="127.0.0.1", port=0,
        shard=args.shard, num_shards=args.num_shards,
        model_version=args.model_version,
        instance_id=args.instance_id,
        batching=batching,
        device=args.device,
    )
    thread.start()

    rings = [shmring.RingFile.attach(path) for path in args.ring]
    wake_req = shmring.Wakeup.from_spec(args.wake_req)
    attach = [
        (ring, wake_req, shmring.Wakeup.from_spec(spec))
        for ring, spec in zip(rings, args.wake_cmp)
    ]
    config = FrontendConfig(
        workers=len(rings),
        max_inflight=args.max_inflight,
        dispatch=args.dispatch,
        control_threads=args.control_threads,
    )
    async_query = None
    if config.dispatch == "async" and service._batcher is not None:
        async_query = service.submit_query_async
    bridge = ScorerBridge(
        service.router, "", 0, config,
        server_name=args.server_name,
        async_query=async_query,
        attach=attach,
    )
    service.scorer_stats = bridge.wakeup_stats
    bridge.start()

    # portfile LAST: its appearance is the fabric's READY signal, and by
    # now both faces answer (tmp+rename so a reader never sees a torn
    # write)
    tmp = f"{args.portfile}.tmp"
    with open(tmp, "w") as f:
        f.write(str(thread.port))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, args.portfile)
    logger.info(
        "shard %d/%d serving (control port %d, %d frontend ring(s),"
        " model version %s)",
        args.shard, args.num_shards, thread.port, len(rings),
        service.model_version,
    )

    stop = threading.Event()

    def _on_term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)
    while not stop.is_set() and not service._stop_event.is_set():
        stop.wait(0.5)
    logger.info("shard %d draining", args.shard)
    # frontends are already stopped/draining when SIGTERM arrives, so the
    # batcher flush answers everything still parked before the rings close
    service.close()
    bridge.stop()
    thread.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
