"""Command line of the port: the ``train`` and ``deploy`` verbs.

    python -m predictionio_tpu_torch.tools.cli train \\
        --engine-json examples/recommendation/engine.json \\
        --events events.jsonl --model-out MODEL_DIR [--resume] [--device cuda|cpu]

    python -m predictionio_tpu_torch.tools.cli deploy \\
        --engine-json examples/recommendation/engine.json \\
        --model MODEL_DIR --port 8000 [--ip 0.0.0.0] [--device cuda|cpu]

``--engine-json`` is an unchanged ``engine.json`` of the recommendation
template: the datasource, preparator and first algorithm's ``params``
configure training, and the algorithm's ``params`` configure serving
(including ``"retrieval": {"mode": "mips"}``).

``train`` reads ``--events`` (JSON lines in the ``pio import`` wire
shape; the port's stand-in for the event store), runs DataSource ->
Preparator -> ``ALSAlgorithm.train`` and writes the model directory with
``save_model``. Step checkpoints go to ``MODEL_DIR/checkpoints`` while
it runs (every ``checkpointInterval`` iterations); ``--resume`` continues
from them after a crash, and a completed train removes them.

``deploy`` serves a model directory: it warms the retrieval indexes up
before it answers. Both verbs run on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

from predictionio_tpu_torch.controller.base import TrainContext
from predictionio_tpu_torch.controller.serving import FirstServing
from predictionio_tpu_torch.models.recommendation import (
    ALSAlgorithm,
    RecommendationDataSource,
    RecommendationModel,
    RecommendationPreparator,
    load_model,
    save_model,
)
from predictionio_tpu_torch.workflow.create_server import (
    QueryService,
    create_query_server,
)


def load_variant(engine_json: str) -> dict:
    """The engine.json object, checked to name the template's one
    algorithm, ``als``."""
    with open(engine_json) as f:
        variant = json.load(f)
    algorithms = variant.get("algorithms") or []
    if not algorithms:
        raise ValueError(f"{engine_json} names no algorithms")
    if algorithms[0].get("name", "als") != "als":
        raise ValueError(
            f"the port serves the recommendation template's 'als' "
            f"algorithm, got {algorithms[0].get('name')!r}"
        )
    return variant


def algorithm_params(engine_json: str) -> dict:
    """``algorithms[0].params`` of an engine.json."""
    return load_variant(engine_json)["algorithms"][0].get("params") or {}


def build_trainer(engine_json: str, events_path: str, *, device: str | None = None):
    """The template's train-path components from an engine.json:
    ``(datasource, preparator, algorithm)``. The algorithm resolves the
    device, so without a card and without ``device="cpu"`` this raises."""
    variant = load_variant(engine_json)
    algorithm = ALSAlgorithm(algorithm_params(engine_json), device=device)
    datasource = RecommendationDataSource(
        (variant.get("datasource") or {}).get("params"), events_path=events_path
    )
    preparator = RecommendationPreparator(
        (variant.get("preparator") or {}).get("params")
    )
    return datasource, preparator, algorithm


def train(engine_json: str, events_path: str, model_out: str, *,
          resume: bool = False, device: str | None = None) -> RecommendationModel:
    """Everything ``train`` does: read, prepare, fit, save; returns the
    trained model."""
    datasource, preparator, algorithm = build_trainer(
        engine_json, events_path, device=device
    )
    checkpoint_dir = os.path.join(model_out, "checkpoints")
    ctx = TrainContext(
        device=algorithm.device, checkpoint_dir=checkpoint_dir, resume=resume
    )
    data = datasource.read_training(ctx)
    data.sanity_check()
    model = algorithm.train(ctx, preparator.prepare(ctx, data))
    save_model(model, model_out)
    # a completed train's step checkpoints must not be resumable into a
    # later one
    shutil.rmtree(checkpoint_dir, ignore_errors=True)
    return model


def build_query_server(engine_json: str, model_path: str, *, ip: str = "127.0.0.1",
                       port: int = 8000, device: str | None = None):
    """Everything ``deploy`` does short of serving: load, warm up, bind.
    Returns ``(server, service)``."""
    algorithm = ALSAlgorithm(algorithm_params(engine_json), device=device)
    model = load_model(model_path)
    algorithm.warm_up(model)
    service = QueryService([algorithm], [model], FirstServing())
    return create_query_server(service, ip, port), service


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="predictionio_tpu_torch.tools.cli")
    verbs = parser.add_subparsers(dest="verb", required=True)
    train_p = verbs.add_parser("train", help="train a model from an events file")
    train_p.add_argument("--engine-json", required=True)
    train_p.add_argument("--events", required=True, help="JSON-lines events file")
    train_p.add_argument("--model-out", required=True, help="model directory to write")
    train_p.add_argument("--resume", action="store_true",
                         help="continue from the step checkpoints of a run that died")
    train_p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    deploy = verbs.add_parser("deploy", help="serve /queries.json for a model")
    deploy.add_argument("--engine-json", required=True)
    deploy.add_argument("--model", required=True, help="save_model directory")
    deploy.add_argument("--ip", default="127.0.0.1")
    deploy.add_argument("--port", type=int, default=8000)
    deploy.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    if args.verb == "train":
        model = train(args.engine_json, args.events, args.model_out,
                      resume=args.resume, device=args.device)
        print(f"trained {len(model.user_index)} users x {len(model.item_ids)} "
              f"items into {args.model_out} ({args.device})", flush=True)
        return 0
    server, _ = build_query_server(
        args.engine_json, args.model, ip=args.ip, port=args.port, device=args.device
    )
    host, port = server.server_address[:2]
    print(f"serving /queries.json on http://{host}:{port} ({args.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
