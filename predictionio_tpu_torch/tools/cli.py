"""Command line of the port: the ``train`` and ``deploy`` verbs.

    python -m predictionio_tpu_torch.tools.cli train \\
        --engine-json examples/recommendation/engine.json \\
        --events events.jsonl --model-out MODEL_DIR [--resume] [--device cuda|cpu]

    python -m predictionio_tpu_torch.tools.cli deploy \\
        --engine-json examples/ncf/engine.json \\
        --model MODEL_DIR --port 8000 [--ip 0.0.0.0] [--device cuda|cpu]

``--engine-json`` is an unchanged ``engine.json`` of one of the ported
templates, picked by its ``engineFactory`` (the reference's factory
path) or, without one, by its first algorithm's name:

- the recommendation template (``als``): ALS training, serving by scan
  or ``"retrieval": {"mode": "mips"}``;
- the Neural-CF template (``ncf``): NeuMF training, serving through the
  fused scorer kernel;
- the sequence template (``sasrec``): SASRec training and serving through
  the flash-attention kernels.

The datasource, preparator and first algorithm's ``params`` configure
training, and the algorithm's ``params`` configure serving. A
``sparkConf["pio.mesh_shape"]`` reaches training (the port runs on one
device).

``train`` reads ``--events`` (JSON lines in the ``pio import`` wire
shape; the port's stand-in for the event store), runs DataSource ->
Preparator -> ``Algorithm.train`` and writes the model directory with
the template's ``save_model``. Checkpoints go to ``MODEL_DIR/checkpoints``
while it runs (ALS: every ``checkpointInterval`` iterations; NCF: every
epoch; SASRec keeps none); ``--resume`` continues from them after a
crash, and a completed train removes them.

``deploy`` serves a model directory: it warms the template's device
state up before it answers. Both verbs run on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from dataclasses import dataclass
from typing import Callable

from predictionio_tpu_torch.controller.base import (
    Algorithm,
    DataSource,
    Preparator,
    TrainContext,
)
from predictionio_tpu_torch.controller.serving import FirstServing
from predictionio_tpu_torch.models import ncf, recommendation, sequence
from predictionio_tpu_torch.models.recommendation import RecommendationDataSource
from predictionio_tpu_torch.workflow.create_server import (
    QueryService,
    create_query_server,
)


@dataclass(frozen=True)
class Template:
    """What the verbs need of one ported template."""

    algorithm: str                      # the engine.json algorithm name
    algorithm_class: type[Algorithm]
    preparator_class: type[Preparator]
    save_model: Callable
    load_model: Callable
    datasource_class: type[DataSource]  # built with ``events_path=``


TEMPLATES = {
    "recommendation": Template(
        "als", recommendation.ALSAlgorithm, recommendation.RecommendationPreparator,
        recommendation.save_model, recommendation.load_model, RecommendationDataSource,
    ),
    "ncf": Template(
        "ncf", ncf.NCFAlgorithm, ncf.NCFPreparator, ncf.save_model, ncf.load_model,
        RecommendationDataSource,
    ),
    "sequence": Template(
        "sasrec", sequence.SASRecAlgorithm, sequence.SequencePreparator,
        sequence.save_model, sequence.load_model, sequence.SequenceDataSource,
    ),
}


def load_variant(engine_json: str) -> tuple[dict, Template]:
    """The engine.json object and its template: by ``engineFactory``
    (``predictionio_tpu.models.<template>.engine_factory``) when it names
    one, else by the first algorithm's name. The first algorithm must be
    the template's."""
    with open(engine_json) as f:
        variant = json.load(f)
    algorithms = variant.get("algorithms") or []
    if not algorithms:
        raise ValueError(f"{engine_json} names no algorithms")
    name = algorithms[0].get("name", "als")
    factory = variant.get("engineFactory")
    if factory:
        parts = factory.split(".")
        key = parts[-2] if len(parts) >= 2 and parts[-1] == "engine_factory" else None
        if key not in TEMPLATES:
            raise ValueError(
                f"engineFactory {factory!r} is not a ported template; the port "
                f"serves {sorted(TEMPLATES)}"
            )
        template = TEMPLATES[key]
    else:
        template = next((t for t in TEMPLATES.values() if t.algorithm == name), None)
        if template is None:
            raise ValueError(
                f"algorithm {name!r} is not a ported template's; the port "
                f"serves {sorted(t.algorithm for t in TEMPLATES.values())}"
            )
    if name != template.algorithm:
        raise ValueError(
            f"the template's algorithm is {template.algorithm!r}, got {name!r}"
        )
    return variant, template


def _algorithm(variant: dict, template: Template, device):
    params = variant["algorithms"][0].get("params") or {}
    return template.algorithm_class(params, device=device)


def build_trainer(engine_json: str, events_path: str, *, device: str | None = None):
    """The engine.json, read once, and its template's train-path
    components: ``(variant, template, datasource, preparator,
    algorithm)``. The algorithm resolves the device, so without a card
    and without ``device="cpu"`` this raises."""
    variant, template = load_variant(engine_json)
    algorithm = _algorithm(variant, template, device)
    datasource = template.datasource_class(
        (variant.get("datasource") or {}).get("params"), events_path=events_path
    )
    preparator = template.preparator_class(
        (variant.get("preparator") or {}).get("params")
    )
    return variant, template, datasource, preparator, algorithm


def train(engine_json: str, events_path: str, model_out: str, *,
          resume: bool = False, device: str | None = None):
    """Everything ``train`` does: read, prepare, fit, save; returns the
    trained model."""
    variant, template, datasource, preparator, algorithm = build_trainer(
        engine_json, events_path, device=device
    )
    checkpoint_dir = os.path.join(model_out, "checkpoints")
    ctx = TrainContext(
        device=algorithm.device, checkpoint_dir=checkpoint_dir, resume=resume,
        mesh_shape=(variant.get("sparkConf") or {}).get("pio.mesh_shape"),
    )
    data = datasource.read_training(ctx)
    data.sanity_check()
    model = algorithm.train(ctx, preparator.prepare(ctx, data))
    template.save_model(model, model_out)
    # a completed train's checkpoints must not be resumable into a later one
    shutil.rmtree(checkpoint_dir, ignore_errors=True)
    return model


def build_query_server(engine_json: str, model_path: str, *, ip: str = "127.0.0.1",
                       port: int = 8000, device: str | None = None):
    """Everything ``deploy`` does short of serving: load, warm up, bind.
    Returns ``(server, service)``."""
    variant, template = load_variant(engine_json)
    algorithm = _algorithm(variant, template, device)
    model = template.load_model(model_path)
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
        print(f"trained a model of {len(model.item_ids)} items into "
              f"{args.model_out} ({args.device})", flush=True)
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
