"""Command line of the port: the ``deploy`` verb so far.

    python -m predictionio_tpu_torch.tools.cli deploy \\
        --engine-json examples/recommendation/engine.json \\
        --model MODEL_DIR --port 8000 [--ip 0.0.0.0] [--device cuda|cpu]

``--engine-json`` is an unchanged ``engine.json`` of the recommendation
template: the first algorithm's ``params`` configure serving (including
``"retrieval": {"mode": "mips"}``). ``--model`` is a directory written by
``models.recommendation.convert.save_model``. The server warms the
retrieval indexes up before it answers, and runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

from predictionio_tpu_torch.controller.serving import FirstServing
from predictionio_tpu_torch.models.recommendation import ALSAlgorithm, load_model
from predictionio_tpu_torch.workflow.create_server import (
    QueryService,
    create_query_server,
)


def algorithm_params(engine_json: str) -> dict:
    """``algorithms[0].params`` of an engine.json (the template serves
    one algorithm, ``als``)."""
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
    return algorithms[0].get("params") or {}


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
    deploy = verbs.add_parser("deploy", help="serve /queries.json for a model")
    deploy.add_argument("--engine-json", required=True)
    deploy.add_argument("--model", required=True, help="save_model directory")
    deploy.add_argument("--ip", default="127.0.0.1")
    deploy.add_argument("--port", type=int, default=8000)
    deploy.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
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
