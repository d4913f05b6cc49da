"""Replay-evaluation quality bench: the standing accuracy trip-wire.

Usage::

    python -m predictionio_tpu_torch.tools.eval_bench [--events 4000]

Builds a seeded rating stream against a fresh file-backed store, runs one
``pio eval --replay`` pass (train on the prefix, score every held-out
user through the template's batched scorer), and reports:

- ``eval_ndcg_at_k`` / ``eval_hit_rate_at_k`` -- the ranking quality
  numbers ``bench.py`` tracks round over round, so a speed PR that
  quietly degrades recommendations moves a committed metric;
- ``mips_recall_at_k`` / ``response_identity_rate`` -- the scan-vs-mips
  retrieval guard: the quantized two-stage retriever's top-k overlap
  with (and byte-identity against) the exact scan on the SAME model and
  split. 1.0 / 1.0 at the default shortlist budget is the contract.

The stream is clique-structured (each user sticks to one item genre) so
the metrics sit far above the random-ranking floor and a real regression
is visible, not lost in noise.

Port of ``predictionio_tpu/tools/eval_bench.py``, the reference's code
under the port's package name, on ``device`` (``cuda`` unless "cpu"; no
card and no "cpu" raises before any work): the replay trains through
B1 (``ops/als_gram.py::gram_rhs``), and the guard's mips arm searches
through B2 (``ops/mips.py::mips_block_topk``) once the catalog is larger
than the shortlist (512): a smaller one, as at the defaults, is its own
shortlist and skips stage 1, as in the reference.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from predictionio_tpu_torch.data import storage as storage_registry
from predictionio_tpu_torch.tools.ingest_bench import _Env

APP = "EvalBenchApp"
APP_ID = 1


def _engine_json(workdir: str, rank: int, iterations: int) -> str:
    path = os.path.join(workdir, "engine.json")
    with open(path, "w") as f:
        json.dump(
            {
                "id": "eval-bench",
                "engineFactory": (
                    "predictionio_tpu_torch.models.recommendation.engine"
                    ".engine_factory"
                ),
                "datasource": {"params": {"appName": APP}},
                "algorithms": [
                    {
                        "name": "als",
                        "params": {
                            "rank": rank,
                            "numIterations": iterations,
                            "seed": 7,
                            "checkpointInterval": 0,
                        },
                    }
                ],
            },
            f,
        )
    return path


def _populate(le, events: int, users: int, items: int, genres: int = 4) -> None:
    """Clique-structured stream: user u rates mostly genre ``u % genres``
    items (fixed time base, 13 ms spacing -- replayable boundaries).

    Size the catalog so each genre pool is wider than one user's event
    budget: then every user's holdout window holds in-genre items THEY
    never rated but their genre-mates trained, and the unseenOnly-scored
    ndcg measures collaborative generalization instead of the
    seen-filtered noise floor."""
    import datetime as _dt

    from predictionio_tpu_torch.data import DataMap, Event

    rng = np.random.default_rng(11)
    base = _dt.datetime(2024, 1, 1, tzinfo=_dt.timezone.utc)
    per_genre = max(items // genres, 1)
    batch = []
    for k in range(events):
        u = int(rng.integers(0, users))
        g = u % genres
        if rng.random() < 0.85:
            item = g * per_genre + int(rng.integers(0, per_genre))
            rating = float(rng.integers(4, 6))
        else:
            item = int(rng.integers(0, items))
            rating = float(rng.integers(1, 3))
        batch.append(
            Event(
                event="rate",
                entity_type="user",
                entity_id=f"u{u}",
                target_entity_type="item",
                target_entity_id=f"i{item}",
                properties=DataMap({"rating": rating}),
                event_time=base + _dt.timedelta(milliseconds=13 * k),
            )
        )
    le.batch_insert(batch, app_id=APP_ID)


def run_eval_quality(
    events: int = 4_000,
    users: int = 80,
    items: int = 192,
    rank: int = 8,
    iterations: int = 4,
    split_frac: float = 0.8,
    k: int = 10,
    workdir: str | None = None,
    device=None,
) -> dict:
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.eval.replay import run_replay_eval
    from predictionio_tpu_torch.utils.device import resolve_device
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    device = resolve_device(device)
    own_tmp = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="pio_eval_bench_")
    with _Env(workdir):
        storage_registry.get_meta_data_apps().insert(App(name=APP))
        le = storage_registry.get_l_events()
        le.init_channel(APP_ID)
        _populate(le, events, users, items)
        variant = load_engine_variant(_engine_json(workdir, rank, iterations))
        t0 = time.perf_counter()
        report = run_replay_eval(variant, split_frac=split_frac, k=k, device=device)
        wall = time.perf_counter() - t0
    if own_tmp:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    guard = report.get("retrieval_guard") or {}
    return {
        "events": events, "users": users, "items": items, "rank": rank,
        "split_frac": split_frac, "k": k,
        "holdout_users": report["split"]["holdout_users"],
        f"eval_ndcg_at_{k}": report["metrics"][f"ndcg_at_{k}"],
        f"eval_hit_rate_at_{k}": report["metrics"][f"hit_rate_at_{k}"],
        f"mips_recall_at_{k}": guard.get(f"shortlist_recall_at_{k}"),
        "response_identity_rate": guard.get("response_identity_rate"),
        "shortlist": guard.get("shortlist"),
        "replay_seconds": round(wall, 3),
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--events", type=int, default=4_000)
    parser.add_argument("--users", type=int, default=80)
    parser.add_argument("--items", type=int, default=192)
    parser.add_argument("--rank", type=int, default=8)
    parser.add_argument("--iterations", type=int, default=4)
    parser.add_argument("--split-frac", type=float, default=0.8)
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    print(
        json.dumps(
            run_eval_quality(
                events=args.events,
                users=args.users,
                items=args.items,
                rank=args.rank,
                iterations=args.iterations,
                split_frac=args.split_frac,
                k=args.k,
                device=args.device,
            ),
            indent=2,
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
