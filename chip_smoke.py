#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card: build, check, time, serve.

    python3 chip_smoke.py [--seed N]

Phases, each printed as one JSON line (a failed phase raises, so the
script exits non-zero and prints no result):

1. device  -- needs CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them.
2. build   -- compiles every kernel of ``predictionio_tpu_torch/csrc``
   (one ``nvcc`` each, started together) and reports ptxas's summary.
3. check   -- each kernel against its plain torch twin on the card, at
   the main path's shapes (1,000,000 items x rank 16, 512-item tiles,
   R=16, batches of 8, 16 and 256) plus small tie and padding cases.
   Tolerance: per (query, tile) the sorted scores agree within
   rtol=atol=1e-5, and the index sets are equal except entries whose
   score lies within that tolerance of the R-th score (the kernel and
   the plain version sum the K products in different orders).
4. time    -- kernel and plain version, median of CUDA-event timed runs
   after warm-up, beside the bound: the larger of bytes / 3.35 TB/s and
   f32 operations / 67 TFLOP/s (H100 SXM data sheet).
5. serve   -- the main path: a recommendation model of 138,000 users x
   1,000,000 items x rank 16 made from ``--seed``, saved with
   ``save_model``, deployed through the ``deploy`` code path on cuda
   with ``"retrieval": {"mode": "mips"}``, answering POST /queries.json
   (user, blackList, unseenOnly=false, item-similarity and cold-user
   queries) and a 256-user ``batch_predict``. Launch counts are zeroed
   just before and read just after. Checks: every kernel of the path
   launched, batch_predict equals per-query predict, and recall@10 of
   the served lists against the exact f32 scan is at least 0.99.

Then one line ``{"kernels": [...]}`` and, last, ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, data sheet
F32_OPS_PER_S = 67e12           # H100 SXM, f32 outside the tensor cores
TOL = 1e-5

NUM_USERS, NUM_ITEMS, RANK = 138_000, 1_000_000, 16
BLOCK_ITEMS, BLOCK_TOPK = 512, 16
BATCHES = (8, 16, 256)
TIMED_RUNS = 30


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms over ``runs`` event pairs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Median host-clock time of ``fn()`` in ms (``fn`` must wait for
    its device work itself)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def stage1_inputs(factors: np.ndarray, queries: np.ndarray, block_items: int):
    import torch

    from predictionio_tpu_torch.ops.quantize import pack_int8_blockwise

    packed = pack_int8_blockwise(factors, block_items)
    return [
        torch.from_numpy(np.ascontiguousarray(x)).cuda()
        for x in (queries, packed.q, packed.scales)
    ]


def compare_stage1(args, r: int, num_items: int, exact: bool) -> float:
    """Kernel vs plain on the same inputs; returns the max abs score
    error. Raises on disagreement beyond the stated tolerance."""
    import torch

    from predictionio_tpu_torch.ops.mips import mips_block_topk, mips_block_topk_plain

    ks, ki = mips_block_topk(*args, block_topk=r, num_items=num_items)
    torch.cuda.synchronize()
    ps, pi = mips_block_topk_plain(*args, block_topk=r, num_items=num_items)
    b = args[0].shape[0]
    ks, ki, ps, pi = (t.reshape(b, -1, r) for t in (ks, ki, ps, pi))
    if exact:
        if not torch.equal(ki, pi):
            raise AssertionError("kernel indices differ from the plain version")
    ks_sorted = torch.sort(ks, dim=2, descending=True).values
    torch.testing.assert_close(ks_sorted, ps, rtol=TOL, atol=TOL)
    # index sets per (query, tile), up to near-ties at the R-th place
    kth = ps[:, :, -1:]
    near = (ks - kth).abs() <= TOL + TOL * kth.abs()
    k_in_p = (ki[..., :, None] == pi[..., None, :]).any(-1)
    p_in_k = (pi[..., :, None] == ki[..., None, :]).any(-1)
    near_p = (ps - kth).abs() <= TOL + TOL * kth.abs()
    if not bool((k_in_p | near).all()) or not bool((p_in_k | near_p).all()):
        raise AssertionError("kernel index sets differ beyond near-ties")
    return float((ks_sorted - ps).abs().max())


def stage1_bound(b: int, padded: int, k: int, nb: int, r: int) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, bytes, operations) for one stage-1 call:
    each input read once (int8 table, scales, queries), each output
    written once ([B, nb, R] f32 scores + i32 indices)."""
    nbytes = padded * k + nb * 4 + b * k * 4 + b * nb * r * 8
    ops = 2.0 * b * padded * k
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def phase_check_and_time(rng: np.random.Generator) -> dict:
    import torch

    from predictionio_tpu_torch.ops.mips import mips_block_topk, mips_block_topk_plain

    # small cases: exact indices (ties break to the lowest index; padding
    # drains as distinct indices after every real row)
    cases = {
        "ties": (np.ones((32, 8), np.float32), np.ones((8, 8), np.float32), 16, 3),
        "padding": (
            -np.abs(rng.standard_normal((10, 8))).astype(np.float32),
            np.abs(rng.standard_normal((8, 8))).astype(np.float32), 16, 16,
        ),
        "ragged": (
            rng.standard_normal((3001, 16)).astype(np.float32),
            rng.standard_normal((24, 16)).astype(np.float32), 512, 16,
        ),
    }
    for name, (f, q, bi, r) in cases.items():
        err = compare_stage1(
            stage1_inputs(f, q, bi), r, f.shape[0], exact=name != "ragged"
        )
        emit({"phase": "check", "case": name, "max_abs_err": err})
    factors = rng.standard_normal((NUM_ITEMS, RANK)).astype(np.float32)
    shapes, worst = [], 0.0
    for b in BATCHES:
        args = stage1_inputs(
            factors, rng.standard_normal((b, RANK)).astype(np.float32), BLOCK_ITEMS
        )
        err = compare_stage1(args, BLOCK_TOPK, NUM_ITEMS, exact=False)
        worst = max(worst, err)
        call = dict(block_topk=BLOCK_TOPK, num_items=NUM_ITEMS)
        ms = cuda_ms(lambda: mips_block_topk(*args, **call))
        plain_ms = cuda_ms(lambda: mips_block_topk_plain(*args, **call))
        # R=1 keeps the staging and scoring and drops 15 of the 16
        # selection passes: the difference is the selection's share
        ms_r1 = cuda_ms(lambda: mips_block_topk(*args, block_topk=1, num_items=NUM_ITEMS))
        padded, nb = args[1].shape[0], args[2].shape[0]
        bound_ms, bound_by, nbytes, ops = stage1_bound(b, padded, RANK, nb, BLOCK_TOPK)
        row = {
            "batch": b, "items": NUM_ITEMS, "rank": RANK,
            "block_items": BLOCK_ITEMS, "block_topk": BLOCK_TOPK,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "ms_r1": ms_r1,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "operations": ops,
            "fraction_of_bound": bound_ms / ms,
        }
        emit({"phase": "time", **row})
        shapes.append(row)
        del args
        torch.cuda.empty_cache()
    return {"shapes": shapes, "max_abs_err": worst}


def make_model(rng: np.random.Generator, queried_users: np.ndarray):
    """A full-width random model: factors from ``rng``, seen items only
    for the users the run queries (50 each)."""
    from predictionio_tpu_torch.models.recommendation import model_from_arrays

    user_factors = rng.standard_normal((NUM_USERS, RANK)).astype(np.float32)
    item_factors = rng.standard_normal((NUM_ITEMS, RANK)).astype(np.float32)
    seen_users = np.repeat(queried_users, 50)
    seen_items = rng.integers(0, NUM_ITEMS, seen_users.size)
    return model_from_arrays(
        user_factors, item_factors,
        [f"u{u}" for u in range(NUM_USERS)], [f"i{i}" for i in range(NUM_ITEMS)],
        seen_users, seen_items,
    )


def post(conn: http.client.HTTPConnection, query: dict) -> tuple[dict, float]:
    """One POST /queries.json on a kept-alive connection; returns the
    body and the round trip in ms."""
    t0 = time.perf_counter()
    conn.request(
        "POST", "/queries.json", body=json.dumps(query).encode(),
        headers={"Content-Type": "application/json"},
    )
    resp = conn.getresponse()
    body = json.loads(resp.read())
    if resp.status != 200:
        raise AssertionError(f"{query} answered {resp.status}: {body}")
    return body, (time.perf_counter() - t0) * 1e3


def get_status(conn: http.client.HTTPConnection) -> dict:
    conn.request("GET", "/")
    resp = conn.getresponse()
    body = json.loads(resp.read())
    if resp.status != 200:
        raise AssertionError(f"GET / answered {resp.status}: {body}")
    return body


def phase_serve(rng: np.random.Generator, workdir: str) -> dict:
    from predictionio_tpu_torch.models._als_common import retrieval_index
    from predictionio_tpu_torch.models.recommendation import ALSAlgorithm, save_model
    from predictionio_tpu_torch.ops import mips
    from predictionio_tpu_torch.tools.cli import build_query_server

    picked = rng.choice(NUM_USERS, size=256 + 12, replace=False)
    model = make_model(rng, picked)
    model_dir = os.path.join(workdir, "model")
    save_model(model, model_dir)
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "examples", "recommendation", "engine.json")) as f:
        variant = json.load(f)
    variant["algorithms"][0]["params"]["retrieval"] = {"mode": "mips"}
    engine_json = os.path.join(workdir, "engine.json")
    with open(engine_json, "w") as f:
        json.dump(variant, f)

    users = [f"u{u}" for u in picked[:12]]
    seen_item = f"i{sorted(model.seen[int(picked[2])])[0]}"
    queries = (
        [{"user": u, "num": 10} for u in users[:8]]
        + [{"user": users[8], "num": 10, "blackList": ["i0", "i1", "i2"]},
           {"user": users[2], "num": 10, "blackList": [seen_item]},
           {"user": users[9], "num": 10, "unseenOnly": False},
           {"user": users[10], "num": 20, "unseenOnly": False},
           {"items": ["i17"], "num": 10},
           {"items": ["i5", "i999999"], "num": 10},
           {"items": ["i123", "i456", "no-such-item"], "num": 10},
           {"user": "cold-user", "num": 10},
           {"items": ["no-such-item"], "num": 10}]
    )
    batch = [(qid, {"user": f"u{u}", "num": 10}) for qid, u in enumerate(picked[12:])]

    mips.mips_block_topk.launches = 0        # counts start at 0 here
    t0 = time.perf_counter()
    server, service = build_query_server(
        engine_json, model_dir, port=0, device="cuda"
    )
    deploy_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
    try:
        served, latencies = [], []
        for q in queries:
            body, ms = post(conn, q)
            served.append(body)
            latencies.append(ms)
        algo, deployed = service.algorithms[0], service.models[0]
        t0 = time.perf_counter()
        batched = dict(algo.batch_predict(deployed, batch))
        batch_s = time.perf_counter() - t0
        launches = {"mips_block_topk": mips.mips_block_topk.launches}  # read here
        # where a query's time goes, host clock, after the counts were read:
        # the HTTP floor (GET /, no predict) and one user query repeated
        http_floor_ms = host_ms(lambda: get_status(conn))
        http_query_ms = host_ms(lambda: post(conn, queries[0]))
    finally:
        conn.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("query server thread did not stop")

    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    if any(batched[qid] != algo.predict(deployed, q) for qid, q in batch):
        raise AssertionError("batch_predict differs from per-query predict")
    if served[-2] != {"itemScores": []} or served[-1] != {"itemScores": []}:
        raise AssertionError("cold user / unknown items must answer empty lists")
    # recall@10 against the exact f32 scan of the same model
    scan = ALSAlgorithm(
        {k: v for k, v in variant["algorithms"][0]["params"].items() if k != "retrieval"},
        device="cuda",
    )
    hits = total = identical = 0
    for q, body in zip(queries, served):
        exact = scan.predict(deployed, q)
        want = [s["item"] for s in exact["itemScores"]][:10]
        got = {s["item"] for s in body["itemScores"]}
        hits += len(got & set(want))
        total += len(want)
        identical += body == exact
        for s in body["itemScores"]:
            if not np.isfinite(s["score"]):
                raise AssertionError(f"non-finite score in {body}")
        if len(body["itemScores"]) != len(exact["itemScores"]):
            raise AssertionError(f"{q}: {len(body['itemScores'])} items served, "
                                 f"{len(exact['itemScores'])} in the scan")
    recall = hits / max(total, 1)
    if recall < 0.99:
        raise AssertionError(f"recall@10 {recall} < 0.99 against the exact scan")
    # the same query without HTTP: the device search alone (it ends in a
    # copy to the host, which waits for the device) and the whole predict
    # (search + numpy re-rank + filter + format)
    index = retrieval_index(deployed.als, algo._retrieval, device=algo.device)
    one_user = deployed.als.user_factors[int(picked[0])][None, :]
    search_ms = host_ms(lambda: index.search(one_user))
    predict_ms = host_ms(lambda: algo.predict(deployed, queries[0]))
    result = {
        "users": NUM_USERS, "items": NUM_ITEMS, "rank": RANK,
        "queries": len(queries), "deploy_s": deploy_s,
        "query_ms_p50": statistics.median(latencies),
        "query_ms_max": max(latencies),
        "http_floor_ms_p50": http_floor_ms, "http_query_ms_p50": http_query_ms,
        "predict_ms_p50": predict_ms, "search_ms_p50": search_ms,
        "batch_predict_users": len(batch), "batch_predict_s": batch_s,
        "launches": launches, "recall_at_10": recall,
        "identical_to_scan": identical,
    }
    emit({"phase": "serve", **result})
    return result


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    from predictionio_tpu_torch import _kernels
    from predictionio_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")  # TF32 off for the plain versions' products too
    t0 = time.perf_counter()
    _kernels.build_all()
    ptxas = [
        line.strip() for log in _kernels.build_logs.values()
        for line in log.splitlines() if "registers" in line or "spill" in line
    ]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    rng = np.random.default_rng(args.seed)
    stage1 = phase_check_and_time(rng)
    with tempfile.TemporaryDirectory() as workdir:
        serve = phase_serve(rng, workdir)

    main_shape = next(s for s in stage1["shapes"] if s["batch"] == 256)
    emit({"kernels": [{
        "name": "mips_block_topk",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/mips_topk.cu",
        "replaces": "predictionio_tpu/ops/mips.py:129",
        "launches": serve["launches"]["mips_block_topk"],
        "max_abs_err": stage1["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes a per-tile top-R "
                        "of an int8-dequantized product",
        "shape": {k: main_shape[k] for k in ("batch", "items", "rank", "block_items", "block_topk")},
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
