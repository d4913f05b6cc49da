#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card: build, check, time, serve, train.

    python3 chip_smoke.py [--seed N]

Phases, each printed as one JSON line (a failed phase raises, so the
script exits non-zero and prints no result):

1. device  -- needs CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them.
2. build   -- compiles every kernel of ``predictionio_tpu_torch/csrc``
   (one ``nvcc`` each, started together) and reports ptxas's summary.
3. check   -- kernel B2 (``mips_topk.cu``) against its plain torch twin
   on the card, at the serving path's shapes (1,000,000 items x rank 16,
   512-item tiles, R=16, batches of 8, 16 and 256) plus small tie and
   padding cases. Tolerance: per (query, tile) the sorted scores agree
   within rtol=atol=1e-5, and the index sets are equal except entries
   whose score lies within that tolerance of the R-th score (the kernel
   and the plain version sum the K products in different orders).
4. time    -- B2 and its plain version, median of CUDA-event timed runs
   after warm-up, beside the bound: the larger of bytes / 3.35 TB/s and
   f32 operations / 67 TFLOP/s (H100 SXM data sheet).
5. serve   -- the serving path: a recommendation model of 138,000 users x
   1,000,000 items x rank 16 made from ``--seed``, saved with
   ``save_model``, deployed through the ``deploy`` code path on cuda
   with ``"retrieval": {"mode": "mips"}``, answering POST /queries.json
   (user, blackList, unseenOnly=false, item-similarity and cold-user
   queries) and a 256-user ``batch_predict``. Launch counts are zeroed
   just before and read just after. Checks: every kernel of the path
   launched, batch_predict equals per-query predict, and recall@10 of
   the served lists against the exact f32 scan is at least 0.99.
6. train   -- the training path at full width: the template's engine.json
   (rank 16, 10 iterations, lambda 0.1, seed 3, f32, explicit) with
   ``maxEventsPerUser`` 256 on 138,000 users x 27,000 items x 20,000,000
   ratings made from ``--seed`` by the bench's MovieLens-20M recipe,
   through RecommendationPreparator -> ALSAlgorithm.train on cuda, the
   generated arrays standing where the events reader's would. B1 launch
   counts are zeroed just before and read just after (20 expected).
   Checks: no NaN; the training RMSE on 100,000 sampled ratings falls
   from iteration 1 to 2 to 10; a 2-iteration fit through B1 equals the
   unfused "xla" path on the card within 1e-4 (the reference's f32
   solver-parity bar).
7. check_b1 -- kernel B1 (``als_gram.cu``) against its plain version on
   the two half-step blocks of that fit (138,000 x 200 and 27,000 x 256,
   trained factors), explicit/implicit x f32/bf16, plus small cases:
   ranks 8, 16, 32, 64, a ragged row count, all-padding rows (exactly
   zero) and the last real row; ranks 65, 128 and 200 (entries split
   into groups of blocks) on 2,000 x 48 blocks in both modes and dtypes;
   ranks 128 and 200 at 1, 2, 5 and 8 rows (all groups of a row run at
   once), each launch repeated and equal bit for bit.
   Tolerance, elementwise: 2 (L + 2) 2^-24 times the same sums over
   absolute values (the worst case of two f32 recursive sums of L
   products in different orders); per Gram row the same factor of its
   max|gram|. Then a 2-iteration fit of phase 6's data at rank 128
   through B1 equals the "xla" path within 1e-4.
8. time_b1 -- B1, its plain version, the ridge + solve and the whole
   half-step at both block shapes in f32 and bf16, beside the bound (the
   reference's fused bytes model over 3.35 TB/s, or the f32 operations).
9. foldin  -- ``fold_in_users`` of 1,000 users' histories against the
   trained item factors, through B1 and through the plain path.
10. train_verb_and_serve -- the ``train`` verb on a 3,000-event JSON-lines
   file and ``deploy`` of what it wrote; then the full-width model of
   phase 6 saved, deployed with mips and queried over HTTP: B2 launches
   and recall@10 >= 0.99 against the exact scan.
11. check_b3 -- kernel B3 (``ncf_score.cu``) against its plain version
   on the card at the NCF template's widths (E=32, hidden 64, 32) over
   1,000,000 items for five users (the last one included), over 1, 1023,
   1025 and 27,000 items, and at widths 8/(16, 8), 5/(12, 7) and
   64/(128, 64), and 64/(256, 128) and 128/(512, 256) over 27,000 items
   and 40/(300, 130) and 100/(200, 70) over 3,001 and 2,047 (the wide
   layout: weights streamed through shared-memory windows). Tolerance,
   elementwise: 2 (3E + H0 + H1 + 6) 2^-24 times S, the same head run on
   the absolute values of every input
   (the worst case of two f32 evaluations that sum each layer in
   different orders; ``b3_tolerance``).
12. time_b3 -- B3 and its plain version at 1,000,000 and 27,000 items,
   and the wide towers at 27,000 items, beside the bound (the larger of
   bytes / 3.35 TB/s and f32 operations / 67 TFLOP/s).
13. train_ncf -- the NCF training path: ``examples/ncf/engine.json``
   (E=32, hidden 64, 32, batch 4096, lr 0.01, implicit, 4 negatives) on
   phase 6's 20,000,000 ratings, through NCFPreparator ->
   NCFAlgorithm.train on cuda, epochs cut 5 -> 1. Checks: the step count,
   no NaN, the mean loss of the last 100 steps below the first 100's,
   and fresh pairs of the data's recipe scoring above uniform ones.
14. serve_ncf -- that model saved, deployed through the ``deploy`` code
   path on cuda and queried over HTTP (known users, blackList,
   unseenOnly=false, num 20, a cold user) and by a 256-user
   ``batch_predict``. B3 launches counted from 0 before the queries must
   equal the known-user queries; every served list and every batch
   answer agrees with the plain head on the card (scores within the B3
   tolerance; items the plain top-k up to near-ties), and each batch
   answer's scores agree with ``predict``'s (B3) within that tolerance.
   serve_ncf_wide -- a random 64/(256, 128) model over 27,000 items
   deployed with an engine.json of that width: 3 known-user queries, each
   200 through B3 (3 launches) and held to the plain head as above.
15. train_verb_ncf -- the ``train`` verb with the NCF engine.json on a
   3,000-event file, and ``deploy`` of what it wrote (B3 serves it).
16. seq_data -- phase 6's 20M ratings as sequence events (event i at
   second i) grouped per user in time order (``group_sequences``, the
   DataSource's grouping), each user's last item held out, the rest
   packed by SequencePreparator to [138,000, 64].
17. check_flash -- kernel B4 (``flash_attention.cu``) and the fused
   backward (``flash_backward.cu``) against their plain versions on the
   card: the training shape (B=256, H=2, T=64, D=16) with the packed
   rows' masks, with random right padding and with left padding; T in
   {1, 65, 200, 1024} x D in {8, 16, 32, 64}, causal and not, each with a
   fully-masked batch row and left-padded rows (T above 64 takes the
   fused kernel's atomic dq path); and D in {24, 128} at T in {64, 1024}
   (24 through the wrappers' zero-padding to 32, held to the plain
   versions at D = 24). Tolerance, elementwise: 2e-5 times max(1,
   max|plain|) of each output (f32 sums of at most T + D terms in other
   orders; the kernels' products are 3xTF32; the reference's own forward
   bar is 2e-5 on unit inputs). Rows with no valid key: out, dq, dk, dv
   exactly 0, lse <= -1e29; masked keys: dk, dv exactly 0; no NaN
   anywhere. Then 20 SASRec steps at embedDim 48 / 2 heads (D = 24)
   through the kernels equal the same steps through the plain versions
   (losses within 1e-4).
18. time_flash -- B4, the fused backward and their plain versions at the
   training shape and at B=16, H=2, T=1024, D=16, and again at the
   training shape with D=24 (the wrappers' padding copies timed with the
   call) and the long one with D=128, beside the bound (the
   larger of bytes / 3.35 TB/s and the causal pairs' operations / 165
   TFLOP/s, 3xTF32 on the tensor cores; the backward's delta rows at the
   f32 units' 67 TFLOP/s) and beside ``scaled_dot_product_attention``
   with the same boolean mask (its forward for B4, its backward for the
   fused kernel), with the SDPA backend PyTorch chose. Times are device
   times from a ``torch.profiler`` trace (the sum of the call's
   kernels), with the CUDA-event time of one call beside: at these sizes
   the host's launch overhead, which events count, is larger than the
   kernels.
19. train_seq -- ``examples/sequence/engine.json`` unchanged (E=32, 2
   heads, 2 blocks, ffn 64, maxLen 64, batch 256, lr 1e-3, 10 epochs)
   through SASRecAlgorithm.train on cuda. Flash counts are zeroed just
   before and read just after: B4 and the fused backward must each be
   2 x steps. Checks: no
   NaN, the mean loss of the last 100 steps below the first 100's,
   hit@10 of the held-out last items above the uniform 10/27,000, and 20
   steps through the kernels equal the same 20 steps through the plain
   versions on the card (losses within 1e-4); the kernel run of those 20
   steps is traced: device ms a step, the card's busy share, top kernels
   and the flash kernels' own ms a step.
20. serve_seq -- that model saved, deployed through the ``deploy`` code
   path on cuda and queried over HTTP (users, sessions of 1-10 items,
   blackList, unseenOnly=false, a cold user) and by a 256-user
   ``batch_predict``: B4 launches counted from 0 must be 2 per forward;
   every list agrees with the plain path on the card (scores within 1e-4
   times max(1, max|score|), items up to near-ties), and batch with
   predict.
21. train_verb_seq -- the ``train`` verb with the sequence engine.json on
   a 3,000-event file, and ``deploy`` of what it wrote (B4 serves it).

Then one line ``{"kernels": [...]}``, the card's line again and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
TF32_MMA_OPS_PER_S = 495e12     # H100 SXM, TF32 on the tensor cores, dense
#: f32 products as 3xTF32 (three TF32 mma each) reach a third of that: the
#: roof of a kernel that does its f32 products on the tensor cores
F32_3XTF32_OPS_PER_S = TF32_MMA_OPS_PER_S / 3
TOL = 1e-5

NUM_USERS, NUM_ITEMS, RANK = 138_000, 1_000_000, 16
BLOCK_ITEMS, BLOCK_TOPK = 512, 16
BATCHES = (8, 16, 256)
TIMED_RUNS = 30

#: the training configuration: the template's engine.json (rank 16, 10
#: iterations, lambda 0.1, seed 3, f32 factors, explicit) on the bench's
#: stand-in for MovieLens-20M, with its 256-event history cap
TRAIN_USERS, TRAIN_ITEMS, TRAIN_EDGES, TRAIN_CAP = 138_000, 27_000, 20_000_000, 256
RMSE_SAMPLE = 100_000
FOLDIN_USERS = 1_000
SMALL_EVENTS = 3_000
#: the reference's f32 solver-parity bar (tests/test_als_gram.py:198)
FIT_ATOL = 1e-4
#: ranks past the 5 x 1,024 entries one B1 block holds (its entries split
#: into groups), checked on small blocks; the 2-iteration fit runs at the
#: middle one on the full training data
B1_WIDE_RANKS, B1_WIDE_ROWS, B1_FIT_RANK = (65, 128, 200), 2_000, 128
#: few-row blocks at the grouped ranks, each launch repeated
B1_FEW_ROWS, B1_FEW_REPEATS = (1, 2, 5, 8), 4

#: the NCF template's widths (examples/ncf/engine.json); B3 is checked at
#: the serving catalog of B2's check and on the training stand-in's
NCF_E, NCF_HIDDEN = 32, (64, 32)
#: wider towers whose weights no longer fit shared memory beside the item
#: tile (B3 streams them through shared-memory windows); the first one is
#: also served
NCF_WIDE = ((64, (256, 128)), (128, (512, 256)))
NCF_WIDE_USERS, NCF_WIDE_QUERIES = 2_000, 3
NCF_SERVE_USERS, NCF_SERVE_ITEMS = NUM_USERS, NUM_ITEMS
NCF_TRAIN_ITEMS = TRAIN_ITEMS
NCF_SMALL_ITEMS = (1, 1023, 1025, 27_000)
NCF_EPOCHS = 1          # the one cut of the NCF training phase: 5 -> 1
NCF_HOLDOUT = 100_000

#: the flash-attention checks and timings: the sequence template's
#: training shape (batch 256, 2 heads of 16, maxLen 64) and a long one
SEQ_TRAIN_SHAPE = (256, 2, 64, 16)      # B, H, T, D
SEQ_LONG_SHAPE = (16, 2, 1024, 16)
#: timed besides: the training shape at head dim 24 (zero-padded to 32 by
#: the wrappers, the copies timed with the call) and the long one at 128
SEQ_TRAIN24_SHAPE = (256, 2, 64, 24)
SEQ_LONG128_SHAPE = (16, 2, 1024, 128)
FLASH_CHECK_T = (1, 65, 200, 1024)
FLASH_CHECK_D = (8, 16, 32, 64)
#: head dims the kernels are not built for (zero-padded to 32) or the
#: largest built one, at the training and the long T
FLASH_PADDED_T = (64, 1024)
FLASH_PADDED_D = (24, 128)
#: the SASRec width whose head dim (48 / 2 = 24) goes through the padding
SEQ_PADDED_EMBED, SEQ_PADDED_HEADS = 48, 2
FLASH_TOL = 2e-5
SEQ_PLAIN_STEPS = 20
SEQ_SCORE_TOL = 1e-4
SEQ_HIT_BATCH = 4096


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


def device_trace(fn, runs: int):
    """``{kernel name: device ms per call}`` of ``fn()`` from a
    ``torch.profiler`` (CUPTI) trace of ``runs`` calls, and the host
    seconds of those calls (device synced at the end)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    per_name = {}
    for event in prof.key_averages():
        us = event.self_device_time_total
        if us > 0:
            per_name[event.key[:120]] = us / runs / 1e3
    return per_name, wall_s


def device_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3):
    """Device time of one ``fn()`` in ms: the summed duration of every
    kernel and copy it runs on the card (``device_trace``). CUDA events
    around a call whose kernels take microseconds also count the host's
    launch overhead, during which the card idles; this leaves it out.
    None when the trace shows no device time."""
    for _ in range(warmup):
        fn()
    per_name, _ = device_trace(fn, runs)
    total = sum(per_name.values())
    return total if total > 0 else None


def timed_pair(fn) -> tuple[float, float]:
    """``(device ms, CUDA-event ms)`` of one ``fn()``; the device time is
    the event time when the trace shows no device time."""
    call_ms = cuda_ms(fn)
    return device_ms(fn) or call_ms, call_ms


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


def recall_against_scan(params: dict, deployed, queries, served) -> tuple[float, int]:
    """recall@10 of the served responses against the exact f32 scan of
    the same model, and how many responses equal the scan's. Raises
    below 0.99, on a non-finite score, or on a length mismatch."""
    from predictionio_tpu_torch.models.recommendation import ALSAlgorithm

    scan = ALSAlgorithm(
        {k: v for k, v in params.items() if k != "retrieval"}, device="cuda"
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
    return recall, identical


def phase_serve(rng: np.random.Generator, workdir: str) -> dict:
    from predictionio_tpu_torch.models._als_common import retrieval_index
    from predictionio_tpu_torch.models.recommendation import save_model
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
    recall, identical = recall_against_scan(
        variant["algorithms"][0]["params"], deployed, queries, served
    )
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


# --------------------------------------------------------------------------
# training: kernel B1 (csrc/als_gram.cu) on the recommendation template
# --------------------------------------------------------------------------


class StepTimes:
    """``telemetry`` for ``als_fit``: wall seconds of each iteration."""

    def __init__(self):
        self.seconds: list[float] = []

    def record_step(self, iteration: int, seconds: float) -> None:
        self.seconds.append(seconds)


def make_ratings(rng: np.random.Generator):
    """The bench's stand-in for MovieLens-20M (``bench.py:68-78``): users
    uniform, item popularity a squared-uniform Zipf (u^2.2), integer
    ratings 1-5; event i happens at second i."""
    users = rng.integers(0, TRAIN_USERS, size=TRAIN_EDGES, dtype=np.int64)
    items = (
        np.minimum(rng.random(TRAIN_EDGES) ** 2.2, 0.999999) * TRAIN_ITEMS
    ).astype(np.int64)
    ratings = rng.integers(1, 6, size=TRAIN_EDGES).astype(np.float32)
    times = np.arange(TRAIN_EDGES, dtype=np.float64)
    return users, items, ratings, times


def template_params(repo: str) -> tuple[dict, dict]:
    """(algorithm params, preparator params) of the template's engine.json,
    with the history cap of ``bench.py:1102``. Without the cap the most
    popular item has ~194,000 ratings: its padded item block would be
    27,000 x ~194,000 slots x 8 B ~ 42 GB, and the unfused gather
    several times that."""
    with open(os.path.join(repo, "examples", "recommendation", "engine.json")) as f:
        variant = json.load(f)
    return variant["algorithms"][0]["params"], {"maxEventsPerUser": TRAIN_CAP}


def rmse(model, users, items, ratings) -> float:
    pred = np.einsum("nk,nk->n", model.user_factors[users], model.item_factors[items])
    return float(np.sqrt(np.mean((pred - ratings) ** 2)))


def phase_train(rng: np.random.Generator, repo: str) -> dict:
    """The main training path at full width: DataSource-shaped arrays ->
    RecommendationPreparator -> ALSAlgorithm.train on cuda, counted."""
    import torch

    from predictionio_tpu_torch.controller.base import TrainContext
    from predictionio_tpu_torch.models.recommendation import (
        ALSAlgorithm,
        RatingsData,
        RecommendationPreparator,
    )
    from predictionio_tpu_torch.ops import als_gram
    from predictionio_tpu_torch.parallel.als import ALSModel, als_fit

    t0 = time.perf_counter()
    users, items, ratings, times = make_ratings(rng)
    data = RatingsData(
        users=users, items=items, ratings=ratings, times=times,
        user_ids=[f"u{u}" for u in range(TRAIN_USERS)],
        item_ids=[f"i{i}" for i in range(TRAIN_ITEMS)],
    )
    data.sanity_check()
    generate_s = time.perf_counter() - t0
    algo_params, prep_params = template_params(repo)
    algorithm = ALSAlgorithm(algo_params, device="cuda")
    steps = StepTimes()
    ctx = TrainContext(device="cuda", telemetry=steps)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    als_gram.gram_rhs.launches = 0           # counts start at 0 here
    t0 = time.perf_counter()
    prepared = RecommendationPreparator(prep_params).prepare(ctx, data)
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = algorithm.train(ctx, prepared)
    train_s = time.perf_counter() - t0
    launches = {"gram_rhs": als_gram.gram_rhs.launches}  # read here
    peak_bytes = torch.cuda.max_memory_allocated()
    _, als_data = prepared
    config = algorithm._config()
    one_card = dataclasses.replace(config, factor_sharding="replicated")
    # the fit alone, after the counts were read: the same 10 iterations
    # again with init, the blocks' transfer and the copy back
    t0 = time.perf_counter()
    refit = als_fit(als_data, one_card, "cuda")
    fit_s = time.perf_counter() - t0

    if launches["gram_rhs"] != 2 * config.iterations:
        raise AssertionError(
            f"{launches['gram_rhs']} B1 launches, expected {2 * config.iterations}"
        )
    for name in ("user_factors", "item_factors"):
        if not np.isfinite(getattr(model.als, name)).all():
            raise AssertionError(f"non-finite {name} after training")
    # quality: training RMSE on a fixed sample falls from iteration 1 to
    # 10, and a 2-iteration fit through the kernel equals the unfused
    # "xla" path on the card within the reference's f32 solver-parity bar
    sample = rng.choice(TRAIN_EDGES, size=RMSE_SAMPLE, replace=False)
    su, si, sr = users[sample], items[sample], ratings[sample]
    two = dataclasses.replace(one_card, iterations=2)
    first = {}
    fused2 = als_fit(als_data, two, "cuda",
                     callback=lambda it, u, v: first.setdefault(it, (u, v)))
    xla2 = als_fit(als_data, dataclasses.replace(two, solver="xla"), "cuda")
    it1 = ALSModel(user_factors=first[0][0], item_factors=first[0][1])
    curve = {1: rmse(it1, su, si, sr), 2: rmse(fused2, su, si, sr),
             10: rmse(model.als, su, si, sr)}
    if not curve[1] > curve[2] > curve[10]:
        raise AssertionError(f"training RMSE does not fall: {curve}")
    xla_diff = max(
        float(np.abs(fused2.user_factors - xla2.user_factors).max()),
        float(np.abs(fused2.item_factors - xla2.item_factors).max()),
    )
    if xla_diff > FIT_ATOL:
        raise AssertionError(
            f"2-iteration fit through the kernel differs from the xla path "
            f"by {xla_diff} > {FIT_ATOL}"
        )
    result = {
        "users": TRAIN_USERS, "items": TRAIN_ITEMS, "edges": TRAIN_EDGES,
        "rank": config.rank, "iterations": config.iterations,
        "max_events_per_user": TRAIN_CAP,
        "user_block": list(als_data.by_row.blocks[0].indices.shape),
        "item_block": list(als_data.by_col.blocks[0].indices.shape),
        "truncated": als_data.by_col.truncated + als_data.by_row.truncated,
        "generate_s": generate_s, "pack_s": pack_s, "train_s": train_s,
        "fit_s": fit_s,
        "refit_identical": bool(
            np.array_equal(refit.user_factors, model.als.user_factors)
            and np.array_equal(refit.item_factors, model.als.item_factors)
        ),
        "iteration_s": steps.seconds,
        "iteration_s_median": statistics.median(steps.seconds),
        "iterations_s_total": sum(steps.seconds),
        # the rest of train_s is host work around the fit, chiefly the
        # seen map the model carries
        "train_s_outside_fit": train_s - fit_s,
        "peak_device_bytes": peak_bytes, "launches": launches,
        "rmse": curve, "xla_max_abs_diff_at_2": xla_diff,
    }
    emit({"phase": "train", **result})
    return {"result": result, "model": model, "als_data": als_data,
            "config": config, "ratings": (users, items, ratings, times)}


def b1_bound(rows: int, pad_len: int, table_rows: int, rank: int,
             itemsize: int) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, bytes, operations) of one B1 call. Bytes:
    what the function must move, each input read once and each output
    written once: indices (i32) and values (f32), the gather table once
    (a factor table fits the 50 MB L2, so its repeated reads by the
    gather need not reach device memory), Gram and rhs (f32). Operations:
    2*R*L*K^2 + 2*R*L*K f32, the full K x K Gram the kernel computes (the
    symmetric upper triangle alone would take about half). The larger of
    bytes over the memory rate and operations over the f32 rate."""
    nbytes = (rows * pad_len * (4 + 4) + table_rows * rank * itemsize
              + rows * (rank * rank + rank) * 4)
    ops = 2.0 * rows * pad_len * rank * rank + 2.0 * rows * pad_len * rank
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def compare_b1(idx, val, table, alpha: float, implicit: bool) -> tuple[float, float]:
    """Kernel vs plain on the same inputs. Tolerance, elementwise: the
    worst-case error of f32 recursive summation of L products is
    (L + 2) * 2^-24 * sum|terms| for each of the two sums, which run in
    different orders, so |kernel - plain| <= 2 (L + 2) 2^-24 S with S the
    same sums over absolute values (computed by the plain version on
    |values| and |table|). With non-negative weights S_ij <= max_k
    gram_kk (Cauchy-Schwarz), so each Gram row also stays within that
    factor of its max|gram|, which is checked too. Returns the max abs
    error and the largest per-row error relative to max|gram|."""
    import torch

    from predictionio_tpu_torch.ops.als_gram import gram_rhs, gram_rhs_plain

    gram, rhs = gram_rhs(idx, val, table, alpha, implicit=implicit)
    torch.cuda.synchronize()
    p_gram, p_rhs = gram_rhs_plain(idx, val, table, alpha, implicit=implicit)
    s_gram, s_rhs = gram_rhs_plain(idx, val.abs(), table.abs(), abs(alpha), implicit=implicit)
    tol = 2.0 * (idx.shape[1] + 2) * 2.0 ** -24
    worst = 0.0
    for what, got, want, scale in (("gram", gram, p_gram, s_gram), ("rhs", rhs, p_rhs, s_rhs)):
        err = (got - want).abs()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"non-finite {what} from the kernel")
        if bool((err > tol * scale + 1e-30).any()):
            ratio = float((err / (scale + 1e-30)).max())
            raise AssertionError(
                f"B1 {what} differs from the plain version: {ratio} of the "
                f"absolute sum, over the bound {tol}"
            )
        worst = max(worst, float(err.max()))
    row_err = (gram - p_gram).abs().amax(dim=(1, 2))
    row_rel = float((row_err / p_gram.abs().amax(dim=(1, 2)).clamp(min=1e-30)).max())
    if row_rel > tol:
        raise AssertionError(f"B1 Gram row error {row_rel} of max|gram| over {tol}")
    return worst, row_rel


def slot_table(side, factors: np.ndarray) -> np.ndarray:
    """A side's factors (original entity order) as the gather table the
    opposite side's block indexes: slot order, ``[total_slots + 1, K]``
    f32, padding slots and the sentinel row zero."""
    table = np.zeros((side.total_slots + 1, factors.shape[1]), np.float32)
    table[side.slot_of] = factors
    return table


def phase_check_b1(rng: np.random.Generator, trained: dict) -> dict:
    """Kernel B1 against its plain version on the card: the two half-step
    blocks of the full-width fit (real indices, trained factors) in both
    modes and dtypes, small cases, ranks past one block's entries (also
    at a few rows, repeated); then a 2-iteration fit at rank 128 through
    B1 against the "xla" path."""
    import torch

    from predictionio_tpu_torch.ops import als_gram
    from predictionio_tpu_torch.ops.als_gram import gram_rhs
    from predictionio_tpu_torch.parallel.als import als_fit

    data, model = trained["als_data"], trained["model"]
    sides = {
        "users": (data.by_row.blocks[0], slot_table(data.by_col, model.als.item_factors)),
        "items": (data.by_col.blocks[0], slot_table(data.by_row, model.als.user_factors)),
    }
    worst = {}
    for side, (block, table) in sides.items():
        idx = torch.from_numpy(block.indices).cuda()
        val = torch.from_numpy(block.values).cuda()
        table32 = torch.from_numpy(table).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            for implicit in (False, True):
                err, row_rel = compare_b1(idx, val, table32.to(dtype), 40.0, implicit)
                worst[side] = max(worst.get(side, 0.0), err)
                emit({"phase": "check_b1", "case": side, "shape": list(block.indices.shape),
                      "dtype": str(dtype).split(".")[-1], "implicit": implicit,
                      "max_abs_err": err, "max_row_rel_err": row_rel})
        del idx, val, table32
        torch.cuda.empty_cache()
    # small cases: every rank size class, a ragged row count, all-padding
    # rows (exactly zero), and indices hitting the last real row
    for k in (8, 16, 32, 64):
        s, l, r = 500, 40, 1001
        table = np.concatenate([rng.standard_normal((s, k)), np.zeros((1, k))]).astype(np.float32)
        idx = rng.integers(0, s, (r, l)).astype(np.int32)
        idx[:, -3:] = s                  # padding tail on every row
        idx[5, :] = s                    # an all-padding row
        idx[7, :] = s - 1                # the last real row, every slot
        val = rng.integers(1, 6, (r, l)).astype(np.float32)
        args = [torch.from_numpy(a).cuda() for a in (idx, val)]
        for dtype in (torch.float32, torch.bfloat16):
            t = torch.from_numpy(table).cuda().to(dtype)
            for implicit in (False, True):
                err, row_rel = compare_b1(*args, t, 2.5, implicit)
                gram, rhs = gram_rhs(*args, t, 2.5, implicit=implicit)
                if bool(gram[5].any()) or bool(rhs[5].any()):
                    raise AssertionError("an all-padding row has a non-zero Gram/rhs")
                emit({"phase": "check_b1", "case": f"small_k{k}", "shape": [r, l],
                      "dtype": str(dtype).split(".")[-1], "implicit": implicit,
                      "max_abs_err": err, "max_row_rel_err": row_rel})
    # ranks whose K (K + 1) entries split into groups of blocks, and whose
    # chunk of gathered slots needs shared memory past the 48 KB default
    for k in B1_WIDE_RANKS:
        s, l, r = 3000, 48, B1_WIDE_ROWS
        table = np.concatenate([rng.standard_normal((s, k)), np.zeros((1, k))]).astype(np.float32)
        idx = rng.integers(0, s + 1, (r, l)).astype(np.int32)
        idx[5, :] = s                    # an all-padding row
        val = rng.integers(1, 6, (r, l)).astype(np.float32)
        args = [torch.from_numpy(a).cuda() for a in (idx, val)]
        case = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            t = torch.from_numpy(table).cuda().to(dtype)
            for implicit in (False, True):
                err, row_rel = compare_b1(*args, t, 2.5, implicit)
                gram, rhs = gram_rhs(*args, t, 2.5, implicit=implicit)
                if bool(gram[5].any()) or bool(rhs[5].any()):
                    raise AssertionError("an all-padding row has a non-zero Gram/rhs")
                case = max(case, err)
                worst[f"k{k}"] = max(worst.get(f"k{k}", 0.0), err)
        emit({"phase": "check_b1", "case": f"wide_k{k}", "shape": [r, l],
              "dtypes": ["float32", "bfloat16"], "modes": ["explicit", "implicit"],
              "max_abs_err": case})
    # few rows at those ranks: every group's block of a row runs at once,
    # so a block that stored into the next group's entries would race it.
    # One thread sums each entry in slot order: repeats agree bit for bit.
    for k in B1_WIDE_RANKS[1:]:
        for r in B1_FEW_ROWS:
            s, l = 500, 48
            table = np.concatenate([rng.standard_normal((s, k)),
                                    np.zeros((1, k))]).astype(np.float32)
            idx = rng.integers(0, s + 1, (r, l)).astype(np.int32)
            val = rng.integers(1, 6, (r, l)).astype(np.float32)
            args = [torch.from_numpy(a).cuda() for a in (idx, val)]
            t = torch.from_numpy(table).cuda()
            case = 0.0
            for implicit in (False, True):
                first = gram_rhs(*args, t, 2.5, implicit=implicit)
                for _ in range(B1_FEW_REPEATS):
                    err, _ = compare_b1(*args, t, 2.5, implicit)
                    again = gram_rhs(*args, t, 2.5, implicit=implicit)
                    if not (torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])):
                        raise AssertionError(f"B1 at rank {k}, {r} rows: repeated launches differ")
                    case = max(case, err)
            worst[f"k{k}"] = max(worst[f"k{k}"], case)
            emit({"phase": "check_b1", "case": f"few_rows_k{k}", "shape": [r, l],
                  "repeats": B1_FEW_REPEATS, "max_abs_err": case})
    # the template's fit at rank 128 through B1 and through the unfused
    # "xla" path, 2 iterations, on the full training data
    data = trained["als_data"]
    fit = dataclasses.replace(trained["config"], factor_sharding="replicated",
                              rank=B1_FIT_RANK, iterations=2)
    before = als_gram.gram_rhs.launches
    t0 = time.perf_counter()
    fused = als_fit(data, fit, "cuda")
    fused_s = time.perf_counter() - t0
    launches = als_gram.gram_rhs.launches - before
    t0 = time.perf_counter()
    xla = als_fit(data, dataclasses.replace(fit, solver="xla"), "cuda")
    xla_s = time.perf_counter() - t0
    fit_diff = max(float(np.abs(fused.user_factors - xla.user_factors).max()),
                   float(np.abs(fused.item_factors - xla.item_factors).max()))
    if launches != 2 * fit.iterations or not np.isfinite(fused.user_factors).all():
        raise AssertionError(f"rank-{B1_FIT_RANK} fit: {launches} B1 launches or non-finite factors")
    if fit_diff > FIT_ATOL:
        raise AssertionError(f"rank-{B1_FIT_RANK} fit through B1 differs from the xla path "
                             f"by {fit_diff} > {FIT_ATOL}")
    emit({"phase": "check_b1", "case": f"fit_rank{B1_FIT_RANK}", "iterations": fit.iterations,
          "b1_launches": launches, "fused_s": fused_s, "xla_s": xla_s,
          "xla_max_abs_diff": fit_diff})
    del fused, xla
    torch.cuda.empty_cache()
    return {"max_abs_err": max(worst.values()), "fit_rank_diff": fit_diff}


def phase_time_b1(trained: dict) -> dict:
    """B1 and its plain version timed at both half-step shapes of the fit,
    f32 and bf16 tables, explicit mode (the template's), beside the bound;
    and the parts of one half-step: B1, the ridge + solve, the whole
    ``solve_rows``, and the host-to-device transfer of the blocks."""
    import torch

    from predictionio_tpu_torch.ops.als_gram import gram_rhs, gram_rhs_plain, half_step_bytes
    from predictionio_tpu_torch.parallel.als import (
        _finish_explicit,
        device_blocks,
        solve_rows,
    )

    data, model, config = trained["als_data"], trained["model"], trained["config"]
    t0 = time.perf_counter()
    blocks = {"users": device_blocks(data.by_row, "cuda")[0],
              "items": device_blocks(data.by_col, "cuda")[0]}
    torch.cuda.synchronize()
    transfer_s = time.perf_counter() - t0
    opp = {"users": slot_table(data.by_col, model.als.item_factors),
           "items": slot_table(data.by_row, model.als.user_factors)}
    shapes = []
    for side, block in blocks.items():
        idx, val, n_obs = block
        table32 = torch.from_numpy(opp[side]).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            table = table32.to(dtype)
            ms = cuda_ms(lambda: gram_rhs(idx, val, table))
            plain_ms = cuda_ms(lambda: gram_rhs_plain(idx, val, table))
            gram, rhs = gram_rhs(idx, val, table)
            finish_ms = cuda_ms(lambda: _finish_explicit(
                gram, rhs, n_obs, config.reg, config.rank, dtype))
            zero = torch.zeros((config.rank, config.rank), device="cuda")
            step_ms = cuda_ms(lambda: solve_rows(
                gram_rhs, block, table, zero, config, dtype))
            rows, pad_len = idx.shape
            itemsize = 2 if dtype == torch.bfloat16 else 4
            bound_ms, bound_by, nbytes, ops = b1_bound(
                rows, pad_len, table.shape[0], config.rank, itemsize)
            # the reference's fused bytes model counts every gathered row
            # as a device-memory read; kept beside the bound, not in it
            ref_bytes = half_step_bytes(rows, pad_len, config.rank, itemsize, fused=True)
            row = {
                "side": side, "rows": rows, "pad_len": pad_len, "rank": config.rank,
                "dtype": str(dtype).split(".")[-1], "ms": ms, "plain_ms": plain_ms,
                "finish_ms": finish_ms, "half_step_ms": step_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes": nbytes, "operations": ops,
                "reference_bytes_model": ref_bytes,
                "reference_bytes_model_ms": ref_bytes / HBM_BYTES_PER_S * 1e3,
                "fraction_of_bound": bound_ms / ms,
            }
            emit({"phase": "time_b1", **row})
            shapes.append(row)
        del table32, table
        torch.cuda.empty_cache()
    return {"shapes": shapes, "transfer_s": transfer_s}


def phase_foldin(rng: np.random.Generator, trained: dict) -> dict:
    """``fold_in_users`` of 1,000 users' full histories against the
    trained item factors, through the kernel and through the plain path
    on the card."""
    import torch

    from predictionio_tpu_torch.online.foldin import fold_in_users
    from predictionio_tpu_torch.ops import als_gram

    users, items, ratings, times = trained["ratings"]
    config = dataclasses.replace(trained["config"], max_len=TRAIN_CAP)
    picked = np.sort(rng.choice(TRAIN_USERS, size=FOLDIN_USERS, replace=False))
    hist = np.isin(users, picked)
    rows = np.searchsorted(picked, users[hist])
    item_factors = trained["model"].als.item_factors
    args = (item_factors, rows, items[hist], ratings[hist], FOLDIN_USERS)
    before = als_gram.gram_rhs.launches
    t0 = time.perf_counter()
    fused = fold_in_users(*args, config, times=times[hist], device="cuda")
    foldin_s = time.perf_counter() - t0
    launches = als_gram.gram_rhs.launches - before
    plain = fold_in_users(*args, dataclasses.replace(config, solver="xla"),
                          times=times[hist], device="cuda")
    torch.cuda.synchronize()
    if launches < 1:
        raise AssertionError("fold_in_users did not launch B1")
    err = float(np.abs(fused - plain).max())
    if not np.isfinite(fused).all() or err > FIT_ATOL:
        raise AssertionError(f"fold-in differs from the plain path by {err}")
    result = {"users": FOLDIN_USERS, "edges": int(hist.sum()), "foldin_s": foldin_s,
              "launches": launches, "max_abs_err": err}
    emit({"phase": "foldin", **result})
    return result


def small_events(rng: np.random.Generator, path: str) -> tuple[int, str]:
    """A few thousand rate events in the quickstart's wire shape; returns
    their count and the first event's user."""
    base = 1_700_000_000
    n = SMALL_EVENTS
    users = rng.integers(0, 300, n)
    items = (np.minimum(rng.random(n) ** 2.2, 0.999999) * 200).astype(np.int64)
    stars = rng.integers(1, 6, n)
    with open(path, "w") as f:
        for e in range(n):
            when = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(base + e))
            f.write(json.dumps({
                "event": "rate", "entityType": "user", "entityId": f"u{users[e]}",
                "targetEntityType": "item", "targetEntityId": f"i{items[e]}",
                "properties": {"rating": int(stars[e])}, "eventTime": when,
            }) + "\n")
    return n, f"u{users[0]}"


def serve_model(engine_json: str, model_dir: str, queries: list[dict]):
    """Deploy ``model_dir`` through the ``deploy`` code path on cuda and
    POST each query over one kept-alive connection; returns
    ``(responses, deployed model, deploy seconds)``."""
    from predictionio_tpu_torch.tools.cli import build_query_server

    t0 = time.perf_counter()
    server, service = build_query_server(engine_json, model_dir, port=0, device="cuda")
    deploy_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
    try:
        served = [post(conn, q)[0] for q in queries]
    finally:
        conn.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("query server thread did not stop")
    return served, service.models[0], deploy_s


def phase_train_verb_and_serve(rng: np.random.Generator, trained: dict, repo: str,
                               workdir: str) -> dict:
    """The ``train`` verb on a small events file, the model it writes
    served by ``deploy``; then the full-width model of the train phase
    saved, deployed with mips and queried over HTTP."""
    from predictionio_tpu_torch.models.recommendation import load_model, save_model
    from predictionio_tpu_torch.ops import als_gram, mips
    from predictionio_tpu_torch.tools import cli

    engine_json = os.path.join(repo, "examples", "recommendation", "engine.json")
    events = os.path.join(workdir, "events.jsonl")
    n_events, user = small_events(rng, events)
    small_dir = os.path.join(workdir, "small_model")
    before = als_gram.gram_rhs.launches
    t0 = time.perf_counter()
    if cli.main(["train", "--engine-json", engine_json, "--events", events,
                 "--model-out", small_dir, "--device", "cuda"]) != 0:
        raise AssertionError("the train verb failed")
    verb_s = time.perf_counter() - t0
    verb_launches = als_gram.gram_rhs.launches - before
    if verb_launches < 1:
        raise AssertionError("the train verb did not launch B1")
    served, small, _ = serve_model(engine_json, small_dir, [{"user": user, "num": 5}])
    if len(served[0]["itemScores"]) != 5 or user not in small.user_index:
        raise AssertionError(f"the trained small model answered {served[0]}")

    model = trained["model"]
    full_dir = os.path.join(workdir, "full_model")
    t0 = time.perf_counter()
    save_model(model, full_dir)
    save_s = time.perf_counter() - t0
    algo_params, _ = template_params(repo)
    mips_params = dict(algo_params, retrieval={"mode": "mips"})
    mips_json = os.path.join(workdir, "engine_mips.json")
    with open(mips_json, "w") as f:
        json.dump({"algorithms": [{"name": "als", "params": mips_params}]}, f)
    picked = rng.choice(TRAIN_USERS, size=10, replace=False)
    queries = (
        [{"user": f"u{u}", "num": 10} for u in picked]
        + [{"user": f"u{picked[0]}", "num": 10, "unseenOnly": False},
           {"items": ["i0"], "num": 10},
           {"items": ["i100", "i26999"], "num": 10}]
    )
    mips.mips_block_topk.launches = 0
    served, deployed, deploy_s = serve_model(mips_json, full_dir, queries)
    b2_launches = mips.mips_block_topk.launches
    if b2_launches < 1:
        raise AssertionError("serving the trained model did not launch B2")
    recall, identical = recall_against_scan(mips_params, deployed, queries, served)
    t0 = time.perf_counter()
    load_model(full_dir)  # the part of deploy_s that reads the model
    load_s = time.perf_counter() - t0
    result = {"events": n_events, "train_verb_s": verb_s, "train_verb_b1_launches": verb_launches,
              "save_s": save_s, "deploy_s": deploy_s, "load_model_s": load_s,
              "queries": len(queries),
              "b2_launches": b2_launches, "recall_at_10": recall,
              "identical_to_scan": identical}
    emit({"phase": "train_verb_and_serve", **result})
    return result


# --------------------------------------------------------------------------
# Neural-CF: kernel B3 (csrc/ncf_score.cu) on the NCF template
# --------------------------------------------------------------------------


def random_ncf_state(num_users: int, num_items: int, embed: int, hidden, seed: int):
    """A ``NeuMF`` state dict at the given widths from ``seed``: flax's
    default init, then the biases drawn too (the init zeroes them, which
    would leave the kernel's bias paths unchecked)."""
    import torch

    from predictionio_tpu_torch.models.ncf.model import NCFConfig, init_model

    model = init_model(NCFConfig(num_users, num_items, embed, tuple(hidden), seed=seed))
    gen = torch.Generator().manual_seed(seed + 1)
    state = model.state_dict()
    for name, value in state.items():
        if name.endswith(".bias"):
            value.copy_(0.1 * torch.randn(value.shape, generator=gen))
    return state


def b3_tolerance(e: int, h0: int, h1: int) -> float:
    """B3 and its plain version sum the products of each layer in
    different orders. Each f32 sum of n terms is within (n - 1) 2^-24
    of its sum over absolute values, and relu passes a layer's error on
    unamplified, so each version is within (3E + H0 + H1 + 6) 2^-24 of
    the exact score in units of S, the same head run on the absolute
    values of every input (the gmf product and its weight, the 2E + 1
    terms of the first layer, the H0 + 1 of the second, the E + H1 + 1
    of the output, one rounding each). Twice that bounds the difference
    of the two."""
    return 2.0 * (3 * e + h0 + h1 + 6) * 2.0 ** -24


def compare_b3(gmf_users, mlp_users, head, users) -> tuple[float, float]:
    """B3 against ``ncf_score_plain`` on the card for each user row;
    elementwise |kernel - plain| <= tol * S (``b3_tolerance``). Returns
    the max abs error and the max of |kernel - plain| / (tol * S)."""
    import torch

    from predictionio_tpu_torch.models.ncf.kernel import ncf_score_all_items, ncf_score_plain

    gi, mi, kernels, biases, out_k, out_b = head
    e = gi.shape[1]
    tol = b3_tolerance(e, kernels[0].shape[1], kernels[1].shape[1])
    abs_head = (gi.abs(), mi.abs(), [k.abs() for k in kernels], [b.abs() for b in biases],
                out_k.abs(), out_b.abs())
    worst = worst_ratio = 0.0
    for u in users:
        got = ncf_score_all_items(gi, mi, gmf_users[u], mlp_users[u], kernels, biases, out_k, out_b)
        torch.cuda.synchronize()
        if got.shape != (gi.shape[0],) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"B3 gave shape {tuple(got.shape)} or a non-finite score")
        want = ncf_score_plain(gi, mi, gmf_users[u], mlp_users[u], kernels, biases, out_k, out_b)
        scale = ncf_score_plain(abs_head[0], abs_head[1], gmf_users[u].abs(),
                                mlp_users[u].abs(), *abs_head[2:])
        err = (got - want).abs()
        ratio = float((err / (tol * scale + 1e-30)).max())
        if ratio > 1.0:
            raise AssertionError(
                f"B3 differs from the plain version for user {u}: {ratio} of the "
                f"bound {tol} x S"
            )
        worst, worst_ratio = max(worst, float(err.max())), max(worst_ratio, ratio)
    return worst, worst_ratio


def b3_bound(items: int, e: int, h0: int, h1: int) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, bytes, operations) of one B3 call. Bytes:
    the two item tables read once and the scores written once (the user
    rows and the ~17 KB of weights are noise). Operations per item:
    2 E H0 + 2 H0 H1 (the two dense layers' multiply-adds, each sum of
    products started from its bias), 3E (the gmf products, their weights
    and sum), 2 H1 (the output dot, started from the gmf sum and the
    output bias) and H0 + H1 relus; per call once more 2 E H0 + H0 for
    the user's half of the first layer."""
    nbytes = 2.0 * items * e * 4 + items * 4 + (2 * e + 2 * e * h0 + h0 * h1) * 4
    per_item = 2 * e * h0 + 2 * h0 * h1 + 3 * e + 2 * h1 + h0 + h1
    ops = float(items * per_item + 2 * e * h0 + h0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def phase_check_b3(seed: int) -> dict:
    """Kernel B3 against its plain version on the card: the template's
    widths (E=32, hidden 64, 32) at 1,000,000 items for several users
    (the last one included), the small catalogs 1, 1023, 1025 and 27,000,
    widths that are not multiples of the kernel's 8-column chunks, and
    the wide towers (the wide layout, weights streamed through windows)
    over 27,000 items and at odd wide widths."""
    import torch

    from predictionio_tpu_torch.models.ncf.kernel import head_tensors

    cases = [(NCF_SERVE_USERS, NCF_SERVE_ITEMS, NCF_E, NCF_HIDDEN)]
    cases += [(64, n, NCF_E, NCF_HIDDEN) for n in NCF_SMALL_ITEMS]
    cases += [(64, 3001, 8, (16, 8)), (64, 3001, 5, (12, 7)), (64, 2049, 64, (128, 64))]
    cases += [(64, NCF_TRAIN_ITEMS, e, hidden) for e, hidden in NCF_WIDE]
    cases += [(64, 3001, 40, (300, 130)), (64, 2047, 100, (200, 70))]
    worst = worst_ratio = 0.0
    for users, items, e, hidden in cases:
        state = random_ncf_state(users, items, e, hidden, seed)
        gmf_users, mlp_users, head = head_tensors(state, items, "cuda")
        picked = sorted({0, 1, users // 2, users - 2, users - 1})
        err, ratio = compare_b3(gmf_users, mlp_users, head, picked)
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
        emit({"phase": "check_b3", "items": items, "embed": e, "hidden": list(hidden),
              "users_checked": picked, "max_abs_err": err,
              "max_err_over_bound": ratio, "tolerance": b3_tolerance(e, *hidden)})
        del gmf_users, mlp_users, head, state
        torch.cuda.empty_cache()
    return {"max_abs_err": worst, "max_err_over_bound": worst_ratio}


def phase_time_b3(seed: int) -> dict:
    """B3 and its plain version, CUDA-event medians, at 1,000,000 and at
    27,000 items (the template's widths) and at the wide towers over
    27,000 items, beside the bound."""
    import torch

    from predictionio_tpu_torch.models.ncf.kernel import (
        head_tensors,
        ncf_score_all_items,
        ncf_score_plain,
    )

    shapes = []
    cases = [(NCF_SERVE_ITEMS, NCF_E, NCF_HIDDEN), (NCF_TRAIN_ITEMS, NCF_E, NCF_HIDDEN)]
    cases += [(NCF_TRAIN_ITEMS, e, hidden) for e, hidden in NCF_WIDE]
    for items, embed, hidden in cases:
        state = random_ncf_state(64, items, embed, hidden, seed)
        gmf_users, mlp_users, (gi, mi, kernels, biases, out_k, out_b) = head_tensors(
            state, items, "cuda")
        args = (gi, mi, gmf_users[7], mlp_users[7], kernels, biases, out_k, out_b)
        ms = cuda_ms(lambda: ncf_score_all_items(*args))
        plain_ms = cuda_ms(lambda: ncf_score_plain(*args))
        bound_ms, bound_by, nbytes, ops = b3_bound(items, embed, *hidden)
        row = {"items": items, "embed": embed, "hidden": list(hidden),
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "bytes": nbytes, "operations": ops,
               "fraction_of_bound": bound_ms / ms}
        emit({"phase": "time_b3", **row})
        shapes.append(row)
        del gmf_users, mlp_users, gi, mi, args, state
        torch.cuda.empty_cache()
    return {"shapes": shapes}


class EpochLog:
    """``telemetry`` for ``NCFAlgorithm.train``: each epoch's wall seconds,
    every step's loss, and the seconds and rows of the negative sampling
    and of each epoch's permutation (seconds summed over epochs)."""

    def __init__(self):
        self.seconds: list[float] = []
        self.losses: list[float] = []
        self.phase_s: dict[str, float] = {}
        self.phase_rows: dict[str, int] = {}

    def record_epoch(self, epoch: int, seconds: float, losses: list[float]) -> None:
        self.seconds.append(seconds)
        self.losses.extend(losses)

    def record_phase(self, name: str, seconds: float, rows: int) -> None:
        self.phase_s[name] = self.phase_s.get(name, 0.0) + seconds
        self.phase_rows[name] = rows


def ncf_engine(repo: str) -> tuple[str, dict]:
    """(path, algorithm params) of the NCF template's engine.json."""
    path = os.path.join(repo, "examples", "ncf", "engine.json")
    with open(path) as f:
        return path, json.load(f)["algorithms"][0]["params"]


def heldout_pairs(rng: np.random.Generator, n: int):
    """``n`` fresh pairs by the stand-in's recipe (``make_ratings``: uniform
    users, squared-uniform Zipf items) and ``n`` uniform random pairs."""
    pos_u = rng.integers(0, TRAIN_USERS, n)
    pos_i = (np.minimum(rng.random(n) ** 2.2, 0.999999) * TRAIN_ITEMS).astype(np.int64)
    return (pos_u, pos_i), (rng.integers(0, TRAIN_USERS, n), rng.integers(0, TRAIN_ITEMS, n))


def phase_train_ncf(rng: np.random.Generator, ratings, repo: str) -> dict:
    """The NCF training path at full width: the template's engine.json
    (E=32, hidden 64, 32, batch 4096, lr 0.01, implicit, 4 negatives) on
    the ALS phase's 20M ratings, through NCFPreparator ->
    NCFAlgorithm.train on cuda; one cut, epochs 5 -> 1."""
    import torch

    from predictionio_tpu_torch.controller.base import TrainContext
    from predictionio_tpu_torch.models.ncf import NCFAlgorithm, NCFPreparator
    from predictionio_tpu_torch.models.ncf.model import NeuMF
    from predictionio_tpu_torch.models.recommendation import RatingsData

    users, items, values, times = ratings
    data = RatingsData(
        users=users, items=items, ratings=values, times=times,
        user_ids=[f"u{u}" for u in range(TRAIN_USERS)],
        item_ids=[f"i{i}" for i in range(TRAIN_ITEMS)],
    )
    _, params = ncf_engine(repo)
    params = dict(params, epochs=NCF_EPOCHS)
    algorithm = NCFAlgorithm(params, device="cuda")
    config = algorithm._config(data)
    log = EpochLog()
    ctx = TrainContext(device="cuda", telemetry=log, mesh_shape=[-1, 1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = algorithm.train(ctx, NCFPreparator().prepare(ctx, data))
    train_s = time.perf_counter() - t0
    peak_bytes = torch.cuda.max_memory_allocated()

    steps = len(log.losses)
    examples = log.phase_rows["negative_sampling"]
    if log.phase_rows["permutation"] != examples:
        raise AssertionError(f"{examples} examples sampled, "
                             f"{log.phase_rows['permutation']} permuted")
    expected = config.epochs * -(-examples // config.batch_size)
    if steps != expected:
        raise AssertionError(f"{steps} training steps, expected {expected}")
    for name, value in model.state.items():
        if not bool(torch.isfinite(value).all()):
            raise AssertionError(f"non-finite {name} after training")
    losses = np.asarray(log.losses)
    if not np.isfinite(losses).all():
        raise AssertionError("a NaN or infinite training loss")
    first, last = float(losses[:100].mean()), float(losses[-100:].mean())
    if not last < first:
        raise AssertionError(f"the training loss does not fall: {first} -> {last}")
    # held out: fresh pairs by the data's recipe score above uniform ones
    net = NeuMF(model.config)
    net.load_state_dict(model.state)
    net.to("cuda").eval()
    (pu, pi), (nu, ni) = heldout_pairs(rng, NCF_HOLDOUT)
    with torch.no_grad():
        pos = net(torch.from_numpy(pu).cuda(), torch.from_numpy(pi).cuda()).mean().item()
        neg = net(torch.from_numpy(nu).cuda(), torch.from_numpy(ni).cuda()).mean().item()
    if not pos > neg:
        raise AssertionError(f"held-out positives {pos} do not score above negatives {neg}")
    epoch_s = sum(log.seconds)
    result = {
        "users": TRAIN_USERS, "items": TRAIN_ITEMS, "positives": int(users.size),
        "examples": examples, "embed": config.embed_dim, "hidden": list(config.hidden),
        "batch_size": config.batch_size, "epochs": config.epochs, "steps": steps,
        "negative_sampling_s": log.phase_s["negative_sampling"],
        "permutation_s": log.phase_s["permutation"],
        "epoch_s": log.seconds, "steps_per_s": steps / epoch_s,
        "steps_per_s_without_permutation": steps / (epoch_s - log.phase_s["permutation"]),
        "train_s": train_s, "train_s_outside_epochs": train_s - epoch_s,
        "peak_device_bytes": peak_bytes,
        "loss_first_100": first, "loss_last_100": last,
        "heldout_positive_mean": pos, "heldout_negative_mean": neg,
    }
    emit({"phase": "train_ncf", **result})
    return {"result": result, "model": model}


def check_against_plain(served: dict, plain: np.ndarray, scale: np.ndarray, tol: float) -> None:
    """A served ``itemScores`` list against the plain head's scores of
    the same user (excluded items at -inf): each score within ``tol``
    times its item's S of the plain score, and the items are the plain
    top-k up to items whose plain score lies within twice the largest
    such bound of the k-th."""
    got = [(int(s["item"][1:]), s["score"]) for s in served["itemScores"]]
    k = len(got)
    if k == 0:
        raise AssertionError("a known user was served no items")
    for j, score in got:
        if not abs(score - plain[j]) <= tol * scale[j] + 1e-30:
            raise AssertionError(f"item i{j}: served {score}, plain {plain[j]}")
    order = np.argsort(-plain, kind="stable")
    kth = plain[order[k - 1]]
    slack = 2 * tol * float(scale[np.isfinite(plain)].max())
    top = set(order[:k].tolist())
    mine = {j for j, _ in got}
    for j in top ^ mine:
        if not abs(plain[j] - kth) <= slack:
            raise AssertionError(f"item i{j} is in one top-{k} only, {plain[j]} vs {kth}")


def phase_serve_ncf(rng: np.random.Generator, trained: dict, repo: str, workdir: str) -> dict:
    """The trained NCF model saved, deployed through the ``deploy`` code
    path on cuda and queried over HTTP; B3 launches counted from 0
    before the queries; the served top-10 held to the plain head on the
    card, and ``batch_predict`` (plain batch scorer) to both."""
    import torch

    from predictionio_tpu_torch.models.ncf import save_model
    from predictionio_tpu_torch.models.ncf import kernel as ncf_kernel
    from predictionio_tpu_torch.models.ncf.kernel import head_tensors, ncf_score_plain
    from predictionio_tpu_torch.tools.cli import build_query_server

    model = trained["model"]
    model_dir = os.path.join(workdir, "ncf_model")
    t0 = time.perf_counter()
    save_model(model, model_dir)
    save_s = time.perf_counter() - t0
    engine_json, _ = ncf_engine(repo)
    picked = rng.choice(TRAIN_USERS, size=256 + 10, replace=False)
    users = [f"u{u}" for u in picked[:10]]
    queries = (
        [{"user": u, "num": 10} for u in users[:6]]
        + [{"user": users[6], "num": 10, "blackList": ["i0", "i1", "i2", "i3"]},
           {"user": users[7], "num": 10, "unseenOnly": False},
           {"user": users[8], "num": 20, "unseenOnly": False},
           {"user": users[9], "num": 10},
           {"user": "cold-user", "num": 10}]
    )
    known = sum(1 for q in queries if q["user"] != "cold-user")
    batch = [(qid, {"user": f"u{u}", "num": 10}) for qid, u in enumerate(picked[10:])]

    t0 = time.perf_counter()
    server, service = build_query_server(engine_json, model_dir, port=0, device="cuda")
    deploy_s = time.perf_counter() - t0
    algo, deployed = service.algorithms[0], service.models[0]
    if not algo.use_kernel:
        raise AssertionError("usePallas is off on cuda: B3 would not serve")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
    try:
        ncf_kernel.ncf_score_all_items.launches = 0   # counts start at 0 here
        served, latencies = [], []
        for q in queries:
            body, ms = post(conn, q)
            served.append(body)
            latencies.append(ms)
        launches = ncf_kernel.ncf_score_all_items.launches  # read here
        t0 = time.perf_counter()
        batched = dict(algo.batch_predict(deployed, batch))
        batch_s = time.perf_counter() - t0
        http_query_ms = host_ms(lambda: post(conn, queries[0]))
    finally:
        conn.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("query server thread did not stop")
    if launches != known:
        raise AssertionError(f"{launches} B3 launches for {known} known-user queries")
    if served[-1] != {"itemScores": []}:
        raise AssertionError(f"the cold user was answered {served[-1]}")

    gmf_users, mlp_users, head = head_tensors(deployed.state, len(deployed.item_ids), "cuda")
    gi, mi, kernels, biases, out_k, out_b = head
    abs_head = (gi.abs(), mi.abs(), [k.abs() for k in kernels], [b.abs() for b in biases],
                out_k.abs(), out_b.abs())
    tol = b3_tolerance(gi.shape[1], kernels[0].shape[1], kernels[1].shape[1])

    def plain_for(query) -> tuple[np.ndarray, np.ndarray]:
        u = deployed.user_index[query["user"]]
        plain = ncf_score_plain(gi, mi, gmf_users[u], mlp_users[u], kernels, biases,
                                out_k, out_b).double().cpu().numpy()
        scale = ncf_score_plain(abs_head[0], abs_head[1], gmf_users[u].abs(),
                                mlp_users[u].abs(), *abs_head[2:]).double().cpu().numpy()
        exclude = {deployed.item_index[b] for b in query.get("blackList") or []}
        if query.get("unseenOnly", True):
            exclude |= deployed.seen.get(u, set())
        plain[list(exclude)] = -np.inf
        return plain, scale

    for q, body in zip(queries[:-1], served[:-1]):
        check_against_plain(body, *plain_for(q), tol)
    batch_diff = 0.0
    for qid, q in batch:
        plain, scale = plain_for(q)
        check_against_plain(batched[qid], plain, scale, tol)
        single = algo.predict(deployed, q)
        check_against_plain(single, plain, scale, tol)
        # batch_predict (plain batch scorer) against predict (B3), item by item
        by_item = {s["item"]: s["score"] for s in single["itemScores"]}
        for s in batched[qid]["itemScores"]:
            if s["item"] in by_item:
                diff = abs(s["score"] - by_item[s["item"]])
                if not diff <= tol * scale[deployed.item_index[s["item"]]] + 1e-30:
                    raise AssertionError(f"{s['item']}: batch {s['score']}, "
                                         f"predict {by_item[s['item']]}")
                batch_diff = max(batch_diff, diff)
    # where a query's time goes, host clock, after the counts were read
    u0 = deployed.user_index[queries[0]["user"]]
    scorer = deployed.scorer(algo.device, True)
    scores = scorer(u0)
    result = {
        "users": TRAIN_USERS, "items": len(deployed.item_ids), "queries": len(queries),
        "known_user_queries": known, "launches": {"ncf_score_all_items": launches},
        "save_s": save_s, "deploy_s": deploy_s,
        "query_ms_p50": statistics.median(latencies), "query_ms_max": max(latencies),
        "http_query_ms_p50": http_query_ms,
        "predict_ms_p50": host_ms(lambda: algo.predict(deployed, queries[0])),
        "scorer_ms_p50": host_ms(lambda: scorer(u0)),
        "topk_ms_p50": host_ms(lambda: algo._topk_response(deployed, scores, queries[0], u0)),
        "batch_predict_users": len(batch), "batch_predict_s": batch_s,
        "batch_vs_predict_max_abs_diff": batch_diff,
    }
    emit({"phase": "serve_ncf", **result})
    return result


def phase_serve_ncf_wide(rng: np.random.Generator, seed: int, repo: str, workdir: str) -> dict:
    """A NeuMF model at the first wide width (E=64, hidden 256, 128; random
    weights from ``seed``, 27,000 items) saved, deployed through the
    ``deploy`` code path on cuda with an engine.json of that width, and
    asked for the top 10 of known users over HTTP: each answer 200 through
    B3 (launches counted from 0 before the queries) and each list the
    plain head's on the card up to near-ties."""
    from predictionio_tpu_torch.models.ncf import kernel as ncf_kernel
    from predictionio_tpu_torch.models.ncf import model_from_state, save_model
    from predictionio_tpu_torch.models.ncf.kernel import head_tensors, ncf_score_plain

    embed, hidden = NCF_WIDE[0]
    items = NCF_TRAIN_ITEMS
    state = random_ncf_state(NCF_WIDE_USERS, items, embed, hidden, seed)
    seen_users = np.repeat(np.arange(NCF_WIDE_USERS), 20)
    seen_items = rng.integers(0, items, seen_users.size)
    model = model_from_state(state, [f"u{u}" for u in range(NCF_WIDE_USERS)],
                             [f"i{i}" for i in range(items)], seen_users, seen_items)
    model_dir = os.path.join(workdir, "ncf_wide")
    save_model(model, model_dir)
    with open(ncf_engine(repo)[0]) as f:
        variant = json.load(f)
    variant["algorithms"][0]["params"].update({"embedDim": embed, "hidden": list(hidden)})
    engine_json = os.path.join(workdir, "ncf_wide_engine.json")
    with open(engine_json, "w") as f:
        json.dump(variant, f)
    picked = rng.choice(NCF_WIDE_USERS, size=NCF_WIDE_QUERIES, replace=False)
    queries = [{"user": f"u{u}", "num": 10} for u in picked]
    before = ncf_kernel.ncf_score_all_items.launches     # counts start here
    served, deployed, deploy_s = serve_model(engine_json, model_dir, queries)
    launches = ncf_kernel.ncf_score_all_items.launches - before - 1  # less the warm-up's
    if launches != len(queries):
        raise AssertionError(f"{launches} B3 launches for {len(queries)} wide-model queries")

    gmf_users, mlp_users, head = head_tensors(deployed.state, items, "cuda")
    gi, mi, kernels, biases, out_k, out_b = head
    abs_head = (gi.abs(), mi.abs(), [k.abs() for k in kernels], [b.abs() for b in biases],
                out_k.abs(), out_b.abs())
    tol = b3_tolerance(embed, *hidden)
    for q, body in zip(queries, served):
        u = deployed.user_index[q["user"]]
        plain = ncf_score_plain(gi, mi, gmf_users[u], mlp_users[u], kernels, biases,
                                out_k, out_b).double().cpu().numpy()
        scale = ncf_score_plain(abs_head[0], abs_head[1], gmf_users[u].abs(),
                                mlp_users[u].abs(), *abs_head[2:]).double().cpu().numpy()
        plain[list(deployed.seen.get(u, set()))] = -np.inf
        check_against_plain(body, plain, scale, tol)
    result = {"embed": embed, "hidden": list(hidden), "users": NCF_WIDE_USERS, "items": items,
              "queries": len(queries), "launches": {"ncf_score_all_items": launches},
              "deploy_s": deploy_s}
    emit({"phase": "serve_ncf_wide", **result})
    return result


def phase_train_verb_ncf(rng: np.random.Generator, repo: str, workdir: str) -> dict:
    """The ``train`` verb with the NCF template's engine.json on a small
    events file, and ``deploy`` of the model it wrote."""
    from predictionio_tpu_torch.models.ncf import kernel as ncf_kernel
    from predictionio_tpu_torch.tools import cli

    engine_json, _ = ncf_engine(repo)
    events = os.path.join(workdir, "ncf_events.jsonl")
    n_events, user = small_events(rng, events)
    model_dir = os.path.join(workdir, "ncf_small")
    t0 = time.perf_counter()
    if cli.main(["train", "--engine-json", engine_json, "--events", events,
                 "--model-out", model_dir, "--device", "cuda"]) != 0:
        raise AssertionError("the train verb failed")
    verb_s = time.perf_counter() - t0
    before = ncf_kernel.ncf_score_all_items.launches
    served, small, _ = serve_model(engine_json, model_dir, [{"user": user, "num": 5}])
    launches = ncf_kernel.ncf_score_all_items.launches - before
    if len(served[0]["itemScores"]) != 5 or user not in small.user_index or launches < 2:
        raise AssertionError(f"the trained small NCF model answered {served[0]} "
                             f"with {launches} B3 launches (warm-up and query)")
    result = {"events": n_events, "train_verb_s": verb_s, "b3_launches": launches,
              "epochs": small.config.epochs}
    emit({"phase": "train_verb_ncf", **result})
    return result


# --------------------------------------------------------------------------
# the sequence template: kernel B4 (csrc/flash_attention.cu) and the fused
# backward (csrc/flash_backward.cu)
# --------------------------------------------------------------------------


FLASH_KERNELS = ("flash_forward", "flash_backward")


def flash_counts() -> dict:
    from predictionio_tpu_torch.ops import flash_attention as fa

    return {name: getattr(fa, name).launches for name in FLASH_KERNELS}


def zero_flash_counts() -> None:
    from predictionio_tpu_torch.ops import flash_attention as fa

    for name in FLASH_KERNELS:
        getattr(fa, name).launches = 0


@contextlib.contextmanager
def plain_flash():
    """Route the flash-attention Function, and so SASRec's attention on
    cuda, through the kernels' plain versions: the comparison path of
    ``train_seq`` and ``serve_seq``."""
    from predictionio_tpu_torch.ops import flash_attention as fa

    kernels = {name: getattr(fa, name) for name in FLASH_KERNELS}
    for name in FLASH_KERNELS:
        setattr(fa, name, getattr(fa, f"{name}_plain"))
    try:
        yield
    finally:
        for name, fn in kernels.items():
            setattr(fa, name, fn)


def sequence_engine(repo: str) -> tuple[str, dict]:
    """(path, engine.json object) of the sequence template."""
    path = os.path.join(repo, "examples", "sequence", "engine.json")
    with open(path) as f:
        return path, json.load(f)


def phase_seq_data(ratings, repo: str) -> dict:
    """The 20M ratings as view events, grouped per user in time order by
    the DataSource's ``group_sequences``; each user's last item held out,
    the rest packed by SequencePreparator."""
    from predictionio_tpu_torch.controller.base import TrainContext
    from predictionio_tpu_torch.models.sequence import SequencePreparator, SequencesData
    from predictionio_tpu_torch.models.sequence.engine import group_sequences

    users, items, _, times = ratings
    _, variant = sequence_engine(repo)
    t0 = time.perf_counter()
    sequences, user_ids = group_sequences(
        users, items, times, [f"u{u}" for u in range(TRAIN_USERS)],
        variant["datasource"]["params"].get("minSeqLen", 2))
    group_s = time.perf_counter() - t0
    held = np.fromiter((s[-1] for s in sequences), np.int64, len(sequences))
    data = SequencesData([s[:-1] for s in sequences], user_ids,
                         [f"i{i}" for i in range(TRAIN_ITEMS)])
    data.sanity_check()
    t0 = time.perf_counter()
    prepared = SequencePreparator(variant["preparator"]["params"]).prepare(
        TrainContext(device="cuda"), data)
    pack_s = time.perf_counter() - t0
    lengths = np.fromiter((len(s) for s in data.sequences), np.int64, len(data.sequences))
    result = {"users": len(user_ids), "events": int(users.size),
              "matrix": list(prepared.matrix.shape), "group_s": group_s, "pack_s": pack_s,
              "history_len_min": int(lengths.min()), "history_len_median": float(np.median(lengths)),
              "padded_fraction": float((prepared.matrix == 0).mean())}
    emit({"phase": "seq_data", **result})
    return {"result": result, "prepared": prepared, "held_out": held, "variant": variant}


def flash_inputs(gen, b: int, h: int, t: int, d: int, mask):
    import torch

    q, k, v, do = (torch.randn((b, t, h, d), device="cuda", generator=gen) for _ in range(4))
    return q, k, v, mask.cuda() if mask is not None else None, do


def compare_flash(q, k, v, mask, do, causal: bool, dead_rows=()) -> dict:
    """B4 and the fused backward against their plain versions on the same
    inputs (the backward from the plain forward's out and lse), through
    the wrappers (a head dim the kernels are not built for goes through
    the padding, held to the plain versions at the caller's D); raises
    beyond FLASH_TOL x max(1, max|plain|) per output, on a NaN, on a row
    with no valid key or a masked key whose output or gradient is not
    exactly 0. Returns the max abs error per kernel."""
    import torch

    from predictionio_tpu_torch.ops import flash_attention as fa

    out, lse = fa.flash_forward(q, k, v, mask, causal)
    p_out, p_lse = fa.flash_forward_plain(q, k, v, mask, causal)
    fused = fa.flash_backward(q, k, v, mask, do, p_out, p_lse, causal)
    torch.cuda.synchronize()
    p_fused = fa.flash_backward_plain(q, k, v, mask, do, p_out, p_lse, causal)
    errs = {}
    for name, got, want in (("flash_forward", out, p_out), ("lse", lse, p_lse),
                            *zip(("fused_dq", "fused_dk", "fused_dv"), fused, p_fused)):
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: shape {tuple(got.shape)} or a non-finite value "
                                 "from the kernel")
        live = want[want > -1e29]
        scale = max(1.0, float(live.abs().max())) if live.numel() else 1.0
        err = float((got - want).abs().max()) if got.numel() else 0.0
        if err > FLASH_TOL * scale:
            raise AssertionError(f"{name} differs from the plain version by {err} "
                                 f"> {FLASH_TOL} x {scale}")
        errs[name] = err
    for b, rows in dead_rows:
        if (out[b, :rows].any() or fused[0][b, :rows].any()
                or bool((lse[b, :, :rows] > -1e29).any())):
            raise AssertionError(f"batch row {b}: a query with no valid key is not 0")
    if mask is not None:
        for name, grad in (("fused_dk", fused[1]), ("fused_dv", fused[2])):
            if grad[~mask].any():
                raise AssertionError(f"{name}: a masked key's gradient is not 0")
    return {"flash_forward": max(errs["flash_forward"], errs["lse"]),
            "flash_backward": max(errs["fused_dq"], errs["fused_dk"], errs["fused_dv"])}


def phase_check_flash(seed: int, seq: dict) -> dict:
    """B4 and the fused backward against their plain versions on the card:
    the training shape with the packed rows' own masks, with random right
    padding (serving's prefixes) and with left padding; every listed
    T x D, causal and not, with a fully-masked batch row and left-padded
    rows; head dims 24 (padded) and 128 at T 64 and 1024; then 20 SASRec
    steps at embedDim 48 / 2 heads (D = 24) through the kernels against
    the same steps through the plain versions."""
    import torch

    from predictionio_tpu_torch.models.sequence.model import SASRecConfig, train_sasrec

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    b, h, t, d = SEQ_TRAIN_SHAPE
    rows = torch.from_numpy(seq["prepared"].matrix[:b] > 0)
    lengths = rng.integers(1, t + 1, b)
    masks = {
        "packed_rows": (rows, ()),
        "right_padded": (torch.from_numpy(np.arange(t)[None] < lengths[:, None]), ()),
        "left_padded": (torch.from_numpy(np.arange(t)[None] >= (t - lengths)[:, None]),
                        [(i, int(t - n)) for i, n in enumerate(lengths[:8])]),
    }
    worst: dict = {}
    cases = 0
    for name, (mask, dead) in masks.items():
        for causal in (True, False):
            errs = compare_flash(*flash_inputs(gen, b, h, t, d, mask), causal,
                                 dead if causal else ())
            cases += 1
            emit({"phase": "check_flash", "case": name, "shape": [b, t, h, d],
                  "causal": causal, "max_abs_err": errs})
            for k, e in errs.items():
                worst[k] = max(worst.get(k, 0.0), e)
    for t in FLASH_CHECK_T:
        for d in FLASH_CHECK_D:
            pads = (0, t // 3, t)  # batch row 2: every key masked
            mask = torch.from_numpy(np.arange(t)[None] >= np.asarray(pads)[:, None])
            for causal in (True, False):
                dead = [(1, t // 3), (2, t)] if causal else [(2, t)]
                errs = compare_flash(*flash_inputs(gen, 3, 2, t, d, mask), causal, dead)
                cases += 1
                for k, e in errs.items():
                    worst[k] = max(worst.get(k, 0.0), e)
            emit({"phase": "check_flash", "case": "sizes", "shape": [3, t, 2, d],
                  "max_abs_err_so_far": dict(worst)})
        torch.cuda.empty_cache()
    padded: dict = {}
    for t in FLASH_PADDED_T:
        pads = (0, t // 3, t)
        mask = torch.from_numpy(np.arange(t)[None] >= np.asarray(pads)[:, None])
        for d in FLASH_PADDED_D:
            for causal in (True, False):
                dead = [(1, t // 3), (2, t)] if causal else [(2, t)]
                errs = compare_flash(*flash_inputs(gen, 3, 2, t, d, mask), causal, dead)
                cases += 1
                for k, e in errs.items():
                    worst[k] = max(worst.get(k, 0.0), e)
                    padded[f"{k}_d{d}"] = max(padded.get(f"{k}_d{d}", 0.0), e)
        torch.cuda.empty_cache()
    emit({"phase": "check_flash", "case": "head_dims", "t": list(FLASH_PADDED_T),
          "d": list(FLASH_PADDED_D), "max_abs_err": padded})
    # SASRec at a head dim of 24 (embedDim 48, 2 heads): 20 steps through
    # B4 and the fused backward (zero-padded to 32) against the plain
    # versions, from the same seeded init
    params = seq["variant"]["algorithms"][0]["params"]
    prepared = seq["prepared"]
    config = SASRecConfig(
        num_items=TRAIN_ITEMS, max_len=prepared.matrix.shape[1], embed_dim=SEQ_PADDED_EMBED,
        num_heads=SEQ_PADDED_HEADS, num_blocks=params.get("numBlocks", 2),
        ffn_dim=params.get("ffnDim", 64), learning_rate=params.get("learningRate", 1e-3),
        batch_size=params.get("batchSize", 256), epochs=1, seed=params.get("seed", 0))
    part = prepared.matrix[: SEQ_PLAIN_STEPS * config.batch_size]
    before = flash_counts()
    _, kernel_losses = train_sasrec(config, part, "cuda", log_every=1)
    launched = {k: n - before[k] for k, n in flash_counts().items()}
    if launched != {k: config.num_blocks * SEQ_PLAIN_STEPS for k in FLASH_KERNELS}:
        raise AssertionError(f"head dim 24 steps launched {launched}")
    with plain_flash():
        _, plain_losses = train_sasrec(config, part, "cuda", log_every=1)
    d24_diff = float(np.abs(np.asarray(kernel_losses) - np.asarray(plain_losses)).max())
    if len(kernel_losses) != SEQ_PLAIN_STEPS or d24_diff > 1e-4:
        raise AssertionError(f"{len(kernel_losses)} head-dim-24 steps through the kernels "
                             f"differ from the plain versions by {d24_diff} > 1e-4")
    emit({"phase": "check_flash", "case": "sasrec_head_dim_24", "embed": config.embed_dim,
          "heads": config.num_heads, "steps": SEQ_PLAIN_STEPS, "launches": launched,
          "kernel_vs_plain_max_loss_diff": d24_diff})
    return {"max_abs_err": worst, "cases": cases, "padded_max_abs_err": padded,
            "sasrec_d24_loss_diff": d24_diff}


def causal_pairs(mask) -> int:
    """(query, key) pairs a causal pass over ``mask`` [B, T] needs per
    head: valid keys at or before each query."""
    t = mask.shape[1]
    return int((mask.astype(np.int64) * (t - np.arange(t))[None]).sum())


def flash_bound(kernel: str, b: int, h: int, t: int, d: int, pairs: int):
    """(bound ms, what bounds it, bytes, operations) of one call: inputs
    read once, outputs written once (f32 tensors of B T H D, [B, T] mask
    bytes, [B, H, T] lse); operations on the causal valid pairs only: per
    pair 2D for q.k and 2D for each further product (B4: P V; the fused
    backward: dO.v, P dO, dS q, dS k), plus 2D a row for the fused
    backward's delta. Both kernels run the pairs' products on the tensor
    cores in 3xTF32, so they count at F32_3XTF32_OPS_PER_S; the delta rows
    at the f32 units' rate."""
    n, rows = b * t * h * d * 4, b * h * t * 4
    nbytes, per_pair, per_row = {
        "flash_forward": (3 * n + b * t + n + rows, 4 * d, 0),
        "flash_backward": (5 * n + b * t + rows + 3 * n, 10 * d, 2 * d),
    }[kernel]
    pair_ops, row_ops = float(per_pair * pairs * h), float(per_row * b * h * t)
    ops = pair_ops + row_ops
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = pair_ops / F32_3XTF32_OPS_PER_S + row_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def sdpa_backend(q, k, v, attn_mask) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these
    inputs, as PyTorch reports it."""
    import torch

    try:
        from torch.nn.attention import SDPBackend

        choice = torch._fused_sdp_choice(q, k, v, attn_mask, 0.0, False)
        return SDPBackend(choice).name
    except (AttributeError, RuntimeError, ValueError) as exc:
        return f"unknown ({type(exc).__name__})"


def phase_time_flash(seed: int, seq: dict) -> dict:
    """B4, the fused backward, their plain versions and SDPA (forward, and
    its backward beside the fused kernel) at the training shape, with the
    packed rows' masks, and at the long shape, all keys valid; then both
    again at head dims 24 (padded) and 128; beside each kernel's bound."""
    import torch
    import torch.nn.functional as F

    from predictionio_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = []
    for name, (b, h, t, d) in (("train", SEQ_TRAIN_SHAPE), ("long", SEQ_LONG_SHAPE),
                               ("train_d24", SEQ_TRAIN24_SHAPE),
                               ("long_d128", SEQ_LONG128_SHAPE)):
        if name.startswith("train"):
            mask = torch.from_numpy(seq["prepared"].matrix[:b] > 0)
        else:
            mask = torch.ones((b, t), dtype=torch.bool)
        pairs = causal_pairs(mask.numpy())
        q, k, v, mask, do = flash_inputs(gen, b, h, t, d, mask)
        out, lse = fa.flash_forward(q, k, v, mask)
        calls = {
            "flash_forward": (lambda: fa.flash_forward(q, k, v, mask),
                              lambda: fa.flash_forward_plain(q, k, v, mask)),
            "flash_backward": (lambda: fa.flash_backward(q, k, v, mask, do, out, lse),
                               lambda: fa.flash_backward_plain(q, k, v, mask, do, out, lse)),
        }
        # the library yardstick: SDPA in its own [B, H, T, D] layout with
        # the same boolean mask (causal and key validity in one)
        bh = [x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v)]
        causal = torch.ones((t, t), dtype=torch.bool, device="cuda").tril()
        attn_mask = (causal[None, None] & mask[:, None, None, :]).contiguous()
        backend = sdpa_backend(*bh, attn_mask)
        sdpa_out = F.scaled_dot_product_attention(*bh, attn_mask=attn_mask)
        g = do.transpose(1, 2).contiguous()

        def sdpa_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(*bh, attn_mask=attn_mask)

        def sdpa_bwd():
            return torch.autograd.grad(sdpa_out, bh, g, retain_graph=True)

        # "ms" is device time (profiler); "call_ms" the CUDA-event time of
        # one call, which also holds the host's launch overhead
        library = {"fwd": timed_pair(sdpa_fwd), "bwd": timed_pair(sdpa_bwd)}
        sdpa_err = float((sdpa_out.detach().transpose(1, 2) - out).abs().max())
        row = {"shape": name, "batch": b, "heads": h, "t": t, "d": d, "causal_pairs": pairs * h,
               "sdpa_backend": backend, "sdpa_fwd_ms": library["fwd"][0],
               "sdpa_fwd_call_ms": library["fwd"][1], "sdpa_bwd_ms": library["bwd"][0],
               "sdpa_bwd_call_ms": library["bwd"][1], "sdpa_max_abs_diff": sdpa_err,
               "kernels": {}}
        for kernel, (fn, plain) in calls.items():
            (ms, call_ms), (plain_ms, plain_call_ms) = timed_pair(fn), timed_pair(plain)
            bound_ms, bound_by, nbytes, ops = flash_bound(kernel, b, h, t, d, pairs)
            lib_ms, lib_call_ms = library["fwd" if kernel == "flash_forward" else "bwd"]
            row["kernels"][kernel] = {
                "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                "plain_call_ms": plain_call_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes": nbytes, "operations": ops, "fraction_of_bound": bound_ms / ms,
                "library_ms": lib_ms, "library_call_ms": lib_call_ms,
            }
        emit({"phase": "time_flash", **row})
        shapes.append(row)
        del q, k, v, do, bh, sdpa_out, out, lse
        torch.cuda.empty_cache()
    return {"shapes": shapes}


def hit_at_10(model, held_out: np.ndarray) -> float:
    """Share of users whose held-out last item is in the top 10 of the
    next-item scores after their trained-in history (no exclusions)."""
    import torch

    from predictionio_tpu_torch.models.sequence.model import next_item_scores, pack_prefixes

    net = model.network("cuda")
    users = list(model.histories)
    index = {u: j for j, u in enumerate(model.histories)}
    hits = 0
    for start in range(0, len(users), SEQ_HIT_BATCH):
        part = users[start : start + SEQ_HIT_BATCH]
        seqs, last = pack_prefixes([model.histories[u] for u in part], model.config.max_len)
        scores = next_item_scores(net, torch.from_numpy(seqs).cuda(), torch.from_numpy(last).cuda())
        top = scores[:, 1:].topk(10, dim=1).indices.cpu().numpy()
        want = held_out[[index[u] for u in part]]
        hits += int((top == want[:, None]).any(axis=1).sum())
    return hits / len(users)


def phase_train_seq(seq: dict) -> dict:
    """The sequence template's training path at full width: the packed
    20M-event sequences through SASRecAlgorithm.train on cuda, B4 and the
    fused backward counted; then the quality and kernel-against-plain
    checks."""
    import torch

    from predictionio_tpu_torch.controller.base import TrainContext
    from predictionio_tpu_torch.models.sequence import SASRecAlgorithm
    from predictionio_tpu_torch.models.sequence.model import train_sasrec

    variant, prepared = seq["variant"], seq["prepared"]
    algorithm = SASRecAlgorithm(variant["algorithms"][0]["params"], device="cuda")
    log = EpochLog()
    ctx = TrainContext(device="cuda", telemetry=log,
                       mesh_shape=variant["sparkConf"]["pio.mesh_shape"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_flash_counts()                       # counts start at 0 here
    t0 = time.perf_counter()
    model = algorithm.train(ctx, prepared)
    train_s = time.perf_counter() - t0
    launches = flash_counts()                 # read here
    peak_bytes = torch.cuda.max_memory_allocated()
    config = model.config

    steps = len(log.losses)
    expected = config.epochs * -(-prepared.matrix.shape[0] // config.batch_size)
    if steps != expected:
        raise AssertionError(f"{steps} training steps, expected {expected}")
    for name, n in launches.items():
        want = config.num_blocks * steps
        if n != want:
            raise AssertionError(f"{n} {name} launches for {steps} steps of "
                                 f"{config.num_blocks} blocks, expected {want}")
    for name, value in model.state.items():
        if not bool(torch.isfinite(value).all()):
            raise AssertionError(f"non-finite {name} after training")
    losses = np.asarray(log.losses)
    if not np.isfinite(losses).all():
        raise AssertionError("a NaN or infinite training loss")
    first, last = float(losses[:100].mean()), float(losses[-100:].mean())
    if not last < first:
        raise AssertionError(f"the training loss does not fall: {first} -> {last}")
    t0 = time.perf_counter()
    hit = hit_at_10(model, seq["held_out"])
    hit_s = time.perf_counter() - t0
    uniform = 10 / config.num_items
    if not hit > uniform:
        raise AssertionError(f"hit@10 {hit} is not above uniform {uniform}")
    # the same first steps through the kernels and through their plain
    # versions on the card: a 20-batch slice of the packed rows, one epoch
    part = prepared.matrix[: SEQ_PLAIN_STEPS * config.batch_size]
    few = dataclasses.replace(config, epochs=1)
    before = flash_counts()
    kernel_losses = []
    # the kernel run is traced: where a step's device time goes, and the
    # card's busy share of the run's wall time
    trace, trace_wall_s = device_trace(
        lambda: kernel_losses.extend(train_sasrec(few, part, "cuda", log_every=1)[1]), 1)
    if (flash_counts()["flash_backward"] - before["flash_backward"]
            != config.num_blocks * SEQ_PLAIN_STEPS):
        raise AssertionError("the kernel run of the comparison did not launch the fused "
                             "backward every step")
    step_device_ms = sum(trace.values()) / SEQ_PLAIN_STEPS
    top = sorted(trace.items(), key=lambda kv: -kv[1])[:8]
    before = flash_counts()
    with plain_flash():
        _, plain_losses = train_sasrec(few, part, "cuda", log_every=1)
    if flash_counts() != before:
        raise AssertionError("the plain run of the comparison launched a kernel")
    plain_diff = float(np.abs(np.asarray(kernel_losses) - np.asarray(plain_losses)).max())
    if len(kernel_losses) != SEQ_PLAIN_STEPS or plain_diff > 1e-4:
        raise AssertionError(f"{len(kernel_losses)} steps through the kernels differ from "
                             f"the plain versions by {plain_diff} > 1e-4")
    epoch_s = sum(log.seconds)
    result = {
        "users": len(model.histories), "items": config.num_items,
        "sequences": list(prepared.matrix.shape), "embed": config.embed_dim,
        "heads": config.num_heads, "blocks": config.num_blocks, "ffn": config.ffn_dim,
        "batch_size": config.batch_size, "epochs": config.epochs, "steps": steps,
        "launches": launches, "epoch_s": log.seconds, "steps_per_s": steps / epoch_s,
        "train_s": train_s, "train_s_outside_epochs": train_s - epoch_s,
        "peak_device_bytes": peak_bytes,
        "loss_first_100": first, "loss_last_100": last, "loss_last": float(losses[-1]),
        "hit_at_10": hit, "hit_at_10_uniform": uniform, "hit_at_10_s": hit_s,
        "kernel_vs_plain_steps": SEQ_PLAIN_STEPS, "kernel_vs_plain_max_loss_diff": plain_diff,
        "traced_steps": SEQ_PLAIN_STEPS, "traced_wall_s": trace_wall_s,
        "traced_device_ms_per_step": step_device_ms,
        "traced_device_busy_share": step_device_ms * SEQ_PLAIN_STEPS / 1e3 / trace_wall_s,
        "traced_top_kernels_ms_per_step": {k: v / SEQ_PLAIN_STEPS for k, v in top},
        "traced_flash_ms_per_step": {k: v / SEQ_PLAIN_STEPS for k, v in trace.items()
                                     if "flash_" in k},
    }
    emit({"phase": "train_seq", **result})
    return {"result": result, "model": model}


def check_seq_list(served: dict, plain: np.ndarray, tol: float) -> None:
    """A served ``itemScores`` list against the plain path's scores
    (excluded items at -inf): each score within ``tol`` of the plain one,
    and the items the plain top-k up to items within 2 ``tol`` of the
    k-th score."""
    got = [(int(s["item"][1:]), s["score"]) for s in served["itemScores"]]
    k = len(got)
    if k == 0:
        raise AssertionError("a known prefix was served no items")
    for j, score in got:
        if not abs(score - plain[j]) <= tol:
            raise AssertionError(f"item i{j}: served {score}, plain {plain[j]}")
    order = np.argsort(-plain, kind="stable")
    kth = plain[order[k - 1]]
    for j in set(order[:k].tolist()) ^ {j for j, _ in got}:
        if not abs(plain[j] - kth) <= 2 * tol:
            raise AssertionError(f"item i{j} is in one top-{k} only, {plain[j]} vs {kth}")


def phase_serve_seq(rng: np.random.Generator, trained: dict, repo: str, workdir: str) -> dict:
    """The trained SASRec saved, deployed through the ``deploy`` code path
    on cuda and queried over HTTP; B4 launches counted from 0 before the
    queries; every list held to the plain path on the card, and the
    256-user ``batch_predict`` to predict."""
    from predictionio_tpu_torch.models.sequence import save_model
    from predictionio_tpu_torch.models.sequence.model import score_next_items
    from predictionio_tpu_torch.tools.cli import build_query_server

    model = trained["model"]
    model_dir = os.path.join(workdir, "seq_model")
    t0 = time.perf_counter()
    save_model(model, model_dir)
    save_s = time.perf_counter() - t0
    engine_json, _ = sequence_engine(repo)
    picked = rng.choice(TRAIN_USERS, size=256 + 8, replace=False)
    users = [f"u{u}" for u in picked[:8]]
    session = lambda n: [f"i{i}" for i in rng.choice(TRAIN_ITEMS, size=n, replace=False)]
    queries = (
        [{"user": u, "num": 10} for u in users[:4]]
        + [{"user": users[4], "num": 10, "blackList": ["i0", "i1", "i2", "i3"]},
           {"user": users[5], "num": 20, "unseenOnly": False},
           {"items": session(1), "num": 10},
           {"items": session(3), "num": 10, "unseenOnly": False},
           {"items": session(10), "num": 10, "blackList": ["i0"]},
           {"items": session(5) + ["no-such-item"], "num": 15},
           {"user": "cold-user", "num": 10},
           {"items": ["no-such-item"], "num": 10}]
    )
    batch = [(qid, {"user": f"u{u}", "num": 10}) for qid, u in enumerate(picked[8:])]

    t0 = time.perf_counter()
    server, service = build_query_server(engine_json, model_dir, port=0, device="cuda")
    deploy_s = time.perf_counter() - t0
    algo, deployed = service.algorithms[0], service.models[0]
    forwards = sum(1 for q in queries if algo._resolve_prefix(deployed, q) is not None
                   and len(algo._resolve_prefix(deployed, q))) + 1   # + the one batch slice
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
    try:
        zero_flash_counts()                   # counts start at 0 here
        served, latencies = [], []
        for q in queries:
            body, ms = post(conn, q)
            served.append(body)
            latencies.append(ms)
        t0 = time.perf_counter()
        batched = dict(algo.batch_predict(deployed, batch))
        batch_s = time.perf_counter() - t0
        launches = flash_counts()["flash_forward"]   # read here
        http_query_ms = host_ms(lambda: post(conn, queries[0]))
    finally:
        conn.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("query server thread did not stop")
    blocks = deployed.config.num_blocks
    if launches != blocks * forwards:
        raise AssertionError(f"{launches} B4 launches for {forwards} forwards of {blocks} blocks")
    if served[-2] != {"itemScores": []} or served[-1] != {"itemScores": []}:
        raise AssertionError("the cold user / unknown items must answer empty lists")

    net = deployed.network("cuda")

    def plain_for(query) -> np.ndarray:
        prefix = algo._resolve_prefix(deployed, query)
        with plain_flash():
            scores = score_next_items(net, prefix).astype(np.float64)
        exclude = {int(i) - 1 for i in prefix} if query.get("unseenOnly", True) else set()
        exclude |= {deployed.item_index[b] for b in query.get("blackList") or []}
        scores[list(exclude)] = -np.inf
        return scores

    def tol_for(plain):
        return SEQ_SCORE_TOL * max(1.0, float(np.abs(plain[np.isfinite(plain)]).max()))

    for q, body in zip(queries[:-2], served[:-2]):
        plain = plain_for(q)
        check_seq_list(body, plain, tol_for(plain))
    batch_diff = 0.0
    for qid, q in batch:
        plain = plain_for(q)
        tol = tol_for(plain)
        check_seq_list(batched[qid], plain, tol)
        single = algo.predict(deployed, q)
        check_seq_list(single, plain, tol)
        by_item = {s["item"]: s["score"] for s in single["itemScores"]}
        for s in batched[qid]["itemScores"]:
            if s["item"] in by_item:
                diff = abs(s["score"] - by_item[s["item"]])
                if not diff <= tol:
                    raise AssertionError(f"{s['item']}: batch {s['score']}, predict "
                                         f"{by_item[s['item']]}")
                batch_diff = max(batch_diff, diff)
    prefix = algo._resolve_prefix(deployed, queries[0])
    result = {
        "users": len(deployed.histories), "items": len(deployed.item_ids),
        "queries": len(queries), "forwards": forwards,
        "launches": {"flash_forward": launches}, "save_s": save_s, "deploy_s": deploy_s,
        "query_ms_p50": statistics.median(latencies), "query_ms_max": max(latencies),
        "http_query_ms_p50": http_query_ms,
        "predict_ms_p50": host_ms(lambda: algo.predict(deployed, queries[0])),
        "forward_ms_p50": host_ms(lambda: score_next_items(net, prefix)),
        "batch_predict_users": len(batch), "batch_predict_s": batch_s,
        "batch_vs_predict_max_abs_diff": batch_diff,
    }
    emit({"phase": "serve_seq", **result})
    return result


def phase_train_verb_seq(rng: np.random.Generator, repo: str, workdir: str) -> dict:
    """The ``train`` verb with the sequence template's engine.json on a
    small events file, and ``deploy`` of the model it wrote."""
    from predictionio_tpu_torch.tools import cli

    engine_json, _ = sequence_engine(repo)
    events = os.path.join(workdir, "seq_events.jsonl")
    n_events, user = small_events(rng, events)
    model_dir = os.path.join(workdir, "seq_small")
    before = flash_counts()
    t0 = time.perf_counter()
    if cli.main(["train", "--engine-json", engine_json, "--events", events,
                 "--model-out", model_dir, "--device", "cuda"]) != 0:
        raise AssertionError("the train verb failed")
    verb_s = time.perf_counter() - t0
    trained = {k: n - before[k] for k, n in flash_counts().items()}
    if min(trained["flash_forward"], trained["flash_backward"]) < 1:
        raise AssertionError(f"the train verb's flash launches: {trained}; B4 and the fused "
                             "backward must launch")
    before = flash_counts()["flash_forward"]
    served, small, _ = serve_model(engine_json, model_dir, [{"user": user, "num": 5}])
    launches = flash_counts()["flash_forward"] - before
    if len(served[0]["itemScores"]) != 5 or user not in small.histories or launches < 4:
        raise AssertionError(f"the trained small SASRec model answered {served[0]} "
                             f"with {launches} B4 launches (warm-up and query)")
    result = {"events": n_events, "users": len(small.histories), "train_verb_s": verb_s,
              "train_launches": trained, "serve_b4_launches": launches,
              "epochs": small.config.epochs}
    emit({"phase": "train_verb_seq", **result})
    return result


def flash_rows(check: dict, timed: dict, train_launches: dict, serve_launches: int) -> list:
    """The ``{"kernels": [...]}`` rows of B4 and the fused backward: times
    at the training shape, the other timed shapes beside them; launches on the
    training path (B4 also on the serving path)."""
    main_shape, *other = timed["shapes"]
    rows = []
    for name, source, line, what in (
        ("flash_forward", "flash_attention", 58, "forward"),
        ("flash_backward", "flash_backward", 106, "backward (dq, dk and dv)"),
    ):
        k = main_shape["kernels"][name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"predictionio_tpu_torch/csrc/{source}.cu",
            "replaces": f"predictionio_tpu/ops/flash_attention.py:{line}",
            "launches": train_launches[name],
            "max_abs_err": check["max_abs_err"][name],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
            "timing": "ms, plain_ms, library_ms: device time from a torch.profiler trace "
                      "(CUDA events where it shows none); call_ms: CUDA events around one "
                      "call, the host's launch included",
            "call_ms": k["call_ms"], "plain_call_ms": k["plain_call_ms"],
            "library_call_ms": k["library_call_ms"],
            "library_note": f"scaled_dot_product_attention {what}, the same boolean "
                            f"mask, {main_shape['sdpa_backend']} backend",
            "shape": {x: main_shape[x] for x in ("batch", "heads", "t", "d")},
            "other_shapes": [{**{x: o[x] for x in ("batch", "heads", "t", "d")},
                              **{x: o["kernels"][name][x] for x in
                                 ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")}} for o in other],
        })
    rows[0]["serve_launches"] = serve_launches
    rows[1]["also_replaces"] = "predictionio_tpu/ops/flash_attention.py:148"
    return rows


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
        line.strip() for log in _kernels.build_logs.values() for line in log.splitlines()
        if any(x in line for x in ("registers", "spill", "entry function"))
    ]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    repo = os.path.dirname(os.path.abspath(__file__))
    rng = np.random.default_rng(args.seed)
    stage1 = phase_check_and_time(rng)
    with tempfile.TemporaryDirectory() as workdir:
        serve = phase_serve(rng, workdir)
    trained = phase_train(rng, repo)
    b1_check = phase_check_b1(rng, trained)
    b1_time = phase_time_b1(trained)
    emit({"phase": "half_step_transfer", "transfer_s": b1_time["transfer_s"]})
    phase_foldin(rng, trained)
    with tempfile.TemporaryDirectory() as workdir:
        phase_train_verb_and_serve(rng, trained, repo, workdir)
    b1_launches = trained["result"]["launches"]["gram_rhs"]
    ratings = trained["ratings"]
    del trained

    b3_check = phase_check_b3(args.seed)
    b3_time = phase_time_b3(args.seed)
    ncf_trained = phase_train_ncf(rng, ratings, repo)
    with tempfile.TemporaryDirectory() as workdir:
        ncf_serve = phase_serve_ncf(rng, ncf_trained, repo, workdir)
        phase_serve_ncf_wide(rng, args.seed, repo, workdir)
        phase_train_verb_ncf(rng, repo, workdir)
    del ncf_trained

    seq = phase_seq_data(ratings, repo)
    del ratings
    flash_check = phase_check_flash(args.seed, seq)
    flash_time = phase_time_flash(args.seed, seq)
    seq_trained = phase_train_seq(seq)
    with tempfile.TemporaryDirectory() as workdir:
        seq_serve = phase_serve_seq(rng, seq_trained, repo, workdir)
        phase_train_verb_seq(rng, repo, workdir)

    main_shape = next(s for s in stage1["shapes"] if s["batch"] == 256)
    b1_main = next(s for s in b1_time["shapes"]
                   if s["side"] == "users" and s["dtype"] == "float32")
    b3_main = next(s for s in b3_time["shapes"] if s["items"] == NCF_SERVE_ITEMS)
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
    }, {
        "name": "gram_rhs",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/als_gram.cu",
        "replaces": "predictionio_tpu/ops/als_gram.py:86",
        "launches": b1_launches,
        "max_abs_err": b1_check["max_abs_err"],
        "ms": b1_main["ms"],
        "plain_ms": b1_main["plain_ms"],
        "bound_ms": b1_main["bound_ms"],
        "bound_by": b1_main["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes a per-row Gram and "
                        "rhs of gathered rows: the nearest is a gather "
                        "followed by bmm, the unfused plain version",
        "shape": {k: b1_main[k] for k in ("side", "rows", "pad_len", "rank", "dtype")},
        "other_shapes": [
            {k: s[k] for k in ("side", "dtype", "ms", "plain_ms", "bound_ms", "bound_by")}
            for s in b1_time["shapes"] if s is not b1_main
        ],
    }, {
        "name": "ncf_score_all_items",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/ncf_score.cu",
        "replaces": "predictionio_tpu/models/ncf/kernel.py:32",
        "launches": ncf_serve["launches"]["ncf_score_all_items"],
        "max_abs_err": b3_check["max_abs_err"],
        "ms": b3_main["ms"],
        "plain_ms": b3_main["plain_ms"],
        "bound_ms": b3_main["bound_ms"],
        "bound_by": b3_main["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the fused NeuMF head "
                        "(two embedding branches, two dense layers and the "
                        "output projection); the nearest is the plain version's "
                        "chain of matmuls",
        "shape": {k: b3_main[k] for k in ("items", "embed", "hidden")},
        "other_shapes": [
            {k: s[k] for k in ("items", "embed", "hidden", "ms", "plain_ms", "bound_ms",
                               "bound_by")}
            for s in b3_time["shapes"] if s is not b3_main
        ],
    }] + flash_rows(flash_check, flash_time, seq_trained["result"]["launches"],
                    seq_serve["launches"]["flash_forward"])})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
