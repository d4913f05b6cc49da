#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card: build, check, time, serve, train.

    python3 chip_smoke.py [--seed N]

Phases, each printed as one JSON line (a failed phase raises, so the
script exits non-zero and prints no result):

1. device  -- needs CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them.
2. build   -- compiles every kernel of ``predictionio_tpu_torch/csrc``
   (one ``nvcc`` each, started together) and reports ptxas's summary;
   then the native host packer (``predictionio_tpu_torch/native``, g++),
   timed. Every part below counts its packs by route (``pack_routes``
   lines: each count set to 0 before the part, read after it) and fails
   where one took the numpy route, which only ``PIO_NATIVE=0`` asks for;
   the launches of dist_train, dist_models and dist_classify report
   their ranks' routes, held the same way.
   pio_check -- on the host, before any kernel runs: the port's static
   analysis (``predictionio_tpu_torch/analysis/``) over
   ``predictionio_tpu_torch/`` through the console, ``python3 -m
   predictionio_tpu_torch.tools.cli check --format json`` (under ``-X
   importtime``) and ``check --self-check``, each a process of its own,
   and a third process timing the sweep by rule family (parse, package
   index, C, R, P). Its line prints both exit codes (0), the findings,
   suppressed and stale counts (unsuppressed 0, stale 0), the seconds,
   whether the check process imported torch or jax (it must not), and
   every kernel's count, set to 0 before and read after (all 0).
3. check   -- kernel B2 (``mips_topk.cu``) against its plain torch twin
   on the card, at the serving path's shapes (1,000,000 items x rank 16,
   512-item tiles, R=16, batches of 8, 16 and 256, and the micro-batcher's
   buckets of 1, 4, 64 and 128 queries as the search hands them to B2:
   padded with zero rows to a multiple of 8) plus small cases:
   ties, padding, a ragged catalog; ranks 5, 17, 33 at tiles of 100 and
   1,000 items; exact integer scores with ties within and across the
   kernel's 512-column sub-tiles of an 8,192-item tile; an all-equal
   tile (every score passes the threshold, past the survivor buffer);
   R = 32 (the threshold filter's largest R), 48 (register passes) and
   80 (the SIMT passes instance). Each case's instance
   (``mips_instance``) equals the kernel's own choice. Tolerance: per
   (query, tile) the sorted scores agree within rtol=atol=1e-5, and the
   index sets are equal except entries whose score lies within that
   tolerance of the R-th score (the kernel and the plain version sum
   the K products in different orders); the tie, padding, integer and
   all-equal cases demand equal indices.
4. time    -- B2 and its plain version, median of CUDA-event timed runs
   after warm-up, beside the bound: the larger of bytes / 3.35 TB/s and
   the operations at the rate of the instance's arithmetic (the
   tensor-core instance: bf16 products in three terms, a third of 989
   TFLOP/s; the passes instance: f32, 67 TFLOP/s; H100 SXM data sheet),
   and beside ``library_pair_ms`` (``torch.matmul`` against the table
   dequantized once, then ``torch.topk`` per tile: two calls, for
   information) and ``ms_r1`` (the same call at R=1). The same at
   R=128 (the passes instance). Then B2 at rank 400 (512-item tiles)
   and at rank 16 with 8,192-item tiles, over the same 1,000,000 items
   at B=256, each held to its plain version as above, timed, and
   served: ``RetrievalIndex.search`` of 64 of the queries launches B2
   once and reaches recall@10 >= 0.99 against the exact f32 scan.
5. serve   -- the serving path: a recommendation model of 138,000 users x
   1,000,000 items x rank 16 made from ``--seed``, saved with
   ``save_model``, deployed through the ``deploy`` code path on cuda
   with ``"retrieval": {"mode": "mips"}``, answering POST /queries.json
   (user, blackList, unseenOnly=false, item-similarity and cold-user
   queries) and a 256-user ``batch_predict``. Launch counts are zeroed
   just before and read just after. Checks: every kernel of the path
   launched, batch_predict equals per-query predict, and recall@10 of
   the served lists against the exact f32 scan is at least 0.99. The
   deploy micro-batches (the reference's default): each of these
   sequential queries is a flush of one.
   serve_fabric -- serve's saved model under the reference's serving A/B
   traffic (32 closed-loop keep-alive clients, 960 user queries drawn
   from ``--seed``, 2% cold users, 24 with a blackList), through four
   deploys in turn: (b) unbatched (``max_batch_size=1``), one client
   first: every other answer must equal its bytes; (a) the default
   micro-batched deploy: B2 at most once per flushed batch (launches at
   most ``pio_serving_batch_flush_total``, above 0, fewer than the
   known-user queries), then one client with every query traced, for the
   span breakdown of a round trip (``query.parse``, ``batch.queue_wait``,
   ``batch.execute``, ``query.respond``); (c) two ``SO_REUSEPORT``
   frontend processes before the scorer, async dispatch: B2 in the
   scorer, at most 2 wakeups per request; (d) the sharded fabric, two
   scorer shard processes on cuda behind two frontends, on registry
   version 1 (the model with two per-shard blobs), then ``POST
   /models/swap`` to version 2 (48 queried users' rows changed): every
   shard launched B2 (read from its control port's ``/metrics``), holds
   a CUDA context (its pid among ``nvidia-smi --query-compute-apps``
   where that lists this process, and CUDA initialised in its
   ``pio_build_info``), stamps ``x-pio-model-version: 2`` after the
   swap, and version 2's answers equal an unbatched server's on version
   2. No answer is a 5xx. Each deploy prints queries/s, p50 and p99, the
   batch sizes and flush reasons, and its B2 launches, each zeroed just
   before its traffic and read just after.
6. train   -- the training path at full width: the template's engine.json
   (rank 16, 10 iterations, lambda 0.1, seed 3, f32, explicit) with
   ``maxEventsPerUser`` 256 on 138,000 users x 27,000 items x 20,000,000
   ratings made from ``--seed`` by the bench's MovieLens-20M recipe,
   through RecommendationPreparator -> ALSAlgorithm.train on cuda, the
   generated arrays standing where the events reader's would. B1 launch
   counts are zeroed just before and read just after (20 expected);
   ``pack_s``, the preparator's pack on the native route.
   pack_compare -- one pack of those 20M ratings (the user side, its
   256 cap by time) on each route, the native packer and ``PIO_NATIVE=0``'s
   numpy path, each timed, the two equal byte for byte.
   Checks: no NaN; the training RMSE on 100,000 sampled ratings falls
   from iteration 1 to 2 to 10; a 2-iteration fit through B1 equals the
   unfused "xla" path on the card within 1e-4 (the reference's f32
   solver-parity bar).
   profile_train -- one more fit of that data with the template's
   params through ALSAlgorithm.train with ``pio.profile`` in the runtime
   conf, under ``profile_trace`` (the ``torch.profiler`` Chrome trace
   ``pio train --profile`` writes, CPU and CUDA activity): the telemetry
   journal's 10 step lines (wall time, edges/s, achieved GB/s against the
   bytes model) and, from the trace, per ``als.iteration`` range the
   device ms of B1 (20 kernels named ``gram_rhs``, gated), of the ridge
   and solve (kernels launched inside ``als.solve`` ranges) and of the
   rest, the share of the range the card idled, the busiest other
   kernels, and the fit's five longest idle gaps with the host calls
   under each.
7. check_b1 -- kernel B1 (``als_gram.cu``) against its plain version on
   the two half-step blocks of that fit (138,000 x 200 and 27,000 x 256,
   trained factors), explicit/implicit x f32/bf16, plus small cases:
   ranks 8, 16, 17, 24, 32, 33, 64 (ragged tensor-core tiles among
   them), a ragged row count, all-padding rows (exactly zero) and the
   last real row; ranks 65, 128, 200, 256, 512 (a row's tiles over warps
   and groups of blocks) and 513 (the SIMT instance past the tensor-core
   one) on 2,000 x 48 blocks in both modes and dtypes; ranks 16, 128,
   200, 512 and 513 at 1, 2, 5 and 8 rows, each launch repeated and
   equal bit for bit; the tensor-core instance's Gram exactly symmetric.
   Tolerance, elementwise: 2 (L + 2) 2^-24 times the same sums over
   absolute values (``compare_b1``); per Gram row the same factor of its
   max|gram|. Then a 2-iteration fit of phase 6's data at rank 128
   through B1 equals the "xla" path within 1e-4.
8. time_b1 -- B1, its plain version, the ridge + solve and the whole
   half-step at both block shapes in f32 and bf16, beside the bound (the
   bytes once over 3.35 TB/s, or the products at 3xTF32's rate) and the
   gather's L2 bytes; B1 and its plain version at ranks 128, 200, 320,
   512 and 640 (the SIMT instance) on 2,000 x 48 blocks; the rank-128 fit's seconds
   through B1 and through "xla".
9. foldin  -- ``fold_in_users`` of 1,000 users' histories against the
   trained item factors, through B1 and through the plain path.
10. train_verb_and_serve -- the ``train`` verb on a 3,000-event JSON-lines
   file and ``deploy`` of what it wrote; then the full-width model of
   phase 6 saved, deployed with mips and queried over HTTP: B2 launches
   and recall@10 >= 0.99 against the exact scan.
11. store_path -- the store path in a fresh ``PIO_FS_BASEDIR``: ``app new``
   and ``accesskey new`` through the port's CLI; the event server on
   port 0 in a thread takes 40 batches of 50 and 20 single "view" events,
   reads them back, answers a bad request 400 and a wrong key 401 (p50
   of a batch's round trip); ``pio import`` of 250,000 "rate" events
   in the quickstart wire shape (MovieLens-1M's 6,040 users and 3,706
   items, a quarter of its 1,000,209 ratings: the depth cut that keeps
   the whole script in its time; squared-uniform popularity, ratings 1-5,
   one second apart);
   ``pio train`` with ``examples/recommendation/engine.json`` unchanged
   but for its ``appName``: B1 launches, the columnar fast scan served
   the read (its calls counted), a COMPLETED engine instance and its
   model blob in the model repository; the same events trained from a
   file give factors within 1e-4 of the store's; ``pio deploy`` of the
   instance (no model directory) with ``"retrieval": {"mode":
   "mips"}``: 10 known-user queries and a cold user, B2 launches,
   recall@10 >= 0.99 against the exact scan; then a new "buy" event for
   a queried user and a deploy with ``seenFilter: "live"``: the item
   leaves the user's list.
12. follow_path -- continuous learning on store_path's store (no second
   import): the event server in a thread with ``ingest_mode="wal"``
   takes, in batches of 50, 600 known users x 20 "rate" events and 30
   new users x 10 (10 new items among them); the instance is deployed
   with ``"retrieval": {"mode": "mips"}``; ``RetrainLoop.run_once``
   (notifying that server) answers "foldin": the WAL tail, the first
   snapshot build (~512,000 rows), one B1 launch, registry version 1, the
   server swapped to it (``GET /``) and the old epoch released. The
   folded rows equal ``fold_in_als_model`` with ``solver="xla"`` on the
   card within 1e-4, untouched rows the base bit for bit, new item rows
   are zero; 10 touched and 2 new users' lists reach recall@10 >= 0.99
   against the exact scan of version 1 (B2 launches, new users' lists
   non-empty). An idle cycle moves neither cursor nor version. 2 events
   each for 1,300 known users (21.5% > 0.2) answer "full_retrain": 20 B1
   launches, version 2, swapped, served through B2. A swap back to
   version 1 answers exactly as before; a swap to a missing version
   answers 404 and version 1 keeps serving. The line carries the WAL's
   events/s, batch p50 and fsyncs, the snapshot build and refresh
   seconds, each cycle's tail/fold/publish/swap seconds, the blob bytes,
   the lag from the last ack to the swapped model, the full retrain's
   seconds, the launches and the card memory around the swap.
   eval_path -- on the same store after follow_path: (a) ``eval
   --replay --split-frac 0.8 --k 10`` of the mips variant through the
   CLI: 20 B1 launches (the prefix's 10 iterations), B2 at least twice
   (the scoring pass and the guard's mips arm), shortlist recall@10 >=
   0.99; held against the same replay on the card through the plain
   versions of B1 and B2 (``plain_b1_b2``, no launch of either):
   the same split and queries, each ranked list equal up to items whose
   plain scores lie within rtol = atol = 1e-4, scores within that;
   metrics within 1e-4, or further apart only where every user whose
   held-out items rank differently owes it to a near tie within that
   tolerance (each such user's two lists printed); (b) ``eval --replay --model-version 2`` (the
   follow path's full retrain): the registry lineage, B2, the same
   split; (c) ``batchpredict`` of every user of the latest instance
   (``{"user": u, "num": 10}``): B2 once a 4,096-query chunk, no error
   row, 200 rows equal to an unbatched (``max_batch_size=1``) mips
   deploy's bodies, one ``top --iterations 1 --no-clear`` frame of that
   deploy; B2 at the 4,096-row chunk held to its plain version and timed
   beside its bound and ``torch.matmul`` + ``torch.topk``; (d) ``eval
   --replay`` of ``examples/ncf/engine.json`` (epochs 5 -> 1): every
   metric, no B3 (the reference's batch path scores without it); (e)
   ``eval`` of a module the phase writes: an ``Evaluation`` of the
   sequence template with a hit@10 ``OptionAverageMetric`` over
   ``examples/sequence/engine.json``'s params (``evalFolds`` 1): a
   COMPLETED evaluation instance, B4 and the fused backward 2 a training
   step, B4 also 2 a scoring forward, bestScore above twice the uniform
   10 / 3,706.
   quickstart -- the README's Quickstart on the same store after
   eval_path, through the port's console and client SDK, every verb a
   ``python -m predictionio_tpu_torch.tools.cli`` process but ``train``:
   ``status`` (``Accelerator: cuda x1 (NAME)``, storage OK), ``version``,
   ``template list``, ``template get recommendation`` with mips set in
   its engine.json, ``build``, ``start-all`` (event server, dashboard,
   admin server as daemons on free ports); ``EventClient`` posts 300
   ratings of existing items by a new user (20 singly, the rest with
   ``create_batch``) and round-trips one more event (``get``, ``find``,
   ``delete``); ``train`` through ``cli.main`` in this process (20 B1
   launches); ``deploy`` (B2 read from the deployed process's
   ``/metrics``, above 0); ``EngineClient`` queries 15 known users and
   the new one, recall@10 >= 0.99 against the exact scan; the
   dashboard lists the new COMPLETED instance and eval_path's
   evaluation, the admin server MLApp; ``run`` of a ``pypio`` script
   (every event of the store, a model blob round trip); ``undeploy``
   (the deploy process exits 0) and ``stop-all`` (no daemon left). Any
   verb that exits non-zero fails the phase; its line carries each
   step's seconds and the launch counts.
   dase_engine -- a user's engine module on the same store after
   quickstart, written against ``predictionio_tpu_torch.controller``
   into an engine directory whose engine.json names its
   ``engineFactory``: the recommendation datasource, a preparator that
   gives ALS's CSR and NCF's COO, two algorithm blocks (``ALSAlgorithm``
   with ``examples/recommendation/engine.json``'s params and mips,
   ``NCFAlgorithm`` with ``examples/ncf/engine.json``'s, epochs 5 -> 1),
   each a subclass taking its half, and a Serving that answers both
   predictions by name. ``pio train`` through ``cli.main`` in this
   process (B1 above 0), ``pio deploy --max-batch-size 1`` as a process
   (batching off, so every known-user query runs B3), 16 known users'
   queries, ``/reload`` and one more query, B2 and B3 read from the
   deployed process's ``/metrics`` (B2 above 0, B3 at least 16), each
   part's items equal and scores within 1e-5 of what ``ALSAlgorithm``
   and ``NCFAlgorithm`` answer in this process from the instance's
   models, ``pio undeploy`` (the process exits 0). Its line carries the
   launch counts, the largest score gaps and each step's seconds.
   templates -- the first 10,000,000 of phase 6's 20,000,000 ratings (a
   depth cut that keeps the script in its limit beside dist_classify) as
   the templates' events
   (every rating a "view", the 5-star ones also a "buy"; each item 1-3 of
   20 categories, from ``--seed``); every kernel's count set to 0 first,
   B3, B4 and the fused backward still 0 at the end:
   cooc_check -- ``ops/cooccurrence.py`` on the card against the same
   code on the CPU at 5,000 users x 2,000 items, self and cross (counts
   equal, LLR indicators at rtol = atol = 1e-5 up to near-ties); and on
   the similar-product template's own call below, 256 item rows drawn
   from ``--seed`` of the card's counts equal to scipy's rows of AᵀA, its
   LLR indicators within the f32 tolerance of an f64 LLR up to near-ties;
   the call's stages timed apart on those counts (the products, the
   LLR with the diagonal drop and the top-k, the top-k alone).
   train_ecommerce -- ``examples/ecommerce/engine.json`` (plus the 256
   history cap) through ECommercePreparator -> ECommAlgorithm.train on
   cuda: 20 B1 launches, implicit; a 2-iteration fit through B1 equals
   "xla" within 1e-4; one fold-in of 1,000 users with an item ``$set``
   window: B1 launched, rows within 1e-4 of the "xla" fold, the new
   category served. serve_ecommerce -- that model deployed scan then
   mips (user, categories, whiteList, blackList, a cold user's recent
   views, unseenOnly=false): the rules hold in both, mips launches B2
   and reaches recall@10 >= 0.99 against the scan over every list, the
   categories and whiteList ones included (each list's overlap is
   printed); a 256-user batch_predict equals predict. train_cooc -- ``examples/similarproduct/engine.json`` and
   ``examples/universal/engine.json`` (plus the cap; "buy" primary,
   "view" cross) on the same events: per call seconds, peak device bytes
   and the products' bound; each deployed, item and user queries equal
   to predict, a 256-query batch_predict equal to predict.
   store_templates -- a fresh store, ``pio import`` of 3,000 view/buy
   events, ``pio train`` -> ``pio deploy`` of each of the three
   engine.jsons; a ``$set`` of ``unavailableItems`` drops the top item
   from the next e-commerce answer without a retrain.
   stream_path -- streamed ALS epochs and the streaming reader; B1 and B2
   counts set to 0 before each drive and read after it, B3, B4 and the
   fused backward still 0 at the end: stream_fit -- phase 6's
   20,000,000 ratings through ``array_coo_chunks`` ->
   ``build_streamed_als_data`` into a block store under the work dir (32
   MB blocks: 9 user and 2 item blocks at the 256 cap), fitted by
   ``als_fit_streamed`` with the template's params (pinned staging
   buffers, the copy stream): factors within 1e-4 of phase 6's resident
   fit, B1 launches = blocks x 10, the measured host -> device block
   bytes equal to ``stream_bytes_per_half_step``'s model, at most two
   blocks in flight, recall@10 of 256 users' mips lists (B2) against the
   exact scan of the streamed model >= 0.99; it prints the store's build
   seconds and bytes on disk, s/iteration beside phase 6's, the achieved
   host -> device GB/s beside one pinned copy of the largest block timed
   alone, and the host's peak resident-set growth during the fit; then
   a fit with a device budget of the whole store: the iterations after
   the first ship no block and the factors are the streamed fit's bit for
   bit. stream_pio -- on a copy of store_path's store taken before
   follow_path (its live-filter "buy" deleted again), ``pio train
   --snapshot-mode refresh --als-feed streamed`` of the recommendation
   engine.json with ``"reader": "streaming"``: B1 once per block of the
   snapshot's block store a half-step, factors within 1e-4 of
   store_path's materialized instance; ``pio deploy`` of it with mips
   and ``seenFilter: "live"``: B2, every list the materialized model's
   up to near-ties (``compare_lists``); then on store_templates' store
   the e-commerce (``--als-feed streamed``), similar-product and
   universal engine.jsons with ``"reader": "streaming"`` through ``pio
   train`` and deployed: the e-commerce factors within 1e-4 of the
   materialized instance's, the indicators equal bit for bit, every
   answer equal to the materialized twin's ``predict``.
   dist_train -- multi-process ALS training on ``torch.distributed``:
   the recommendation engine.json (the 256 cap, mips, ``seenFilter:
   "live"``) on the first 1,250,000 of phase 6's ratings (cut from all
   20M to 5,000,000 beside dist_models, to 2,500,000 beside the
   pio_check phase, then to 1,250,000 beside dase_engine) as ``pio
   train``'s core
   (``run_train``) in ranks this script starts as ``chip_smoke.py
   --dist-worker`` under the launch contract's env: (a) one rank in
   an NCCL group, mesh [1, 1]; (b) two ranks sharing the card (gloo, which takes
   the card's tensors and copies them through host memory itself), [2,
   1], data-sharded rows;
   (c) two ranks, [1, 2], ALX model-sharded factors through B1 on each
   rank's slice of the table; (c) again as ``pio train --snapshot-mode
   refresh --als-feed streamed`` itself, run in two ranks on stream_pio's
   copy of store_path's store with ``"reader": "streaming"`` (the ranks
   agree on rank 0's scan bound, rank 0 readies the snapshot and the
   mesh's block store first, each rank reads its rows of every block).
   Each launch: B1 launched on every rank (counted from 0 in the rank),
   each rank's backend and collective counts printed (none in the
   one-rank launch, where every collective is the identity: no NCCL
   collective runs on one card), one new COMPLETED instance recorded by
   rank 0, the blob's factors within 1e-4 of the one-process fit of the
   same data (the resident fit of the same packing; for the streamed
   launch store_path's materialized instance), and the blob deployed
   with mips answering 16 queries with exactly 16 + 2 B2 launches (the
   warm-up searches the dot and the cosine index once each), each list
   the one-process model's up to near ties. Two ranks on one card
   measure correctness and overhead, not scaling. B3, B4 and the fused
   backward stay 0.
   dist_models -- multi-process NCF and SASRec training, the same way
   (``pio train``'s core in ``--dist-worker`` ranks, two ranks sharing
   the card over gloo, each launch a store of its own):
   ``examples/ncf/engine.json`` (widths unchanged, checkpoint on; epochs
   5 -> 1 on the first 62,500 of phase 6's ratings (125,000 before the
   pio_check phase), the full 138,000 x 27,000 tables, 77 steps) as (a)
   [2, 1], the batch over ``data``, and
   (b) [1, 2], the params and Adam's moments over ``model``;
   ``examples/sequence/engine.json`` (``("data", "seq")``, widths
   unchanged; epochs 10 -> 1 on the first 12,800 of seq_data's packed
   sequences, 50 steps; 25,600 before the pio_check phase) as (c) [2, 1],
   flash per rank, (d) [1, 2]
   ring attention (the reference's ring body is plain: B4 launches 0 in
   training) and (e) [1, 2] Ulysses (flash at one head per rank). The
   reference of each template: its one-process ``Algorithm.train`` on
   the card from the same seeded init over the same examples; for a
   launch with a data axis, that run with each batch cut as the axis
   cuts it and the shards' gradients summed (``split_reference``: Adam
   turns the rounding of half-batch products into lr-sized steps where
   a ReLU input or a sparse row's gradient sits near 0, so the unsplit
   run's trajectory is printed beside, not gated). Each launch: the
   first 20 step losses of every rank within 1e-4 of the reference's,
   rank 0's blob's params within 1e-3 element by element (the seq-split
   launches (d) and (e), which have no one-process twin of their
   position-split gradient sums: leaf by leaf, every leaf within 1e-3
   but the item table within 1e-2, a bar the control -- the one-process
   run over another batch order -- must lie past; and so of each other;
   the RMS printed),
   B4 and the fused backward 2 a step on every rank in (c) and (e) and 0
   in (d), B3 0 in training; each rank's backend, launch seconds, train
   seconds and collectives printed (the ring's point-to-point sends
   staged through the host: gloo refuses CUDA tensors there, 5 a
   block a step; Ulysses 8 all-to-alls and a gather); the blob deployed
   unbatched: NCF 10 known users, B3 once each and once in the warm-up;
   SASRec 10 users, B4 2 a forward (the warm-up's included); every list
   the reference model's (scored through the plain versions) up to near
   ties (scores within 1e-3). Two ranks on one card measure correctness
   and overhead, not scaling.
   classification -- every kernel's count set to 0 first, all five still 0
   at the end (the part is plain torch, as the reference's is plain jnp):
   classify_path -- BASELINE config #2 through the verbs in a fresh store:
   ``pio app new MyApp``, ``pio import`` of 5,574 SMS ``train`` events
   (747 spam, 4,827 ham: the UCI SMS Spam Collection's counts; 4-30
   tokens from two Zipf vocabularies of 8,000 words sharing 4,000, from
   ``--seed``), ``pio train`` of ``examples/classification/engine.json``
   unchanged (naive-bayes, hashDim 4096) and of a logistic-regression
   variant (reg 1e-4, 100 L-BFGS updates), each held to the same training
   on the CPU: Naive Bayes within rtol 1e-6; logistic regression's first
   10 iterates within rtol 2e-3, atol 2e-4, and its final model by its
   labels on every message and its loss within 1e-3 (100 updates on
   separable text part further between any two f32 reduction orders,
   the reference's own two included; the weights' gap is printed); each
   deployed, 20 queries over HTTP: bodies equal to ``predict``, labels
   the CPU model's, Naive Bayes scores within 1e-5; ``pio batchpredict``
   equal to ``predict``; a 3-fold ``pio eval`` (accuracy
   ``AverageMetric``, both algorithms) on the card and on the CPU; 10,000
   users' ``$set`` of three categorical and two numeric attributes
   trained in properties mode (naive-bayes) and held to the CPU; the
   same SMS events in an Elasticsearch-fake store (all three
   repositories) and an HBase-fake event store: ``run_train`` on the
   card, the blob read back through ``Engine.prepare_deploy`` from that
   store, its answers bit-equal to the sqlite store's model's.
   classify_scale -- the trainers alone at 262,144 messages x hashDim
   4096 (4.29 GB of f32 on the card): Naive Bayes (held to the CPU at
   1e-6) and 100 L-BFGS updates (the first 10 iterates held to the
   CPU's at the bar above): train s, evaluations, host syncs, peak
   bytes, and one loss-and-gradient evaluation timed beside its bound
   (two passes over x: 8.59 GB at 3.35 TB/s, 2.56 ms).
   kmeans_check -- e2's ``kmeans`` on 1,000,000 x 32 points around 64
   seeded centers, k = 64, 20 iterations: each Lloyd step held to the
   CPU's step from the same centers (assignments equal but for near
   ties, the centers of the card's assignment within 1e-4, the cost
   within 1e-5), the CPU's costs along that path stopping it at the
   card's iteration; the host k-means++ seconds; a Lloyd step timed
   beside its bound (2 N D k operations at 67 TFLOP/s, 0.061 ms).
   dist_classify -- the classifiers and k-means over the ``data`` axis:
   one launch of two ``--dist-worker`` ranks sharing the card over gloo,
   every count of B1-B6 set to 0 before it and still 0 after it (here
   and in each rank). Each rank runs ``pio train -- --mesh-shape 2,1
   --dcn-mesh-shape 1,1`` of classify_path's logistic-regression variant
   (5,574 messages, hashDim 4096, 100 updates) and of its Naive Bayes
   engine.json on classify_path's store, then e2's ``kmeans`` of
   kmeans_check's 1,000,000 x 32 points, k = 64, over a ``[2, 1]`` mesh
   with ``dcn_mesh_shape [1, 1]``. Gates: every mesh a rank built is
   ``{"data": 2, "model": 1}`` from ``dcn_mesh_shape [1, 1]``, gloo
   all-reduces on both ranks, rank 0 alone records the two COMPLETED
   instances; logistic regression's first 10 iterates within rtol 2e-3,
   atol 2e-4 of the one-process card fit's (rank 1's equal to rank
   0's), the blob's labels on every message the one-process model's and
   its loss within 1e-3, the blob deployed and 20 queries over HTTP
   answered with the one-process model's labels; Naive Bayes within
   rtol 1e-6 of the one-process card model; k-means centers within
   1e-4 of the one-process card fit's, the same ``iterations_run``, the
   cost within 1e-5. Each rank's train seconds and collective counts
   printed. Two ranks on one card measure correctness and overhead,
   not scaling.
13. check_b3 -- kernel B3 (``ncf_score.cu``) against its plain version
   on the card at the NCF template's widths (E=32, hidden 64, 32) over
   1,000,000 items for five users (the last one included); over 1, 15,
   16, 17, 127, 128, 129, 255, 256, 257, 1023, 1025, 5,003 and 27,000
   items (the edges of the 16-row m-tiles and of the 128-item tiles);
   at odd widths 8/(16, 8), 5/(12, 7), 64/(128, 64), 33/(100, 45) (E not
   a multiple of 4: 4-byte copies), 5/(130, 9), 100/(8, 70), 3/(1, 1),
   40/(300, 130) and 100/(200, 70); 64/(256, 128) over 255, 256 and 257
   items (the 256-item tiles past H1 = 32); 8/(60,000, 8) (c0 recomputed per
   H0 chunk: too wide for shared memory); and at the five wide
   widths over 27,000 items (64/(256, 128), 128/(512, 256), 64/(1600,
   800), 64/(4096, 2048), 1536/(64, 32): weights staged a chunk per use,
   the ring in E chunks at E = 1536). Each case emits its staging layout
   (``ncf_score_layout``), grid and shared memory. Tolerance,
   elementwise: 2 (3E + H0 + H1 + 6) 2^-24 times S, the same head run on
   the absolute values of every input
   (the worst case of two f32 evaluations that sum each layer in
   different orders; ``b3_tolerance``).
14. time_b3 -- B3 and its plain version at 1,000,000 and 27,000 items
   and the five wide widths at 27,000 items: CUDA-event medians and
   profiler device times of each, beside the bound (the larger of bytes
   / 3.35 TB/s and the dense layers' products at 3xTF32's 165 TFLOP/s
   plus the rest at f32's 67 TFLOP/s) and the f32 bound of earlier runs
   (every operation at 67 TFLOP/s, ``bound_f32_ms``). The template's
   27,000-item row reports its device time: its CUDA-event pair brackets
   the wrapper's host work, during which the card idles.
15. train_ncf -- the NCF training path: ``examples/ncf/engine.json``
   (E=32, hidden 64, 32, batch 4096, lr 0.01, implicit, 4 negatives) on
   the first 1,000,000 of phase 6's ratings (2,500,000 before the
   pio_check phase; the full 138,000 x 27,000 tables), through
   NCFPreparator -> NCFAlgorithm.train on cuda, epochs cut 5 -> 1.
   Checks: the step count,
   no NaN, the mean loss of the last 100 steps below the first 100's,
   and fresh pairs of the data's recipe scoring above uniform ones.
16. serve_ncf -- that model saved, deployed unbatched
   (``max_batch_size=1``: as in the reference, the micro-batched NCF path
   scores through the plain batch scorer, so only predict reaches B3)
   through the ``deploy`` code path on cuda and queried over HTTP (known users, blackList,
   unseenOnly=false, num 20, a cold user) and by a 256-user
   ``batch_predict``. B3 launches counted from 0 before the queries must
   equal the known-user queries; every served list and every batch
   answer agrees with the plain head on the card (scores within the B3
   tolerance; items the plain top-k up to near-ties), and each batch
   answer's scores agree with ``predict``'s (B3) within that tolerance.
   serve_ncf_wide -- random 64/(256, 128) and 64/(1600, 800) models over
   27,000 items, each deployed with an engine.json of its width: 3
   known-user queries each, each 200 through B3 (3 launches a model) and
   held to the plain head as above.
17. train_verb_ncf -- a 3,000-event file imported into a fresh store,
   the ``train`` verb with the NCF engine.json reading the store, and
   ``deploy`` of the engine instance it recorded (B3 serves it).
18. seq_data -- phase 6's 20M ratings as sequence events (event i at
   second i) grouped per user in time order (``group_sequences``, the
   DataSource's grouping), each user's last item held out, the rest
   packed by SequencePreparator to [138,000, 64].
19. check_flash -- kernel B4 (``flash_attention.cu``) and the fused
   backward (``flash_backward.cu``) against their plain versions on the
   card: the training shape (B=256, H=2, T=64, D=16) and Ulysses' local
   shape on dist_models' [1, 2] mesh (H=1 over the whole T) with the
   packed rows' masks, with random right padding and with left padding; T in
   {1, 65, 200, 1024} x D in {8, 16, 32, 64}, causal and not, each with a
   fully-masked batch row and left-padded rows (T above 64 takes the
   fused kernel's atomic dq path); D in {24, 128, 136, 256} at T in {64,
   1024} and D 512 at T 200 (24 and 136 through the wrappers'
   zero-padding to 32 and 192, held to the plain versions at the caller's
   D; past 128 the chunked instances). Tolerance, elementwise: 2e-5 times max(1,
   max|plain|) of each output (f32 sums of at most T + D terms in other
   orders; the kernels' products are 3xTF32; the reference's own forward
   bar is 2e-5 on unit inputs). Rows with no valid key: out, dq, dk, dv
   exactly 0, lse <= -1e29; masked keys: dk, dv exactly 0; no NaN
   anywhere. Then 20 SASRec steps at embedDim 48 / 2 heads (D = 24) and
   at 256 / 1 head (D = 256) through the kernels equal the same steps
   through the plain versions (losses within 1e-4).
20. time_flash -- B4, the fused backward and their plain versions at the
   training shape and at B=16, H=2, T=1024, D=16, and again at the
   training shape with D=24 (the wrappers' padding copies timed with the
   call) and the long one with D=128 and D=256 (the chunked instances,
   their recomputed S, dP and delta counted beside the bound as
   ``chunked_extra_operations``), beside the bound (the
   larger of bytes / 3.35 TB/s and the causal pairs' operations / 165
   TFLOP/s, 3xTF32 on the tensor cores; the backward's delta rows at the
   f32 units' 67 TFLOP/s) and beside ``scaled_dot_product_attention``
   with the same boolean mask (its forward for B4, its backward for the
   fused kernel), with the SDPA backend PyTorch chose. Times are device
   times from a ``torch.profiler`` trace (the sum of the call's
   kernels), with the CUDA-event time of one call beside: at these sizes
   the host's launch overhead, which events count, is larger than the
   kernels.
21. train_seq -- ``examples/sequence/engine.json`` (E=32, 2 heads, 2
   blocks, ffn 64, maxLen 64, batch 256, lr 1e-3; epochs cut 10 -> 1,
   3 before the pio_check phase)
   through SASRecAlgorithm.train on cuda. Flash counts are zeroed just
   before and read just after: B4 and the fused backward must each be
   2 x steps. Checks: no
   NaN, the mean loss of the last 100 steps below the first 100's,
   hit@10 of the held-out last items above the uniform 10/27,000, and 20
   steps through the kernels equal the same 20 steps through the plain
   versions on the card (losses within 1e-4); the kernel run of those 20
   steps is traced: device ms a step, the card's busy share, top kernels
   and the flash kernels' own ms a step.
22. serve_seq -- that model saved, deployed through the ``deploy`` code
   path on cuda and queried over HTTP (users, sessions of 1-10 items,
   blackList, unseenOnly=false, a cold user) and by a 256-user
   ``batch_predict``: B4 launches counted from 0 must be 2 per forward;
   every list agrees with the plain path on the card (scores within 1e-4
   times max(1, max|score|), items up to near-ties), and batch with
   predict.
   serve_seq_wide -- a random SASRec at embedDim 256 / 1 head (head dim
   256) over 27,000 items deployed with an engine.json of that width: 3
   user queries, each 200 through B4 (2 launches a query) and each list
   the plain path's on the card up to near-ties.
23. train_verb_seq -- the same with the sequence engine.json (B4 and the
   fused backward train it, B4 serves it).
24. bench_tools -- the port's six ``tools/*_bench.py`` tools through
   their main ``run_*`` on the card, each with B1's and B2's counts set
   to 0 just before and read just after, one line each (the report, its
   seconds, the launches, the card's name and power limit):
   ingest_bench ``run_ab`` (32 x 50 events, sync vs WAL group commit;
   the SIGKILL crash cycle: 0 lost, 0 duplicated, an idempotent second
   replay); train_bench ``run_ab`` at 50,000 events (cut from 2,000,000:
   the host populate; 200,000 before the pio_check phase, 100,000 before
   dase_engine) with the refresh identity bit for bit on 50,000 (its
   200,000 before);
   eval_bench at its defaults and at 2,048 items (recall@10 and
   identity 1.0, B1 in both, B2 in the wide run: 192 items are their
   own shortlist); als_stream_bench ``run_ab`` at rank 16 over 1,500,000
   edges (streamed factors equivalent to resident ones, B1 in each
   arm); retrain_bench ``run_ab`` (no load error, every probe visible,
   B1 in both arms); serving_bench ``run_ab("recommendation")`` (rank 64
   over 100,000 items, 32 clients x 480 requests, cut from the tool's
   960 beside the pio_check phase, batching off and on:
   no failure, the responses identical or equivalent, QPS and p50/p99
   printed).

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
import shutil
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
BF16_MMA_OPS_PER_S = 989e12     # H100 SXM, bf16 on the tensor cores, dense
#: int8 x f32 products as three bf16 terms of the f32 operand (three bf16
#: mma each, B2's tensor-core instance) reach a third of that
INT8_F32_3XBF16_OPS_PER_S = BF16_MMA_OPS_PER_S / 3
TOL = 1e-5

NUM_USERS, NUM_ITEMS, RANK = 138_000, 1_000_000, 16
BLOCK_ITEMS, BLOCK_TOPK = 512, 16
BATCHES = (8, 16, 256)
TIMED_RUNS = 30
#: (rank, blockItems) past one shared-memory stage of B2: rank 400 (K
#: passes) and 8,192-item tiles (global score rows), over the same catalog
#: at B=256; the served recall is checked on MIPS_WIDE_QUERIES of the batch
MIPS_WIDE = ((400, 512), (16, 8192))
MIPS_WIDE_BATCH, MIPS_WIDE_QUERIES = 256, 64
#: a per-tile top-R past B2's tensor-core instance (R > 64: the SIMT
#: passes instance), timed at the serving catalog's B=256
MIPS_PASSES_TOPK = 128
#: the micro-batcher's bucket ladder (workflow/microbatch.py): a flushed
#: batch of b queries pads to the next bucket, and RetrievalIndex.search
#: pads that to a multiple of 8 rows with zero queries, the rows B2 sees;
#: 16 is BATCHES' B = 16
BATCH_BUCKETS = (1, 4, 64, 128)

#: serve_fabric: the reference's serving A/B traffic
#: (predictionio_tpu/tools/serving_bench.py:1037-1044): 32 closed-loop
#: keep-alive clients, 960 {"user": u, "num": 10} queries over users drawn
#: from the seed, about 2% cold users and a few blackList queries; one
#: client for the span breakdown (at most the tracer's 128 recent traces); version 2 of the fabric's registry
#: changes FABRIC_SWAP_USERS users' rows
FABRIC_CLIENTS, FABRIC_QUERIES, FABRIC_COLD, FABRIC_BLACKLIST = 32, 960, 19, 24
FABRIC_TRACE_QUERIES, FABRIC_SWAP_USERS, FABRIC_SHARDS, FABRIC_WORKERS = 100, 48, 2, 2

#: the training configuration: the template's engine.json (rank 16, 10
#: iterations, lambda 0.1, seed 3, f32 factors, explicit) on the bench's
#: stand-in for MovieLens-20M, with its 256-event history cap
TRAIN_USERS, TRAIN_ITEMS, TRAIN_EDGES, TRAIN_CAP = 138_000, 27_000, 20_000_000, 256
RMSE_SAMPLE = 100_000
FOLDIN_USERS = 1_000
SMALL_EVENTS = 3_000
#: the store path at MovieLens-1M's width, 6,040 users of 3,706 items,
#: its depth cut from 1,000,209 ratings to 500,000 beside the templates
#: part, then to 250,000 beside the dist_train part, to keep the whole
#: script in its time (the import's rate falls as the store grows),
#: imported through ``pio import``; before it 40 batches of 50 and 20
#: single "view" events go through the event server (outside the
#: template's eventNames, so the training read and the events file hold
#: the same ratings)
STORE_EVENTS, STORE_USERS, STORE_ITEMS = 250_000, 6_040, 3_706
STORE_BATCHES, STORE_BATCH, STORE_SINGLES = 40, 50, 20
STORE_QUERIES = 10
#: the follow path on store_path's store: a fold-in window of 600 known
#: users (10% of 6,040, under the staleness budget's 0.2) rating 20 known
#: items each, plus 30 new users rating 10 items each, one of them among
#: 10 new items (0.27% item growth, under 0.05); then an escalating
#: window of 2 events each for 1,300 known users (21.5%, over 0.2)
FOLLOW_USERS, FOLLOW_EVENTS = 600, 20
FOLLOW_NEW_USERS, FOLLOW_NEW_EVENTS, FOLLOW_NEW_ITEMS = 30, 10, 10
FOLLOW_ESCALATE_USERS, FOLLOW_ESCALATE_EVENTS = 1_300, 2
#: served and checked after each swap: touched known users and new users
FOLLOW_QUERIES, FOLLOW_NEW_QUERIES = 10, 2
#: the reference's f32 solver-parity bar (tests/test_als_gram.py:198)
FIT_ATOL = 1e-4
#: ranks whose tiles spread over a block's warps and over groups of blocks,
#: up to the tensor-core instance's last (512) and the SIMT one's first
#: (513), checked on small blocks; the 2-iteration fit runs at 128 on the
#: full training data
B1_WIDE_RANKS, B1_WIDE_ROWS, B1_FIT_RANK = (65, 128, 200, 256, 512, 513), 2_000, 128
#: ranks with ragged tensor-core tiles among the small cases
B1_SMALL_RANKS = (8, 16, 17, 24, 32, 33, 64)
#: few-row blocks (fewer than rank 16's 8 rows a block; every group of a
#: wide row at once), each launch repeated
B1_FEW_RANKS, B1_FEW_ROWS, B1_FEW_REPEATS = (16, 128, 200, 512, 513), (1, 2, 5, 8), 4
#: ranks timed on the wide checks' 2,000 x 48 blocks (640: the SIMT instance)
B1_TIME_RANKS = (128, 200, 320, 512, 640)

#: the NCF template's widths (examples/ncf/engine.json); B3 is checked at
#: the serving catalog of B2's check and on the training stand-in's
NCF_E, NCF_HIDDEN = 32, (64, 32)
#: wider towers, checked and timed over 27,000 items: their weights no
#: longer fit shared memory beside the item tiles, so B3 stages them a
#: chunk per use and computes layer 1 once per 64 columns of H1 (at E =
#: 1536 its ring also holds E in chunks); the first and third are served
NCF_WIDE = ((64, (256, 128)), (128, (512, 256)), (64, (1600, 800)), (64, (4096, 2048)),
            (1536, (64, 32)))
NCF_SERVED_WIDE = (NCF_WIDE[0], NCF_WIDE[2])
NCF_WIDE_USERS, NCF_WIDE_QUERIES = 2_000, 3
NCF_SERVE_USERS, NCF_SERVE_ITEMS = NUM_USERS, NUM_ITEMS
NCF_TRAIN_ITEMS = TRAIN_ITEMS
#: catalogs at the template's widths: the edges of B3's 16-row m-tiles and
#: of its 128-item tiles (H1 <= 32), a ragged tile and the training catalog
NCF_SMALL_ITEMS = (1, 15, 16, 17, 127, 128, 129, 255, 256, 257, 1023, 1025, 5003, 27_000)
#: (items, E, (H0, H1)): widths that are not multiples of B3's 8-column
#: tiles, E not a multiple of 4 (4-byte copies), H0 past one 64-column
#: chunk and H1 past one 32-column chunk, a single hidden unit, the
#: 256-item tile edges of the instance past H1 = 32, and an H0 whose c0
#: does not fit shared memory beside the rest (recomputed per chunk)
NCF_ODD = ((3001, 8, (16, 8)), (3001, 5, (12, 7)), (2049, 64, (128, 64)), (2049, 33, (100, 45)),
           (1003, 5, (130, 9)), (1003, 100, (8, 70)), (517, 3, (1, 1)), (3001, 40, (300, 130)),
           (2047, 100, (200, 70)), (255, 64, (256, 128)), (256, 64, (256, 128)),
           (257, 64, (256, 128)), (300, 8, (60_000, 8)))
NCF_EPOCHS = 1          # the NCF training phase's cuts: epochs 5 -> 1, and
#: its ratings: the first 1,000,000 of the 20M (cut from all 20M beside the
#: dist_models part, to 2,500,000, then beside the pio_check phase, to keep
#: the script in its limit on the card's slower hosts)
NCF_TRAIN_RATINGS = 1_000_000
#: the SASRec training phase's cut, for the same reasons: epochs 10 -> 3,
#: then 3 -> 1
SEQ_TRAIN_EPOCHS = 1
NCF_HOLDOUT = 100_000

#: the flash-attention checks and timings: the sequence template's
#: training shape (batch 256, 2 heads of 16, maxLen 64) and a long one
SEQ_TRAIN_SHAPE = (256, 2, 64, 16)      # B, H, T, D
#: Ulysses' local attention on dist_models' [1, 2] ("data", "seq") mesh:
#: the training shape after the all-to-all, at H / 2 heads over the whole T
SEQ_ULYSSES_SHAPE = (256, 1, 64, 16)
SEQ_LONG_SHAPE = (16, 2, 1024, 16)
#: timed besides: the training shape at head dim 24 (zero-padded to 32 by
#: the wrappers, the copies timed with the call) and the long one at 128
SEQ_TRAIN24_SHAPE = (256, 2, 64, 24)
SEQ_LONG128_SHAPE = (16, 2, 1024, 128)
#: the long shape at a head dim past 128 (the chunked instances)
SEQ_LONG256_SHAPE = (16, 2, 1024, 256)
FLASH_CHECK_T = (1, 65, 200, 1024)
FLASH_CHECK_D = (8, 16, 32, 64)
#: head dims the kernels are not built for (24 zero-padded to 32, 136 to
#: 192), the largest instance below the chunked ones (128) and one of
#: theirs (256), at the training and the long T; and 512 at T 200
FLASH_PADDED_T = (64, 1024)
FLASH_PADDED_D = (24, 128, 136, 256)
FLASH_WIDE_T, FLASH_WIDE_D = 200, 512
#: SASRec widths whose head dims go through the padding (48 / 2 = 24) and
#: through the chunked instances (256 / 1), each 20 steps kernel vs plain
SEQ_PADDED_WIDTHS = ((48, 2), (256, 1))
#: the random SASRec served at head dim 256 (serve_seq_wide)
SEQ_WIDE_USERS, SEQ_WIDE_QUERIES = 2_000, 3
FLASH_TOL = 2e-5
SEQ_PLAIN_STEPS = 20
SEQ_SCORE_TOL = 1e-4
SEQ_HIT_BATCH = 4096


#: the script's start, for each phase line's ``t_s`` (seconds since it)
STARTED = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; a phase's line also says when it was printed."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - STARTED}
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


def raw_stage1_inputs(rng: np.random.Generator, nb: int, bi: int, k: int, b: int):
    """An int8 table of ``nb`` tiles of ``bi`` rows (any ``bi``, where
    ``pack_int8_blockwise`` takes multiples of 8), its scales and ``b``
    queries, on the card."""
    import torch

    q_table = rng.integers(-127, 128, (nb * bi, k)).astype(np.int8)
    scales = rng.uniform(0.01, 0.05, (nb, 1)).astype(np.float32)
    queries = rng.standard_normal((b, k)).astype(np.float32)
    return [torch.from_numpy(x).cuda() for x in (queries, q_table, scales)]


def stage1_instance(args, r: int) -> str:
    """The instance B2 runs for ``args`` at R = ``r``: ``mips_instance``,
    held to the kernel's own choice."""
    from predictionio_tpu_torch import _kernels
    from predictionio_tpu_torch.ops.mips import mips_instance

    k, nb = args[0].shape[1], args[2].shape[0]
    bi = args[1].shape[0] // nb
    name = mips_instance(k, bi, r)
    if _kernels.library("mips_topk").mips_block_topk_instance(k, bi, r) != ("mma", "passes").index(name):
        raise AssertionError(f"B2's instance at rank {k}, tile {bi}, R {r} is not {name}")
    return name


def compare_stage1(args, r: int, num_items: int, exact: bool) -> float:
    """Kernel vs plain on the same inputs; returns the max abs score
    error. Raises on disagreement beyond the stated tolerance."""
    import torch

    from predictionio_tpu_torch.ops.mips import mips_block_topk, mips_block_topk_plain

    stage1_instance(args, r)
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


def stage1_bound(b: int, padded: int, k: int, nb: int, r: int,
                 instance: str) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, bytes, operations) for one stage-1 call:
    each input read once (int8 table, scales, queries), each output
    written once ([B, nb, R] f32 scores + i32 indices); the products at
    the rate of the instance's arithmetic (three bf16 terms on the tensor
    cores, or f32 outside them)."""
    nbytes = padded * k + nb * 4 + b * k * 4 + b * nb * r * 8
    ops = 2.0 * b * padded * k
    rate = INT8_F32_3XBF16_OPS_PER_S if instance == "mma" else F32_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def time_stage1(args, r: int, num_items: int) -> dict:
    """B2 at R = ``r`` on ``args``: its time and R=1's, the plain
    version's, the library pair's (``torch.matmul`` against the table
    dequantized once outside the timing, then ``torch.topk`` per tile:
    two calls, so it is not ``library_ms``), the bound, the instance and
    its shared memory and scratch."""
    import torch

    from predictionio_tpu_torch import _kernels
    from predictionio_tpu_torch.ops.mips import mips_block_topk, mips_block_topk_plain

    queries, q_table, scales = args
    b, k = queries.shape
    padded, nb = q_table.shape[0], scales.shape[0]
    bi = padded // nb
    instance = stage1_instance(args, r)
    call = dict(block_topk=r, num_items=num_items)
    ms = cuda_ms(lambda: mips_block_topk(*args, **call))
    plain_ms = cuda_ms(lambda: mips_block_topk_plain(*args, **call))
    # R=1 keeps the staging and scoring and nearly all of the selection's
    # fixed work: the difference is what R itself costs
    ms_r1 = cuda_ms(lambda: mips_block_topk(*args, block_topk=1, num_items=num_items))
    deq = (q_table.reshape(nb, bi, k).float() * scales.reshape(nb, 1, 1)).reshape(padded, k)
    library_pair_ms = cuda_ms(
        lambda: torch.topk(torch.matmul(queries, deq.T).reshape(b, nb, bi), r, dim=2))
    del deq
    torch.cuda.empty_cache()
    lib = _kernels.library("mips_topk")
    bound_ms, bound_by, nbytes, ops = stage1_bound(b, padded, k, nb, r, instance)
    return {"batch": b, "items": num_items, "rank": k, "block_items": bi, "block_topk": r,
            "instance": instance, "smem_bytes": lib.mips_block_topk_smem_bytes(b, k, bi, r),
            "scratch_bytes": 4 * lib.mips_block_topk_scratch_floats(b, k, bi, r, nb),
            "ms": ms, "plain_ms": plain_ms, "ms_r1": ms_r1, "library_pair_ms": library_pair_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "operations": ops,
            "fraction_of_bound": bound_ms / ms}


def integer_factors(rng: np.random.Generator, n: int, k: int) -> np.ndarray:
    """Factors in {-127, 0, 127}: each tile's scale is exactly 1.0, so with
    integer queries every score is an exact integer whatever the order of
    the sums, and ties are everywhere."""
    return (127 * rng.integers(-1, 2, (n, k))).astype(np.float32)


def phase_check_and_time(rng: np.random.Generator) -> dict:
    import torch

    # small cases: exact indices (ties break to the lowest index; padding
    # drains as distinct indices after every real row; exact integer
    # scores tie within and across the kernel's 512-column sub-tiles; an
    # all-equal tile passes the threshold filter's survivor buffer), and
    # near-tie indices on random data (a ragged catalog, R past 32 and
    # past the tensor-core instance)
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
        "ties_across_subtiles": (
            integer_factors(rng, 20_000, 16),
            rng.integers(-3, 4, (16, 16)).astype(np.float32), 8192, 16,
        ),
        "ties_rank33_r32": (
            integer_factors(rng, 5_000, 33),
            rng.integers(-3, 4, (16, 33)).astype(np.float32), 1000, 32,
        ),
        "all_equal": (np.ones((2048, 16), np.float32), np.ones((16, 16), np.float32), 512, 16),
        "r32": (
            rng.standard_normal((20_000, 16)).astype(np.float32),
            rng.standard_normal((32, 16)).astype(np.float32), 512, 32,
        ),
        "r48": (
            rng.standard_normal((20_000, 16)).astype(np.float32),
            rng.standard_normal((32, 16)).astype(np.float32), 512, 48,
        ),
        "r80_passes": (
            rng.standard_normal((20_000, 16)).astype(np.float32),
            rng.standard_normal((32, 16)).astype(np.float32), 512, 80,
        ),
    }
    exact_cases = ("ties", "padding", "ties_across_subtiles", "ties_rank33_r32", "all_equal")
    worst = 0.0
    for name, (f, q, bi, r) in cases.items():
        args = stage1_inputs(f, q, bi)
        err = compare_stage1(args, r, f.shape[0], exact=name in exact_cases)
        worst = max(worst, err)
        emit({"phase": "check", "case": name, "instance": stage1_instance(args, r),
              "max_abs_err": err})
    # odd ranks (partial 16- and 32-column steps) at odd tiles (a partial
    # 16-row tensor-core tile; two 512-column sub-tiles), the last tile
    # part padding
    for k, bi, r in ((5, 100, 16), (17, 1000, 16), (33, 100, 1), (33, 1000, 16), (5, 1000, 32)):
        nb = 200
        args = raw_stage1_inputs(rng, nb, bi, k, 24)
        err = compare_stage1(args, r, nb * bi - 7, exact=False)
        worst = max(worst, err)
        emit({"phase": "check", "case": f"rank{k}_tile{bi}_r{r}",
              "instance": stage1_instance(args, r), "max_abs_err": err})
    factors = rng.standard_normal((NUM_ITEMS, RANK)).astype(np.float32)
    shapes = []
    for b in BATCHES:
        args = stage1_inputs(
            factors, rng.standard_normal((b, RANK)).astype(np.float32), BLOCK_ITEMS
        )
        err = compare_stage1(args, BLOCK_TOPK, NUM_ITEMS, exact=False)
        worst = max(worst, err)
        row = {**time_stage1(args, BLOCK_TOPK, NUM_ITEMS), "max_abs_err": err}
        emit({"phase": "time", **row})
        shapes.append(row)
        if b == max(BATCHES):
            # past the tensor-core instance's R: the SIMT passes instance
            err = compare_stage1(args, MIPS_PASSES_TOPK, NUM_ITEMS, exact=False)
            worst = max(worst, err)
            row = {**time_stage1(args, MIPS_PASSES_TOPK, NUM_ITEMS), "max_abs_err": err}
            emit({"phase": "time", **row})
            shapes.append(row)
        del args
        torch.cuda.empty_cache()
    for bucket in BATCH_BUCKETS:
        # a flushed batch as the serving path hands it to B2: ``bucket``
        # queries, then RetrievalIndex.search's zero rows up to a multiple
        # of 8 (a generator of its own: the later phases keep their data)
        rows = -(-bucket // 8) * 8
        queries = np.zeros((rows, RANK), np.float32)
        queries[:bucket] = np.random.default_rng([7, bucket]).standard_normal((bucket, RANK))
        args = stage1_inputs(factors, queries, BLOCK_ITEMS)
        err = compare_stage1(args, BLOCK_TOPK, NUM_ITEMS, exact=False)
        worst = max(worst, err)
        row = {**time_stage1(args, BLOCK_TOPK, NUM_ITEMS), "bucket": bucket, "max_abs_err": err}
        emit({"phase": "time", **row})
        shapes.append(row)
        del args
        torch.cuda.empty_cache()
    wide = []
    for rank, block_items in MIPS_WIDE:
        # a generator of their own: the later phases keep the data they had
        row = mips_wide(np.random.default_rng([rank, block_items]), rank, block_items)
        worst = max(worst, row["max_abs_err"])
        emit({"phase": "time", **row})
        wide.append(row)
    return {"shapes": shapes, "wide_shapes": wide, "max_abs_err": worst}


def mips_wide(rng: np.random.Generator, rank: int, block_items: int) -> dict:
    """B2 at a rank or tile size past the serving one, over the 1M
    catalog at B=256: against its plain version (indices equal up to
    near-ties, as ``compare_stage1``), timed beside its bound, and the
    serving search (``RetrievalIndex.search``, stage 1 through B2) held
    to recall@10 >= 0.99 against the exact f32 scan."""
    import torch

    from predictionio_tpu_torch.ops.mips import RetrievalConfig, RetrievalIndex, mips_block_topk

    factors = rng.standard_normal((NUM_ITEMS, rank)).astype(np.float32)
    queries = rng.standard_normal((MIPS_WIDE_BATCH, rank)).astype(np.float32)
    args = stage1_inputs(factors, queries, block_items)
    err = compare_stage1(args, BLOCK_TOPK, NUM_ITEMS, exact=False)
    timed = time_stage1(args, BLOCK_TOPK, NUM_ITEMS)
    del args
    torch.cuda.empty_cache()

    config = RetrievalConfig(mode="mips", block_items=block_items, block_topk=BLOCK_TOPK)
    index = RetrievalIndex(factors, config, device="cuda")
    picked = queries[:MIPS_WIDE_QUERIES]
    before = mips_block_topk.launches
    idx, scores = index.search(picked)
    launches = mips_block_topk.launches - before
    exact = torch.from_numpy(picked).cuda() @ index._table.T          # [Q, items]
    want = torch.topk(exact, 10, dim=1).indices.cpu().numpy()
    order = np.argsort(-scores, axis=1, kind="stable")[:, :10]
    got = np.take_along_axis(idx, order, axis=1)
    recall = float(np.mean([len(set(g) & set(w)) / 10 for g, w in zip(got, want)]))
    if launches != 1 or recall < 0.99:
        raise AssertionError(f"rank {rank}, blockItems {block_items}: {launches} B2 launches, "
                             f"recall@10 {recall} against the exact scan")
    del index, exact
    torch.cuda.empty_cache()
    return {**timed, "max_abs_err": err, "search_queries": len(picked),
            "search_launches": launches, "search_recall_at_10": recall}


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
        service.close()
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
# the serving fabric: the micro-batcher, the frontend tier, scorer shards
# --------------------------------------------------------------------------


def fabric_traffic(rng: np.random.Generator) -> list[dict]:
    """The serving A/B's queries: FABRIC_QUERIES over users drawn from
    ``rng``, FABRIC_COLD of them cold users and FABRIC_BLACKLIST known
    users with a 3-item blackList."""
    queries = [{"user": f"u{u}", "num": 10} for u in rng.integers(0, NUM_USERS, FABRIC_QUERIES)]
    picks = rng.permutation(FABRIC_QUERIES)
    for j in picks[:FABRIC_COLD]:
        queries[j] = {"user": f"cold-{j}", "num": 10}
    for j in picks[FABRIC_COLD:FABRIC_COLD + FABRIC_BLACKLIST]:
        queries[j]["blackList"] = [f"i{i}" for i in rng.integers(0, NUM_ITEMS, 3)]
    return queries


def drive(port: int, queries: list[dict], clients: int) -> dict:
    """``clients`` closed-loop keep-alive clients released together,
    client k posting queries k, k + clients, ... in turn: each answer's
    body bytes and ``x-pio-model-version``, queries/s, and the round
    trips' p50 and p99 in ms (host clock). Raises unless every answer is
    a 200 (a 5xx among them is named)."""
    answers = [None] * len(queries)
    errors = []
    barrier = threading.Barrier(clients + 1)

    def client(k: int) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            barrier.wait(timeout=120)
            for j in range(k, len(queries), clients):
                t0 = time.perf_counter()
                conn.request("POST", "/queries.json", body=json.dumps(queries[j]).encode(),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = resp.read()
                answers[j] = (resp.status, body, resp.getheader("x-pio-model-version"),
                              (time.perf_counter() - t0) * 1e3)
        except Exception as exc:  # raised below, with the others
            errors.append(repr(exc))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,), daemon=True) for k in range(clients)]
    for t in threads:
        t.start()
    barrier.wait(timeout=120)
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    seconds = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads) or any(a is None for a in answers):
        raise AssertionError(f"{len(errors)} clients failed: {errors[:3]}")
    bad = [(q, a[0], a[1][:200]) for q, a in zip(queries, answers) if a[0] != 200]
    if bad:
        raise AssertionError(f"{len(bad)} answers not 200, "
                             f"{sum(b[1] >= 500 for b in bad)} of them 5xx: {bad[:3]}")
    ms = [a[3] for a in answers]
    return {"bodies": [a[1] for a in answers], "versions": [a[2] for a in answers],
            "ms": ms, "seconds": seconds, "queries_per_s": len(queries) / seconds,
            "p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99))}


def load_summary(run: dict) -> dict:
    return {k: run[k] for k in ("queries_per_s", "p50_ms", "p99_ms", "seconds")}


def same_bodies(got: dict, want: dict, what: str) -> None:
    differ = [j for j, (a, b) in enumerate(zip(got["bodies"], want["bodies"])) if a != b]
    if differ:
        raise AssertionError(f"{what}: {len(differ)} of {len(got['bodies'])} bodies "
                             f"differ from the sequential unbatched server's, first at query "
                             f"{differ[0]}")


def scrape(port: int, path: str = "/metrics") -> dict:
    """``{series: value}`` of a Prometheus ``GET /metrics`` (a series is
    the name with its labels)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        text = resp.read().decode()
    finally:
        conn.close()
    if resp.status != 200:
        raise AssertionError(f"GET {path} answered {resp.status}")
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            series, value = line.rsplit(" ", 1)
            out[series] = float(value)
    return out


def batch_stats(metrics: dict) -> dict:
    """Flushes by closing reason, and the real (unpadded) batch size's
    mean and largest, from ``pio_serving_batch_size`` (the largest as
    the upper bound of the histogram bucket that holds it)."""
    reasons = {k.split('reason="', 1)[1].split('"', 1)[0]: v for k, v in metrics.items()
               if k.startswith("pio_serving_batch_flush_total{")}
    count = metrics.get("pio_serving_batch_size_count", 0.0)
    total = metrics.get("pio_serving_batch_size_sum", 0.0)
    holding = sorted(float(k.split('le="', 1)[1].split('"', 1)[0]) for k, v in metrics.items()
                     if k.startswith("pio_serving_batch_size_bucket{") and count and v >= count)
    return {"flushes": sum(reasons.values()), "flush_reasons": reasons,
            "batch_size_mean": total / count if count else None,
            "batch_size_max_at_most": holding[0] if holding else None}


def span_breakdown(port: int, run: dict) -> dict:
    """The median ms of each span of the last ``len(run["ms"])`` query
    traces (every query traced), beside the client's round trip: what a
    round trip spends outside the root span is the HTTP stack's."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("GET", f"/traces.json?op=queries.json&limit={len(run['ms'])}")
        traces = json.loads(conn.getresponse().read())["recent"]
    finally:
        conn.close()
    if len(traces) != len(run["ms"]):
        raise AssertionError(f"{len(traces)} query traces for {len(run['ms'])} queries")
    per_op: dict = {}
    for trace in traces:
        spans: dict = {}
        for span in trace["spans"]:
            spans[span["op"]] = spans.get(span["op"], 0.0) + span["durationMs"]
        for op, ms in spans.items():
            per_op.setdefault(op, []).append(ms)
    medians = {op: statistics.median(v) for op, v in per_op.items()}
    root = medians.get("POST /queries.json")
    round_trip = statistics.median(run["ms"])
    return {"traces": len(traces), "round_trip_ms_p50": round_trip, "span_ms_p50": medians,
            "outside_root_ms": None if root is None else round_trip - root}


@contextlib.contextmanager
def serving(server, service):
    """``build_query_server``'s pair, served in a thread for the block;
    then the listener stops and the batcher drains."""
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("query server thread did not stop")


def compute_app_pids() -> set:
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return {int(x) for x in out.stdout.split() if x.strip().isdigit()}


def phase_serve_fabric(rng: np.random.Generator, workdir: str) -> dict:
    """serve's saved model (138,000 x 1,000,000 x rank 16, mips) under the
    reference's serving A/B traffic, through four deploys in turn:

    (b) unbatched (``max_batch_size=1``): one client first, whose answers
        every other deploy is held to byte for byte, then 32 clients;
    (a) the default deploy (the micro-batcher: 64 queries, 2 ms, buckets
        1/4/16/64/128): 32 clients; B2 at most once per flushed batch and
        fewer times than the known-user queries; then one client with
        every query traced, for the span breakdown of a round trip;
    (c) ``frontend_workers=2`` with async dispatch: B2 in the scorer,
        at most 2 wakeups per request;
    (d) the sharded fabric (2 scorer shard processes on cuda, 2
        frontends) on registry version 1 (the same model, with 2
        per-shard blobs), then ``POST /models/swap`` to version 2
        (FABRIC_SWAP_USERS of the queried users' rows changed): every
        shard launches B2 (its control face's ``/metrics``), holds a CUDA
        context, and stamps version 2; version 2's answers equal an
        unbatched single-process server's on version 2.
    Launch counts are zeroed just before each deploy's traffic and read
    just after it."""
    import dataclasses as _dc

    from predictionio_tpu_torch.models.recommendation import ALSAlgorithm, load_model
    from predictionio_tpu_torch.online.registry import ModelRegistry
    from predictionio_tpu_torch.ops import mips
    from predictionio_tpu_torch.parallel.als import ALSModel
    from predictionio_tpu_torch.serving.procserver import FrontendConfig
    from predictionio_tpu_torch.serving.shardmap import shard_of
    from predictionio_tpu_torch.tools.cli import build_query_server
    from predictionio_tpu_torch.workflow.create_server import (
        create_multiproc_query_server,
        create_sharded_query_server,
    )
    from predictionio_tpu_torch.workflow.json_extractor import build_engine, load_engine_variant

    t_phase = time.perf_counter()
    model_dir = os.path.join(workdir, "model")
    engine_json = os.path.join(workdir, "engine.json")
    queries = fabric_traffic(rng)
    known = [q for q in queries if not q["user"].startswith("cold-")]
    result = {"users": NUM_USERS, "items": NUM_ITEMS, "rank": RANK, "clients": FABRIC_CLIENTS,
              "queries": len(queries), "known_user_queries": len(known)}

    # (b) the unbatched deploy: the sequential answers, then the load
    server, service = build_query_server(engine_json, model_dir, port=0, device="cuda",
                                         batching=unbatched())
    with serving(server, service) as port:
        reference = drive(port, queries, 1)
        mips.mips_block_topk.launches = 0
        load = drive(port, queries, FABRIC_CLIENTS)
        launches = mips.mips_block_topk.launches
        one = drive(port, queries[:FABRIC_TRACE_QUERIES], 1)
    same_bodies(load, reference, "unbatched, 32 clients")
    result["unbatched"] = {**load_summary(load), "b2_launches": launches,
                           "sequential_p50_ms": reference["p50_ms"],
                           "one_client_p50_ms": one["p50_ms"]}

    # (a) the default deploy: the micro-batcher
    server, service = build_query_server(engine_json, model_dir, port=0, device="cuda")
    if not service.batching.enabled:
        raise AssertionError("the default deploy does not batch")
    with serving(server, service) as port:
        mips.mips_block_topk.launches = 0
        load = drive(port, queries, FABRIC_CLIENTS)
        launches = mips.mips_block_topk.launches
        stats = batch_stats(scrape(port))
        service.router.tracer.sample = 1.0   # every query of the next run traced
        one = drive(port, queries[:FABRIC_TRACE_QUERIES], 1)
        spans = span_breakdown(port, one)
    same_bodies(load, reference, "batched, 32 clients")
    same_bodies(one, {"bodies": reference["bodies"][:FABRIC_TRACE_QUERIES]}, "batched, 1 client")
    if not 0 < launches <= stats["flushes"] or launches >= len(known):
        raise AssertionError(f"batched: {launches} B2 launches for {stats['flushes']} flushes "
                             f"and {len(known)} known-user queries")
    result["batched"] = {**load_summary(load), **stats, "b2_launches": launches,
                         "one_client_p50_ms": one["p50_ms"], "one_client_spans": spans}

    # (c) the multi-process tier: two SO_REUSEPORT frontends, async dispatch
    handle, service = create_multiproc_query_server(
        load_engine_variant(engine_json), "127.0.0.1", 0, model_path=model_dir, device="cuda",
        frontend=FrontendConfig(workers=FABRIC_WORKERS, dispatch="async"))
    try:
        handle.start()
        mips.mips_block_topk.launches = 0
        load = drive(handle.port, queries, FABRIC_CLIENTS)
        launches = mips.mips_block_topk.launches
        metrics = scrape(handle.port)
    finally:
        handle.stop()
        service.close()
    same_bodies(load, reference, "frontend workers")
    wakeups = metrics.get("pio_scorer_wakeups_per_request")
    if launches < 1 or wakeups is None or not wakeups <= 2.0:
        raise AssertionError(f"frontend workers: {launches} B2 launches in the scorer, "
                             f"{wakeups} wakeups per request (at most 2 under async dispatch)")
    result["multiproc"] = {**load_summary(load), **batch_stats(metrics), "b2_launches": launches,
                           "workers": FABRIC_WORKERS, "dispatch": "async",
                           "wakeups_per_request": wakeups,
                           "dispatch_threads": metrics.get("pio_scorer_dispatch_threads")}

    # (d) the sharded fabric on registry versions 1 and 2
    with fresh_store(workdir, "fabric_store"):
        variant = load_engine_variant(engine_json)
        engine = build_engine(variant)
        algorithm = ALSAlgorithm(variant.engine_params.algorithm_params_list[0][1], device="cuda")

        def blob_of(model):
            return engine.serialize_models(None, variant.engine_params, "", [model])

        base = load_model(model_dir)
        factors = base.als.user_factors.copy()
        changed = rng.choice(sorted({base.user_index[q["user"]] for q in known}),
                             size=FABRIC_SWAP_USERS, replace=False)
        factors[changed] = rng.standard_normal((FABRIC_SWAP_USERS, RANK)).astype(np.float32)
        second = _dc.replace(base, als=ALSModel(user_factors=factors,
                                                 item_factors=base.als.item_factors))
        registry = ModelRegistry.for_variant(variant)
        t0 = time.perf_counter()
        for model in (base, second):
            registry.publish(
                blob_of(model),
                meta={"source": "chip_smoke", "engine_params": variant.engine_params.to_json_obj()},
                shard_blobs=[blob_of(algorithm.shard_model(model, k, FABRIC_SHARDS))
                             for k in range(FABRIC_SHARDS)],
            )
        publish_s = time.perf_counter() - t0
        del base, second, factors
        v1 = registry.get(1)
        blob_bytes = {"full": v1.manifest["blob_bytes"],
                      "shards": [b["bytes"] for b in v1.manifest["shards"]["blobs"]]}
        fabric = create_sharded_query_server(
            variant, "127.0.0.1", 0, scorer_shards=FABRIC_SHARDS, model_version=1,
            device="cuda", frontend=FrontendConfig(workers=FABRIC_WORKERS, spawn_timeout_s=300.0))
        t0 = time.perf_counter()
        fabric.start()
        try:
            start_s = time.perf_counter() - t0
            ports = [fabric._shard_port(k) for k in range(FABRIC_SHARDS)]
            pids = [fabric._shards[k].proc.pid for k in range(FABRIC_SHARDS)]
            b2 = 'pio_kernel_launches_total{kernel="mips_block_topk"}'
            before = [scrape(p).get(b2, 0.0) for p in ports]
            load = drive(fabric.port, queries, FABRIC_CLIENTS)
            shard_metrics = [scrape(p) for p in ports]
            shard_launches = [m.get(b2, 0.0) - b for m, b in zip(shard_metrics, before)]
            listed = compute_app_pids()
            t0 = time.perf_counter()
            conn = http.client.HTTPConnection("127.0.0.1", fabric.port, timeout=300)
            try:
                conn.request("POST", "/models/swap", body=b"{}",
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                swap = json.loads(resp.read())
            finally:
                conn.close()
            swap_s = time.perf_counter() - t0
            load2 = drive(fabric.port, queries, FABRIC_CLIENTS)
        finally:
            fabric.stop()
        server, service = build_query_server(engine_json, None, model_version=2, port=0,
                                             device="cuda", batching=unbatched())
        with serving(server, service) as port:
            reference2 = drive(port, queries, 1)
    same_bodies(load, reference, "sharded fabric, version 1")
    same_bodies(load2, reference2, "sharded fabric, version 2")
    owners = {shard_of(q["user"], FABRIC_SHARDS) for q in known}
    if set(load["versions"]) != {"1"} or set(load2["versions"]) != {"2"} or len(owners) < 2:
        raise AssertionError(f"fabric versions {set(load['versions'])} then "
                             f"{set(load2['versions'])} over shards {owners}")
    if resp.status != 200 or [s.get("modelVersion") for s in swap.get("shards", [])] != [2, 2]:
        raise AssertionError(f"swap answered {resp.status}: {swap}")
    if min(shard_launches) < 1:
        raise AssertionError(f"shard B2 launches {shard_launches}: every shard must launch B2")
    on_cuda = [any(k.startswith("pio_build_info") and 'backend="cuda"' in k for k in m)
               for m in shard_metrics]
    # nvidia-smi lists compute apps by pid; where it sees this process's
    # pid namespace (this process holds a context too), every shard's pid
    # must be listed
    sees_pids = os.getpid() in listed
    if not all(on_cuda) or (sees_pids and not set(pids) <= listed):
        raise AssertionError(f"shard pids {pids}, nvidia-smi compute apps {sorted(listed)}, "
                             f"CUDA initialised in each shard: {on_cuda}")
    result["sharded"] = {
        **load_summary(load), "shards": FABRIC_SHARDS, "workers": FABRIC_WORKERS,
        "start_s": start_s, "publish_s": publish_s, "blob_bytes": blob_bytes,
        "b2_launches": shard_launches,
        "shard_batches": [batch_stats(m) for m in shard_metrics],
        "shard_pids": pids, "nvidia_smi_compute_pids": sorted(listed),
        "nvidia_smi_sees_pids": sees_pids, "shard_cuda_initialised": on_cuda,
        "swap_s": swap_s, "swapped_versions": [s["modelVersion"] for s in swap["shards"]],
        "after_swap": load_summary(load2), "changed_users": FABRIC_SWAP_USERS,
        "changed_answers": sum(a != b for a, b in zip(reference["bodies"], reference2["bodies"])),
    }
    result["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "serve_fabric", **result})
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
    from predictionio_tpu_torch.ops import als_gram, ragged
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
    ragged.PACK_ROUTES.clear()
    t0 = time.perf_counter()
    prepared = RecommendationPreparator(prep_params).prepare(ctx, data)
    pack_s = time.perf_counter() - t0
    pack_routes = ragged.pack_routes()
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
        "generate_s": generate_s, "pack_s": pack_s, "pack_routes": pack_routes,
        "train_s": train_s,
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


def phase_pack_compare(ratings) -> dict:
    """One pack of the train part's 20M ratings (the user side: its
    256-event cap, each user's latest by time) on each route: the native
    packer, then the numpy path ``PIO_NATIVE=0`` asks for, each timed,
    the two held equal byte for byte."""
    from predictionio_tpu_torch.ops import ragged

    users, items, values, times = ratings
    args, kwargs = (users, items, values, TRAIN_USERS, TRAIN_ITEMS), {
        "max_len": TRAIN_CAP, "times": times}
    before = ragged.pack_routes()
    t0 = time.perf_counter()
    native_pack = ragged.pack_padded_csr(*args, **kwargs)
    native_s = time.perf_counter() - t0
    asked = os.environ.get("PIO_NATIVE")
    os.environ["PIO_NATIVE"] = "0"
    try:
        t0 = time.perf_counter()
        numpy_pack = ragged.pack_padded_csr(*args, **kwargs)
        numpy_s = time.perf_counter() - t0
    finally:
        if asked is None:
            os.environ.pop("PIO_NATIVE")
        else:
            os.environ["PIO_NATIVE"] = asked
    routes = {k: v - before[k] for k, v in ragged.pack_routes().items()}
    if routes != {"native": 1, "numpy": 1}:
        raise AssertionError(f"pack_compare: routes {routes}")
    for name in ("indices", "values", "mask"):
        if getattr(native_pack, name).tobytes() != getattr(numpy_pack, name).tobytes():
            raise AssertionError(f"pack_compare: the routes' {name} differ")
    if native_pack.truncated != numpy_pack.truncated:
        raise AssertionError("pack_compare: the routes truncate apart")
    result = {"ratings": int(users.size), "shape": list(native_pack.indices.shape),
              "truncated": native_pack.truncated, "native_s": native_s, "numpy_s": numpy_s,
              "bytes_equal": True}
    emit({"phase": "pack_compare", **result})
    return result


#: each part's packs by route (``pack_routes_of``)
PACKS: dict = {}


@contextlib.contextmanager
def pack_routes_of(part: str):
    """Count the packs of the block, ``part`` of the script, by route:
    every count set to 0 first, read at the end, printed. A pack on the
    numpy route fails the part unless ``PIO_NATIVE=0`` asked for it."""
    from predictionio_tpu_torch import native
    from predictionio_tpu_torch.ops import ragged

    ragged.PACK_ROUTES.clear()
    yield
    PACKS[part] = routes = ragged.pack_routes()
    emit({"phase": "pack_routes", "part": part, **routes})
    if routes["numpy"] and native.enabled():
        raise AssertionError(f"{part}: {routes['numpy']} packs took the numpy route")


# --------------------------------------------------------------------------
# profile_train: the ALS fit under ``pio train --profile``'s trace
# --------------------------------------------------------------------------

#: idle gaps listed from the profiled fit's trace, and host calls under each
PROFILE_GAPS, PROFILE_GAP_CALLS = 5, 4
#: CPU-side events of a torch.profiler Chrome trace that can sit under a gap
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def merged(intervals: list) -> list:
    """Sorted, merged ``[start, end]`` intervals."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def covered(intervals: list, lo: float, hi: float) -> float:
    """Length of the merged ``intervals`` inside ``[lo, hi]``."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in intervals)


def analyse_fit_trace(path: str) -> dict:
    """A profiled ALS fit's Chrome trace (``workflow/core_workflow.py::
    profile_trace``; times in microseconds): per ``als.iteration`` range,
    the device ms of B1 (kernels named ``gram_rhs``), of the ridge and
    solve (kernels launched inside ``als.solve`` ranges: the ridge's
    elementwise add, ``torch.linalg.cholesky_ex``, ``cholesky_solve``),
    of everything else, and the share of the range the card idled; the
    longest idle gaps of the fit and the host calls under each."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    iters = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e.get("name") == "als.iteration"), key=lambda e: e["ts"])
    solves = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation" and e.get("name") == "als.solve"]
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    host = [e for e in events if e.get("cat") in HOST_CATS]

    def part(kernel) -> str:
        if "gram_rhs" in kernel["name"]:
            return "b1"
        t = launches.get(kernel.get("args", {}).get("correlation"))
        if t is not None and any(lo <= t <= hi for lo, hi in solves):
            return "solve"
        return "other"

    busy = merged([[e["ts"], e["ts"] + e["dur"]] for e in device])
    per_iteration, names = [], {}
    for e in iters:
        lo, hi = e["ts"], e["ts"] + e["dur"]
        ms = {"b1": 0.0, "solve": 0.0, "other": 0.0}
        for k in device:
            if lo <= k["ts"] < hi:
                ms[part(k)] += k["dur"] / 1e3
                if part(k) != "b1":
                    names[k["name"][:80]] = names.get(k["name"][:80], 0.0) + k["dur"] / 1e3
        per_iteration.append({
            "window_ms": e["dur"] / 1e3, "b1_ms": ms["b1"], "solve_ms": ms["solve"],
            "other_ms": ms["other"], "idle_share": 1.0 - covered(busy, lo, hi) / e["dur"]})
    gaps = []
    if iters:
        lo, hi = iters[0]["ts"], iters[-1]["ts"] + iters[-1]["dur"]
        inside = [[max(s, lo), min(e, hi)] for s, e in busy if e > lo and s < hi]
        edges = [lo] + [x for s, e in inside for x in (s, e)] + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)),
                      reverse=True)[:PROFILE_GAPS]
    listed = []
    for length, start in gaps:
        end = start + length
        under = sorted(((min(h["ts"] + h["dur"], end) - max(h["ts"], start), h["name"][:80])
                        for h in host if h["ts"] < end and h["ts"] + h["dur"] > start),
                       reverse=True)[:PROFILE_GAP_CALLS]
        listed.append({"gap_ms": length / 1e3,
                       "host_calls": [{"name": n, "overlap_ms": o / 1e3} for o, n in under]})
    return {
        "b1_kernels": sum(1 for k in device if "gram_rhs" in k["name"]),
        "iterations": per_iteration,
        "top_other_kernels_ms": dict(sorted(names.items(), key=lambda kv: -kv[1])[:8]),
        "longest_idle_gaps": listed,
    }


def phase_profile_train(trained: dict, repo: str, workdir: str) -> dict:
    """One profiled fit of phase_train's data and template params (10
    iterations) through ``ALSAlgorithm.train`` with ``pio.profile`` in
    the runtime conf -- the journal of ``_build_telemetry`` -- under
    ``profile_trace``, the trace ``pio train --profile`` writes. Gates:
    10 step lines, 20 B1 kernels in the trace (and 20 launches counted),
    the trace file present. Prints each iteration's wall time, edges/s
    and achieved GB/s from the journal and, from the trace, its B1,
    ridge + solve and other device ms and its idle share, and the fit's
    longest idle gaps with the host calls under them."""
    from predictionio_tpu_torch.controller.base import TrainContext
    from predictionio_tpu_torch.models.ncf import kernel as ncf_kernel
    from predictionio_tpu_torch.models.recommendation import ALSAlgorithm, RatingsData
    from predictionio_tpu_torch.ops import als_gram, mips
    from predictionio_tpu_torch.workflow.core_workflow import profile_trace

    users, items, ratings, times = trained["ratings"]
    data = RatingsData(users=users, items=items, ratings=ratings, times=times,
                       user_ids=[f"u{u}" for u in range(TRAIN_USERS)],
                       item_ids=[f"i{i}" for i in range(TRAIN_ITEMS)])
    algo_params, _ = template_params(repo)
    algorithm = ALSAlgorithm(algo_params, device="cuda")
    profile_dir = os.path.join(workdir, "pio-profile")
    ctx = TrainContext(device="cuda", runtime_conf={"pio.profile": profile_dir})
    als_gram.gram_rhs.launches = 0           # counts start at 0 here
    mips.mips_block_topk.launches = 0
    ncf_kernel.ncf_score_all_items.launches = 0
    zero_flash_counts()
    t0 = time.perf_counter()
    with profile_trace(profile_dir, "cuda", "profile_train") as trace_path:
        algorithm.train(ctx, (data, trained["als_data"]))
    profiled_s = time.perf_counter() - t0
    launches = als_gram.gram_rhs.launches    # read here
    counted = {"gram_rhs": launches, "mips_block_topk": mips.mips_block_topk.launches,
               "ncf_score_all_items": ncf_kernel.ncf_score_all_items.launches,
               **flash_counts()}
    iterations = trained["config"].iterations
    with open(os.path.join(profile_dir, "als-telemetry.jsonl")) as f:
        journal = [json.loads(line) for line in f]
    steps = [line for line in journal if line["event"] == "step"]
    if len(steps) != iterations or not os.path.exists(trace_path):
        raise AssertionError(f"{len(steps)} journal steps, trace {trace_path}")
    t0 = time.perf_counter()
    trace = analyse_fit_trace(trace_path)
    analyse_s = time.perf_counter() - t0
    if trace["b1_kernels"] != 2 * iterations or launches != 2 * iterations:
        raise AssertionError(f"B1 kernels in the trace {trace['b1_kernels']}, launches "
                             f"{launches}, expected {2 * iterations}")
    if len(trace["iterations"]) != iterations:
        raise AssertionError(f"{len(trace['iterations'])} als.iteration ranges in the trace")
    result = {
        "meta": {k: journal[0][k] for k in ("edges", "modeled_bytes_per_iter", "solver",
                                            "platform", "rank", "iterations")},
        "journal": [{k: s[k] for k in ("step", "wall_s", "edges_per_sec", "achieved_gbps")}
                    for s in steps],
        "wall_s_median": statistics.median(s["wall_s"] for s in steps),
        "launches": counted,
        "trace_file_bytes": os.path.getsize(trace_path),
        "profiled_train_s": profiled_s, "analyse_s": analyse_s, **trace,
    }
    emit({"phase": "profile_train", **result})
    return result


def b1_bound(rows: int, pad_len: int, table_rows: int, rank: int,
             itemsize: int) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, bytes, operations) of one B1 call. Bytes:
    what the function must move, each input read once and each output
    written once: indices (i32) and values (f32), the gather table once
    (a factor table fits the 50 MB L2, so its repeated reads by the
    gather need not reach device memory), Gram and rhs (f32). Operations:
    2*R*L*K^2 + 2*R*L*K, the full K x K Gram and the rhs, counted at
    3xTF32's rate on the tensor cores (as ``flash_bound`` counts the
    attention products): the card can do these f32 products there, and
    the kernel does. The larger of bytes over the memory rate and
    operations over that rate."""
    nbytes = (rows * pad_len * (4 + 4) + table_rows * rank * itemsize
              + rows * (rank * rank + rank) * 4)
    ops = 2.0 * rows * pad_len * rank * rank + 2.0 * rows * pad_len * rank
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_3XTF32_OPS_PER_S
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
    error and the largest per-row error relative to max|gram|.

    The tensor-core instance computes in 3xTF32 (``mma_tf32.cuh``): each
    operand splits into a TF32 hi rounded to nearest and the exact f32
    rest, which the tensor core reads truncated, so each product loses at
    most about 1.5 2^-21 = 12 2^-24 of itself (the rest's truncation and
    the dropped lo*lo term); an 8-slot step's sum, truncated by the
    tensor core, adds about 2 2^-24 of the step's absolute sum, and the f32
    adds of the steps L/8 2^-24 of the total. Its own error is then at
    most about (14 + L/8) 2^-24 S, within the plain version's (L + 2)
    2^-24 S allowance at every L the checks run (40 and up). A case that
    fails is the kernel's fault, not the bound's."""
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
    for k in B1_SMALL_RANKS:
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
                if not torch.equal(gram, gram.transpose(1, 2)):
                    raise AssertionError(f"B1 at rank {k}: the Gram is not exactly symmetric")
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
                if (als_gram.gram_instance(k) == "mma"
                        and not torch.equal(gram, gram.transpose(1, 2))):
                    raise AssertionError(f"B1 at rank {k}: the Gram is not exactly symmetric")
                case = max(case, err)
                worst[f"k{k}"] = max(worst.get(f"k{k}", 0.0), err)
        emit({"phase": "check_b1", "case": f"wide_k{k}", "shape": [r, l],
              "dtypes": ["float32", "bfloat16"], "modes": ["explicit", "implicit"],
              "max_abs_err": case})
    # few rows: fewer than rank 16's 8 rows a block, and at the wide ranks
    # every group's block of a row at once, so a block that stored into
    # another's entries would race it. Each entry has one owner that sums
    # it in a fixed order: repeats agree bit for bit.
    for k in B1_FEW_RANKS:
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
            worst[f"k{k}"] = max(worst.get(f"k{k}", 0.0), case)
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
    return {"max_abs_err": max(worst.values()), "fit_rank_diff": fit_diff,
            "fit_fused_s": fused_s, "fit_xla_s": xla_s}


def phase_time_b1(rng: np.random.Generator, trained: dict, b1_check: dict) -> dict:
    """B1 and its plain version timed at both half-step shapes of the fit,
    f32 and bf16 tables, explicit mode (the template's), beside the bound
    and the gather's L2 bytes; and the parts of one half-step: B1, the
    ridge + solve, the whole ``solve_rows``, and the host-to-device
    transfer of the blocks. Then B1 at the wide ranks on random 2,000 x 48
    blocks, and the rank-128 fit's seconds from ``check_b1``."""
    import torch

    from predictionio_tpu_torch.ops.als_gram import (
        gram_instance,
        gram_rhs,
        gram_rhs_plain,
        half_step_bytes,
    )
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
                # the gather's reads of table rows, served from L2 (the
                # table fits it): outside the bound, likely the floor
                "gather_l2_bytes": rows * pad_len * config.rank * itemsize,
                "reference_bytes_model": ref_bytes,
                "reference_bytes_model_ms": ref_bytes / HBM_BYTES_PER_S * 1e3,
                "fraction_of_bound": bound_ms / ms,
            }
            emit({"phase": "time_b1", **row})
            shapes.append(row)
        del table32, table
        torch.cuda.empty_cache()
    wide = []
    for k in B1_TIME_RANKS:
        s, l, r = 3000, 48, B1_WIDE_ROWS
        table = torch.from_numpy(np.concatenate(
            [rng.standard_normal((s, k)), np.zeros((1, k))]).astype(np.float32)).cuda()
        idx = torch.from_numpy(rng.integers(0, s + 1, (r, l)).astype(np.int32)).cuda()
        val = torch.from_numpy(rng.integers(1, 6, (r, l)).astype(np.float32)).cuda()
        bound_ms, bound_by, nbytes, ops = b1_bound(r, l, s + 1, k, 4)
        row = {"side": "random", "rows": r, "pad_len": l, "rank": k, "dtype": "float32",
               "instance": gram_instance(k),
               "ms": cuda_ms(lambda: gram_rhs(idx, val, table)),
               "plain_ms": cuda_ms(lambda: gram_rhs_plain(idx, val, table)),
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
               "operations": ops, "gather_l2_bytes": r * l * k * 4}
        row["fraction_of_bound"] = bound_ms / row["ms"]
        emit({"phase": "time_b1", **row})
        wide.append(row)
    fit = {"rank": B1_FIT_RANK, "iterations": 2, "fused_s": b1_check["fit_fused_s"],
           "xla_s": b1_check["fit_xla_s"]}
    emit({"phase": "time_b1", "case": f"fit_rank{B1_FIT_RANK}", **fit})
    return {"shapes": shapes, "wide_shapes": wide, "fit": fit, "transfer_s": transfer_s}


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


def unbatched():
    """The unbatched deploy (``max_batch_size=1``: one ``predict`` per
    request). The NCF deploys take it: with batching on, the reference's
    ``NCFAlgorithm.batch_predict`` scores through its plain batch scorer
    and never reaches its Pallas scorer (its ``models/ncf/kernel.py:158-
    169``), and the port's does the same, so only this path launches B3."""
    from predictionio_tpu_torch.workflow.microbatch import BatchConfig

    return BatchConfig(max_batch_size=1)


def serve_model(engine_json: str, model_dir: str | None, queries: list[dict],
                times: list | None = None, batching=None, instance_id: str | None = None):
    """Deploy ``model_dir`` (None: the latest COMPLETED engine instance of
    the variant, from the store) through the ``deploy`` code path on cuda
    and POST each query over one kept-alive connection; returns
    ``(responses, deployed model, deploy seconds)``; each round trip's
    ms goes to ``times`` when given. ``batching`` is the deploy's
    ``BatchConfig`` (default: the micro-batcher's defaults);
    ``instance_id`` names the engine instance to deploy instead of the
    latest."""
    from predictionio_tpu_torch.tools.cli import build_query_server

    t0 = time.perf_counter()
    server, service = build_query_server(engine_json, model_dir, port=0, device="cuda",
                                         batching=batching, engine_instance_id=instance_id)
    deploy_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
    try:
        served = []
        for q in queries:
            body, ms = post(conn, q)
            served.append(body)
            if times is not None:
                times.append(ms)
    finally:
        conn.close()
        server.shutdown()
        server.server_close()
        service.close()
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
# the store path: app -> event server -> pio import -> sqlite store ->
# pio train (B1) -> engine instance + model blob -> pio deploy (B2)
# --------------------------------------------------------------------------


@contextlib.contextmanager
def plain_b1_b2():
    """Route the ALS fit's half-step (``parallel/als.py::half_step_fn``)
    and the retrieval index's stage 1 through B1's and B2's plain
    versions: the comparison path of ``eval_path``'s replay."""
    from predictionio_tpu_torch.ops import als_gram, mips
    from predictionio_tpu_torch.parallel import als

    saved = als.gram_rhs, mips.mips_block_topk
    als.gram_rhs, mips.mips_block_topk = als_gram.gram_rhs_plain, mips.mips_block_topk_plain
    try:
        yield
    finally:
        als.gram_rhs, mips.mips_block_topk = saved


@contextlib.contextmanager
def fresh_store(workdir: str, name: str):
    """The port's storage pointed at a new sqlite store under
    ``workdir/name`` (``PIO_FS_BASEDIR``) for the block; restored after."""
    from predictionio_tpu_torch.data import storage

    before = os.environ.get("PIO_FS_BASEDIR")
    os.environ["PIO_FS_BASEDIR"] = os.path.join(workdir, name)
    storage.reset()
    try:
        yield os.environ["PIO_FS_BASEDIR"]
    finally:
        storage.reset()
        if before is None:
            os.environ.pop("PIO_FS_BASEDIR")
        else:
            os.environ["PIO_FS_BASEDIR"] = before


def cli_out(args: list[str]) -> str:
    """Run a verb of the port's CLI; its standard output (a verb that
    fails raises)."""
    import io

    from predictionio_tpu_torch.tools import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    if rc != 0:
        raise AssertionError(f"{args} exited {rc}: {buf.getvalue()}")
    return buf.getvalue()


def said(text: str, label: str) -> str:
    return text.split(f"{label}: ", 1)[1].split()[0]


def store_variant(src: str, app_name: str, path: str, **algorithm_params) -> str:
    """``src``'s engine.json written to ``path`` with its datasource's
    ``appName`` set (and algorithm params added); the same path keeps the
    variant's identity across rewrites."""
    with open(src) as f:
        variant = json.load(f)
    variant.setdefault("datasource", {}).setdefault("params", {})["appName"] = app_name
    variant["algorithms"][0].setdefault("params", {}).update(algorithm_params)
    with open(path, "w") as f:
        json.dump(variant, f)
    return path


def store_train(app_name: str, engine_json: str, events: str, variant_path: str) -> tuple:
    """``app new`` + ``import`` of ``events`` + ``train`` from the store
    through the port's CLI; returns (variant path, engine instance id)."""
    app_id = said(cli_out(["app", "new", app_name]), "ID")
    cli_out(["import", "--appid", app_id, "--input", events])
    store_variant(engine_json, app_name, variant_path)
    out = cli_out(["train", "--variant", variant_path, "--device", "cuda"])
    return variant_path, said(out, "Engine instance ID")


def store_rate_events(rng: np.random.Generator, path: str):
    """MovieLens-1M's users and items (``STORE_EVENTS`` of its ratings) in
    the quickstart wire shape: users
    uniform, items by the squared-uniform popularity of ``small_events``,
    ratings 1-5, one second apart (no time ties). Returns the arrays."""
    n = STORE_EVENTS
    users = rng.integers(0, STORE_USERS, n)
    items = (np.minimum(rng.random(n) ** 2.2, 0.999999) * STORE_ITEMS).astype(np.int64)
    stars = rng.integers(1, 6, n)
    base = 956_703_932  # MovieLens-1M's first rating time
    with open(path, "w") as f:
        for e in range(n):
            when = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(base + e))
            f.write(
                '{"event": "rate", "entityType": "user", "entityId": "u%d", '
                '"targetEntityType": "item", "targetEntityId": "i%d", '
                '"properties": {"rating": %d}, "eventTime": "%s"}\n'
                % (users[e], items[e], stars[e], when))
    return users, items, stars


def es_request(conn, method: str, path: str, body=None) -> tuple[int, object, float]:
    """One event-server request on a kept-alive connection: (status,
    JSON body, round trip ms)."""
    t0 = time.perf_counter()
    data = None if body is None else (body if isinstance(body, bytes) else
                                      json.dumps(body).encode())
    conn.request(method, path, body=data, headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    payload = json.loads(resp.read() or b"null")
    return resp.status, payload, (time.perf_counter() - t0) * 1e3


def phase_eventserver(rng: np.random.Generator, key: str) -> dict:
    """The port's event server on port 0 in a thread: 40 batches of 50
    and 20 single "view" events, a read back, a bad request (400) and a
    wrong key (401)."""
    from predictionio_tpu_torch.data.api.eventserver import create_event_server

    svc = create_event_server(host="127.0.0.1", port=0).start()
    conn = http.client.HTTPConnection("127.0.0.1", svc.port, timeout=120)
    q = f"?accessKey={key}"
    view = lambda n: {"event": "view", "entityType": "user", "entityId": f"u{n % STORE_USERS}",
                      "targetEntityType": "item", "targetEntityId": f"i{n % STORE_ITEMS}",
                      "eventTime": "2001-01-01T00:00:00Z"}
    try:
        batch_ms = []
        for b in range(STORE_BATCHES):
            body = [view(int(x)) for x in rng.integers(0, 10**6, STORE_BATCH)]
            status, out, ms = es_request(conn, "POST", "/batch/events.json" + q, body)
            if status != 200 or [r["status"] for r in out] != [201] * STORE_BATCH:
                raise AssertionError(f"batch {b} answered {status}: {out}")
            batch_ms.append(ms)
        for n in range(STORE_SINGLES):
            status, out, _ = es_request(conn, "POST", "/events.json" + q,
                                        dict(view(n), entityId="u-es"))
            if status != 201 or "eventId" not in out:
                raise AssertionError(f"single post answered {status}: {out}")
        status, found, _ = es_request(
            conn, "GET", f"/events.json{q}&entityType=user&entityId=u-es&limit=-1")
        if status != 200 or len(found) != STORE_SINGLES:
            raise AssertionError(f"read back {status}: {len(found)} events")
        bad, _, _ = es_request(conn, "POST", "/events.json" + q,
                               {"event": "$bogus", "entityType": "user", "entityId": "x"})
        wrong, _, _ = es_request(conn, "POST", "/events.json?accessKey=wrong", view(0))
        if (bad, wrong) != (400, 401):
            raise AssertionError(f"bad request {bad}, wrong key {wrong}; want 400, 401")
    finally:
        conn.close()
        svc.stop()
    return {"batches": STORE_BATCHES, "batch_events": STORE_BATCH, "singles": STORE_SINGLES,
            "batch_p50_ms": statistics.median(batch_ms), "read_back": len(found),
            "bad_request_status": bad, "wrong_key_status": wrong}


def phase_store_path(rng: np.random.Generator, repo: str, workdir: str) -> dict:
    """app -> event server -> ``pio import`` at MovieLens-1M's width ->
    ``pio train`` from the store (B1) -> engine instance and model blob
    -> the same events trained from a file (factors within 1e-4) ->
    ``pio deploy`` of the instance with mips (B2), recall@10 against the
    exact scan, and a live seen filter that drops a newly posted item."""
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import sql_common
    from predictionio_tpu_torch.ops import als_gram, mips
    from predictionio_tpu_torch.tools import cli
    from predictionio_tpu_torch.workflow.core_workflow import load_instance_models, run_train
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    engine_json = os.path.join(repo, "examples", "recommendation", "engine.json")
    with fresh_store(workdir, "store"):
        out = cli_out(["app", "new", "MLApp"])
        app_id = int(said(out, "ID"))
        key = said(cli_out(["accesskey", "new", "MLApp"]), "Access Key")
        result = {"eventserver": phase_eventserver(rng, key)}

        events = os.path.join(workdir, "ml1m.jsonl")
        t0 = time.perf_counter()
        store_rate_events(rng, events)
        result["write_file_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        said_import = cli_out(["import", "--appid", str(app_id), "--input", events])
        import_s = time.perf_counter() - t0
        imported = storage.get_l_events().count_interactions(app_id, event_names=["rate"])
        if imported != STORE_EVENTS or f"Imported {STORE_EVENTS} events." not in said_import:
            raise AssertionError(f"import stored {imported} rate events: {said_import}")
        result.update(events_imported=imported, import_s=import_s,
                      import_events_per_s=imported / import_s)

        variant_path = store_variant(engine_json, "MLApp", os.path.join(workdir, "ml1m.json"))
        fast_scans = []
        real_scan = sql_common.SQLLEvents.scan_interactions

        def counted_scan(*args, **kwargs):
            cols = real_scan(*args, **kwargs)
            fast_scans.append(len(cols[0]))  # counted only when it served the read
            return cols

        sql_common.SQLLEvents.scan_interactions = counted_scan
        timings = {}
        als_gram.gram_rhs.launches = 0
        try:
            t0 = time.perf_counter()
            instance = run_train(load_engine_variant(variant_path), device="cuda",
                                 timings=timings)
            train_verb_s = time.perf_counter() - t0
        finally:
            sql_common.SQLLEvents.scan_interactions = real_scan
        b1_launches = als_gram.gram_rhs.launches
        recorded = storage.get_meta_data_engine_instances().get(instance.id)
        blob = storage.get_model_data_models().get(instance.id)
        if b1_launches < 1:
            raise AssertionError("pio train from the store did not launch B1")
        if fast_scans != [STORE_EVENTS]:
            raise AssertionError(f"the columnar fast scan did not serve the read: {fast_scans}")
        if recorded is None or recorded.status != "COMPLETED" or blob is None:
            raise AssertionError(f"instance {instance.id}: {recorded}, blob {blob is not None}")
        result.update(fast_scan_rows=fast_scans, b1_launches=b1_launches,
                      instance_id=instance.id,
                      instance_status=recorded.status, blob_bytes=len(blob.models),
                      train_verb_s=train_verb_s,
                      read_s=timings["read"], prepare_s=timings["prepare"],
                      train_s=timings["train[als]"], persist_s=timings["persist"])

        # the same events through the events-file stand-in (no time ties,
        # so both reads encode alike): factors within the f32 bar
        t0 = time.perf_counter()
        file_model = cli.train(variant_path, events, os.path.join(workdir, "ml1m_file"),
                               device="cuda")
        result["file_train_s"] = time.perf_counter() - t0
        _, [store_model] = load_instance_models(load_engine_variant(variant_path))
        if store_model.user_index != file_model.user_index or (
                store_model.item_ids != file_model.item_ids):
            raise AssertionError("the store and the file encode users or items differently")
        err = max(float(np.abs(store_model.als.user_factors - file_model.als.user_factors).max()),
                  float(np.abs(store_model.als.item_factors - file_model.als.item_factors).max()))
        if not err <= FIT_ATOL:
            raise AssertionError(f"store vs file factors differ by {err} > {FIT_ATOL}")
        result.update(users=len(store_model.user_index), items=len(store_model.item_ids),
                      factors_max_abs_err_vs_file=err)
        del file_model

        # deploy the instance with mips: the variant's path keeps its identity
        algo_params, _ = template_params(repo)
        mips_params = dict(algo_params, retrieval={"mode": "mips"})
        store_variant(engine_json, "MLApp", variant_path, retrieval={"mode": "mips"})
        picked = rng.choice(STORE_USERS, size=STORE_QUERIES, replace=False)
        queries = [{"user": f"u{u}", "num": 10} for u in picked] + [
            {"user": "cold-user", "num": 10}]
        query_ms = []
        mips.mips_block_topk.launches = 0
        served, deployed, deploy_s = serve_model(variant_path, None, queries, query_ms)
        b2_launches = mips.mips_block_topk.launches
        if b2_launches < 1:
            raise AssertionError("deploying the instance with mips did not launch B2")
        if served[-1] != {"itemScores": []}:
            raise AssertionError(f"the cold user answered {served[-1]}")
        recall, identical = recall_against_scan(mips_params, deployed, queries, served)
        result.update(deploy_s=deploy_s, query_p50_ms=statistics.median(query_ms[:-1]),
                      queries=len(queries), b2_launches=b2_launches, recall_at_10=recall,
                      identical_to_scan=identical)

        # a new event for a queried user; deployed with seenFilter "live",
        # the user's list drops that item at once
        user, top = queries[0]["user"], served[0]["itemScores"][0]["item"]
        storage.get_l_events().insert(Event(
            event="buy", entity_type="user", entity_id=user, target_entity_type="item",
            target_entity_id=top), app_id)
        store_variant(engine_json, "MLApp", variant_path, retrieval={"mode": "mips"},
                      seenFilter="live")
        live_ms = []
        before = mips.mips_block_topk.launches
        live, _, _ = serve_model(variant_path, None, [{"user": user, "num": 10}], live_ms)
        listed = [s["item"] for s in live[0]["itemScores"]]
        if top in listed or len(listed) != 10 or mips.mips_block_topk.launches <= before:
            raise AssertionError(f"the live filter kept {top}: {listed}")
        result.update(live_filter_dropped=top, live_query_ms=live_ms[0])
    emit({"phase": "store_path", **result})
    return result


def post_event_batches(conn, key: str, events: list) -> tuple[list, float, float]:
    """``events`` to the event server in ``/batch/events.json`` posts of
    ``STORE_BATCH``, each answered 201 per event; returns (each post's
    round trip ms, seconds of all posts, perf_counter of the last ack)."""
    batch_ms = []
    t0 = time.perf_counter()
    for start in range(0, len(events), STORE_BATCH):
        body = events[start:start + STORE_BATCH]
        status, out, ms = es_request(conn, "POST", f"/batch/events.json?accessKey={key}",
                                     body)
        if status != 200 or [r["status"] for r in out] != [201] * len(body):
            raise AssertionError(f"batch at {start} answered {status}: {out}")
        batch_ms.append(ms)
    acked = time.perf_counter()
    return batch_ms, acked - t0, acked


def wait_flushed(wal_dir: str, records: int, timeout_s: float = 120.0) -> None:
    """Until the WAL's storage checkpoint covers ``records`` records: an
    event is acknowledged at its fsync and flushed to the store behind
    it, and the follower reads only what the store holds."""
    from predictionio_tpu_torch.data.wal import read_checkpoint

    deadline = time.perf_counter() + timeout_s
    while read_checkpoint(wal_dir) < records:
        if time.perf_counter() > deadline:
            raise AssertionError(f"the WAL checkpoint stalled at {read_checkpoint(wal_dir)}"
                                 f" of {records} records")
        time.sleep(0.01)


def rate_event(user: str, item: str, stars: int) -> dict:
    return {"event": "rate", "entityType": "user", "entityId": user,
            "targetEntityType": "item", "targetEntityId": item,
            "properties": {"rating": int(stars)}}


def query_version(conn, query: dict) -> tuple[dict, str | None]:
    """One ``/queries.json`` answer and its ``x-pio-model-version``."""
    conn.request("POST", "/queries.json", body=json.dumps(query).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    if resp.status != 200:
        raise AssertionError(f"{query} answered {resp.status}: {body}")
    return body, resp.getheader("x-pio-model-version")


def instrument_loop(loop) -> tuple[dict, dict]:
    """Time the retrain loop's stages (the WAL tail polls, the snapshot
    refresh, the fold-in, the registry publish, the swap notify) by
    wrapping them on the instance, and capture each fold's base model and
    delta. Returns (stage seconds lists, captured)."""
    spans = {"tail_s": [], "snapshot_s": [], "fold_s": [], "publish_s": [], "swap_s": []}
    captured: dict = {}

    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spans[name].append(time.perf_counter() - t0)
        return run

    for tail in loop.tails:
        tail.poll = timed("tail_s", tail.poll)
    loop.snapshots.ensure = timed("snapshot_s", loop.snapshots.ensure)
    loop.registry.publish = timed("publish_s", loop.registry.publish)
    loop._notify_swap = timed("swap_s", loop._notify_swap)
    fold = loop.algorithms[0].fold_in

    def spy(model, delta):
        captured.update(base=model, delta=delta)
        return fold(model, delta)

    loop.algorithms[0].fold_in = timed("fold_s", spy)
    return spans, captured


def run_cycle(loop, spans: dict, want: str) -> dict:
    """One ``run_once`` that must answer ``want``: its seconds, each
    stage's and the B1 launches it made."""
    from predictionio_tpu_torch.ops import als_gram

    for times in spans.values():
        times.clear()
    before = als_gram.gram_rhs.launches
    t0 = time.perf_counter()
    got = loop.run_once()
    row = {"result": got, "cycle_s": time.perf_counter() - t0,
           "b1_launches": als_gram.gram_rhs.launches - before,
           **{k: sum(v) for k, v in spans.items()}}
    if got != want:
        raise AssertionError(f"the retrain cycle answered {got!r}, want {want!r}: {row}")
    return row


def phase_follow_path(rng: np.random.Generator, repo: str, workdir: str) -> dict:
    """Continuous learning on store_path's store: the event server with
    ``ingest_mode="wal"`` takes a fold-in window; ``RetrainLoop.run_once``
    tails the WAL, builds the snapshot (~512,000 rows), folds the touched users
    in through B1 (one launch), publishes registry version 1 and swaps the
    deployed mips server to it; the folded rows equal the plain path on
    the card, untouched rows the base, new item rows zero, and the served
    lists the exact scan (recall@10 >= 0.99, B2 launches). An idle cycle
    moves nothing; an escalating window retrains in full from the store
    (20 B1 launches), version 2; a swap back to version 1 answers as
    before, a missing version 404."""
    import gc
    import weakref

    import torch

    from predictionio_tpu_torch.data.api.eventserver import create_event_server
    from predictionio_tpu_torch.online.foldin import fold_in_als_model
    from predictionio_tpu_torch.online.loop import RetrainConfig, RetrainLoop
    from predictionio_tpu_torch.ops import als_gram, mips
    from predictionio_tpu_torch.tools import cli
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    engine_json = os.path.join(repo, "examples", "recommendation", "engine.json")
    variant_path = store_variant(engine_json, "MLApp", os.path.join(workdir, "ml1m.json"),
                                 retrieval={"mode": "mips"})
    mips_params = dict(template_params(repo)[0], retrieval={"mode": "mips"})
    with fresh_store(workdir, "store") as basedir:
        key = said(cli_out(["accesskey", "new", "MLApp"]), "Access Key")
        wal_dir = os.path.join(basedir, "wal")
        als_gram.gram_rhs.launches = 0
        mips.mips_block_topk.launches = 0
        events = create_event_server(host="127.0.0.1", port=0, ingest_mode="wal").start()
        server, service = cli.build_query_server(variant_path, port=0, device="cuda")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        econn = http.client.HTTPConnection("127.0.0.1", events.port, timeout=120)
        qconn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
        result: dict = {}
        try:
            loop = RetrainLoop(load_engine_variant(variant_path),
                               RetrainConfig(notify_urls=[url]), device="cuda")
            spans, captured = instrument_loop(loop)
            base = loop.models[0]
            users = np.asarray(list(base.user_index))
            items = np.asarray(base.item_ids)

            # window 1: known users, new users, new items
            known = rng.choice(users, FOLLOW_USERS, replace=False)
            window = [rate_event(u, i, s) for u in known
                      for i, s in zip(rng.choice(items, FOLLOW_EVENTS, replace=False),
                                      rng.integers(1, 6, FOLLOW_EVENTS))]
            new_users = [f"follow-u{k}" for k in range(FOLLOW_NEW_USERS)]
            new_items = [f"follow-i{k}" for k in range(FOLLOW_NEW_ITEMS)]
            for k, user in enumerate(new_users):
                rated = [new_items[k % FOLLOW_NEW_ITEMS]] + list(
                    rng.choice(items, FOLLOW_NEW_EVENTS - 1, replace=False))
                window += [rate_event(user, i, s) for i, s in
                           zip(rated, rng.integers(1, 6, FOLLOW_NEW_EVENTS))]
            batch_ms, post_s, acked = post_event_batches(econn, key, window)
            wait_flushed(wal_dir, len(window))
            old_epoch = weakref.ref(service.models[0])
            memory_before = torch.cuda.memory_allocated()
            cycle1 = run_cycle(loop, spans, "foldin")
            swapped = time.perf_counter()
            gc.collect()
            memory_after = torch.cuda.memory_allocated()
            if cycle1["b1_launches"] != 1:
                raise AssertionError(f"the fold-in cycle made {cycle1['b1_launches']} B1 launches")
            version = get_status(qconn)["modelVersion"]
            if version != 1 or old_epoch() is not None:
                raise AssertionError(f"after the fold-in the server serves {version};"
                                     f" old epoch released: {old_epoch() is None}")
            # the folded rows against the plain path on the card
            delta = captured["delta"]
            plain = fold_in_als_model(
                base.als, base.user_index, base.item_ids, base.item_index, delta,
                dataclasses.replace(loop.algorithms[0]._config(), solver="xla"), device="cuda")
            folded = loop.models[0]
            fold_err = float(np.abs(folded.als.user_factors - plain.als.user_factors).max())
            if not fold_err <= FIT_ATOL:
                raise AssertionError(f"folded rows differ from the plain path by {fold_err}")
            snap = delta.snapshot
            in_window = (np.asarray(snap.column("times")) * 1000.0).astype(np.int64) >= (
                delta.window_start_ms)
            uvocab = snap.vocab("users")
            touched = {uvocab[c] for c in np.unique(np.asarray(snap.column("users"))[in_window])}
            touched |= delta.touched_user_ids or set()
            if not set(known) | set(new_users) <= touched:
                raise AssertionError("a posted user is missing from the fold's window")
            untouched = np.asarray([r for u, r in base.user_index.items() if u not in touched])
            if not np.array_equal(folded.als.user_factors[untouched],
                                  base.als.user_factors[untouched]):
                raise AssertionError("an untouched user row changed in the fold-in")
            if folded.als.item_factors[[folded.item_index[i] for i in new_items]].any():
                raise AssertionError("a new item row is not zero")
            # served through B2: touched known users and new users
            queries = [{"user": str(u), "num": 10} for u in known[:FOLLOW_QUERIES]] + [
                {"user": u, "num": 10} for u in new_users[:FOLLOW_NEW_QUERIES]]
            before = mips.mips_block_topk.launches
            served_v1 = [query_version(qconn, q)[0] for q in queries]
            b2_v1 = mips.mips_block_topk.launches - before
            recall_v1, identical_v1 = recall_against_scan(mips_params, folded, queries, served_v1)
            if b2_v1 < 1 or not all(b["itemScores"] for b in served_v1[-FOLLOW_NEW_QUERIES:]):
                raise AssertionError(f"after the swap: {b2_v1} B2 launches, new users "
                                     f"{served_v1[-FOLLOW_NEW_QUERIES:]}")
            v1 = loop.registry.get(1)
            result.update(
                wal_events=len(window), wal_batch_p50_ms=statistics.median(batch_ms),
                wal_events_per_s=len(window) / post_s,
                foldin=cycle1, touched_users=int(plain.touched_users),
                new_users=int(plain.new_users), new_items=int(plain.new_items),
                snapshot_rows=len(snap), first_snapshot_build_s=cycle1["snapshot_s"],
                registry_blob_bytes=v1.manifest["blob_bytes"],
                lag_ack_to_swap_s=swapped - acked, loop_lag_s=loop.last_lag_s,
                foldin_max_abs_err_vs_plain=fold_err, recall_at_10_v1=recall_v1,
                identical_to_scan_v1=identical_v1, b2_launches_v1=b2_v1,
                cuda_memory_before_swap=memory_before, cuda_memory_after_swap=memory_after,
                old_epoch_released=True)

            # an idle cycle: nothing new, nothing moves
            cursor = loop.cursor.seqno
            idle = run_cycle(loop, spans, "idle")
            if loop.cursor.seqno != cursor or get_status(qconn)["modelVersion"] != 1:
                raise AssertionError("the idle cycle moved the cursor or the served version")

            # window 2: past the touched budget, a full retrain from the store
            escalate = rng.choice(users, FOLLOW_ESCALATE_USERS, replace=False)
            window2 = [rate_event(u, i, s) for u in escalate
                       for i, s in zip(rng.choice(items, FOLLOW_ESCALATE_EVENTS, replace=False),
                                       rng.integers(1, 6, FOLLOW_ESCALATE_EVENTS))]
            post_event_batches(econn, key, window2)
            wait_flushed(wal_dir, len(window) + len(window2))
            retrain = run_cycle(loop, spans, "full_retrain")
            if retrain["b1_launches"] != 20 or get_status(qconn)["modelVersion"] != 2:
                raise AssertionError(f"the full retrain: {retrain}")
            before = mips.mips_block_topk.launches
            for q in queries:
                body, header = query_version(qconn, q)
                if header != "2" or not body["itemScores"]:
                    raise AssertionError(f"version 2 answered {header}: {body}")
            b2_v2 = mips.mips_block_topk.launches - before

            # rollback to version 1, then a version that does not exist
            status, out, rollback_ms = es_request(qconn, "POST", "/models/swap", {"version": 1})
            if status != 200 or out["modelVersion"] != 1:
                raise AssertionError(f"rollback answered {status}: {out}")
            before = mips.mips_block_topk.launches
            rolled = [query_version(qconn, q) for q in queries]
            b2_rollback = mips.mips_block_topk.launches - before
            if rolled != [(b, "1") for b in served_v1]:
                raise AssertionError("after the rollback the answers differ from version 1's")
            missing, out, _ = es_request(qconn, "POST", "/models/swap", {"version": 999})
            still = query_version(qconn, queries[0])
            if missing != 404 or still != (served_v1[0], "1"):
                raise AssertionError(f"a missing version answered {missing}: {out}; {still}")
            if min(b2_v2, b2_rollback) < 1:
                raise AssertionError(f"B2 launches after the swaps: {b2_v2}, {b2_rollback}")
            econn.request("GET", "/metrics")
            metrics = econn.getresponse().read().decode()
            fsyncs = [line.split()[-1] for line in metrics.splitlines()
                      if line.startswith("pio_wal_fsyncs_total")]
            result.update(
                wal_fsyncs=float(fsyncs[0]),
                idle=idle, escalate_events=len(window2), full_retrain=retrain,
                refresh_s=retrain["snapshot_s"], full_retrain_s=retrain["cycle_s"],
                b2_launches_v2=b2_v2, rollback_swap_ms=rollback_ms,
                b2_launches_rollback=b2_rollback, missing_version_status=missing,
                cycles=dict(loop.cycles))
        finally:
            econn.close()
            qconn.close()
            server.shutdown()
            server.server_close()
            service.close()
            thread.join(timeout=30)
            events.stop()
        result.update(b1_launches=als_gram.gram_rhs.launches,
                      b2_launches=mips.mips_block_topk.launches)
    if result["b1_launches"] < 1 or result["b2_launches"] < 1:
        raise AssertionError(f"the follow path launched B1 {result['b1_launches']} and "
                             f"B2 {result['b2_launches']} times")
    emit({"phase": "follow_path", **result})
    return result


# --------------------------------------------------------------------------
# eval_path: pio eval --replay, batchpredict, k-fold eval on the store
# --------------------------------------------------------------------------

#: the replay's split and cutoff (the reference's defaults)
EVAL_SPLIT_FRAC, EVAL_K = 0.8, 10
#: scores (and near-ties) compared within rtol = atol = 1e-4
EVAL_TOL = 1e-4
#: batchpredict's chunk (workflow/batch_predict.py) and the rows compared
#: with an unbatched deploy
BATCH_CHUNK, BATCH_COMPARED = 4096, 200
#: the sequence k-fold eval's hit@10 must beat uniform (10 / items) by this
SEQ_EVAL_MARGIN = 2.0


def compare_lists(got: list, want: list, tol: float = EVAL_TOL) -> tuple[float, int]:
    """``(max |score difference|, near-tie swaps)`` of two ``itemScores``
    lists; raises unless the scores agree within rtol = atol = ``tol``
    rank by rank and the items agree except where the two items' scores
    lie within that tolerance."""
    if len(got) != len(want):
        raise AssertionError(f"lists of {len(got)} and {len(want)} items")
    g = np.array([s["score"] for s in got], np.float64)
    w = np.array([s["score"] for s in want], np.float64)
    bound = tol + tol * np.abs(w)
    if (np.abs(g - w) > bound).any():
        raise AssertionError(f"scores differ past {tol}: {got} against {want}")
    swaps = sum(a["item"] != b["item"] for a, b in zip(got, want))
    return (float(np.abs(g - w).max()) if len(g) else 0.0), swaps


def held_out_moves(card: dict, plain: dict, k: int) -> list:
    """The users whose held-out items rank differently in two replays'
    top-``k`` lists (the only thing that moves a ranking metric), each
    with both lists, the items' ranks (None: outside the list) and
    whether each move is a near tie: in each list the scores between the
    two ranks (an item outside it at the list's last rank) lie within
    rtol = atol = EVAL_TOL, the tolerance ``compare_lists`` allows."""
    moves = []
    for q, actual, got, want in zip(card["queries"], card["actual"], card["responses"],
                                    plain["responses"]):
        lists = [r["itemScores"][:k] for r in (got, want)]
        ranks = [{s["item"]: r for r, s in enumerate(lst)} for lst in lists]
        moved = [a for a in actual if ranks[0].get(a) != ranks[1].get(a)]
        if not moved:
            continue
        items = []
        for a in moved:
            spread = []
            for lst in lists:
                if not lst:
                    spread.append(False)
                    continue
                at = [min(rank.get(a, len(lst) - 1), len(lst) - 1) for rank in ranks]
                hi, lo = lst[min(at)]["score"], lst[max(at)]["score"]
                spread.append(hi - lo <= EVAL_TOL + EVAL_TOL * abs(lo))
            items.append({"item": a, "ranks": [rank.get(a) for rank in ranks],
                          "near_tie": all(spread)})
        moves.append({"query": q, "held_out": items,
                      "card": [[s["item"], s["score"]] for s in lists[0]],
                      "plain": [[s["item"], s["score"]] for s in lists[1]],
                      "near_tie": all(i["near_tie"] for i in items)})
    return moves


def replay_report(args: list[str], responses: bool = False) -> dict:
    """``eval --replay`` through the port's CLI; its JSON report (with the
    responses when asked: the CLI's ``run_replay_eval`` is then called
    with ``include_responses=True``)."""
    import functools

    from predictionio_tpu_torch.eval import replay

    real = replay.run_replay_eval
    if responses:
        replay.run_replay_eval = functools.partial(real, include_responses=True)
    try:
        return json.loads(cli_out(["eval", "--replay", *args]))
    finally:
        replay.run_replay_eval = real


SEQ_EVAL_MODULE = '''\
"""The sequence template's k-fold evaluation: hit@10 of each user's
held-out last item (leave-one-out), built of the port's objects."""
import json

from predictionio_tpu_torch.controller.engine import EngineParams
from predictionio_tpu_torch.controller.metrics import (
    EngineParamsGenerator,
    Evaluation,
    OptionAverageMetric,
)
from predictionio_tpu_torch.models.sequence import engine_factory


def hit_at_10(info, query, prediction, actual):
    got = [s["item"] for s in prediction["itemScores"]][:10]
    return float(actual[0] in got)


EVALUATION = Evaluation(engine=engine_factory(),
                        metric=OptionAverageMetric(score=hit_at_10))
with open(%r) as f:
    _obj = json.load(f)
_obj["datasource"]["params"].update(appName=%r, evalFolds=1)
GENERATOR = EngineParamsGenerator([EngineParams.from_json_obj(_obj)])
'''


def phase_eval_path(rng: np.random.Generator, repo: str, workdir: str) -> dict:
    """Evaluation and batch predict on store_path's store after
    follow_path (store_path's ratings, the follow path's events,
    registry versions 1 and 2): (a) ``eval --replay`` of the mips
    variant, B1 and B2 counted, the guard's recall, held against the same
    replay through their plain versions on the card; (b) the replay of registry version 2; (c)
    ``batchpredict`` of every user, 200 rows against an unbatched mips
    deploy of the instance, one ``top`` frame of that deploy; (d) an NCF
    replay (epochs 5 -> 1), no B3; (e) ``eval`` of a sequence-template
    Evaluation module, B4 and the fused backward counted."""
    import torch

    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.eval.replay import run_replay_eval
    from predictionio_tpu_torch.models.ncf import kernel as ncf_kernel
    from predictionio_tpu_torch.models.sequence import engine as seq_engine
    from predictionio_tpu_torch.ops import als_gram, mips
    from predictionio_tpu_torch.tools import cli
    from predictionio_tpu_torch.workflow.core_workflow import load_instance_models
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant
    from predictionio_tpu_torch.workflow.microbatch import BatchConfig

    engine_json = os.path.join(repo, "examples", "recommendation", "engine.json")
    variant_path = store_variant(engine_json, "MLApp", os.path.join(workdir, "ml1m.json"),
                                 retrieval={"mode": "mips"})
    split_args = ["--split-frac", str(EVAL_SPLIT_FRAC), "--k", str(EVAL_K)]
    result: dict = {}
    with fresh_store(workdir, "store"):
        # (a) the replay through the CLI, then the same replay through
        # the plain versions
        als_gram.gram_rhs.launches = 0
        mips.mips_block_topk.launches = 0
        t0 = time.perf_counter()
        card = replay_report(["--variant", variant_path, "--device", "cuda", *split_args],
                             responses=True)
        replay_s = time.perf_counter() - t0
        b1, b2 = als_gram.gram_rhs.launches, mips.mips_block_topk.launches
        guard = card["retrieval_guard"]
        recall = guard[f"shortlist_recall_at_{EVAL_K}"]
        if b1 != 20 or b2 < 2 or not recall >= 0.99:
            raise AssertionError(f"replay: B1 {b1}, B2 {b2}, guard {guard}")
        # the same replay on the card through the plain versions of B1
        # and B2: neither kernel launches in it
        t0 = time.perf_counter()
        variant = load_engine_variant(variant_path)
        with plain_b1_b2():
            plain = run_replay_eval(variant, split_frac=EVAL_SPLIT_FRAC, k=EVAL_K,
                                    include_responses=True, device="cuda")
        reference_s = time.perf_counter() - t0
        if (als_gram.gram_rhs.launches, mips.mips_block_topk.launches) != (b1, b2):
            raise AssertionError("the plain replay launched B1 or B2")
        if card["split"] != plain["split"] or card["queries"] != plain["queries"]:
            raise AssertionError("the card's and the plain replay cut different folds")
        metric_diff = max(abs(card["metrics"][m] - plain["metrics"][m]) for m in plain["metrics"])
        # a held-out item that moves across a near tie moves the metrics
        # by up to 1/users (past EVAL_TOL): allowed only where every such
        # move is a near tie by compare_lists' own tolerance
        moves = held_out_moves(card, plain, EVAL_K)
        emit({"phase": "eval_path_held_out_moves", "metric_max_abs_diff": metric_diff,
              "users": len(card["queries"]), "count": len(moves), "moves": moves[:20]})
        compared = [compare_lists(g["itemScores"], w["itemScores"])
                    for g, w in zip(card["responses"], plain["responses"])]
        if any(not m["near_tie"] for m in moves) or (metric_diff > EVAL_TOL and not moves):
            raise AssertionError(f"metrics: {card['metrics']} against {plain['metrics']}, "
                                 f"held-out moves {moves}")
        result["replay"] = {
            "seconds": replay_s, "b1_launches": b1, "b2_launches": b2,
            "metrics": card["metrics"], "split": card["split"], "retrieval_guard": guard,
            "users": len(card["queries"]),
            "reference": "plain versions on the card", "reference_s": reference_s,
            "reference_metrics": plain["metrics"], "metric_max_abs_diff": metric_diff,
            "score_max_abs_diff": max(d for d, _ in compared),
            "near_tie_swaps": sum(s for _, s in compared),
            "held_out_moves": len(moves),
        }
        holdout = card["split"]
        del card, plain, compared, moves

        # (b) a registry version follow_path published (2: the full retrain)
        mips.mips_block_topk.launches = 0
        t0 = time.perf_counter()
        pinned = replay_report(["--variant", variant_path, "--device", "cuda",
                                "--model-version", "2", *split_args])
        pinned_s = time.perf_counter() - t0
        b2 = mips.mips_block_topk.launches
        lineage = pinned["model"]
        if (lineage["source"] != "registry" or lineage["model_version"] != 2 or b2 < 1
                or pinned["split"] != holdout):
            raise AssertionError(f"pinned replay: {lineage}, B2 {b2}, split {pinned['split']}")
        result["pinned"] = {"seconds": pinned_s, "model": lineage, "b2_launches": b2,
                            "metrics": pinned["metrics"],
                            "retrieval_guard": pinned["retrieval_guard"]}

        # (c) batchpredict of every user of the latest instance
        instance, [model] = load_instance_models(variant)
        users = sorted(model.user_index, key=model.user_index.get)
        del model
        queries = [{"user": u, "num": 10} for u in users]
        qpath, opath = (os.path.join(workdir, n) for n in ("bp_in.jsonl", "bp_out.jsonl"))
        with open(qpath, "w") as f:
            f.writelines(json.dumps(q) + "\n" for q in queries)
        mips.mips_block_topk.launches = 0
        t0 = time.perf_counter()
        said_bp = cli_out(["batchpredict", "--variant", variant_path, "--input", qpath,
                           "--output", opath, "--device", "cuda"])
        batch_s = time.perf_counter() - t0
        b2 = mips.mips_block_topk.launches
        with open(opath) as f:
            rows = [json.loads(line) for line in f]
        errors = sum("error" in r for r in rows)
        chunks = -(-len(queries) // BATCH_CHUNK)
        if (len(rows) != len(queries) or errors or b2 != chunks
                or f"{len(queries)} queries" not in said_bp):
            raise AssertionError(f"batchpredict: {len(rows)} rows, {errors} errors, B2 {b2}, "
                                 f"{chunks} chunks")
        picked = sorted(rng.choice(len(queries), BATCH_COMPARED, replace=False).tolist())
        server, service = cli.build_query_server(
            variant_path, port=0, device="cuda", engine_instance_id=instance.id,
            batching=BatchConfig(max_batch_size=1))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        frame: list = []
        top_thread = threading.Thread(target=lambda: frame.append(cli_out(
            ["top", url, "--iterations", "1", "--no-clear", "--interval", "1.0"])))
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
        try:
            top_thread.start()
            time.sleep(0.2)           # top's first poll before the traffic
            served = [post(conn, queries[i])[0] for i in picked]
            top_thread.join(timeout=60)
        finally:
            conn.close()
            server.shutdown()
            server.server_close()
            service.close()
            thread.join(timeout=30)
        unequal = [i for i, body in zip(picked, served) if body != rows[i]["prediction"]]
        if unequal:
            raise AssertionError(f"{len(unequal)} batchpredict rows differ from the deploy's "
                                 f"bodies, first {queries[unequal[0]]}")
        row = next(line for line in frame[0].splitlines() if line.startswith(url))
        qps, p50 = row.split()[1:3]
        result["batchpredict"] = {
            "seconds": batch_s, "queries": len(queries), "chunks": chunks,
            "b2_launches": b2, "error_rows": errors, "compared_with_deploy": len(picked),
            "instance": instance.id, "top_qps": qps, "top_p50_ms": p50,
        }
        del rows, served
        # B2 at the 4,096-row chunk: held to its plain version, timed
        _, [model] = load_instance_models(variant)
        factors = model.als.item_factors
        chunk = min(BATCH_CHUNK, model.als.user_factors.shape[0] // 8 * 8)
        args = stage1_inputs(factors, model.als.user_factors[:chunk], BLOCK_ITEMS)
        err = compare_stage1(args, BLOCK_TOPK, factors.shape[0], exact=False)
        result["batchpredict"]["b2_chunk"] = {"max_abs_err": err,
                                              **time_stage1(args, BLOCK_TOPK, factors.shape[0])}
        del args, model
        torch.cuda.empty_cache()

        # (d) the NCF template's replay (epochs 5 -> 1): no B3, as in the
        # reference (batch_predict scores through the plain batch scorer)
        ncf_path = store_variant(os.path.join(repo, "examples", "ncf", "engine.json"), "MLApp",
                                 os.path.join(workdir, "ml1m_ncf.json"), epochs=NCF_EPOCHS)
        ncf_kernel.ncf_score_all_items.launches = 0
        t0 = time.perf_counter()
        ncf = replay_report(["--variant", ncf_path, "--device", "cuda", *split_args])
        ncf_s = time.perf_counter() - t0
        b3 = ncf_kernel.ncf_score_all_items.launches
        want = {f"{m}_at_{EVAL_K}" for m in ("hit_rate", "ndcg", "recall")} | {"mrr"}
        if (set(ncf["metrics"]) != want or any(v is None for v in ncf["metrics"].values())
                or b3 != 0 or ncf["retrieval_guard"] is not None):
            raise AssertionError(f"NCF replay: {ncf['metrics']}, B3 {b3}")
        result["ncf_replay"] = {"seconds": ncf_s, "metrics": ncf["metrics"],
                                "b3_launches": b3, "epochs": NCF_EPOCHS}

        # (e) k-fold eval of a sequence-template Evaluation module
        module = os.path.join(workdir, "seq_eval.py")
        with open(module, "w") as f:
            f.write(SEQ_EVAL_MODULE % (os.path.join(repo, "examples", "sequence", "engine.json"),
                                       "MLApp"))
        trained, forwards = [], []
        real_train, real_score = seq_engine.train_sasrec, seq_engine.score_next_items_batch

        def counted_train(config, sequences, *a, **kw):
            trained.append(config.epochs * -(-len(sequences) // config.batch_size))
            return real_train(config, sequences, *a, **kw)

        def counted_score(net, prefixes):
            forwards.append(len(prefixes))
            return real_score(net, prefixes)

        seq_engine.train_sasrec, seq_engine.score_next_items_batch = counted_train, counted_score
        zero_flash_counts()
        t0 = time.perf_counter()
        try:
            out = cli_out(["eval", "seq_eval.EVALUATION", "seq_eval.GENERATOR",
                           "--engine-dir", workdir, "--device", "cuda"])
        finally:
            seq_engine.train_sasrec, seq_engine.score_next_items_batch = real_train, real_score
        seq_s = time.perf_counter() - t0
        counts = flash_counts()
        recorded = storage.get_meta_data_evaluation_instances().get(
            said(out, "Evaluation instance ID"))
        best = json.loads(recorded.evaluator_results_json)["bestScore"]
        uniform = EVAL_K / STORE_ITEMS
        steps = sum(trained)
        if (recorded.status != "COMPLETED" or counts["flash_backward"] != 2 * steps
                or counts["flash_forward"] != 2 * steps + 2 * len(forwards)
                or not best > SEQ_EVAL_MARGIN * uniform):
            raise AssertionError(f"sequence eval: {recorded.status}, {counts}, steps {steps}, "
                                 f"forwards {len(forwards)}, bestScore {best}")
        result["sequence_eval"] = {
            "seconds": seq_s, "status": recorded.status, "best_score_hit_at_10": best,
            "uniform_hit_at_10": uniform, "steps": steps, "scoring_forwards": len(forwards),
            "queries": sum(forwards), "launches": counts,
        }
    result["b1_launches"] = result["replay"]["b1_launches"]
    result["b2_launches"] = (result["replay"]["b2_launches"] + result["pinned"]["b2_launches"]
                             + result["batchpredict"]["b2_launches"])
    result["b3_launches"] = result["ncf_replay"]["b3_launches"]
    result["flash_launches"] = result["sequence_eval"]["launches"]
    emit({"phase": "eval_path", **result})
    return result


# --------------------------------------------------------------------------
# quickstart: the README's Quickstart through the port's console and SDK
# --------------------------------------------------------------------------

#: the quickstart's new user rates this many existing items through the
#: event server: QUICKSTART_SINGLES one POST each, the rest in batches of
#: STORE_BATCH; then 15 known users and the new one are queried
QUICKSTART_RATINGS, QUICKSTART_SINGLES, QUICKSTART_QUERIES = 300, 20, 16
QUICKSTART_USER = "u-quickstart"
#: pypio's round trip in ``pio run``: prints one JSON line
QUICKSTART_SCRIPT = """\
import json
from predictionio_tpu_torch import pypio

pypio.init()
events = pypio.find_events("MLApp")
blob_id = pypio.save_model({"factors": [1.0, 2.0], "note": "quickstart"})
print("PYPIO " + json.dumps({"events": len(events), "blob_id": blob_id,
                             "loaded": pypio.load_model(blob_id)}))
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_http(url: str, proc=None, timeout_s: float = 180.0) -> None:
    """Poll ``url`` until it answers below 500; fails if ``proc`` exits."""
    import urllib.request

    deadline = time.time() + timeout_s
    last = None
    while time.time() < deadline:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"{url}: its server exited {proc.returncode}")
        try:
            with urllib.request.urlopen(url, timeout=5) as resp:
                if resp.status < 500:
                    return
        except Exception as exc:
            last = exc
        time.sleep(0.25)
    raise AssertionError(f"{url} never answered: {last}")


def pid_gone(pid: int) -> bool:
    """The process has exited (no /proc entry, or a zombie)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


def expected_accelerator() -> str:
    import torch

    return (f"Accelerator: cuda x{torch.cuda.device_count()} "
            f"({torch.cuda.get_device_name(0)})")


def phase_quickstart(repo: str, workdir: str) -> dict:
    """The README's Quickstart on store_path's store as follow_path and
    eval_path left it, every verb a ``python -m
    predictionio_tpu_torch.tools.cli`` process but ``train``: ``status``
    (the card and storage OK), ``version``, ``template list``, ``template
    get recommendation DIR --app-name MLApp``, ``"retrieval": {"mode":
    "mips"}`` set in DIR/engine.json, ``build``, ``start-all`` (the event
    server, dashboard and admin server as daemons on free ports);
    ``EventClient`` posts a new user's ratings of existing items (singly
    and in batches) and round-trips one more event (``get``, ``find``,
    ``delete``); ``train --engine-dir DIR`` through ``cli.main`` in this
    process (B1's counter read: 20 launches, rank 16 x 10 iterations);
    ``deploy`` (B2, read from the deployed process's ``/metrics``);
    ``EngineClient`` queries 15 known users and the new one, held to
    the exact scan (recall@10 >= 0.99); the dashboard's engine-instance
    page lists the new COMPLETED instance and its evaluation list
    eval_path's; the admin server lists MLApp; ``run`` of a ``pypio``
    script (every event of the store, a model blob round trip);
    ``undeploy`` (the deploy process exits) and ``stop-all`` (no daemon
    left). Any verb exiting non-zero fails the phase."""
    from predictionio_tpu_torch.client import EngineClient, EventClient, PIOServerError
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.models.ncf import kernel as ncf_kernel
    from predictionio_tpu_torch.ops import als_gram, mips
    from predictionio_tpu_torch.workflow.core_workflow import load_instance_models
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    engine_dir = os.path.join(workdir, "quickstart")
    started_at = time.perf_counter()
    seconds: dict = {}
    procs: list = []
    daemons: dict = {}
    with fresh_store(workdir, "store") as basedir:
        env = dict(os.environ, PIO_FS_BASEDIR=basedir, PYTHONPATH=repo)

        def pio(step: str, *argv: str) -> str:
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-m", "predictionio_tpu_torch.tools.cli",
                                  *argv], env=env, cwd=repo, capture_output=True, text=True,
                                 timeout=600)
            seconds[step] = time.perf_counter() - t0
            if out.returncode != 0:
                raise AssertionError(f"pio {' '.join(argv)} exited {out.returncode}: "
                                     f"{out.stdout[-2000:]} {out.stderr[-4000:]}")
            return out.stdout

        try:
            status = pio("status", "status")
            if expected_accelerator() not in status.splitlines() or (
                    "Storage check OK" not in status):
                raise AssertionError(f"status said: {status}")
            accelerator = next(line for line in status.splitlines()
                               if line.startswith("Accelerator:"))
            version = pio("version", "version").strip()
            listed = pio("template_list", "template", "list")
            if "recommendation" not in listed:
                raise AssertionError(f"template list: {listed}")
            pio("template_get", "template", "get", "recommendation", engine_dir,
                "--app-name", "MLApp")
            engine_json = os.path.join(engine_dir, "engine.json")
            with open(engine_json) as f:
                variant = json.load(f)
            variant["algorithms"][0]["params"]["retrieval"] = {"mode": "mips"}
            with open(engine_json, "w") as f:
                json.dump(variant, f, indent=2)
            if "Build finished" not in pio("build", "build", "--engine-dir", engine_dir):
                raise AssertionError("build did not finish")

            ports = {"eventserver": free_port(), "dashboard": free_port(),
                     "adminserver": free_port()}
            started = pio("start_all", "start-all", "--event-server-port",
                          str(ports["eventserver"]), "--dashboard-port",
                          str(ports["dashboard"]), "--admin-port", str(ports["adminserver"]))
            pid_dir = os.path.join(basedir, "pids", "predictionio_tpu_torch")
            for service in ports:
                with open(os.path.join(pid_dir, f"{service}.pid")) as f:
                    daemons[service] = int(f.read())
            if started.count("started") != 3:
                raise AssertionError(f"start-all said: {started}")
            t0 = time.perf_counter()
            for port in ports.values():
                wait_http(f"http://127.0.0.1:{port}/")
            seconds["daemons_up"] = time.perf_counter() - t0

            # the SDK: a new user's ratings of existing items, then one
            # more event round-tripped
            app_id = storage.get_meta_data_apps().get_by_name("MLApp").id
            before = storage.get_l_events().count_interactions(app_id)
            key = storage.get_meta_data_access_keys().get_by_app_id(app_id)[0].key
            events = EventClient(f"http://127.0.0.1:{ports['eventserver']}", access_key=key,
                                 timeout=60)
            t0 = time.perf_counter()
            stars = np.random.default_rng(QUICKSTART_RATINGS).integers(1, 6, QUICKSTART_RATINGS)
            rated = [{"event": "rate", "entityType": "user", "entityId": QUICKSTART_USER,
                      "targetEntityType": "item", "targetEntityId": f"i{i}",
                      "properties": {"rating": int(stars[i])}}
                     for i in range(QUICKSTART_RATINGS)]
            for e in rated[:QUICKSTART_SINGLES]:
                events.create(event=e["event"], entity_type=e["entityType"],
                              entity_id=e["entityId"], target_entity_type="item",
                              target_entity_id=e["targetEntityId"], properties=e["properties"])
            for i in range(QUICKSTART_SINGLES, QUICKSTART_RATINGS, STORE_BATCH):
                statuses = events.create_batch(rated[i:i + STORE_BATCH])
                if [s["status"] for s in statuses] != [201] * len(rated[i:i + STORE_BATCH]):
                    raise AssertionError(f"create_batch answered {statuses}")
            probe = events.create(event="view", entity_type="user", entity_id=QUICKSTART_USER,
                                  target_entity_type="item", target_entity_id="i0")
            got = events.get(probe)
            found = events.find(entityType="user", entityId=QUICKSTART_USER, limit=-1)
            events.delete(probe)
            try:
                events.get(probe)
                gone = None
            except PIOServerError as exc:
                gone = exc.status
            if (got["event"], gone, len(found)) != ("view", 404, QUICKSTART_RATINGS + 1):
                raise AssertionError(f"round trip: {got}, {gone}, {len(found)} found")
            seconds["sdk_events"] = time.perf_counter() - t0
            after = storage.get_l_events().count_interactions(app_id)
            if after != before + QUICKSTART_RATINGS:
                raise AssertionError(f"store holds {after} events, want {before} + "
                                     f"{QUICKSTART_RATINGS}")

            # train in this process: B1's counter
            als_gram.gram_rhs.launches = 0
            mips.mips_block_topk.launches = 0
            ncf_kernel.ncf_score_all_items.launches = 0
            zero_flash_counts()
            t0 = time.perf_counter()
            trained = cli_out(["train", "--engine-dir", engine_dir, "--device", "cuda"])
            seconds["train"] = time.perf_counter() - t0
            counts = kernel_counts()
            instance_id = said(trained, "Engine instance ID")
            if counts["gram_rhs"] != 20:
                raise AssertionError(f"train launched B1 {counts['gram_rhs']} times, want 20")

            deploy_port = free_port()
            t0 = time.perf_counter()
            deploy = subprocess.Popen(
                [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "deploy",
                 "--engine-dir", engine_dir, "--ip", "127.0.0.1", "--port", str(deploy_port),
                 "--device", "cuda"],
                env=env, cwd=repo, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
            procs.append(deploy)
            wait_http(f"http://127.0.0.1:{deploy_port}/", deploy)
            seconds["deploy"] = time.perf_counter() - t0
            _, [model] = load_instance_models(load_engine_variant(engine_json), instance_id)
            known = [u for u in model.user_index if u != QUICKSTART_USER]
            picked = np.random.default_rng(QUICKSTART_QUERIES).choice(
                len(known), QUICKSTART_QUERIES - 1, replace=False)
            queries = [{"user": known[i], "num": 10} for i in sorted(picked)] + [
                {"user": QUICKSTART_USER, "num": 10}]
            engine = EngineClient(f"http://127.0.0.1:{deploy_port}", timeout=120)
            t0 = time.perf_counter()
            served = [engine.query(q) for q in queries]
            seconds["queries"] = time.perf_counter() - t0
            mips_params = dict(variant["algorithms"][0]["params"])
            recall, identical = recall_against_scan(mips_params, model, queries, served)
            metrics = scrape(deploy_port)
            b2 = metrics.get('pio_kernel_launches_total{kernel="mips_block_topk"}', 0.0)
            if not b2 > 0:
                raise AssertionError(f"the deployed process never launched B2: {b2}")
            counts["mips_block_topk"] = int(b2)

            # the dashboard and the admin server, as daemons
            import urllib.request

            with urllib.request.urlopen(
                    f"http://127.0.0.1:{ports['dashboard']}/engine_instances", timeout=60) as r:
                page = r.read().decode()
            row = next((r for r in page.split("<tr>") if instance_id[:12] in r), "")
            if "COMPLETED" not in row:
                raise AssertionError(f"the dashboard does not list {instance_id}: {page[:2000]}")
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{ports['dashboard']}/evaluation_instances.json",
                    timeout=60) as r:
                evaluations = json.loads(r.read())
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{ports['adminserver']}/cmd/app", timeout=60) as r:
                apps = json.loads(r.read())
            if not [a for a in apps if a["name"] == "MLApp" and a["id"] == app_id]:
                raise AssertionError(f"the admin server lists {apps}")
            if not [e for e in evaluations if e["status"] == "COMPLETED"]:
                raise AssertionError(f"the dashboard lists no evaluation: {evaluations}")

            # pio run of a pypio script
            script = os.path.join(engine_dir, "quickstart_pypio.py")
            with open(script, "w") as f:
                f.write(QUICKSTART_SCRIPT)
            ran = pio("run", "run", "--engine-dir", engine_dir, script)
            line = json.loads(next(l for l in ran.splitlines() if l.startswith("PYPIO "))[6:])
            if line["events"] != after or line["loaded"] != {"factors": [1.0, 2.0],
                                                             "note": "quickstart"}:
                raise AssertionError(f"pypio: {line}, want {after} events")

            if "Engine server stopping." not in pio("undeploy", "undeploy", "--ip",
                                                    "127.0.0.1", "--port", str(deploy_port)):
                raise AssertionError("undeploy did not stop the server")
            t0 = time.perf_counter()
            deploy_rc = deploy.wait(timeout=120)
            seconds["deploy_exit"] = time.perf_counter() - t0
            if deploy_rc != 0:
                raise AssertionError(f"the deploy process exited {deploy_rc}: "
                                     f"{deploy.stderr.read()[-4000:]}")
            stopped = pio("stop_all", "stop-all")
            deadline = time.time() + 60
            while time.time() < deadline and not all(map(pid_gone, daemons.values())):
                time.sleep(0.2)
            alive = {s: p for s, p in daemons.items() if not pid_gone(p)}
            if stopped.count("stopped") != 3 or alive or os.listdir(pid_dir):
                raise AssertionError(f"stop-all said {stopped}; alive {alive}, pidfiles "
                                     f"{os.listdir(pid_dir)}")
            daemons.clear()
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
            for pid in daemons.values():
                if not pid_gone(pid):
                    with contextlib.suppress(OSError):
                        os.kill(pid, 9)
    result = {
        "accelerator": accelerator, "version": version, "instance_id": instance_id,
        "events_before": before, "events_after": after, "ratings_posted": QUICKSTART_RATINGS,
        "queries": len(queries), "recall_at_10": recall, "identical_to_scan": identical,
        "launches": counts, "pypio_events": line["events"],
        "seconds": seconds, "phase_s": time.perf_counter() - started_at,
    }
    emit({"phase": "quickstart", **result})
    return result


# --------------------------------------------------------------------------
# the DASE engine: a user's engine module through the console, two
# algorithm blocks (ALS with mips, NCF) combined by the user's Serving
# --------------------------------------------------------------------------

#: the user engine module the dase_engine phase writes, against the
#: port's controller: the recommendation datasource, a preparator giving
#: ALS's CSR and NCF's COO, each template's algorithm behind a subclass
#: that takes its half, and a Serving that returns both predictions
DASE_MODULE = "chip_dase_engine"
DASE_ENGINE = '''\
"""ALS and NCF over one datasource, both predictions served by name."""

from predictionio_tpu_torch.controller import Engine, Preparator, Serving
from predictionio_tpu_torch.models.ncf.engine import NCFAlgorithm, NCFPreparator
from predictionio_tpu_torch.models.recommendation.engine import (
    ALSAlgorithm,
    RecommendationDataSource,
    RecommendationPreparator,
)


class BothPreparator(Preparator):
    """ALS's CSR and NCF's COO of the same ratings."""

    def prepare(self, ctx, training_data):
        return (RecommendationPreparator(self.params).prepare(ctx, training_data),
                NCFPreparator(self.params).prepare(ctx, training_data))


class UserALS(ALSAlgorithm):
    def train(self, ctx, prepared_data):
        return super().train(ctx, prepared_data[0])


class UserNCF(NCFAlgorithm):
    def train(self, ctx, prepared_data):
        return super().train(ctx, prepared_data[1])


class ByName(Serving):
    def serve(self, query, predictions):
        return {"als": predictions[0], "ncf": predictions[1]}


def engine_factory():
    return Engine(RecommendationDataSource, BothPreparator,
                  {"als": UserALS, "ncf": UserNCF}, ByName)
'''
#: known users queried in the deployed process (each a B3 launch)
DASE_QUERIES = 16
#: the phase's depth cut: NCF's epochs 5 -> 1 (examples/ncf/engine.json)
DASE_NCF_EPOCHS = 1
#: a served score against the single-template algorithm's in process
DASE_SCORE_TOL = 1e-5


def dase_engine_json(repo: str, engine_dir: str) -> tuple[str, dict, dict]:
    """The user engine's engine.json in ``engine_dir``: the params of
    ``examples/recommendation/engine.json`` (with ``"retrieval": {"mode":
    "mips"}``) and ``examples/ncf/engine.json`` (epochs cut), on
    store_path's MLApp. Returns its path and the two algorithms' params."""
    rec, ncf = (json.load(open(os.path.join(repo, "examples", t, "engine.json")))
                for t in ("recommendation", "ncf"))
    als_params = dict(rec["algorithms"][0]["params"], retrieval={"mode": "mips"})
    ncf_params = dict(ncf["algorithms"][0]["params"], epochs=DASE_NCF_EPOCHS)
    os.makedirs(engine_dir, exist_ok=True)
    with open(os.path.join(engine_dir, f"{DASE_MODULE}.py"), "w") as f:
        f.write(DASE_ENGINE)
    path = os.path.join(engine_dir, "engine.json")
    with open(path, "w") as f:
        json.dump({"id": "dase-engine", "engineFactory": f"{DASE_MODULE}.engine_factory",
                   "datasource": {"params": dict(rec["datasource"]["params"],
                                                 appName="MLApp")},
                   "algorithms": [{"name": "als", "params": als_params},
                                  {"name": "ncf", "params": ncf_params}],
                   "sparkConf": rec["sparkConf"]}, f)
    return path, als_params, ncf_params


def same_scores(got: dict, want: dict, what: str) -> float:
    """The same items in order, scores within ``DASE_SCORE_TOL``; returns
    the largest score gap."""
    if [s["item"] for s in got["itemScores"]] != [s["item"] for s in want["itemScores"]]:
        raise AssertionError(f"{what}: served {got}, the algorithm answers {want}")
    gaps = [abs(a["score"] - b["score"]) for a, b in zip(got["itemScores"],
                                                        want["itemScores"])]
    if gaps and max(gaps) > DASE_SCORE_TOL:
        raise AssertionError(f"{what}: scores {max(gaps)} apart")
    return max(gaps, default=0.0)


def phase_dase_engine(repo: str, workdir: str) -> dict:
    """A user engine module (``DASE_ENGINE``) in an engine directory, its
    engine.json naming ``chip_dase_engine.engine_factory``, on
    store_path's store as quickstart left it: ``pio train --engine-dir``
    through ``cli.main`` in this process (B1's counter read: both blocks
    trained, one instance, one blob), ``pio deploy`` as a process with
    batching off (``--max-batch-size 1``: every known-user query runs
    NCF's unbatched predict, one B3 launch, and ALS's mips search, B2),
    16 known users' queries, ``GET /reload`` and one more query, B2 and
    B3 read from the deployed process's ``/metrics``, ``pio undeploy``
    (the process exits). Each answer is ``{"als": ..., "ncf": ...}``, each
    part the items and scores (within ``DASE_SCORE_TOL``) that
    ``ALSAlgorithm`` and ``NCFAlgorithm`` with the engine.json's params
    answer in this process from the blob's models
    (``load_instance_models``)."""
    from predictionio_tpu_torch.models.ncf import NCFAlgorithm
    from predictionio_tpu_torch.models.ncf import kernel as ncf_kernel
    from predictionio_tpu_torch.models.recommendation import ALSAlgorithm
    from predictionio_tpu_torch.ops import als_gram, mips
    from predictionio_tpu_torch.workflow.core_workflow import load_instance_models
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    started_at = time.perf_counter()
    seconds: dict = {}
    engine_dir = os.path.join(workdir, "dase_engine")
    engine_json, als_params, ncf_params = dase_engine_json(repo, engine_dir)
    deploy = None
    with fresh_store(workdir, "store") as basedir:
        env = dict(os.environ, PIO_FS_BASEDIR=basedir, PYTHONPATH=repo)
        try:
            als_gram.gram_rhs.launches = 0
            mips.mips_block_topk.launches = 0
            ncf_kernel.ncf_score_all_items.launches = 0
            zero_flash_counts()
            t0 = time.perf_counter()
            trained = cli_out(["train", "--engine-dir", engine_dir, "--device", "cuda"])
            seconds["train"] = time.perf_counter() - t0
            counts = kernel_counts()
            instance_id = said(trained, "Engine instance ID")
            if counts["gram_rhs"] < 1:
                raise AssertionError("the user engine's train never launched B1")

            port = free_port()
            t0 = time.perf_counter()
            deploy = subprocess.Popen(
                [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "deploy",
                 "--engine-dir", engine_dir, "--ip", "127.0.0.1", "--port", str(port),
                 "--device", "cuda", "--max-batch-size", "1"],
                env=env, cwd=repo, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True)
            wait_http(f"http://127.0.0.1:{port}/", deploy)
            seconds["deploy"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            _, (als_model, ncf_model) = load_instance_models(
                load_engine_variant(engine_json), instance_id, device="cuda")
            known = sorted(set(als_model.user_index) & set(ncf_model.user_index))
            picked = np.random.default_rng(DASE_QUERIES).choice(
                len(known), DASE_QUERIES, replace=False)
            queries = [{"user": known[i], "num": 10} for i in sorted(picked)]
            seconds["load_models"] = time.perf_counter() - t0
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            try:
                t0 = time.perf_counter()
                served = [post(conn, q)[0] for q in queries]
                seconds["queries"] = time.perf_counter() - t0
                conn.request("GET", "/reload")
                reload_resp = conn.getresponse()
                reloaded = json.loads(reload_resp.read())
                if reload_resp.status != 200 or reloaded["engineInstanceId"] != instance_id:
                    raise AssertionError(f"/reload answered {reload_resp.status}: {reloaded}")
                after_reload = post(conn, queries[0])[0]
            finally:
                conn.close()
            if after_reload != served[0]:
                raise AssertionError(f"after /reload {after_reload} != {served[0]}")
            metrics = scrape(port)
            counts["mips_block_topk"] = int(metrics.get(
                'pio_kernel_launches_total{kernel="mips_block_topk"}', 0.0))
            counts["ncf_score_all_items"] = int(metrics.get(
                'pio_kernel_launches_total{kernel="ncf_score_all_items"}', 0.0))
            if counts["mips_block_topk"] < 1:
                raise AssertionError("the deployed user engine never launched B2")
            if counts["ncf_score_all_items"] < DASE_QUERIES:
                raise AssertionError(f"the deployed user engine launched B3 "
                                     f"{counts['ncf_score_all_items']} times for "
                                     f"{DASE_QUERIES} queries")

            als = ALSAlgorithm(als_params, device="cuda")
            ncf = NCFAlgorithm(ncf_params, device="cuda")
            gaps = {"als": 0.0, "ncf": 0.0}
            for q, body in zip(queries, served):
                if set(body) != {"als", "ncf"} or not body["ncf"]["itemScores"]:
                    raise AssertionError(f"{q}: served {body}")
                gaps["als"] = max(gaps["als"], same_scores(
                    body["als"], als.predict(als_model, q), f"als {q}"))
                gaps["ncf"] = max(gaps["ncf"], same_scores(
                    body["ncf"], ncf.predict(ncf_model, q), f"ncf {q}"))

            if "Engine server stopping." not in cli_out(
                    ["undeploy", "--ip", "127.0.0.1", "--port", str(port)]):
                raise AssertionError("undeploy did not stop the server")
            if deploy.wait(timeout=120) != 0:
                raise AssertionError(f"the deploy process exited {deploy.returncode}: "
                                     f"{deploy.stderr.read()[-4000:]}")
            if not pid_gone(deploy.pid):
                raise AssertionError("the deploy process is still there")
        finally:
            if deploy is not None and deploy.poll() is None:
                deploy.kill()
                deploy.wait(timeout=30)
    result = {"instance_id": instance_id, "queries": len(queries),
              "launches": counts, "max_score_gap": gaps,
              "ncf_epochs": DASE_NCF_EPOCHS, "seconds": seconds,
              "phase_s": time.perf_counter() - started_at}
    emit({"phase": "dase_engine", **result})
    return result


# --------------------------------------------------------------------------
# the templates: e-commerce (implicit ALS through B1, B2 with
# mips, the business rules), similar-product and universal (the
# cooccurrence products and the LLR on the card, plain torch)
# --------------------------------------------------------------------------

#: each item of the training stand-in gets 1-3 of 20 categories; every
#: rating is a "view", the 5-star ratings also a "buy"
TEMPLATE_CATEGORIES, TEMPLATE_MAX_CATEGORIES = 20, 3
#: the templates part's depth cut: the first 10,000,000 of phase 6's 20M
#: ratings (all 20M before; cut to keep the script in its limit beside the
#: dist_classify part)
TEMPLATE_RATINGS = 10_000_000
#: cooc_check: the card against the CPU on the first 5,000 users x 2,000
#: items, and the full-size counts against scipy on 256 item rows
COOC_CHECK_USERS, COOC_CHECK_ITEMS, COOC_CHECK_ROWS = 5_000, 2_000, 256
#: the e-commerce fold-in's users, the "sale" items its $set window adds,
#: the users queried, and the size of every template's batch_predict check
TEMPLATE_FOLDIN_USERS, TEMPLATE_SALE_ITEMS, TEMPLATE_QUERIES = 1_000, 3, 10
TEMPLATE_BATCH = 256
#: store_templates: a small store as the train-verb phases build one
TEMPLATE_STORE_EVENTS, TEMPLATE_STORE_USERS, TEMPLATE_STORE_ITEMS = 3_000, 300, 200
TEMPLATE_APP = "ChipShop"


def template_events(ratings, rng: np.random.Generator) -> dict:
    """The training stand-in's ratings as the templates' events: every
    rating a "view" at its second, the 5-star ones also a "buy" half a
    second later; each item's categories drawn from ``rng``."""
    users, items, stars, times = ratings
    buy = stars == 5
    counts = rng.integers(1, TEMPLATE_MAX_CATEGORIES + 1, TRAIN_ITEMS)
    categories = {
        f"i{i}": [f"cat{c}" for c in sorted(rng.choice(TEMPLATE_CATEGORIES, n, replace=False))]
        for i, n in enumerate(counts.tolist())
    }
    return {
        "view": (users, items, times),
        "buy": (users[buy], items[buy], times[buy] + 0.5),
        "categories": categories,
        "user_ids": [f"u{u}" for u in range(TRAIN_USERS)],
        "item_ids": [f"i{i}" for i in range(TRAIN_ITEMS)],
    }


def llr_f64(k11: np.ndarray, row_totals: np.ndarray, col_totals: np.ndarray,
            total: float) -> np.ndarray:
    """The G^2 log-likelihood ratio in f64 with numpy's log: the host's
    reference for the card's f32 LLR."""
    def xlogx(x):
        return np.where(x > 0, x * np.log(np.where(x > 0, x, 1.0)), 0.0)

    k12 = np.maximum(row_totals[:, None] - k11, 0.0)
    k21 = np.maximum(col_totals[None, :] - k11, 0.0)
    k22 = np.maximum(total - k11 - k12 - k21, 0.0)
    llr = 2.0 * (xlogx(k11) + xlogx(k12) + xlogx(k21) + xlogx(k22)
                 + xlogx(k11 + k12 + k21 + k22) - xlogx(k11 + k12) - xlogx(k21 + k22)
                 - xlogx(k11 + k21) - xlogx(k12 + k22))
    return np.where(k11 > 0, np.maximum(llr, 0.0), 0.0)


def llr_f32_tolerance(total: float) -> float:
    """How far an f32 LLR may lie from the f64 one: its sum cancels terms
    as large as N ln N (the grand total's x log x), each rounded to f32;
    32 ulps of that magnitude (4.0 at N = 138,000)."""
    return 32.0 * float(np.spacing(np.float32(total * np.log(total))))


def compare_indicators(got, want, atol: float, rtol: float = 0.0) -> dict:
    """Indicator tables ``(indices, values)`` held to ``want``: values
    within ``atol + rtol * |want|`` position by position; an index may
    differ only at a near-tie (its value within that tolerance of another
    value of the row, or of the row's k-th). Returns the max value error
    and the swapped slots; raises on any other difference."""
    (gi, gv), (wi, wv) = got, want
    if gi.shape != wi.shape:
        raise AssertionError(f"indicator shapes {gi.shape} vs {wi.shape}")
    wv = wv.astype(np.float64)
    diff = np.abs(gv.astype(np.float64) - wv)
    tol = atol + rtol * np.abs(wv)
    if np.any(diff > tol):
        raise AssertionError(f"indicator values differ by {float(diff.max())}")
    swaps = 0
    for r, c in zip(*np.nonzero(gi != wi)):
        swaps += 1
        others = np.delete(wv[r], c)
        if not (np.any(np.abs(others - wv[r, c]) <= tol[r, c])
                or abs(wv[r, c] - wv[r, -1]) <= tol[r, c]):
            raise AssertionError(f"row {r} slot {c}: {gi[r]} vs {wi[r]}, {wv[r]}")
    for r in range(gi.shape[0]):
        kth = wv[r, -1]
        near = atol + rtol * abs(kth)
        for idx, vals, ref in ((gi[r], gv[r], set(wi[r].tolist())),
                               (wi[r], wv[r], set(gi[r].tolist()))):
            for j, v in zip(idx.tolist(), vals.tolist()):
                if j not in ref and abs(v - kth) > near:
                    raise AssertionError(f"row {r}: index {j} ({v}) missing from the other")
    return {"max_abs_err": float(diff.max()) if diff.size else 0.0, "near_tie_swaps": swaps}


def host_topk(values: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-row top-k by a stable descending sort (lower index first)."""
    order = np.argsort(-values, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(values, order, axis=1)
    return order, np.where(np.isfinite(vals), vals, 0.0)


def cooc_bound(rows: int, items_p: int, items_o: int) -> float:
    """ms of the one-hot products at the f32 rate (TF32 off): 2 flops a
    (user row, primary item, other item)."""
    return 2.0 * rows * items_p * items_o / F32_OPS_PER_S * 1e3


def phase_cooc_check(ev: dict) -> dict:
    """``ops/cooccurrence.py`` on the card against the same port code on
    the CPU at 5,000 users x 2,000 items, self (views) and cross (buys
    against views): counts equal, LLR indicators at rtol = atol = 1e-5
    up to near-ties. The full-size half runs on the similar-product
    template's own call (``full_cooc_check``, in ``train_cooc``)."""
    import torch

    from predictionio_tpu_torch.ops import cooccurrence as cooc
    from predictionio_tpu_torch.ops.ragged import pack_padded_csr

    def corner(u, i, t):
        keep = (u < COOC_CHECK_USERS) & (i < COOC_CHECK_ITEMS)
        return pack_padded_csr(u[keep], i[keep], np.ones(int(keep.sum()), np.float32),
                               COOC_CHECK_USERS, COOC_CHECK_ITEMS, times=t[keep],
                               max_len=TRAIN_CAP)

    views, buys = corner(*ev["view"]), corner(*ev["buy"])
    result = {}
    for label, primary, other in (("self", views, None), ("cross", buys, views)):
        rows = torch.tensor(cooc.distinct_user_counts(primary))
        cols = torch.tensor(cooc.distinct_user_counts(other if other is not None else primary))
        out, seconds = {}, {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            counts = cooc.cooccurrence_counts(primary, other, chunk=1024, device=device)
            idx, vals = cooc.indicators_from_counts(
                counts, 50, row_totals=rows.to(device), col_totals=cols.to(device),
                total=float(COOC_CHECK_USERS), drop_diagonal=other is None)
            out[device] = (counts.cpu().numpy(), idx.cpu().numpy(), vals.cpu().numpy())
            seconds[device] = time.perf_counter() - t0
        if not np.array_equal(out["cuda"][0], out["cpu"][0]):
            raise AssertionError(f"{label} counts differ between the card and the CPU")
        cmp = compare_indicators(out["cuda"][1:], out["cpu"][1:], TOL, TOL)
        result[label] = {"pairs": int(out["cpu"][0].sum()), **cmp,
                         "bit_equal": bool(np.array_equal(out["cuda"][2], out["cpu"][2])),
                         "card_s": seconds["cuda"], "cpu_s": seconds["cpu"]}
    return result


def full_cooc_check(csr, indicators, llr_totals, rng: np.random.Generator) -> dict:
    """The full-size half of cooc_check on the similar-product template's
    own CSR and indicators: the card's counts again (timed), 256 item
    rows of them equal to scipy's rows of AᵀA exactly, and the
    template's LLR indicators of those rows held to an f64 LLR up to
    near-ties within the f32 tolerance. On those counts the call's
    later stages are timed apart: the LLR with the diagonal drop and the
    top-k (equal to the call's indicators), and the top-k alone."""
    import scipy.sparse as sp
    import torch

    from predictionio_tpu_torch.ops import cooccurrence as cooc

    num = csr.num_cols
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts = cooc.cooccurrence_counts(csr, chunk=4096, device="cuda")
    torch.cuda.synchronize()
    counts_s = time.perf_counter() - t0
    picked = np.sort(rng.choice(num, COOC_CHECK_ROWS, replace=False))
    card_counts = counts[torch.as_tensor(picked, device="cuda")].cpu().numpy()
    # the call's stages apart on these counts: the LLR with the diagonal
    # drop and the top-k (the call's own indicators again), the top-k alone
    idx, vals = indicators
    totals_dev = torch.tensor(np.asarray(llr_totals, np.float32), device="cuda")
    stages = {"counts_s": counts_s}
    for name, kw in (("llr_topk_s", {"row_totals": totals_dev, "col_totals": totals_dev,
                                      "total": float(csr.num_rows)}), ("topk_s", {})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = cooc.indicators_from_counts(counts, idx.shape[1], drop_diagonal=True, **kw)
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        if name == "llr_topk_s" and not (np.array_equal(got[0].cpu().numpy(), idx)
                                         and np.array_equal(got[1].cpu().numpy(), vals)):
            raise AssertionError("the LLR stage's indicators differ from the call's")
        del got
    stages["llr_s"] = stages["llr_topk_s"] - stages["topk_s"]
    stages["llr_share_of_stages"] = stages["llr_s"] / (counts_s + stages["llr_topk_s"])
    del counts, totals_dev
    t0 = time.perf_counter()
    r, c = np.nonzero((csr.mask > 0) & (csr.indices < num))
    a = sp.csr_matrix((np.ones(r.size), (r, csr.indices[r, c])),
                      shape=(csr.indices.shape[0], num))
    a.sum_duplicates()
    a.data[:] = 1.0
    host_counts = (a.tocsc()[:, picked].T.tocsr() @ a).toarray()
    if not np.array_equal(host_counts, card_counts):
        bad = np.argwhere(host_counts != card_counts)[:5].tolist()
        raise AssertionError(f"card counts differ from scipy's at {bad}")
    totals = np.asarray(llr_totals, np.float64)
    llr = llr_f64(host_counts, totals[picked], totals, float(csr.num_rows))
    llr[np.arange(picked.size), picked] = -np.inf
    tol = llr_f32_tolerance(csr.num_rows)
    cmp = compare_indicators((idx[picked], vals[picked]), host_topk(llr, idx.shape[1]), tol)
    return {"users": csr.num_rows, "items": num, "pairs_in_rows": int(host_counts.sum()),
            "rows_checked": COOC_CHECK_ROWS, "counts_s": counts_s, "stages": stages,
            "host_check_s": time.perf_counter() - t0, "llr_tolerance": tol, **cmp}


class ColumnSnapshot:
    """The read surface of a training snapshot (``data/snapshot.py``)
    over given columns: what the retrain loop hands ``fold_in``."""

    def __init__(self, users, items, names, times, uvocab, ivocab, nvocab):
        self._cols = {"users": users, "items": items, "names": names, "times": times,
                      "ratings": np.full(users.size, np.nan)}
        self._vocabs = {"users": uvocab, "items": ivocab, "names": nvocab}
        self.manifest = {"until_ms": int(times.max() * 1000) + 1}

    def column(self, name):
        return self._cols[name]

    def vocab(self, which):
        return self._vocabs[which]

    def __len__(self):
        return self._cols["users"].size


def example_engine(repo: str, template: str) -> dict:
    with open(os.path.join(repo, "examples", template, "engine.json")) as f:
        return json.load(f)


def shop_store(ev: dict) -> None:
    """The app the e-commerce model reads live: every item's categories
    ``$set`` (what the DataSource's category read sees)."""
    import datetime as _dt

    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.event import DataMap, Event
    from predictionio_tpu_torch.data.storage.base import App

    app_id = storage.get_meta_data_apps().insert(App(name=TEMPLATE_APP))
    le = storage.get_l_events()
    le.init_channel(app_id)
    when = _dt.datetime(2015, 1, 1, tzinfo=_dt.timezone.utc)
    le.batch_insert([
        Event(event="$set", entity_type="item", entity_id=item,
              properties=DataMap({"categories": cats}), event_time=when)
        for item, cats in ev["categories"].items()
    ], app_id)


def shop_event(name: str, etype: str, eid: str, target=None, props=None):
    """One event for the e-commerce app, now."""
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.event import DataMap, Event
    from predictionio_tpu_torch.data.store import resolve_app_channel

    app_id, _ = resolve_app_channel(TEMPLATE_APP, None)
    storage.get_l_events().insert(
        Event(event=name, entity_type=etype, entity_id=eid,
              target_entity_type="item" if target else None, target_entity_id=target,
              properties=DataMap(props or {})), app_id)


def phase_train_ecommerce(ev: dict, repo: str, rng: np.random.Generator) -> dict:
    """``examples/ecommerce/engine.json`` (plus the 256 history cap) on
    the 24M view/buy events through ECommercePreparator ->
    ECommAlgorithm.train on cuda: 20 B1 launches counted; a 2-iteration
    implicit fit through B1 equals "xla" within 1e-4. Then one fold-in of
    1,000 users (a view each) with a window holding item ``$set`` records
    ("sale" added to 3 items): B1 launched, the folded rows within 1e-4
    of the "xla" fold, the category index rebuilt from the store and the
    new category served."""
    import torch

    from predictionio_tpu_torch.controller.base import TrainContext
    from predictionio_tpu_torch.models.ecommerce import (
        ECommAlgorithm,
        ECommerceData,
        ECommercePreparator,
    )
    from predictionio_tpu_torch.models.ecommerce.engine import _load_categories
    from predictionio_tpu_torch.online.foldin import FoldinDelta
    from predictionio_tpu_torch.ops import als_gram
    from predictionio_tpu_torch.parallel.als import als_fit

    variant = example_engine(repo, "ecommerce")
    ds_params = variant["datasource"]["params"]
    algo_params = variant["algorithms"][0]["params"]
    vu, vi, vt = ev["view"]
    bu, bi, bt = ev["buy"]
    t0 = time.perf_counter()
    data = ECommerceData(
        users=np.concatenate([vu, bu]), items=np.concatenate([vi, bi]),
        weights=np.concatenate([np.ones(vu.size, np.float32),
                                np.full(bu.size, ds_params["buyWeight"], np.float32)]),
        times=np.concatenate([vt, bt]), user_ids=ev["user_ids"], item_ids=ev["item_ids"],
        app_name=TEMPLATE_APP, categories=_load_categories(TEMPLATE_APP),
    )
    data.sanity_check()
    data_s = time.perf_counter() - t0
    algorithm = ECommAlgorithm(algo_params, device="cuda")
    steps = StepTimes()
    ctx = TrainContext(device="cuda", telemetry=steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prepared = ECommercePreparator({"maxEventsPerUser": TRAIN_CAP}).prepare(ctx, data)
    pack_s = time.perf_counter() - t0
    als_gram.gram_rhs.launches = 0           # counts start at 0 here
    t0 = time.perf_counter()
    model = algorithm.train(ctx, prepared)
    train_s = time.perf_counter() - t0
    launches = als_gram.gram_rhs.launches    # read here
    peak = torch.cuda.max_memory_allocated()
    config = algorithm._config()
    if launches != 2 * config.iterations or not config.implicit:
        raise AssertionError(f"{launches} B1 launches (implicit {config.implicit}), "
                             f"expected {2 * config.iterations}")
    for name in ("user_factors", "item_factors"):
        if not np.isfinite(getattr(model.als, name)).all():
            raise AssertionError(f"non-finite {name} after training")
    if set(model.category_items) != {f"cat{c}" for c in range(TEMPLATE_CATEGORIES)}:
        raise AssertionError(f"category index {sorted(model.category_items)}")
    _, als_data = prepared
    two = dataclasses.replace(config, factor_sharding="replicated", iterations=2)
    fused2 = als_fit(als_data, two, "cuda")
    xla2 = als_fit(als_data, dataclasses.replace(two, solver="xla"), "cuda")
    xla_diff = max(float(np.abs(fused2.user_factors - xla2.user_factors).max()),
                   float(np.abs(fused2.item_factors - xla2.item_factors).max()))
    if xla_diff > FIT_ATOL:
        raise AssertionError(f"implicit 2-iteration fit differs from xla by {xla_diff}")

    # the fold-in: 1,000 users' histories and one new view each, after
    # three items gained the "sale" category in the store
    picked = np.sort(rng.choice(TRAIN_USERS, TEMPLATE_FOLDIN_USERS, replace=False))
    hist = np.isin(data.users, picked)
    start = float(data.times.max()) + 10.0
    new_items = rng.integers(0, TRAIN_ITEMS, picked.size)
    snap = ColumnSnapshot(
        users=np.concatenate([data.users[hist], picked]),
        items=np.concatenate([data.items[hist], new_items]),
        names=np.concatenate([(data.weights[hist] > 1).astype(np.int32),
                              np.zeros(picked.size, np.int32)]),
        times=np.concatenate([data.times[hist], start + np.arange(picked.size) * 1e-3]),
        uvocab=ev["user_ids"], ivocab=ev["item_ids"], nvocab=["view", "buy"])
    sale = [f"i{i}" for i in rng.choice(TRAIN_ITEMS, TEMPLATE_SALE_ITEMS, replace=False)]
    for item in sale:
        shop_event("$set", "item", item, props={"categories": ev["categories"][item] + ["sale"]})
    delta = FoldinDelta(snapshot=snap, window_start_ms=int(start * 1000),
                        extras={"event_values": {"view": 1.0, "buy": ds_params["buyWeight"]}},
                        set_entity_types={"item"})
    als_gram.gram_rhs.launches = 0
    t0 = time.perf_counter()
    folded = algorithm.fold_in(model, delta)
    foldin_s = time.perf_counter() - t0
    foldin_launches = als_gram.gram_rhs.launches
    plain = ECommAlgorithm({**algo_params, "alsSolver": "xla"}, device="cuda").fold_in(model, delta)
    rows = [folded.user_index[f"u{u}"] for u in picked]
    fold_err = float(np.abs(folded.als.user_factors[rows] - plain.als.user_factors[rows]).max())
    if foldin_launches < 1 or fold_err > FIT_ATOL:
        raise AssertionError(f"fold-in: {foldin_launches} B1 launches, {fold_err} from xla")
    want_sale = sorted(folded.item_index[i] for i in sale)
    if folded.category_items.get("sale", np.zeros(0)).tolist() != want_sale:
        raise AssertionError(f"the sale category was not rebuilt: {folded.category_items.get('sale')}")
    answer = algorithm.predict(folded, {"user": f"u{picked[0]}", "num": 10,
                                        "categories": ["sale"], "unseenOnly": False})
    served_sale = {s["item"] for s in answer["itemScores"]}
    if not served_sale or not served_sale <= set(sale):
        raise AssertionError(f"the sale category served {answer}")
    result = {
        "events": int(data.users.size), "views": int(vu.size), "buys": int(bu.size),
        "rank": config.rank, "iterations": config.iterations, "alpha": config.alpha,
        "implicit": config.implicit, "max_events_per_user": TRAIN_CAP,
        "user_block": list(als_data.by_row.blocks[0].indices.shape),
        "item_block": list(als_data.by_col.blocks[0].indices.shape),
        "data_s": data_s, "pack_s": pack_s, "train_s": train_s,
        "iteration_s_median": statistics.median(steps.seconds),
        "iterations_s_total": sum(steps.seconds), "peak_device_bytes": peak,
        "b1_launches": launches, "xla_max_abs_diff_at_2": xla_diff,
        "foldin": {"users": TEMPLATE_FOLDIN_USERS, "rows": len(snap), "seconds": foldin_s,
                   "b1_launches": foldin_launches, "max_abs_err_vs_xla": fold_err,
                   "sale_items_served": sorted(served_sale)},
    }
    emit({"phase": "train_ecommerce", **result})
    return {"result": result, "model": model}


def check_rules(body: dict, q: dict, model, anchors=()) -> None:
    """The e-commerce business rules on a served answer."""
    got = [s["item"] for s in body["itemScores"]]
    rows = {model.item_index[i] for i in got}
    if q.get("categories"):
        allowed = set()
        for c in q["categories"]:
            allowed |= set(model.category_items.get(c, np.zeros(0)).tolist())
        if not rows <= allowed:
            raise AssertionError(f"{q}: items outside the categories: {got}")
    if q.get("whiteList") and not set(got) <= set(q["whiteList"]):
        raise AssertionError(f"{q}: items outside the whiteList: {got}")
    if set(got) & set(q.get("blackList") or []):
        raise AssertionError(f"{q}: blackListed items served: {got}")
    user_row = model.user_index.get(q["user"])
    if user_row is not None and q.get("unseenOnly", True) and rows & model.seen.get(user_row, set()):
        raise AssertionError(f"{q}: seen items served: {got}")
    if rows & set(anchors):
        raise AssertionError(f"{q}: the cold user's anchors served: {got}")
    if not got:
        raise AssertionError(f"{q}: empty answer")


def phase_serve_ecommerce(trained: dict, ev: dict, repo: str, workdir: str,
                          rng: np.random.Generator) -> dict:
    """The trained e-commerce model saved and deployed twice through the
    ``deploy`` code path on cuda, scan then mips: known users, categories,
    whiteList, blackList, a cold user with recent views (a live read) and
    ``unseenOnly: false``. The rules hold in both deploys; the mips one
    launches B2 and reaches recall@10 >= 0.99 against the scan's lists.
    A 256-user ``batch_predict`` equals per-query ``predict``."""
    from predictionio_tpu_torch.models.ecommerce import ECommAlgorithm, save_model
    from predictionio_tpu_torch.ops import mips

    model = trained["model"]
    model_dir = os.path.join(workdir, "ecommerce_model")
    t0 = time.perf_counter()
    save_model(model, model_dir)
    save_s = time.perf_counter() - t0
    variant = example_engine(repo, "ecommerce")
    variant["datasource"]["params"]["appName"] = TEMPLATE_APP
    algo_params = variant["algorithms"][0]["params"]
    paths = {}
    for mode in ("scan", "mips"):
        v = json.loads(json.dumps(variant))
        if mode == "mips":
            v["algorithms"][0]["params"]["retrieval"] = {"mode": "mips"}
        paths[mode] = os.path.join(workdir, f"ecommerce_{mode}.json")
        with open(paths[mode], "w") as f:
            json.dump(v, f)
    users = [f"u{u}" for u in rng.choice(TRAIN_USERS, TEMPLATE_QUERIES, replace=False)]
    anchors = [f"i{i}" for i in rng.choice(TRAIN_ITEMS, 5, replace=False)]
    for item in anchors:
        shop_event("view", "user", "cold-chip", item)
    # a whiteList the mips shortlist can answer: 10 of the user's unfiltered
    # top 30 (scan) among 50 random items
    top = ECommAlgorithm(algo_params, device="cuda").predict(
        model, {"user": users[2], "num": 30, "unseenOnly": False})["itemScores"]
    white = ([s["item"] for s in top[::3]]
             + [f"i{i}" for i in rng.choice(TRAIN_ITEMS, 50, replace=False)])
    queries = ([{"user": u, "num": 10} for u in users] + [
        {"user": users[0], "num": 10, "categories": ["cat3"]},
        {"user": users[1], "num": 10, "categories": ["cat7", "cat11"]},
        {"user": users[2], "num": 5, "whiteList": white},
        {"user": users[3], "num": 10, "blackList": [f"i{i}" for i in range(40)]},
        {"user": "cold-chip", "num": 10},
        {"user": users[4], "num": 10, "unseenOnly": False},
    ])
    anchor_rows = [model.item_index[i] for i in anchors]
    out = {}
    for mode in ("scan", "mips"):
        times = []
        mips.mips_block_topk.launches = 0    # counts start at 0 here
        served, deployed, deploy_s = serve_model(paths[mode], model_dir, queries, times)
        b2 = mips.mips_block_topk.launches   # read here
        for q, body in zip(queries, served):
            check_rules(body, q, deployed, anchor_rows if q["user"] == "cold-chip" else ())
        out[mode] = {"served": served, "deploy_s": deploy_s, "b2_launches": b2,
                     "query_ms_p50": statistics.median(times), "query_ms_max": max(times)}
    if out["mips"]["b2_launches"] < 1 or out["scan"]["b2_launches"] != 0:
        raise AssertionError(f"B2 launches: scan {out['scan']['b2_launches']}, "
                             f"mips {out['mips']['b2_launches']}")
    # recall@10 against the scan over every list, the categories and
    # whiteList ones included
    hits = total = identical = 0
    overlap = []
    for scan_body, mips_body in zip(out["scan"]["served"], out["mips"]["served"]):
        want = [s["item"] for s in scan_body["itemScores"]][:10]
        hit = len(set(want) & {s["item"] for s in mips_body["itemScores"]})
        identical += scan_body == mips_body
        overlap.append(f"{hit}/{len(want)}")
        hits, total = hits + hit, total + len(want)
    recall = hits / max(total, 1)
    if recall < 0.99:
        raise AssertionError(f"e-commerce mips recall@10 {recall} < 0.99 against the scan "
                             f"(per list {overlap})")
    # batch_predict of 256 users through the mips algorithm = per-query predict
    algorithm = ECommAlgorithm({**algo_params, "retrieval": {"mode": "mips"}}, device="cuda")
    batch_users = rng.choice(TRAIN_USERS, TEMPLATE_BATCH, replace=False)
    batch = [(k, {"user": f"u{u}", "num": 10}) for k, u in enumerate(batch_users)]
    mips.mips_block_topk.launches = 0
    t0 = time.perf_counter()
    answers = dict(algorithm.batch_predict(deployed, batch))
    batch_s = time.perf_counter() - t0
    batch_b2 = mips.mips_block_topk.launches
    for k, q in batch:
        if answers[k] != algorithm.predict(deployed, q):
            raise AssertionError(f"batch_predict differs from predict for {q}")
    result = {
        "save_s": save_s, "queries": len(queries),
        "scan": {k: v for k, v in out["scan"].items() if k != "served"},
        "mips": {k: v for k, v in out["mips"].items() if k != "served"},
        "recall_at_10": recall, "recall_lists": len(queries),
        "overlap_with_scan": overlap, "identical_to_scan": identical,
        "batch_predict": {"queries": TEMPLATE_BATCH, "seconds": batch_s, "b2_launches": batch_b2},
    }
    emit({"phase": "serve_ecommerce", **result})
    result["b2_launches"] = out["mips"]["b2_launches"] + batch_b2
    return result


@contextlib.contextmanager
def timed_cooccurrence(module, calls: list, check=None):
    """Time each ``cooccurrence_indicators`` call of a template module
    (synced), with its peak device bytes and the products' bound;
    ``check(primary, result, kwargs)`` runs after each call, untimed."""
    import torch

    real = module.cooccurrence_indicators

    def timed(primary, other=None, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = real(primary, other, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        o = primary if other is None else other
        phys = max(primary.indices.shape[0], o.indices.shape[0])
        chunk = min(kw.get("chunk", 4096), phys)
        rows = -(-phys // chunk) * chunk
        calls.append({"rows": rows, "items_p": primary.num_cols, "items_o": o.num_cols,
                      "seconds": seconds, "peak_device_bytes": torch.cuda.max_memory_allocated(),
                      "bound_ms": cooc_bound(rows, primary.num_cols, o.num_cols)})
        if check is not None:
            check(primary, out, kw)
        return out

    module.cooccurrence_indicators = timed
    try:
        yield calls
    finally:
        module.cooccurrence_indicators = real


def template_algorithm(template: str):
    """``(name, class)`` of a ported template's one algorithm."""
    from predictionio_tpu_torch.workflow.json_extractor import template_engine

    return next(iter(template_engine(template).algorithm_class_map.items()))


def serve_and_batch(template: str, params: dict, model, workdir: str, queries: list,
                    batch: list) -> dict:
    """Save and deploy a cooccurrence model with ``params`` through the
    ``deploy`` code path on cuda; every served answer equals in-process
    ``predict``, and a ``batch_predict`` of ``batch`` equals per-query
    ``predict``."""
    name, cls = template_algorithm(template)
    model_dir = os.path.join(workdir, f"{template}_model")
    t0 = time.perf_counter()
    cls.model_files.save(model, model_dir)
    save_s = time.perf_counter() - t0
    engine_json = os.path.join(workdir, f"{template}.json")
    with open(engine_json, "w") as f:
        json.dump({"algorithms": [{"name": name, "params": params}]}, f)
    times = []
    served, deployed, deploy_s = serve_model(engine_json, model_dir, queries, times)
    algorithm = cls(params, device="cuda")
    for q, body in zip(queries, served):
        if body != algorithm.predict(deployed, q):
            raise AssertionError(f"{template}: served {q} differs from predict")
    if not all(body["itemScores"] for body in served):
        raise AssertionError(f"{template}: an empty answer among {served}")
    t0 = time.perf_counter()
    answers = dict(algorithm.batch_predict(deployed, batch))
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = {k: algorithm.predict(deployed, q) for k, q in batch}
    predict_s = time.perf_counter() - t0
    if answers != single:
        raise AssertionError(f"{template}: batch_predict differs from predict")
    return {"save_s": save_s, "deploy_s": deploy_s, "queries": len(queries),
            "query_ms_p50": statistics.median(times), "query_ms_max": max(times),
            "batch_queries": len(batch), "batch_s": batch_s, "predict_s": predict_s}


def phase_train_cooc(ev: dict, repo: str, workdir: str, rng: np.random.Generator,
                     small_check: dict) -> dict:
    """``examples/similarproduct/engine.json`` and ``examples/universal/
    engine.json`` unchanged, plus the 256 history cap, on the same
    events (27,000 items; the universal template's primary "buy", cross
    "view"): each ``cooccurrence_indicators`` call's seconds, peak device
    bytes and the products' bound; the similar-product call's full-size
    check (``full_cooc_check``, printed as cooc_check with the small
    half); then each model deployed and asked item and user queries, and
    a 256-query ``batch_predict`` held to per-query ``predict``."""
    import torch

    from predictionio_tpu_torch.controller.base import TrainContext
    from predictionio_tpu_torch.models.similarproduct import (
        CooccurrenceAlgorithm,
        InteractionData,
    )
    from predictionio_tpu_torch.models.similarproduct import engine as sp_engine
    from predictionio_tpu_torch.models.universal import MultiEventData, URAlgorithm
    from predictionio_tpu_torch.models.universal import engine as ur_engine

    vu, vi, vt = ev["view"]
    bu, bi, bt = ev["buy"]
    ctx = TrainContext(device="cuda")
    users = [f"u{u}" for u in rng.choice(TRAIN_USERS, TEMPLATE_QUERIES, replace=False)]
    items = [f"i{i}" for i in rng.choice(TRAIN_ITEMS, TEMPLATE_QUERIES, replace=False)]
    batch_users = rng.choice(TRAIN_USERS, TEMPLATE_BATCH // 2, replace=False)
    batch_items = rng.choice(TRAIN_ITEMS, TEMPLATE_BATCH // 2, replace=False)
    result = {}

    sp_params = dict(example_engine(repo, "similarproduct")["algorithms"][0]["params"],
                     maxEventsPerUser=TRAIN_CAP)
    data = InteractionData(users=np.concatenate([vu, bu]), items=np.concatenate([vi, bi]),
                           times=np.concatenate([vt, bt]), user_ids=ev["user_ids"],
                           item_ids=ev["item_ids"])
    algorithm = CooccurrenceAlgorithm(sp_params, device="cuda")
    full = []

    def check(primary, out, kw):
        full.append(full_cooc_check(primary, out, kw["llr_row_totals"], rng))

    with timed_cooccurrence(sp_engine, [], check) as calls:
        t0 = time.perf_counter()
        model = algorithm.train(ctx, data)
        train_s = time.perf_counter() - t0
    if model.top_indices.shape != (TRAIN_ITEMS, sp_params["topK"]) or not np.isfinite(
            model.top_values).all():
        raise AssertionError(f"similar-product indicators {model.top_indices.shape}")
    emit({"phase": "cooc_check", "small": small_check, "full": full[0]})
    queries = ([{"items": [i], "num": 10} for i in items]
               + [{"user": u, "num": 10} for u in users]
               + [{"items": items[:3], "num": 10, "blackList": items[3:6]}])
    batch = ([(k, {"user": f"u{u}", "num": 10}) for k, u in enumerate(batch_users)]
             + [(TEMPLATE_BATCH + k, {"items": [f"i{i}"], "num": 10})
                for k, i in enumerate(batch_items)])
    result["similarproduct"] = {
        "events": int(data.users.size), "train_s": train_s, "calls": calls,
        **serve_and_batch("similarproduct", sp_params, model, workdir, queries, batch)}
    del model, data

    ur_params = dict(example_engine(repo, "universal")["algorithms"][0]["params"],
                     maxEventsPerUser=TRAIN_CAP)
    data = MultiEventData(
        event_names=["buy", "view"], per_event={"buy": ev["buy"], "view": ev["view"]},
        user_ids=ev["user_ids"], item_ids=ev["item_ids"],
        item_properties={i: {"categories": c} for i, c in ev["categories"].items()})
    algorithm = URAlgorithm(ur_params, device="cuda")
    with timed_cooccurrence(ur_engine, []) as calls:
        t0 = time.perf_counter()
        model = algorithm.train(ctx, data)
        train_s = time.perf_counter() - t0
    if set(model.indicators) != {"buy", "view"} or len(calls) != 2:
        raise AssertionError(f"UR indicators {sorted(model.indicators)}, {len(calls)} calls")
    queries = ([{"user": u, "num": 10} for u in users]
               + [{"items": [i], "num": 10} for i in items]
               + [{"user": users[0], "num": 10, "fields": [
                   {"name": "categories", "values": ["cat2"], "bias": -1}]},
                  {"user": users[1], "num": 10, "blackList": items, "fields": [
                      {"name": "categories", "values": ["cat5"], "bias": 3.0}]}])
    result["universal"] = {
        "events": int(vu.size + bu.size), "train_s": train_s, "calls": calls,
        **serve_and_batch("universal", ur_params, model, workdir, queries, batch)}
    torch.cuda.empty_cache()
    emit({"phase": "train_cooc", **result})
    return result


def small_template_events(rng: np.random.Generator, path: str) -> None:
    """A few thousand view/buy events and every item's categories in the
    ``pio import`` wire shape."""
    base = 1_700_000_000
    n = TEMPLATE_STORE_EVENTS
    users = rng.integers(0, TEMPLATE_STORE_USERS, n)
    items = (np.minimum(rng.random(n) ** 2.2, 0.999999) * TEMPLATE_STORE_ITEMS).astype(np.int64)
    buys = rng.random(n) < 0.2
    with open(path, "w") as f:
        for i in range(TEMPLATE_STORE_ITEMS):
            f.write(json.dumps({
                "event": "$set", "entityType": "item", "entityId": f"i{i}",
                "properties": {"categories": [f"cat{i % 7}"]},
                "eventTime": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(base - 1)),
            }) + "\n")
        for e in range(n):
            f.write(json.dumps({
                "event": "buy" if buys[e] else "view", "entityType": "user",
                "entityId": f"u{users[e]}", "targetEntityType": "item",
                "targetEntityId": f"i{items[e]}",
                "eventTime": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(base + e)),
            }) + "\n")


def phase_store_templates(rng: np.random.Generator, repo: str, workdir: str) -> dict:
    """A fresh store: ``pio import`` of a few thousand view/buy events,
    then ``pio train`` -> ``pio deploy`` of each shipped engine.json (the
    app name set) through the port's CLI on cuda, each answer equal to
    the instance's model's ``predict``; on the e-commerce deploy a
    ``$set`` of ``unavailableItems`` drops the top item from the next
    answer without a retrain."""
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.event import DataMap, Event
    from predictionio_tpu_torch.ops import als_gram
    from predictionio_tpu_torch.tools.cli import build_query_server
    from predictionio_tpu_torch.workflow.core_workflow import load_instance_models
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    events = os.path.join(workdir, "template_events.jsonl")
    small_template_events(rng, events)
    result = {}
    with fresh_store(workdir, "templates_store"):
        app_id = said(cli_out(["app", "new", "SmallShop"]), "ID")
        t0 = time.perf_counter()
        cli_out(["import", "--appid", app_id, "--input", events])
        result["import_s"] = time.perf_counter() - t0
        user = "u1"
        for template, query in (("ecommerce", {"user": user, "num": 5}),
                                ("similarproduct", {"items": ["i1"], "num": 5}),
                                ("universal", {"user": user, "num": 5})):
            variant_path = store_variant(
                os.path.join(repo, "examples", template, "engine.json"), "SmallShop",
                os.path.join(workdir, f"small_{template}.json"))
            als_gram.gram_rhs.launches = 0   # counts start at 0 here
            t0 = time.perf_counter()
            instance = said(cli_out(["train", "--variant", variant_path, "--device", "cuda"]),
                            "Engine instance ID")
            train_s = time.perf_counter() - t0
            b1 = als_gram.gram_rhs.launches  # read here
            variant = load_engine_variant(variant_path)
            _, [model] = load_instance_models(variant, instance)
            algorithm = template_algorithm(template)[1](
                variant.engine_params.algorithm_params_list[0][1], device="cuda")
            server, service = build_query_server(variant_path, port=0, device="cuda")
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
            try:
                body, ms = post(conn, query)
                if body != algorithm.predict(model, query) or not body["itemScores"]:
                    raise AssertionError(f"{template}: deploy answered {body}")
                entry = {"instance": instance, "train_s": train_s, "b1_launches": b1,
                         "query_ms": ms, "items": [s["item"] for s in body["itemScores"]]}
                if template == "ecommerce":
                    if b1 != 2 * algorithm._config().iterations:
                        raise AssertionError(f"the e-commerce train launched B1 {b1} times")
                    top = body["itemScores"][0]["item"]
                    storage.get_l_events().insert(
                        Event(event="$set", entity_type="constraint",
                              entity_id="unavailableItems",
                              properties=DataMap({"items": [top]})), int(app_id))
                    after, _ = post(conn, query)
                    served = [s["item"] for s in after["itemScores"]]
                    if top in served or not served:
                        raise AssertionError(f"unavailable {top} still served: {served}")
                    entry.update(unavailable=top, after=served)
                result[template] = entry
            finally:
                conn.close()
                server.shutdown()
                server.server_close()
                service.close()
                thread.join(timeout=30)
    emit({"phase": "store_templates", **result})
    result["b1_launches"] = result["ecommerce"]["b1_launches"]
    return result


def phase_templates(rng: np.random.Generator, ratings, repo: str, workdir: str) -> dict:
    """The templates part: cooc_check, train_ecommerce, serve_ecommerce,
    train_cooc and store_templates. Every kernel's count is set to 0
    first; B3, B4 and the fused backward must stay at 0 through it."""
    from predictionio_tpu_torch.models.ncf import kernel as ncf_kernel

    t0 = time.perf_counter()
    ev = template_events(tuple(a[:TEMPLATE_RATINGS] for a in ratings), rng)
    events_s = time.perf_counter() - t0
    ncf_kernel.ncf_score_all_items.launches = 0
    zero_flash_counts()
    seconds = {"events": events_s}
    t0 = time.perf_counter()
    small_check = phase_cooc_check(ev)
    seconds["cooc_check_small"] = time.perf_counter() - t0
    with fresh_store(workdir, "shop"):
        shop_store(ev)
        t0 = time.perf_counter()
        trained = phase_train_ecommerce(ev, repo, rng)
        seconds["train_ecommerce"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = phase_serve_ecommerce(trained, ev, repo, workdir, rng)
        seconds["serve_ecommerce"] = time.perf_counter() - t0
    ecommerce = trained["result"]
    del trained
    t0 = time.perf_counter()
    phase_train_cooc(ev, repo, workdir, rng, small_check)
    seconds["train_cooc"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = phase_store_templates(rng, repo, workdir)
    seconds["store_templates"] = time.perf_counter() - t0
    others = {"ncf_score_all_items": ncf_kernel.ncf_score_all_items.launches, **flash_counts()}
    if any(others.values()):
        raise AssertionError(f"the templates launched other kernels: {others}")
    result = {
        "b1_launches": {"train_ecommerce": ecommerce["b1_launches"],
                        "foldin": ecommerce["foldin"]["b1_launches"],
                        "store_templates": store["b1_launches"]},
        "b2_launches": {"serve_ecommerce": served["b2_launches"]},
        "other_launches": others, "seconds": seconds,
    }
    emit({"phase": "templates", **result})
    # store_templates' materialized instances: the stream path's twins
    result["store_instances"] = {t: store[t]["instance"]
                                 for t in ("ecommerce", "similarproduct", "universal")}
    return result


# --------------------------------------------------------------------------
# the stream path: streamed ALS epochs through B1 (``alsFeed: "streamed"``)
# and the templates' streaming reader (``"reader": "streaming"``)
# --------------------------------------------------------------------------

#: users of the streamed fit whose mips top-10 (B2) is held to its scan
STREAM_RECALL_USERS = 256
#: CUDA-event runs of the pinned copy of the largest block, timed alone
STREAM_COPY_RUNS = 10


class RssPeak:
    """The process's resident set (``/proc/self/statm``) over a block,
    sampled every 2 ms by a thread: ``growth`` is the peak less the
    resident set at entry."""

    def _rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def _run(self) -> None:
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, self._rss())

    def __enter__(self) -> "RssPeak":
        self.page = os.sysconf("SC_PAGE_SIZE")
        self.start = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())
        self.growth = self.peak - self.start


def store_blocks(store) -> int:
    return len(store.by_row.specs) + len(store.by_col.specs)


def phase_stream_fit(ratings, resident: dict, repo: str, workdir: str, seed: int) -> dict:
    """(a) The ALS training cell's 20M ratings packed into a block store
    (``array_coo_chunks`` -> ``build_streamed_als_data``, 32 MB blocks)
    and fitted by ``als_fit_streamed`` through B1 with the template's
    params: factors within 1e-4 of phase 6's resident fit, B1 once per
    block a half-step, the measured host -> device bytes the model's, at
    most two blocks in flight, recall@10 of B2's lists against the exact
    scan of the streamed model; then the same fit with a device budget
    over the whole store: after the first iteration no block ships, the
    factors the same."""
    import torch

    from predictionio_tpu_torch.models._als_common import score_known_user, topk_order
    from predictionio_tpu_torch.models.recommendation import ALSAlgorithm
    from predictionio_tpu_torch.ops import als_gram, mips
    from predictionio_tpu_torch.ops.mips import RetrievalConfig
    from predictionio_tpu_torch.parallel.als import als_fit_streamed
    from predictionio_tpu_torch.parallel.reader import array_coo_chunks
    from predictionio_tpu_torch.parallel.stream import (
        StreamStats,
        build_streamed_als_data,
        stream_bytes_per_half_step,
    )

    users, items, values, times = ratings
    algo_params, _ = template_params(repo)
    config = dataclasses.replace(ALSAlgorithm(algo_params, device="cuda")._config(),
                                 max_len=TRAIN_CAP, factor_sharding="replicated")
    t0 = time.perf_counter()
    store = build_streamed_als_data(array_coo_chunks(users, items, values, times),
                                    TRAIN_USERS, TRAIN_ITEMS, config,
                                    os.path.join(workdir, "ml20m_blocks"))
    build_s = time.perf_counter() - t0
    disk_bytes = sum(os.path.getsize(os.path.join(store.directory, f))
                     for f in os.listdir(store.directory))
    blocks = store_blocks(store)
    per_iteration = 2 * stream_bytes_per_half_step(store, config.implicit)

    torch.cuda.synchronize()
    stats, steps = StreamStats(), StepTimes()
    als_gram.gram_rhs.launches = 0           # counts start at 0 here
    with RssPeak() as rss:
        t0 = time.perf_counter()
        model = als_fit_streamed(store, config, "cuda", telemetry=steps, stats=stats)
        fit_s = time.perf_counter() - t0
    b1 = als_gram.gram_rhs.launches          # read here
    err = max(float(np.abs(model.user_factors - resident["user_factors"]).max()),
              float(np.abs(model.item_factors - resident["item_factors"]).max()))
    if b1 != blocks * config.iterations:
        raise AssertionError(f"{b1} B1 launches for {blocks} blocks x {config.iterations}")
    if not err <= FIT_ATOL:
        raise AssertionError(f"streamed factors differ from the resident fit's by {err}")
    if stats.h2d_block_bytes != round(per_iteration * config.iterations):
        raise AssertionError(f"{stats.h2d_block_bytes} block bytes shipped, the model "
                             f"says {per_iteration * config.iterations}")
    if stats.max_inflight_blocks > 2:
        raise AssertionError(f"{stats.max_inflight_blocks} blocks in flight")

    # B2 over the streamed model: its top-10 against its exact scan
    retrieval = RetrievalConfig(mode="mips")
    picked = np.random.default_rng(seed).choice(TRAIN_USERS, STREAM_RECALL_USERS,
                                                replace=False)
    mips.mips_block_topk.launches = 0
    hits = 0
    for u in picked.tolist():
        short = score_known_user(model, u, retrieval, device="cuda")
        got = set(short.indices[topk_order(short.scores, 10)].tolist())
        hits += len(got & set(topk_order(model.score_items_for_user(u), 10).tolist()))
    b2 = mips.mips_block_topk.launches
    recall = hits / (10 * len(picked))
    if recall < 0.99 or b2 < 1:
        raise AssertionError(f"recall@10 {recall} with {b2} B2 launches")

    # one pinned copy of the largest block's size, timed alone
    largest = max(s.idx_bytes() + s.val_bytes() + (0 if config.implicit else s.nobs_bytes())
                  for side in (store.by_row, store.by_col) for s in side.specs)
    host = torch.empty(largest, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(largest, dtype=torch.uint8, device="cuda")
    copy_ms = cuda_ms(lambda: dev.copy_(host, non_blocking=True), runs=STREAM_COPY_RUNS)
    del host, dev

    # a device budget holding the whole store: only the first iteration ships
    pinned_stats = StreamStats()
    t0 = time.perf_counter()
    pinned = als_fit_streamed(store, config, "cuda", stats=pinned_stats,
                              device_budget_bytes=round(per_iteration))
    pinned_fit_s = time.perf_counter() - t0
    if pinned_stats.h2d_block_bytes != round(per_iteration) or (
            pinned_stats.blocks_pinned != blocks * (config.iterations - 1)):
        raise AssertionError(f"the pinned fit shipped {pinned_stats}")
    if not (np.array_equal(pinned.user_factors, model.user_factors)
            and np.array_equal(pinned.item_factors, model.item_factors)):
        raise AssertionError("the pinned fit's factors differ from the streamed fit's")
    del pinned
    torch.cuda.empty_cache()

    result = {
        "users": TRAIN_USERS, "items": TRAIN_ITEMS, "edges": TRAIN_EDGES,
        "rank": config.rank, "iterations": config.iterations,
        "store_build_s": build_s, "store_disk_bytes": disk_bytes,
        "spill_s": store.manifest["spill_seconds"], "pack_s": store.manifest["pack_seconds"],
        "blocks": {"users": [[s.rows, s.pad_len] for s in store.by_row.specs],
                   "items": [[s.rows, s.pad_len] for s in store.by_col.specs]},
        "fit_s": fit_s, "b1_launches": b1, "factors_max_abs_err_vs_resident": err,
        "iteration_s": steps.seconds,
        "iteration_s_median": statistics.median(steps.seconds),
        "resident_iteration_s_median": resident["iteration_s_median"],
        "stats": dataclasses.asdict(stats),
        "modeled_block_bytes": per_iteration * config.iterations,
        "h2d_gb_per_s": stats.h2d_block_bytes / fit_s / 1e9,
        "largest_block_bytes": largest, "pinned_copy_ms": copy_ms,
        "pinned_copy_gb_per_s": largest / copy_ms / 1e6,
        "host_rss_growth_bytes": rss.growth, "host_rss_start_bytes": rss.start,
        "recall_at_10": recall, "recall_users": len(picked), "b2_launches": b2,
        "budget": {"fit_s": pinned_fit_s, "stats": dataclasses.asdict(pinned_stats),
                   "factors_equal": True},
    }
    emit({"phase": "stream_fit", **result})
    return result


def streaming_variant(src: str, app_name: str, path: str, **algorithm_params) -> str:
    """``store_variant`` with the datasource's ``"reader": "streaming"``."""
    store_variant(src, app_name, path, **algorithm_params)
    with open(path) as f:
        variant = json.load(f)
    variant["datasource"]["params"]["reader"] = "streaming"
    with open(path, "w") as f:
        json.dump(variant, f)
    return path


def snapshot_blocks(basedir: str) -> int:
    """Blocks of the block stores under ``basedir``'s training snapshots."""
    import glob

    total = 0
    for path in glob.glob(os.path.join(basedir, "snapshots", "*", "gen-*", "blocks",
                                       "blocks-*", "manifest.json")):
        with open(path) as f:
            manifest = json.load(f)
        total += len(manifest["u"]["specs"]) + len(manifest["i"]["specs"])
    return total


def phase_stream_pio(repo: str, stream_root: str, store: dict, templates: dict,
                     templates_workdir: str, seed: int) -> dict:
    """(b) Through ``pio``: on a copy of store_path's store (its 250,000
    ratings, the live-filter check's "buy" taken back out), ``pio train
    --snapshot-mode refresh --als-feed streamed`` of the recommendation
    engine.json with ``"reader": "streaming"``: the snapshot's block store
    fitted through B1, factors within 1e-4 of store_path's materialized
    instance; ``pio deploy`` of it with mips (B2) and the live seen filter,
    each list the materialized model's up to near-ties. Then on
    store_templates' store the e-commerce (``--als-feed streamed``: B1 per
    block), similar-product and universal engine.jsons with ``"reader":
    "streaming"``: each model equal to its materialized twin of
    store_templates (the factors within 1e-4, the indicators bit for
    bit), each deploy's answers equal dicts to the twin's."""
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.models.recommendation import ALSAlgorithm
    from predictionio_tpu_torch.ops import als_gram, mips
    from predictionio_tpu_torch.tools.cli import build_query_server
    from predictionio_tpu_torch.workflow.core_workflow import load_instance_models
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    result = {}
    engine_json = os.path.join(repo, "examples", "recommendation", "engine.json")
    with fresh_store(stream_root, "ml_store") as basedir:
        app_id = storage.get_meta_data_apps().get_by_name("MLApp").id
        le = storage.get_l_events()
        buys = list(le.find(app_id=app_id, event_names=["buy"]))
        if len(buys) != 1 or not le.delete(buys[0].event_id, app_id):
            raise AssertionError(f"store_path's store holds {len(buys)} buy events")
        variant_path = streaming_variant(engine_json, "MLApp",
                                         os.path.join(stream_root, "ml1m_streaming.json"),
                                         retrieval={"mode": "mips"}, seenFilter="live")
        als_gram.gram_rhs.launches = 0       # counts start at 0 here
        t0 = time.perf_counter()
        out = cli_out(["train", "--variant", variant_path, "--device", "cuda",
                       "--snapshot-mode", "refresh", "--als-feed", "streamed"])
        train_s = time.perf_counter() - t0
        b1 = als_gram.gram_rhs.launches      # read here
        instance = said(out, "Engine instance ID")
        variant = load_engine_variant(variant_path)
        _, [streamed] = load_instance_models(variant, instance)
        _, [materialized] = load_instance_models(variant, store["instance_id"])
        blocks = snapshot_blocks(basedir)
        iterations = variant.engine_params.algorithm_params_list[0][1].get_or(
            "numIterations", 10)
        if b1 != blocks * iterations or blocks < 2:
            raise AssertionError(f"{b1} B1 launches for {blocks} blocks x {iterations}")
        if streamed.user_index != materialized.user_index or (
                streamed.item_ids != materialized.item_ids):
            raise AssertionError("the streamed and materialized trains encode differently")
        err = max(float(np.abs(streamed.als.user_factors
                               - materialized.als.user_factors).max()),
                  float(np.abs(streamed.als.item_factors
                               - materialized.als.item_factors).max()))
        if not err <= FIT_ATOL or streamed.seen_mode != "live" or streamed.seen:
            raise AssertionError(f"streamed model: factors {err} apart, seen filter "
                                 f"{streamed.seen_mode}")
        picked = np.random.default_rng(seed).choice(STORE_USERS, size=STORE_QUERIES,
                                                    replace=False)
        queries = [{"user": f"u{u}", "num": 10} for u in picked] + [
            {"user": "cold-user", "num": 10}]
        query_ms = []
        mips.mips_block_topk.launches = 0
        served, _, deploy_s = serve_model(variant_path, None, queries, query_ms)
        b2 = mips.mips_block_topk.launches
        algorithm = ALSAlgorithm(variant.engine_params.algorithm_params_list[0][1],
                                 device="cuda")
        algorithm.warm_up(materialized)
        diffs, swaps = [], 0
        for q, body in zip(queries, served):
            d, s = compare_lists(body["itemScores"], algorithm.predict(
                materialized, q)["itemScores"])
            diffs.append(d)
            swaps += s
        if b2 < 1 or served[-1] != {"itemScores": []}:
            raise AssertionError(f"the streamed deploy: {b2} B2 launches, cold {served[-1]}")
        result["recommendation"] = {
            "events": STORE_EVENTS, "train_s": train_s, "b1_launches": b1,
            "blocks": blocks, "factors_max_abs_err_vs_materialized": err,
            "deploy_s": deploy_s, "query_p50_ms": statistics.median(query_ms[:-1]),
            "b2_launches": b2, "list_max_abs_diff": max(diffs), "near_tie_swaps": swaps,
        }

    user = "u1"
    with fresh_store(templates_workdir, "templates_store") as basedir:
        for template, queries in (
                ("ecommerce", [{"user": user, "num": 5}, {"user": "u7", "num": 8}]),
                ("similarproduct", [{"items": ["i1"], "num": 5}, {"user": user, "num": 5}]),
                ("universal", [{"user": user, "num": 5}, {"items": ["i3"], "num": 5}])):
            variant_path = streaming_variant(
                os.path.join(repo, "examples", template, "engine.json"), "SmallShop",
                os.path.join(templates_workdir, f"stream_{template}.json"))
            args = ["train", "--variant", variant_path, "--device", "cuda",
                    "--snapshot-mode", "refresh"]
            if template == "ecommerce":
                args += ["--als-feed", "streamed"]
            before = snapshot_blocks(basedir)
            als_gram.gram_rhs.launches = 0   # counts start at 0 here
            t0 = time.perf_counter()
            instance = said(cli_out(args), "Engine instance ID")
            train_s = time.perf_counter() - t0
            b1 = als_gram.gram_rhs.launches  # read here
            variant = load_engine_variant(variant_path)
            _, [model] = load_instance_models(variant, instance)
            _, [twin] = load_instance_models(variant, templates["store_instances"][template])
            params = variant.engine_params.algorithm_params_list[0][1]
            algorithm = template_algorithm(template)[1](params, device="cuda")
            entry = {"train_s": train_s, "b1_launches": b1}
            if template == "ecommerce":
                blocks = snapshot_blocks(basedir) - before
                if b1 != blocks * algorithm._config().iterations or blocks < 2:
                    raise AssertionError(f"e-commerce: {b1} B1 launches, {blocks} blocks")
                if model.user_index != twin.user_index or model.item_ids != twin.item_ids:
                    raise AssertionError("e-commerce: the vocabularies differ")
                err = max(float(np.abs(model.als.user_factors - twin.als.user_factors).max()),
                          float(np.abs(model.als.item_factors - twin.als.item_factors).max()))
                if not err <= FIT_ATOL or model.seen_mode != "live":
                    raise AssertionError(f"e-commerce: factors {err} apart")
                entry.update(blocks=blocks, factors_max_abs_err=err, factors_equal=bool(
                    np.array_equal(model.als.user_factors, twin.als.user_factors)
                    and np.array_equal(model.als.item_factors, twin.als.item_factors)))
            elif template == "similarproduct":
                if model.item_ids != twin.item_ids or not (
                        np.array_equal(model.top_indices, twin.top_indices)
                        and np.array_equal(model.top_values, twin.top_values)):
                    raise AssertionError("similar-product: the indicators differ")
                entry["indicators_equal"] = True
            else:
                by_id = lambda m, name: {
                    m.item_ids[j]: sorted((m.item_ids[p], v) for p, v in pairs)
                    for j, pairs in m.indicators[name].items()}
                if set(model.indicators) != set(twin.indicators) or any(
                        by_id(model, n) != by_id(twin, n) for n in twin.indicators):
                    raise AssertionError("universal: the indicators differ")
                entry["indicators_equal"] = True
            server, service = build_query_server(variant_path, port=0, device="cuda")
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                              timeout=120)
            try:
                for q in queries:
                    body, _ = post(conn, q)
                    if body != algorithm.predict(twin, q):
                        raise AssertionError(f"{template} {q}: the streamed deploy answered "
                                             f"{body}, its materialized twin "
                                             f"{algorithm.predict(twin, q)}")
            finally:
                conn.close()
                server.shutdown()
                server.server_close()
                service.close()
                thread.join(timeout=30)
            entry["queries"] = len(queries)
            result[template] = entry
    emit({"phase": "stream_pio", **result})
    return result


def phase_stream_path(ratings, resident: dict, store: dict, templates: dict, repo: str,
                      workdir: str, stream_root: str, seed: int) -> dict:
    """The stream path: (a) stream_fit, (b) stream_pio, drawing from their
    own generators of ``seed`` (the later phases' draws stay as they
    were). B1 and B2 counts are set to 0 before each drive and read
    after it; B3, B4 and the fused backward stay 0."""
    from predictionio_tpu_torch.models.ncf import kernel as ncf_kernel

    ncf_kernel.ncf_score_all_items.launches = 0
    zero_flash_counts()
    t0 = time.perf_counter()
    fit = phase_stream_fit(ratings, resident, repo, workdir, seed)
    seconds = {"stream_fit": time.perf_counter() - t0}
    t0 = time.perf_counter()
    pio = phase_stream_pio(repo, stream_root, store, templates, workdir, seed + 1)
    seconds["stream_pio"] = time.perf_counter() - t0
    others = {"ncf_score_all_items": ncf_kernel.ncf_score_all_items.launches, **flash_counts()}
    if any(others.values()):
        raise AssertionError(f"the stream path launched other kernels: {others}")
    result = {
        "b1_launches": {"fit": fit["b1_launches"],
                        "pio_recommendation": pio["recommendation"]["b1_launches"],
                        "pio_ecommerce": pio["ecommerce"]["b1_launches"]},
        "b2_launches": {"fit_recall": fit["b2_launches"],
                        "pio_deploy": pio["recommendation"]["b2_launches"]},
        "other_launches": others, "seconds": seconds,
    }
    emit({"phase": "stream_path", **result})
    return result


# --------------------------------------------------------------------------
# dist_train: the multi-process ALS training path on torch.distributed
# (``pio train`` under the launch contract; one card, so two ranks share it)
# --------------------------------------------------------------------------

#: (name, pio.mesh_shape, feed) of each launch: (a) one rank over NCCL,
#: (b) two ranks sharing the card, data-sharded rows and replicated
#: factors, (c) two ranks, ALX model-sharded factors through B1, and (c)
#: again as ``pio train --als-feed streamed`` of the streaming reader
DIST_LAUNCHES = (("a_nccl_1x1", [1, 1], "resident"), ("b_data_2x1", [2, 1], "resident"),
                 ("c_model_1x2", [1, 2], "resident"), ("c_model_1x2_streamed", [1, 2], "streamed"))
#: queries each launch's deploy answers through B2
DIST_QUERIES = 16
#: the resident launches' depth cut: the first 1,250,000 of phase 6's 20M
#: ratings (cut from all 20M to 5,000,000 beside the dist_models part,
#: to 2,500,000 beside the pio_check phase, then to 1,250,000 beside the
#: dase_engine phase, to keep the script in its limit on the card's
#: slower hosts)
DIST_ALS_RATINGS = 1_250_000
#: B2 launches of a deploy's warm-up: one search of each retrieval index
#: (dot for user scoring, cosine for similar items)
WARM_UP_SEARCHES = 2
#: seconds a launch may take before every rank is killed
DIST_TIMEOUT_S = 300


def dist_worker(spec: dict) -> int:
    """One rank of a ``dist_train`` or ``dist_models`` launch
    (``chip_smoke.py --dist-worker SPEC``; the launch contract's ``PIO_*``
    env names the rank). With ``spec["argv"]``: the port's command line,
    ``pio SPEC["argv"]`` (the streamed launch's ``train``, on the store
    ``PIO_FS_BASEDIR`` names). Else ``pio train``'s core (``run_train``)
    of ``spec["variant"]`` on cuda, the data memory-mapped from
    ``spec["arrays"]`` standing where the events reader's would: for
    ``spec["template"]`` "recommendation" (the default) and "ncf" the
    ratings, for "sequence" the packed sequences. Writes the rank's
    kernel launches (each counted from 0 here), the instance it
    recorded, its backend, collective counts and seconds, and for the
    neural templates its step count and first ``DIST_LOSS_STEPS``
    losses, to ``spec["out"]``-RANK.json."""
    if spec.get("template") == "classification":
        return classify_worker(spec)
    from predictionio_tpu_torch.models.ncf import kernel as ncf_kernel
    from predictionio_tpu_torch.ops import als_gram, ragged
    from predictionio_tpu_torch.parallel import mesh as mesh_lib
    from predictionio_tpu_torch.parallel.distributed import distributed_info

    rank = int(os.environ["PIO_PROCESS_ID"])
    timings, log = {}, None
    als_gram.gram_rhs.launches = 0           # counts start at 0 here
    ncf_kernel.ncf_score_all_items.launches = 0
    zero_flash_counts()
    t0 = time.perf_counter()
    if spec.get("argv"):
        out = cli_out(spec["argv"])
        b1 = als_gram.gram_rhs.launches      # read here
        wall_s = time.perf_counter() - t0
        instance_id = said(out, "Engine instance ID") if rank == 0 else None
        if rank != 0 and "Training completed on rank" not in out:
            raise AssertionError(f"rank {rank} said {out}")
        status = "COMPLETED" if rank == 0 else None
    else:
        from predictionio_tpu_torch.models import recommendation as rec
        from predictionio_tpu_torch.workflow.core_workflow import run_train
        from predictionio_tpu_torch.workflow.json_extractor import (
            load_engine_variant,
            template_engine,
        )

        template = spec.get("template", "recommendation")
        if template == "sequence":
            matrix = np.load(os.path.join(spec["arrays"], "sequences.npy"))

            def read_training(self, ctx):
                return sequence_rows_data(matrix, spec["app"])
        else:
            users, items, ratings, times = (
                np.load(os.path.join(spec["arrays"], f"{n}.npy"), mmap_mode="r")
                for n in ("users", "items", "ratings", "times"))

            def read_training(self, ctx):
                return rec.RatingsData(
                    users=np.asarray(users), items=np.asarray(items),
                    ratings=np.asarray(ratings), times=np.asarray(times),
                    user_ids=[f"u{u}" for u in range(TRAIN_USERS)],
                    item_ids=[f"i{i}" for i in range(TRAIN_ITEMS)], app_name=spec["app"],
                    event_names=["rate", "buy"])

        template_engine(template).data_source_class.read_training = read_training
        # the neural trainers report every step's loss (ALS journals iterations)
        log = None if template == "recommendation" else EpochLog()
        instance = run_train(load_engine_variant(spec["variant"]), device="cuda",
                             telemetry=log, timings=timings)
        b1 = als_gram.gram_rhs.launches      # read here
        wall_s = time.perf_counter() - t0
        instance_id, status = instance.id, instance.status
    report = {"rank": rank, "b1_launches": b1,
              "b3_launches": ncf_kernel.ncf_score_all_items.launches,
              "flash_launches": flash_counts(), "instance_id": instance_id,
              "status": status, "distributed": distributed_info(),
              "collectives": mesh_lib.collective_counts(), "timings": timings,
              "run_train_s": wall_s, "pack_routes": ragged.pack_routes()}
    if log is not None:
        report.update(steps=len(log.losses), losses=log.losses[:DIST_LOSS_STEPS],
                      epoch_s=log.seconds)
    with open(f"{spec['out']}-{rank}.json", "w") as f:
        json.dump(report, f)
    return 0


def run_launch(spec: dict, n: int) -> tuple[list[dict], float]:
    """``n`` ranks of ``dist_worker`` under the launch contract (a fresh
    coordinator port on this host), all killed past ``DIST_TIMEOUT_S``;
    each must exit 0 and pack on the native route only. Returns their
    reports and the launch's seconds."""
    from predictionio_tpu_torch import native

    env = dict(os.environ, PIO_COORDINATOR=f"127.0.0.1:{free_port()}",
               PIO_NUM_PROCESSES=str(n))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-worker",
                               json.dumps(spec)], env=dict(env, PIO_PROCESS_ID=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    try:
        outs = [p.communicate(timeout=DIST_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    seconds = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {spec['name']} exited {p.returncode}:\n"
                                 f"{out[-6000:]}")
    reports = []
    for r in range(n):
        with open(f"{spec['out']}-{r}.json") as f:
            reports.append(json.load(f))
        if reports[-1]["pack_routes"]["numpy"] and native.enabled():
            raise AssertionError(f"rank {r} of {spec['name']} packed on the numpy route: "
                                 f"{reports[-1]['pack_routes']}")
    return reports, seconds


def phase_dist_train(ratings, store: dict, repo: str, workdir: str, stream_root: str,
                     seed: int) -> dict:
    """dist_train: each of ``DIST_LAUNCHES`` under the launch contract's
    env. The three resident launches: the recommendation template's
    shipped engine.json (with the 256-event history cap of phase 6,
    ``retrieval`` mips and ``seenFilter: "live"``, so the blob holds no
    seen map) on the first ``DIST_ALS_RATINGS`` of phase 6's ratings, run
    as ``pio train``'s core, each in a store of its own; the reference is
    the one-process resident fit with the same packing (``num_shards`` x
    ``model_shards`` = 1 and 2: a fit each here, through B1).
    The streamed launch: ``pio train --snapshot-mode refresh --als-feed
    streamed`` of stream_pio's variant (``"reader": "streaming"``) on
    stream_pio's copy of store_path's store, so the ranks agree on one
    scan bound, rank 0 readies the snapshot and the mesh's block store
    before rank 1 loads them, and the model-sharded streamed fit runs;
    the reference is store_path's materialized instance, as for
    stream_pio's one-process streamed train. Per launch: each rank's B1
    launches (counted from 0 in the rank, above 0 on every rank), its
    backend and collective counts (none in the one-rank launch: a
    collective there is the identity); rank 0 alone recorded the one
    new COMPLETED instance; the blob's factors within ``FIT_ATOL`` of
    the reference; the blob deployed with mips answers ``DIST_QUERIES``
    queries, B2 launched exactly once per query and once per warm-up
    search (counted from 0 before the deploy), each list the reference
    model's up to near ties (``compare_lists``). Two ranks on one card
    measure correctness and overhead, not scaling."""
    import torch

    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.models.recommendation import ALSAlgorithm
    from predictionio_tpu_torch.ops import als_gram, mips
    from predictionio_tpu_torch.parallel.als import ALSConfig, ALSModel, als_fit, build_als_data
    from predictionio_tpu_torch.parallel.distributed import BACKEND_RULE
    from predictionio_tpu_torch.workflow.core_workflow import load_instance_models
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    users, items, values, times = (a[:DIST_ALS_RATINGS] for a in ratings)
    arrays = os.path.join(workdir, "dist_arrays")
    os.makedirs(arrays, exist_ok=True)
    for name, a in (("users", users), ("items", items), ("ratings", values),
                    ("times", times)):
        np.save(os.path.join(arrays, f"{name}.npy"), a)
    algo_params, prep_params = template_params(repo)
    config = dataclasses.replace(ALSAlgorithm(algo_params, device="cuda")._config(),
                                 max_len=TRAIN_CAP, factor_sharding="replicated")
    # the one-process fits of the one- and two-rank packings (the latter
    # in 8 x 2-row multiples)
    t0 = time.perf_counter()
    als_gram.gram_rhs.launches = 0
    references = {}
    for shards in (1, 2):
        fit = als_fit(build_als_data(users, items, values, TRAIN_USERS, TRAIN_ITEMS, config,
                                     times=times, num_shards=shards), config, "cuda")
        references[shards] = (fit.user_factors, fit.item_factors)
    reference_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    picked = rng.choice(TRAIN_USERS, DIST_QUERIES, replace=False)
    train_queries = [{"user": f"u{u}", "num": 10} for u in picked.tolist()]
    picked = rng.choice(STORE_USERS, DIST_QUERIES, replace=False)
    store_queries = [{"user": f"u{u}", "num": 10} for u in picked.tolist()]
    engine_json = os.path.join(repo, "examples", "recommendation", "engine.json")
    result = {"backend_rule": BACKEND_RULE, "reference_fit_s": reference_s,
              "reference_b1_launches": als_gram.gram_rhs.launches, "launches": {}}
    for name, shape, feed in DIST_LAUNCHES:
        n = shape[0] * shape[1]
        streamed = feed == "streamed"
        spec = {"name": name, "out": os.path.join(workdir, f"dist_{name}")}
        with (fresh_store(stream_root, "ml_store") if streamed
              else fresh_store(workdir, f"dist_{name}")):
            variant_path = os.path.join(workdir, f"dist_{name}.json")
            if streamed:
                streaming_variant(engine_json, "MLApp", variant_path,
                                  retrieval={"mode": "mips"}, seenFilter="live")
                spec["argv"] = ["train", "--variant", variant_path, "--device", "cuda",
                                "--snapshot-mode", "refresh", "--als-feed", "streamed"]
                queries = store_queries
            else:
                cli_out(["app", "new", "DistApp"])  # an empty app: live seen lookups find it
                store_variant(engine_json, "DistApp", variant_path,
                              retrieval={"mode": "mips"}, seenFilter="live")
                spec.update(variant=variant_path, arrays=arrays, app="DistApp")
                queries = train_queries
            with open(variant_path) as f:
                variant = json.load(f)
            if not streamed:
                variant["preparator"]["params"] = dict(prep_params)
            variant["sparkConf"] = {"pio.mesh_shape": shape}
            with open(variant_path, "w") as f:
                json.dump(variant, f)
            before = {i.id for i in storage.get_meta_data_engine_instances().get_all()}
            reports, launch_s = run_launch(spec, n)
            b1 = [r["b1_launches"] for r in reports]
            if min(b1) < 1 or len(set(b1)) != 1:
                raise AssertionError(f"{name}: B1 launches per rank {b1}")
            backends = [r["distributed"]["backend"] for r in reports]
            if backends != ["nccl" if n == 1 else "gloo"] * n:
                raise AssertionError(f"{name}: backends {backends}")
            collectives = [r["collectives"] for r in reports]
            if n == 1 and collectives != [{}]:
                raise AssertionError(f"{name}: one rank issued collectives {collectives}")
            ids = [r["instance_id"] for r in reports]
            storage.reset()
            recorded = [(i.id, i.status)
                        for i in storage.get_meta_data_engine_instances().get_all()
                        if i.id not in before]
            if ids[1:] != [None] * (n - 1) or recorded != [(ids[0], "COMPLETED")]:
                raise AssertionError(f"{name}: new instances {recorded}, ranks said {ids}")
            loaded = load_engine_variant(variant_path)
            _, [model] = load_instance_models(loaded, ids[0])
            if streamed:
                _, [reference] = load_instance_models(loaded, store["instance_id"])
                if (model.user_index != reference.user_index
                        or model.item_ids != reference.item_ids):
                    raise AssertionError(f"{name}: the vocabularies differ")
                want_u, want_i = reference.als.user_factors, reference.als.item_factors
            else:
                want_u, want_i = references[n]
            err = max(float(np.abs(model.als.user_factors - want_u).max()),
                      float(np.abs(model.als.item_factors - want_i).max()))
            if not err <= FIT_ATOL:
                raise AssertionError(f"{name}: factors {err} from the one-process fit")
            query_ms = []
            mips.mips_block_topk.launches = 0    # counts start at 0 here
            served, deployed, deploy_s = serve_model(variant_path, None, queries, query_ms,
                                                     instance_id=ids[0])
            b2 = mips.mips_block_topk.launches   # read here
            algorithm = ALSAlgorithm(loaded.engine_params.algorithm_params_list[0][1],
                                     device="cuda")
            one_process = (reference if streamed
                           else dataclasses.replace(deployed, als=ALSModel(want_u, want_i)))
            algorithm.warm_up(one_process)
            diffs, swaps = [], 0
            for q, body in zip(queries, served):
                d, s = compare_lists(body["itemScores"], algorithm.predict(
                    one_process, q)["itemScores"])
                diffs.append(d)
                swaps += s
            if b2 != WARM_UP_SEARCHES + len(queries) or any(
                    not body["itemScores"] for body in served):
                raise AssertionError(f"{name}: {b2} B2 launches, answers {served}")
            result["launches"][name] = {
                "mesh_shape": shape, "feed": feed, "ranks": n, "launch_s": launch_s,
                "events": STORE_EVENTS if streamed else DIST_ALS_RATINGS,
                "backends": backends, "b1_launches": b1, "collectives": collectives,
                "timings": [r["timings"] for r in reports],
                "run_train_s": [r["run_train_s"] for r in reports],
                "pack_routes": [r["pack_routes"] for r in reports],
                "factors_max_abs_err": err, "b2_launches": b2, "deploy_s": deploy_s,
                "query_p50_ms": statistics.median(query_ms),
                "list_max_abs_diff": max(diffs), "near_tie_swaps": swaps,
            }
            emit({"phase": "dist_train_launch", "name": name, **result["launches"][name]})
        del model, deployed, one_process
        torch.cuda.empty_cache()
    emit({"phase": "dist_train", **{k: v for k, v in result.items() if k != "launches"},
          "launch_s": {k: v["launch_s"] for k, v in result["launches"].items()}})
    return result


def phase_dist_train_path(ratings, store: dict, repo: str, workdir: str,
                          stream_root: str, seed: int) -> dict:
    """dist_train with the parent's counts of the other kernels set to 0
    before and read after (B3, B4 and the fused backward stay 0); B1's
    launches per launch and rank, B2's per launch, for the kernels line."""
    from predictionio_tpu_torch.models.ncf import kernel as ncf_kernel

    ncf_kernel.ncf_score_all_items.launches = 0
    zero_flash_counts()
    t0 = time.perf_counter()
    dist = phase_dist_train(ratings, store, repo, workdir, stream_root, seed)
    others = {"ncf_score_all_items": ncf_kernel.ncf_score_all_items.launches, **flash_counts()}
    if any(others.values()):
        raise AssertionError(f"the dist_train path launched other kernels: {others}")
    result = {
        "b1_launches": {name: run["b1_launches"] for name, run in dist["launches"].items()},
        "b2_launches": {name: run["b2_launches"] for name, run in dist["launches"].items()},
        "other_launches": others, "seconds": time.perf_counter() - t0,
    }
    emit({"phase": "dist_train_path", **result})
    return result


# --------------------------------------------------------------------------
# dist_models: multi-process NCF and SASRec training on torch.distributed
# (``pio train`` under the launch contract; two ranks share the one card)
# --------------------------------------------------------------------------

#: (name, template, pio.mesh_shape, seqParallel) of each launch: NCF (a)
#: data-sharded, (b) model-sharded; SASRec over ("data", "seq"): (c)
#: data-sharded, flash per rank, (d) ring attention, (e) Ulysses
DIST_MODEL_LAUNCHES = (("a_ncf_data_2x1", "ncf", [2, 1], None),
                       ("b_ncf_model_1x2", "ncf", [1, 2], None),
                       ("c_seq_data_2x1", "sequence", [2, 1], "ring"),
                       ("d_seq_ring_1x2", "sequence", [1, 2], "ring"),
                       ("e_seq_ulysses_1x2", "sequence", [1, 2], "ulysses"))
#: the depth cuts: the first ratings of phase 6's 20M (NCF, epochs 5 -> 1;
#: 125,000 before the pio_check phase) and the first packed sequences of
#: seq_data's 138,000 (SASRec, 10 -> 1; 25,600 before the pio_check phase)
DIST_NCF_RATINGS = 62_500
DIST_SEQ_ROWS = 12_800
#: the first step losses held to the one-process reference, and the bars
DIST_LOSS_STEPS = 20
DIST_LOSS_TOL = 1e-4
DIST_PARAM_TOL = 1e-3
#: a seq-sharded launch has no one-process twin of its arithmetic (each
#: rank reduces the position-local layers' gradients over its T/s
#: positions, then one all-reduce sums the ranks'), and Adam carries the
#: rounding of those sums into lr-sized steps of the elements whose
#: gradient is near 0. Its params are held to the one-process run, and the
#: ring's and Ulysses' to each other, leaf by leaf in max abs: every leaf
#: at DIST_PARAM_TOL but the item table, whose sparse rows drift furthest,
#: at DIST_SEQ_ITEM_TOL. That bar lies between the sound launches' largest
#: reading and the control's (the one-process run over another batch
#: order, DIST_SEQ_CONTROL_SEED), and the script checks that it does.
DIST_SEQ_ITEM_LEAF = "item_embed.weight"
DIST_SEQ_ITEM_TOL = 1e-2
DIST_SEQ_CONTROL_SEED = 1
#: known users each deploy answers, and the bar on their scores
DIST_MODEL_QUERIES = 10
DIST_LIST_TOL = 1e-3


def sequence_rows_data(matrix: np.ndarray, app: str):
    """The packed ``[N, maxLen]`` rows (ids + 1, 0 = padding) as the
    sequence DataSource's ``SequencesData`` (users ``s0`` ...): the
    preparator packs them back to the same rows."""
    from predictionio_tpu_torch.models.sequence import SequencesData

    return SequencesData([row[row > 0].astype(np.int64) - 1 for row in matrix],
                         [f"s{r}" for r in range(matrix.shape[0])],
                         [f"i{i}" for i in range(TRAIN_ITEMS)], app_name=app,
                         event_names=["view", "buy", "rate"])


def neural_reference(template: str, params: dict, data) -> dict:
    """The one-process train of ``template`` on the card from the same
    seeded init over the same examples: ``Algorithm.train`` (the
    negatives sampled alike for NCF), every step's loss, the state, the
    seconds, and its kernel launches."""
    from predictionio_tpu_torch.controller.base import TrainContext
    from predictionio_tpu_torch.models.ncf import NCFAlgorithm
    from predictionio_tpu_torch.models.ncf import kernel as ncf_kernel
    from predictionio_tpu_torch.models.sequence import SASRecAlgorithm, SequencePreparator

    log = EpochLog()
    ctx = TrainContext(device="cuda", telemetry=log)
    before = {**flash_counts(), "ncf_score_all_items": ncf_kernel.ncf_score_all_items.launches}
    t0 = time.perf_counter()
    if template == "ncf":
        model = NCFAlgorithm(params, device="cuda").train(ctx, data)
    else:
        prepared = SequencePreparator({"maxLen": params.get("maxLen", 64)}).prepare(ctx, data)
        model = SASRecAlgorithm(params, device="cuda").train(ctx, prepared)
    seconds = time.perf_counter() - t0
    after = {**flash_counts(), "ncf_score_all_items": ncf_kernel.ncf_score_all_items.launches}
    return {"state": model.state, "config": model.config, "losses": log.losses,
            "train_s": seconds, "launches": {k: after[k] - before[k] for k in after}}


def split_reference(template: str, params: dict, data, config, dp: int,
                    order_seed: int | None = None) -> dict:
    """``neural_reference``'s one-process train with each batch cut as a
    ``dp``-way data axis cuts it (to a multiple of ``dp``; skipped below
    it) and its ``dp`` shards' gradients summed before each Adam step:
    the data-sharded launch's arithmetic (each shard's products at the
    shard's shape, then one sum) without its collectives. Adam turns the
    rounding of half-batch products into lr-sized steps wherever it
    flips a ReLU or cancels a sparse row's gradient, so a data-sharded
    launch is held to this run, and its gap to the unsplit one printed.
    ``order_seed`` draws the batch order from another seed (the init
    stays ``config.seed``'s): the seq-sharded gates' control."""
    import torch
    import torch.nn.functional as F

    from predictionio_tpu_torch.models.ncf.model import init_model as ncf_init
    from predictionio_tpu_torch.models.ncf.model import make_implicit_batches
    from predictionio_tpu_torch.models.sequence import SequencePreparator
    from predictionio_tpu_torch.models.sequence.model import init_model as seq_init
    from predictionio_tpu_torch.models.sequence.model import logits

    if template == "ncf":
        u, i, y = data.users, data.items, data.ratings
        if config.implicit:
            u, i, y = make_implicit_batches(u, i, config.num_items, config.negatives,
                                            np.random.default_rng(config.seed), device="cuda")
        net = ncf_init(config)
        rows_of = [torch.as_tensor(np.asarray(a, dt), device="cuda")
                   for a, dt in ((u, np.int64), (i, np.int64), (y, np.float32))]
    else:
        matrix = SequencePreparator({"maxLen": config.max_len}).prepare(None, data).matrix
        inputs = torch.as_tensor(np.asarray(matrix, np.int64), device="cuda")
        targets = torch.zeros_like(inputs)
        targets[:, :-1] = inputs[:, 1:]
        net = seq_init(config)
        rows_of = [inputs, targets]
    net.to("cuda").train()
    optimizer = torch.optim.Adam(net.parameters(), lr=config.learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8)
    n = rows_of[0].shape[0]
    np_rng = np.random.default_rng(config.seed if order_seed is None else order_seed)
    losses = []
    for _ in range(config.epochs):
        order = torch.as_tensor(np_rng.permutation(n), device="cuda")
        for start in range(0, n, config.batch_size):
            take = order[start:start + config.batch_size]
            per = take.numel() // dp
            if not per:
                continue
            optimizer.zero_grad(set_to_none=True)
            if template == "ncf":
                scale = per * dp
            else:
                scale = (rows_of[1][take[:per * dp]] > 0).sum().clamp_min(1)
            total = 0.0
            for r in range(dp):
                shard = take[r * per:(r + 1) * per]
                if template == "ncf":
                    out = net(rows_of[0][shard], rows_of[1][shard])
                    y = rows_of[2][shard]
                    part = (F.binary_cross_entropy_with_logits(out, y, reduction="sum")
                            if config.implicit else ((out - y) ** 2).sum())
                else:
                    out = logits(net, net(rows_of[0][shard]))
                    part = F.cross_entropy(out.reshape(-1, out.shape[-1]),
                                           rows_of[1][shard].reshape(-1), ignore_index=0,
                                           reduction="sum")
                part = part / scale
                part.backward()
                total = total + part.detach()
            optimizer.step()
            losses.append(total)
    return {"state": {k: v.detach().to("cpu", copy=True) for k, v in net.state_dict().items()},
            "losses": torch.stack(losses).tolist()}


def leaf_gaps(got: dict, want: dict) -> dict:
    """Max abs gap of each leaf of two state dicts (arrays or tensors)."""
    return {k: float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max()) for k in want}


def check_seq_leaves(what: str, gaps: dict) -> None:
    """A seq-sharded launch's leaf gaps (``leaf_gaps``) against the bars:
    ``DIST_SEQ_ITEM_TOL`` for the item table, ``DIST_PARAM_TOL`` for
    every other leaf."""
    over = {k: g for k, g in gaps.items()
            if not g <= (DIST_SEQ_ITEM_TOL if k == DIST_SEQ_ITEM_LEAF else DIST_PARAM_TOL)}
    if over:
        raise AssertionError(f"{what}: leaves past their bars {over} (item table "
                             f"{DIST_SEQ_ITEM_TOL}, the others {DIST_PARAM_TOL})")


def phase_dist_models(ratings, seq: dict, repo: str, workdir: str, seed: int) -> dict:
    """dist_models: each of ``DIST_MODEL_LAUNCHES`` under the launch
    contract's env, ``pio train``'s core of the template's engine.json
    (epochs cut to 1, ``pio.mesh_shape`` per launch) in a store of its
    own; the reference is ``neural_reference``. Per launch: every rank's
    steps and first ``DIST_LOSS_STEPS`` losses against the reference's
    (within ``DIST_LOSS_TOL``), the kernel launches of every rank (B3 0;
    B4 and the fused backward 2 a step where the attention runs flash,
    0 in the ring's training), its backend and collectives (the ring's
    and Ulysses' counts exact); rank 0 alone recorded the one new
    COMPLETED instance; the blob's params within ``DIST_PARAM_TOL`` of the
    reference's (a seq-sharded launch's leaf by leaf, ``check_seq_leaves``,
    beside the control's reading, and the ring's and Ulysses' likewise
    to each other); the blob deployed unbatched answers
    ``DIST_MODEL_QUERIES`` known users (B3 once a query and once in the
    warm-up; B4 2 a forward, the warm-up's included), each list the
    reference model's (scored through the plain versions) up to near
    ties. Two ranks on one card measure correctness and overhead, not
    scaling."""
    import torch

    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.models.ncf import NCFAlgorithm
    from predictionio_tpu_torch.models.ncf import kernel as ncf_kernel
    from predictionio_tpu_torch.models.recommendation import RatingsData
    from predictionio_tpu_torch.models.sequence import SASRecAlgorithm
    from predictionio_tpu_torch.parallel.distributed import BACKEND_RULE
    from predictionio_tpu_torch.workflow.core_workflow import load_instance_models
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    users, items, values, times = (a[:DIST_NCF_RATINGS] for a in ratings)
    matrix = np.ascontiguousarray(seq["prepared"].matrix[:DIST_SEQ_ROWS])
    arrays = os.path.join(workdir, "dist_model_arrays")
    os.makedirs(arrays, exist_ok=True)
    for name, a in (("users", users), ("items", items), ("ratings", values),
                    ("times", times), ("sequences", matrix)):
        np.save(os.path.join(arrays, f"{name}.npy"), a)
    engines = {"ncf": ncf_engine(repo)[0], "sequence": sequence_engine(repo)[0]}
    params, data = {}, {}
    for template, path in engines.items():
        with open(path) as f:
            params[template] = dict(json.load(f)["algorithms"][0]["params"], epochs=1)
    data["ncf"] = RatingsData(users=users, items=items, ratings=values, times=times,
                              user_ids=[f"u{u}" for u in range(TRAIN_USERS)],
                              item_ids=[f"i{i}" for i in range(TRAIN_ITEMS)],
                              app_name="DistApp", event_names=["rate", "buy"])
    data["sequence"] = sequence_rows_data(matrix, "DistApp")
    references = {t: neural_reference(t, params[t], data[t]) for t in engines}
    # the control of the seq-sharded gates: the one-process SASRec run
    # from the same init over another batch order; its item-table gap
    # must lie past DIST_SEQ_ITEM_TOL, or that bar could not see such a run
    t0 = time.perf_counter()
    before = flash_counts()
    control = split_reference("sequence", params["sequence"], data["sequence"],
                              references["sequence"]["config"], 1,
                              order_seed=DIST_SEQ_CONTROL_SEED)
    control_gaps = leaf_gaps(control["state"], references["sequence"]["state"])
    control_result = {"order_seed": DIST_SEQ_CONTROL_SEED, "leaf_max_abs_err": control_gaps,
                      "train_s": time.perf_counter() - t0,
                      "launches": {k: n - before[k] for k, n in flash_counts().items()}}
    emit({"phase": "dist_models_control", **control_result})
    if not control_gaps[DIST_SEQ_ITEM_LEAF] > DIST_SEQ_ITEM_TOL:
        raise AssertionError(f"the control's item table is {control_gaps[DIST_SEQ_ITEM_LEAF]} "
                             f"from the reference's, within the bar {DIST_SEQ_ITEM_TOL}")
    rng = np.random.default_rng(seed)
    queries = {
        "ncf": [{"user": f"u{u}", "num": 10} for u in
                rng.choice(np.unique(users), DIST_MODEL_QUERIES, replace=False).tolist()],
        "sequence": [{"user": f"s{r}", "num": 10} for r in
                     rng.choice(DIST_SEQ_ROWS, DIST_MODEL_QUERIES, replace=False).tolist()],
    }
    result = {"backend_rule": BACKEND_RULE, "launches": {}, "control": control_result,
              "reference": {t: {"steps": len(r["losses"]), "train_s": r["train_s"],
                                "launches": r["launches"]} for t, r in references.items()}}
    splits, seq_split_states = {}, {}
    for name, template, shape, seq_parallel in DIST_MODEL_LAUNCHES:
        n = shape[0] * shape[1]
        unsplit = references[template]
        reference = unsplit
        if shape[0] > 1:
            key = (template, shape[0])
            if key not in splits:
                t0 = time.perf_counter()
                before = {**flash_counts(),
                          "ncf_score_all_items": ncf_kernel.ncf_score_all_items.launches}
                splits[key] = split_reference(template, params[template], data[template],
                                              unsplit["config"], shape[0])
                splits[key]["train_s"] = time.perf_counter() - t0
                splits[key]["launches"] = {
                    k: v - before[k] for k, v in {
                        **flash_counts(),
                        "ncf_score_all_items": ncf_kernel.ncf_score_all_items.launches}.items()}
            reference = splits[key]
        spec = {"name": name, "template": template, "arrays": arrays, "app": "DistApp",
                "out": os.path.join(workdir, f"dist_{name}")}
        with fresh_store(workdir, f"dist_{name}"):
            cli_out(["app", "new", "DistApp"])
            variant_path = os.path.join(workdir, f"dist_{name}.json")
            with open(engines[template]) as f:
                variant = json.load(f)
            variant["datasource"]["params"]["appName"] = "DistApp"
            algo = variant["algorithms"][0]["params"]
            algo["epochs"] = 1
            if seq_parallel is not None:
                algo["seqParallel"] = seq_parallel
            variant["sparkConf"] = dict(variant["sparkConf"], **{"pio.mesh_shape": shape})
            with open(variant_path, "w") as f:
                json.dump(variant, f)
            spec["variant"] = variant_path
            before = {i.id for i in storage.get_meta_data_engine_instances().get_all()}
            reports, launch_s = run_launch(spec, n)
            backends = [r["distributed"]["backend"] for r in reports]
            if backends != ["gloo"] * n:
                raise AssertionError(f"{name}: backends {backends}")
            steps = [r["steps"] for r in reports]
            if steps != [len(reference["losses"])] * n:
                raise AssertionError(f"{name}: steps per rank {steps}, reference "
                                     f"{len(reference['losses'])}")
            want_losses = np.asarray(reference["losses"][:DIST_LOSS_STEPS])
            loss_err = max(float(np.abs(np.asarray(r["losses"]) - want_losses).max())
                           for r in reports)
            if not loss_err <= DIST_LOSS_TOL:
                raise AssertionError(f"{name}: first losses {loss_err} from the reference's")
            flash = [r["flash_launches"] for r in reports]
            b3 = [r["b3_launches"] for r in reports]
            blocks = int(algo.get("numBlocks", 2))
            per_rank = (0 if template == "ncf" or seq_parallel == "ring" and shape[1] > 1
                        else blocks * steps[0])
            if any(f != {k: per_rank for k in FLASH_KERNELS} for f in flash) or any(b3):
                raise AssertionError(f"{name}: flash launches {flash}, B3 {b3}, "
                                     f"expected {per_rank} flash a rank")
            collectives = [r["collectives"] for r in reports]
            hops = blocks * steps[0]  # attention calls a rank
            exact = {"d_seq_ring_1x2": {"gloo:ppermute": 5 * hops,
                                        "gloo:staged_ppermute": 5 * hops},
                     "e_seq_ulysses_1x2": {"gloo:all_to_all": 8 * hops,
                                           "gloo:all_gather": hops}}.get(name, {})
            for c in collectives:
                if any(c.get(k, 0) != v for k, v in exact.items()):
                    raise AssertionError(f"{name}: collectives {c}, expected {exact}")
            ids = [r["instance_id"] for r in reports]
            storage.reset()
            recorded = [(i.id, i.status)
                        for i in storage.get_meta_data_engine_instances().get_all()
                        if i.id not in before]
            if ids[1:] != [None] * (n - 1) or recorded != [(ids[0], "COMPLETED")]:
                raise AssertionError(f"{name}: new instances {recorded}, ranks said {ids}")
            loaded = load_engine_variant(variant_path)
            _, [model] = load_instance_models(loaded, ids[0])
            gaps = {k: np.abs(np.asarray(model.state[k]) - reference["state"][k].numpy())
                    for k in reference["state"]}
            worst = max(gaps, key=lambda k: float(gaps[k].max()))
            param_err = float(gaps[worst].max())
            param_detail = {
                "worst": worst, "worst_index": np.unravel_index(
                    int(gaps[worst].argmax()), gaps[worst].shape),
                "over_1e-4": {k: int((g > 1e-4).sum()) for k, g in gaps.items()
                              if (g > 1e-4).any()},
                "rms": float(np.sqrt(sum(float((g ** 2).sum()) for g in gaps.values())
                                     / sum(g.size for g in gaps.values()))),
            }
            param_detail["worst_index"] = [int(x) for x in param_detail["worst_index"]]
            param_detail["leaf_max_abs_err"] = {k: float(g.max()) for k, g in gaps.items()}
            if template == "sequence" and shape[1] > 1:
                seq_split_states[name] = model.state
                check_seq_leaves(name, param_detail["leaf_max_abs_err"])
            elif not param_err <= DIST_PARAM_TOL:
                raise AssertionError(f"{name}: params {param_err} from the reference's")
            unsplit_err = max(float(np.abs(np.asarray(model.state[k]) -
                                           unsplit["state"][k].numpy()).max())
                              for k in unsplit["state"])
            unsplit_loss_err = max(float(np.abs(
                np.asarray(r["losses"]) - np.asarray(unsplit["losses"][:DIST_LOSS_STEPS])).max())
                for r in reports)
            query_ms = []
            before = {"ncf_score_all_items": ncf_kernel.ncf_score_all_items.launches,
                      **flash_counts()}
            served, deployed, deploy_s = serve_model(variant_path, None, queries[template],
                                                     query_ms, batching=unbatched(),
                                                     instance_id=ids[0])
            deploy_launches = {k: v - before[k] for k, v in {
                "ncf_score_all_items": ncf_kernel.ncf_score_all_items.launches,
                **flash_counts()}.items()}
            want = ({"ncf_score_all_items": DIST_MODEL_QUERIES + 1, "flash_forward": 0,
                     "flash_backward": 0} if template == "ncf" else
                    {"ncf_score_all_items": 0, "flash_forward": blocks * (DIST_MODEL_QUERIES + 1),
                     "flash_backward": 0})
            if deploy_launches != want or any(not b["itemScores"] for b in served):
                raise AssertionError(f"{name}: deploy launches {deploy_launches}, expected "
                                     f"{want}; answers {served}")
            # the reference's lists through the plain versions: no launch
            algo_params = dict(loaded.engine_params.algorithm_params_list[0][1])
            if template == "ncf":
                algorithm = NCFAlgorithm(dict(algo_params, usePallas=False), device="cuda")
            else:
                algorithm = SASRecAlgorithm(algo_params, device="cuda")
            one_process = dataclasses.replace(deployed, state=reference["state"])
            diffs, swaps = [], 0
            with plain_flash():
                want_lists = [algorithm.predict(one_process, q)["itemScores"]
                              for q in queries[template]]
            for body, want_list in zip(served, want_lists):
                d, sw = compare_lists(body["itemScores"], want_list, tol=DIST_LIST_TOL)
                diffs.append(d)
                swaps += sw
            result["launches"][name] = {
                "template": template, "mesh_shape": shape, "seq_parallel": seq_parallel,
                "ranks": n, "launch_s": launch_s, "backends": backends, "steps": steps[0],
                "timings": [r["timings"] for r in reports],
                "run_train_s": [r["run_train_s"] for r in reports],
                "epoch_s": [r["epoch_s"] for r in reports],
                "collectives": collectives, "flash_launches": flash, "b3_launches": b3,
                "reference": "split" if reference is not unsplit else "one_process",
                "first_losses_max_abs_err": loss_err, "params_max_abs_err": param_err,
                "params_gap": param_detail,
                "one_process_first_losses_max_abs_err": unsplit_loss_err,
                "one_process_params_max_abs_err": unsplit_err,
                "deploy_launches": deploy_launches, "deploy_s": deploy_s,
                "query_p50_ms": statistics.median(query_ms),
                "list_max_abs_diff": max(diffs), "near_tie_swaps": swaps,
            }
            emit({"phase": "dist_models_launch", "name": name, **result["launches"][name]})
        del model, deployed, one_process
        torch.cuda.empty_cache()
    if len(seq_split_states) == 2:
        ring, ulysses = seq_split_states.values()
        gaps = [np.abs(np.asarray(ring[k]) - np.asarray(ulysses[k])) for k in ring]
        rms = float(np.sqrt(sum(float((g ** 2).sum()) for g in gaps) / sum(g.size for g in gaps)))
        leaves = leaf_gaps(ulysses, ring)
        result["ring_vs_ulysses_params"] = {"max_abs_err": max(leaves.values()), "rms": rms,
                                            "leaf_max_abs_err": leaves}
        check_seq_leaves("ring against Ulysses", leaves)
    result["split_reference"] = {f"{t}_split_{dp}": {"steps": len(r["losses"]),
                                                     "train_s": r["train_s"],
                                                     "launches": r["launches"]}
                                 for (t, dp), r in splits.items()}
    emit({"phase": "dist_models", "backend_rule": BACKEND_RULE,
          "reference": result["reference"], "split_reference": result["split_reference"],
          "ring_vs_ulysses_params": result.get("ring_vs_ulysses_params"),
          "control": control_result,
          "launch_s": {k: v["launch_s"] for k, v in result["launches"].items()}})
    return result


def phase_dist_models_path(ratings, seq: dict, repo: str, workdir: str, seed: int) -> dict:
    """dist_models with this process's counts of every kernel set to 0
    before and read after: B1 and B2 stay 0, and B3, B4 and the fused
    backward launch only in the references' training and the deploys
    (their sum); each kernel's launches per launch and rank beside them,
    for the kernels line."""
    from predictionio_tpu_torch.models.ncf import kernel as ncf_kernel
    from predictionio_tpu_torch.ops import als_gram, mips

    counters = {"gram_rhs": als_gram.gram_rhs, "mips_block_topk": mips.mips_block_topk,
                "ncf_score_all_items": ncf_kernel.ncf_score_all_items}
    for fn in counters.values():
        fn.launches = 0
    zero_flash_counts()
    t0 = time.perf_counter()
    dist = phase_dist_models(ratings, seq, repo, workdir, seed)
    here = {**{k: fn.launches for k, fn in counters.items()}, **flash_counts()}
    launches = {}
    for kernel in here:
        ranks = {}
        for name, run in dist["launches"].items():
            if kernel == "ncf_score_all_items":
                ranks[name] = run["b3_launches"]
            elif kernel in FLASH_KERNELS:
                ranks[name] = [f[kernel] for f in run["flash_launches"]]
            else:
                ranks[name] = [0] * run["ranks"]
        launches[kernel] = {
            "ranks_training": ranks,
            "deploys": {name: run["deploy_launches"].get(kernel, 0)
                        for name, run in dist["launches"].items()},
            "references": {t: r["launches"].get(kernel, 0)
                           for t, r in {**dist["reference"], **dist["split_reference"],
                                        "sequence_control": dist["control"]}.items()},
            "this_process": here[kernel],
        }
        accounted = (sum(launches[kernel]["deploys"].values())
                     + sum(launches[kernel]["references"].values()))
        if here[kernel] != accounted:
            raise AssertionError(f"{kernel}: {here[kernel]} launches in this process, "
                                 f"{accounted} in the references and deploys")
    result = {"launches": launches, "seconds": time.perf_counter() - t0}
    emit({"phase": "dist_models_path", **result})
    return result


# --------------------------------------------------------------------------
# the classification part: the classification template (Naive Bayes and
# L-BFGS logistic regression) and e2's k-means, plain torch on the card;
# none of B1-B6 runs here
# --------------------------------------------------------------------------


SMS_SPAM, SMS_HAM = 747, 4_827  # the UCI SMS Spam Collection's two counts
SMS_VOCAB = 8_000               # words per class vocabulary
SMS_SHARED = 4_000              # words the two vocabularies share
SMS_ZIPF = 1.07                 # Zipf exponent of each vocabulary's ranks
SMS_TOKENS = (4, 30)            # tokens per message, uniform
SMS_QUERIES = 20
CLASSIFY_APP = "MyApp"          # examples/classification/engine.json's appName
PROPERTY_APP = "PropApp"
PROPERTY_USERS = 10_000
#: the reference's bars: Naive Bayes sharded vs single, logistic regression
#: for a different reduction order (tests/test_classification_template.py)
NB_RTOL = 1e-6
LR_RTOL, LR_ATOL = 2e-3, 2e-4
LR_EARLY = 10                   # the L-BFGS iterates held to the CPU's
#: 100 updates on separable text part past LR_RTOL/LR_ATOL between any two
#: reduction orders (the reference's own sharded and single fits too):
#: the final model is held by its labels and its loss
LR_LOSS_RTOL = 1e-3
SERVE_SCORE_TOL = 1e-5
SCALE_MESSAGES = 262_144
HASH_DIM = 4_096
KM_POINTS, KM_DIM, KM_BLOBS, KM_K, KM_ITERATIONS = 1_000_000, 32, 64, 64, 20
KM_SPREAD = 3.0                 # blob centers ~ N(0, 3^2), points ~ N(center, 1)
KM_CENTER_ATOL, KM_COST_RTOL = 1e-4, 1e-5


def sms_corpus(rng: np.random.Generator, n_spam: int, n_ham: int, texts: bool = True):
    """Messages of two Zipf vocabularies of ``SMS_VOCAB`` words sharing
    ``SMS_SHARED``, 4-30 tokens each, in a shuffled order: ``(labels
    ["spam"|"ham"], word ids per token, tokens per message, the words,
    texts or None)``."""
    words = np.array([f"w{i}" for i in range(2 * SMS_VOCAB - SMS_SHARED)])
    p = np.arange(1, SMS_VOCAB + 1, dtype=np.float64) ** -SMS_ZIPF
    p /= p.sum()
    vocab = {"spam": rng.permutation(SMS_VOCAB),
             "ham": rng.permutation(SMS_VOCAB) + (SMS_VOCAB - SMS_SHARED)}
    labels = np.array(["spam"] * n_spam + ["ham"] * n_ham)[rng.permutation(n_spam + n_ham)]
    lengths = rng.integers(SMS_TOKENS[0], SMS_TOKENS[1] + 1, labels.size)
    ranks = rng.choice(SMS_VOCAB, size=int(lengths.sum()), p=p)
    is_spam = np.repeat(labels == "spam", lengths)
    ids = np.where(is_spam, vocab["spam"][ranks], vocab["ham"][ranks])
    out = None
    if texts:
        bounds = np.concatenate([[0], np.cumsum(lengths)])
        out = [" ".join(words[ids[a:b]]) for a, b in zip(bounds[:-1], bounds[1:])]
    return labels, ids, lengths, words, out


def sms_events(labels, texts, path: str) -> None:
    """The messages as ``train`` events in the ``pio import`` wire shape,
    one a second."""
    base = 1_700_000_000
    with open(path, "w") as f:
        for i, (label, text) in enumerate(zip(labels, texts)):
            f.write(json.dumps({
                "event": "train", "entityType": "message", "entityId": f"m{i}",
                "properties": {"text": text, "label": str(label)},
                "eventTime": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(base + i)),
            }) + "\n")


def property_events(rng: np.random.Generator, path: str) -> list[dict]:
    """``PROPERTY_USERS`` users' ``$set`` of three categorical and two
    numeric attributes and their ``plan``; returns the feature dicts of
    the first 200."""
    regions, devices, contracts = ["n", "s", "e", "w", "c", "x"], ["ios", "android",
                                                                 "web", "tv"], ["m", "y", "2y"]
    base = 1_700_000_000
    sample = []
    with open(path, "w") as f:
        for u in range(PROPERTY_USERS):
            props = {"region": str(rng.choice(regions)), "device": str(rng.choice(devices)),
                     "contract": str(rng.choice(contracts)), "age": int(rng.integers(18, 81)),
                     "minutes": round(float(rng.gamma(2.0, 150.0)), 2)}
            heavy = props["minutes"] > 300 or props["device"] == "tv"
            plan = "pro" if heavy and props["contract"] != "m" else (
                "plus" if heavy or props["age"] < 30 else "basic")
            if rng.random() < 0.1:
                plan = str(rng.choice(["basic", "plus", "pro"]))
            if u < 200:
                sample.append(dict(props))
            f.write(json.dumps({
                "event": "$set", "entityType": "user", "entityId": f"u{u}",
                "properties": {**props, "plan": plan},
                "eventTime": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(base + u)),
            }) + "\n")
    return sample


def within(got, want, rtol: float, atol: float = 0.0) -> bool:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))


def classifier_loss(model, x: np.ndarray, y: np.ndarray, reg: float) -> float:
    """The logistic regression's training loss in f64 on the host."""
    z = x.astype(np.float64) @ model.inner.weights.astype(np.float64) + model.inner.bias
    z -= z.max(axis=1, keepdims=True)
    nll = np.log(np.exp(z).sum(axis=1)) - z[np.arange(y.size), y]
    return float(nll.mean() + reg * np.sum(model.inner.weights.astype(np.float64) ** 2))


@contextlib.contextmanager
def lbfgs_recorder(into: dict):
    """Record the L-BFGS run of every logistic-regression train inside
    the block: its stats and its first ``LR_EARLY`` iterates (host
    copies)."""
    from predictionio_tpu_torch.models.classification import engine as cls_engine

    real = cls_engine.train_logistic_regression

    def spy(*args, **kwargs):
        into["iterates"], into["stats"] = [], {}

        def keep(k, params):
            if k <= LR_EARLY:
                into["iterates"].append([p.cpu().numpy().copy() for p in params])

        return real(*args, **kwargs, stats=into["stats"], on_iterate=keep)

    cls_engine.train_logistic_regression = spy
    try:
        yield into
    finally:
        cls_engine.train_logistic_regression = real


def early_iterates_within(card: list, cpu: list) -> list:
    """Per early iterate, whether ``w`` and ``b`` agree at the bar, and
    the worst absolute difference."""
    out = []
    for k, (a, b) in enumerate(zip(card, cpu), 1):
        ok = all(within(p, q, LR_RTOL, LR_ATOL) for p, q in zip(a, b))
        out.append({"iterate": k, "within": ok,
                    "max_abs": max(float(np.abs(p - q).max()) for p, q in zip(a, b))})
    return out


def compare_classifiers(name: str, card, cpu, x: np.ndarray | None, y: np.ndarray | None,
                        records: dict, rows: int = 0) -> dict:
    """The card-trained model against the CPU's: Naive Bayes by
    ``naive_bayes_within`` (``x`` None: over ``rows`` examples of float
    attributes); logistic regression by its first
    iterates, labels and loss (gated) and its weights (printed)."""
    if name == "logistic_regression":
        early = early_iterates_within(records["cuda"]["iterates"], records["cpu"]["iterates"])
        if len(early) != LR_EARLY or not all(e["within"] for e in early):
            raise AssertionError(f"{name}: early iterates part from the CPU's: {early}")
        card_labels = card.inner.scores(x).argmax(axis=1)
        cpu_labels = cpu.inner.scores(x).argmax(axis=1)
        card_loss, cpu_loss = classifier_loss(card, x, y, 1e-4), classifier_loss(cpu, x, y, 1e-4)
        if not (card_labels == cpu_labels).all() or abs(card_loss - cpu_loss) > (
                LR_LOSS_RTOL * cpu_loss):
            raise AssertionError(f"{name}: card loss {card_loss}, CPU {cpu_loss}; "
                                 f"{int((card_labels != cpu_labels).sum())} labels differ")
        return {"early_iterates_max_abs": max(e["max_abs"] for e in early),
                "loss": card_loss, "cpu_loss": cpu_loss,
                "train_accuracy": float((card_labels == y).mean()),
                "weights_max_abs_diff": float(np.abs(card.inner.weights - cpu.inner.weights).max()),
                "weights_within_bar": within(card.inner.weights, cpu.inner.weights, LR_RTOL, LR_ATOL),
                "lbfgs": records["cuda"]["stats"], "cpu_lbfgs": records["cpu"]["stats"]}
    return naive_bayes_within(name, card.inner, cpu.inner, float_rows=0 if x is not None else rows)


def naive_bayes_within(name: str, card, cpu, float_rows: int = 0) -> dict:
    """Naive Bayes on the card against the CPU: each log within ``NB_RTOL``
    or within ``atol``, the rounding of the difference of two f32 logs
    (each within an ulp, at most 2^-23 |v|, of the exact one: a log
    prior such as log(227,000) - log(262,000) cancels to -0.14, where
    one ulp of its terms is 8e-6 of it). Integer counts sum exactly in
    f32 in any order; over ``float_rows`` examples of float attributes
    (properties mode's numeric columns) two orders of a sum of
    non-negative values also part by ~sqrt(n) roundings."""
    scale = float(max(np.abs(cpu.log_likelihood).max(), np.abs(cpu.log_prior).max()))
    atol = 2.0 ** -22 * scale + 2 * np.sqrt(float_rows) * 2.0 ** -24
    errs = {p: float(np.abs(getattr(card, p) - getattr(cpu, p)).max())
            for p in ("log_prior", "log_likelihood")}
    if not all(within(getattr(card, p), getattr(cpu, p), NB_RTOL, atol) for p in errs):
        raise AssertionError(f"{name}: Naive Bayes differs from the CPU's by {errs}, beyond "
                             f"rtol {NB_RTOL}, atol {atol}")
    return {"max_abs_err": max(errs.values()), "atol": atol}


def serve_classifier(engine_json: str, queries: list, algorithm, model, cpu_algorithm,
                     cpu_model, exact: bool, instance_id: str | None = None) -> dict:
    """``queries`` over HTTP to a deploy of the engine.json's latest
    instance (or ``instance_id``) on cuda: each body the instance model's
    ``predict``, each label the CPU model's, scores within
    ``SERVE_SCORE_TOL`` where ``exact`` (Naive Bayes)."""
    from predictionio_tpu_torch.tools.cli import build_query_server

    server, service = build_query_server(engine_json, port=0, device="cuda",
                                         engine_instance_id=instance_id)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
    times, worst = [], 0.0
    try:
        for q in queries:
            body, ms = post(conn, q)
            times.append(ms)
            want = cpu_algorithm.predict(cpu_model, q)
            if body != algorithm.predict(model, q) or body["label"] != want["label"]:
                raise AssertionError(f"served {body} for {q}; CPU model {want}")
            diff = max(abs(body["scores"][c] - want["scores"][c]) for c in want["scores"])
            if exact and diff > SERVE_SCORE_TOL:
                raise AssertionError(f"served scores {body} vs the CPU's {want}")
            worst = max(worst, diff)
    finally:
        conn.close()
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    return {"queries": len(queries), "query_ms_p50": statistics.median(times),
            "scores_max_abs_diff": worst}


SMS_EVAL_MODULE = '''\
from predictionio_tpu_torch.controller.engine import EngineParams
from predictionio_tpu_torch.controller.metrics import (
    AverageMetric, EngineParamsGenerator, Evaluation)
from predictionio_tpu_torch.models.classification import engine_factory


def accuracy(info, query, prediction, actual):
    return 1.0 if prediction["label"] == actual else 0.0


EVALUATION = Evaluation(engine=engine_factory(),
                        metric=AverageMetric(score=accuracy))
GENERATOR = EngineParamsGenerator([EngineParams.from_json_obj({
    "datasource": {"params": {"appName": "%s", "evalFolds": 3}},
    "algorithms": [{"name": name, "params": params}]})
    for name, params in (("naive-bayes", {"smoothing": 1.0}),
                         ("logistic-regression", {"reg": 1e-4, "iterations": 100}))])
'''


@contextlib.contextmanager
def fake_backend_store(workdir: str, backend: str):
    """A fresh ``PIO_FS_BASEDIR`` with the Elasticsearch fake serving all
    three repositories, or the HBase fake the event data (sqlite the
    rest), for the block; the environment restored after."""
    from predictionio_tpu_torch.data import storage

    env = {"PIO_FS_BASEDIR": os.path.join(workdir, f"{backend}_store")}
    if backend == "elasticsearch":
        for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
            env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "ES"
        env.update(PIO_STORAGE_SOURCES_ES_TYPE="elasticsearch",
                   PIO_STORAGE_SOURCES_ES_TRANSPORT="fake")
    else:
        env.update(PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE="HB",
                   PIO_STORAGE_SOURCES_HB_TYPE="hbase", PIO_STORAGE_SOURCES_HB_TRANSPORT="fake")
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    storage.reset()
    try:
        yield
    finally:
        storage.reset()
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def remote_store_check(workdir: str, events_path: str, engine_json: str, queries: list,
                       want: list) -> dict:
    """The SMS events in an Elasticsearch-fake store and in an HBase-fake
    event store: ``run_train`` of naive-bayes on the card, the instance
    and blob in that store's model repository, ``Engine.prepare_deploy``
    of them; every answer bit-equal to ``want`` (the sqlite store's)."""
    from predictionio_tpu_torch.controller.base import TrainContext
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.workflow.core_workflow import (
        engine_params_from_instance,
        run_train,
    )
    from predictionio_tpu_torch.workflow.json_extractor import (
        load_engine_variant,
        template_engine,
    )

    out = {}
    for backend in ("elasticsearch", "hbase"):
        with fake_backend_store(workdir, backend):
            app_id = said(cli_out(["app", "new", CLASSIFY_APP]), "ID")
            t0 = time.perf_counter()
            cli_out(["import", "--appid", app_id, "--input", events_path])
            import_s = time.perf_counter() - t0
            events_dao = type(storage.get_l_events()).__module__
            t0 = time.perf_counter()
            instance = run_train(load_engine_variant(engine_json), device="cuda")
            train_s = time.perf_counter() - t0
            models = storage.get_model_data_models()
            record = models.get(instance.id)
            engine, params = template_engine("classification"), engine_params_from_instance(
                instance)
            [model] = engine.prepare_deploy(TrainContext(device="cuda"), params, instance.id,
                                            record.models)
            [algorithm] = engine._algorithms(params, "cuda")
            got = [algorithm.predict(model, q) for q in queries]
            if got != want:
                raise AssertionError(f"{backend}: the answers differ from the sqlite store's")
            out[backend] = {"events_dao": events_dao, "models_dao": type(models).__module__,
                            "import_s": import_s, "train_s": train_s,
                            "blob_bytes": len(record.models)}
    if not out["elasticsearch"]["models_dao"].endswith("elasticsearch.client"):
        raise AssertionError(f"the ES store's models went to {out['elasticsearch']['models_dao']}")
    if not out["hbase"]["events_dao"].endswith("hbase.client"):
        raise AssertionError(f"the HBase store's events went to {out['hbase']['events_dao']}")
    return out


def phase_classify_path(rng: np.random.Generator, repo: str, workdir: str) -> dict:
    """BASELINE config #2 at its size through the verbs: ``pio app new``,
    ``pio import`` of 5,574 SMS ``train`` events, ``pio train`` of
    ``examples/classification/engine.json`` unchanged (naive-bayes) and
    of a logistic-regression variant (reg 1e-4, 100 updates), each
    held to the same training on the CPU and deployed (20 queries over
    HTTP); ``pio batchpredict``; a 3-fold ``pio eval`` on the card and
    on the CPU; properties mode on 10,000 users; the Elasticsearch- and
    HBase-fake stores."""
    from predictionio_tpu_torch.controller.base import TrainContext
    from predictionio_tpu_torch.tools.cli import load_variant
    from predictionio_tpu_torch.workflow.core_workflow import load_instance_models

    labels, _, _, _, texts = sms_corpus(rng, SMS_SPAM, SMS_HAM)
    events_path = os.path.join(workdir, "sms_events.jsonl")
    sms_events(labels, texts, events_path)
    queries = [{"text": t} for t in sms_corpus(rng, SMS_QUERIES // 4,
                                               SMS_QUERIES - SMS_QUERIES // 4)[4]]
    nb_json = os.path.join(repo, "examples", "classification", "engine.json")
    with open(nb_json) as f:
        lr_variant = json.load(f)
    lr_variant["algorithms"] = [{"name": "logistic-regression",
                                 "params": {"reg": 1e-4, "iterations": 100}}]
    lr_json = os.path.join(workdir, "classification_lr.json")
    with open(lr_json, "w") as f:
        json.dump(lr_variant, f)
    result = {"messages": int(labels.size), "spam": int((labels == "spam").sum())}
    # what dist_classify holds its launch to: the one-process card fits
    handoff = {"queries": queries, "nb_json": nb_json, "lr_json": lr_json}
    with fresh_store(workdir, "classify"):
        app_id = said(cli_out(["app", "new", CLASSIFY_APP]), "ID")
        t0 = time.perf_counter()
        cli_out(["import", "--appid", app_id, "--input", events_path])
        result["import_s"] = time.perf_counter() - t0
        for name, engine_json in (("naive_bayes", nb_json), ("logistic_regression", lr_json)):
            records = {}
            t0 = time.perf_counter()
            with lbfgs_recorder(records.setdefault("cuda", {})):
                instance = said(cli_out(["train", "--engine-json", engine_json,
                                         "--device", "cuda"]), "Engine instance ID")
            train_s = time.perf_counter() - t0
            variant, engine = load_variant(engine_json)
            _, [model] = load_instance_models(variant, instance)
            [cpu_algorithm] = engine._algorithms(variant.engine_params, "cpu")
            ctx = TrainContext(device="cpu")
            t0 = time.perf_counter()
            with lbfgs_recorder(records.setdefault("cpu", {})):
                [cpu_model] = engine.train(ctx, variant.engine_params)
            cpu_train_s = time.perf_counter() - t0
            data = engine.data_source(variant.engine_params).read_training(ctx)
            x = model.space.vectorize_records(data.records)
            y = np.array([model.space.classes.index(l) for l in data.labels])
            entry = {"instance": instance, "train_s": train_s, "cpu_train_s": cpu_train_s,
                     **compare_classifiers(name, model, cpu_model, x, y, records)}
            [algorithm] = engine._algorithms(variant.engine_params, "cuda")
            entry["serve"] = serve_classifier(engine_json, queries, algorithm, model,
                                              cpu_algorithm, cpu_model, name == "naive_bayes")
            result[name] = entry
            handoff[name] = {"model": model, "algorithm": algorithm, "x": x, "y": y,
                             "iterates": records["cuda"].get("iterates")}
            if name == "naive_bayes":
                nb_answers = [algorithm.predict(model, q) for q in queries]
                q_path = os.path.join(workdir, "sms_queries.jsonl")
                p_path = os.path.join(workdir, "sms_predictions.jsonl")
                with open(q_path, "w") as f:
                    f.writelines(json.dumps(q) + "\n" for q in queries)
                t0 = time.perf_counter()
                cli_out(["batchpredict", "--engine-json", nb_json, "--input", q_path,
                         "--output", p_path, "--device", "cuda"])
                with open(p_path) as f:
                    rows = [json.loads(line) for line in f]
                if [r["prediction"] for r in rows] != nb_answers:
                    raise AssertionError("batchpredict differs from predict")
                entry["batchpredict"] = {"rows": len(rows), "s": time.perf_counter() - t0}
        with open(os.path.join(workdir, "sms_eval.py"), "w") as f:
            f.write(SMS_EVAL_MODULE % CLASSIFY_APP)
        accuracy = {}
        for device in ("cuda", "cpu"):
            out = os.path.join(workdir, f"sms_eval_{device}.json")
            t0 = time.perf_counter()
            cli_out(["eval", "sms_eval.EVALUATION", "sms_eval.GENERATOR", "--engine-dir",
                     workdir, "--device", device, "--output-path", out])
            with open(out) as f:
                report = json.load(f)
            accuracy[device] = {"s": time.perf_counter() - t0,
                                "naive_bayes": report["results"][0]["score"],
                                "logistic_regression": report["results"][1]["score"]}
        if min(accuracy["cuda"]["naive_bayes"], accuracy["cuda"]["logistic_regression"]) < 0.8:
            raise AssertionError(f"3-fold accuracy {accuracy}")
        result["eval_3_fold"] = accuracy
        # properties mode: 10,000 users' $set, naive-bayes
        prop_path = os.path.join(workdir, "property_events.jsonl")
        sample = property_events(rng, prop_path)
        prop_id = said(cli_out(["app", "new", PROPERTY_APP]), "ID")
        cli_out(["import", "--appid", prop_id, "--input", prop_path])
        prop_json = os.path.join(workdir, "classification_properties.json")
        with open(prop_json, "w") as f:
            json.dump({"engineFactory": lr_variant["engineFactory"], "datasource": {"params": {
                "appName": PROPERTY_APP, "mode": "properties", "labelField": "plan"}},
                "algorithms": [{"name": "naive-bayes", "params": {"smoothing": 1.0}}]}, f)
        t0 = time.perf_counter()
        instance = said(cli_out(["train", "--engine-json", prop_json, "--device", "cuda"]),
                        "Engine instance ID")
        train_s = time.perf_counter() - t0
        prop_variant, engine = load_variant(prop_json)
        _, [model] = load_instance_models(prop_variant, instance)
        [cpu_algorithm] = engine._algorithms(prop_variant.engine_params, "cpu")
        [cpu_model] = engine.train(TrainContext(device="cpu"), prop_variant.engine_params)
        entry = compare_classifiers("properties", model, cpu_model, None, None, {},
                                    rows=PROPERTY_USERS)
        served = [cpu_algorithm.predict(model, {"features": s})["label"] for s in sample]
        if served != [cpu_algorithm.predict(cpu_model, {"features": s})["label"] for s in sample]:
            raise AssertionError("properties mode: card and CPU models label users apart")
        result["properties"] = {"users": PROPERTY_USERS, "train_s": train_s,
                                "columns": int(model.inner.log_likelihood.shape[1]), **entry}
    t0 = time.perf_counter()
    result["remote_stores"] = remote_store_check(workdir, events_path, nb_json, queries,
                                                 nb_answers)
    result["remote_stores"]["s"] = time.perf_counter() - t0
    emit({"phase": "classify_path", **result})
    return result, handoff


def scale_corpus(rng: np.random.Generator, n: int):
    """``n`` messages of ``sms_corpus``'s recipe (spam at the public
    corpus's share) hashed straight into a dense ``[n, HASH_DIM]`` f32
    count matrix (what ``hashing_vectorize`` makes of their texts, held
    to it on the first 256), and the labels (1 spam)."""
    from predictionio_tpu_torch.ops.features import hash_token, hashing_vectorize

    n_spam = round(n * SMS_SPAM / (SMS_SPAM + SMS_HAM))
    labels, ids, lengths, words, _ = sms_corpus(rng, n_spam, n - n_spam, texts=False)
    columns = np.array([hash_token(w, HASH_DIM) for w in words], np.int64)[ids]
    x = np.zeros((n, HASH_DIM), np.float32)
    np.add.at(x, (np.repeat(np.arange(n), lengths), columns), 1.0)
    head = int(lengths[:256].sum())
    bounds = np.concatenate([[0], np.cumsum(lengths[:256])])
    texts = [" ".join(words[ids[:head][a:b]]) for a, b in zip(bounds[:-1], bounds[1:])]
    if not np.array_equal(hashing_vectorize(texts, HASH_DIM), x[:256]):
        raise AssertionError("the hashed matrix is not hashing_vectorize's")
    return x, (labels == "spam").astype(np.int64)


def phase_classify_scale(rng: np.random.Generator) -> dict:
    """The trainers alone at 262,144 messages x hashDim 4096 (4.29 GB of
    f32 on the card): Naive Bayes and 100 L-BFGS updates of logistic
    regression, beside the CPU (Naive Bayes by ``naive_bayes_within``; the first
    ``LR_EARLY`` iterates at the reference's bar); s per loss-and-
    gradient evaluation beside its bytes bound."""
    import torch

    from predictionio_tpu_torch.ops import classify

    t0 = time.perf_counter()
    x, y = scale_corpus(rng, SCALE_MESSAGES)
    result = {"messages": SCALE_MESSAGES, "hash_dim": HASH_DIM, "x_bytes": x.nbytes,
              "data_s": time.perf_counter() - t0}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    xd = torch.from_numpy(x).cuda()
    yd = torch.from_numpy(y).cuda()
    torch.cuda.synchronize()
    result["upload_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nb = classify.train_naive_bayes(xd, yd, 2, device="cuda")
    result["naive_bayes_train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nb_cpu = classify.train_naive_bayes(torch.from_numpy(x), y, 2, device="cpu")
    result["naive_bayes_cpu_s"] = time.perf_counter() - t0
    result["naive_bayes"] = naive_bayes_within("classify_scale", nb, nb_cpu)
    iterates = {"cuda": [], "cpu": []}

    def keep(into):
        return lambda k, p: into.append([t.cpu().numpy().copy() for t in p]) if k <= LR_EARLY else None

    stats = {}
    t0 = time.perf_counter()
    lr = classify.train_logistic_regression(xd, yd, 2, device="cuda", stats=stats,
                                            on_iterate=keep(iterates["cuda"]))
    result["logistic_regression_train_s"] = time.perf_counter() - t0
    result["lbfgs"] = stats
    result["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    classify.train_logistic_regression(torch.from_numpy(x), y, 2, iterations=LR_EARLY,
                                       device="cpu", on_iterate=keep(iterates["cpu"]))
    result["logistic_regression_cpu_s_10_updates"] = time.perf_counter() - t0
    early = early_iterates_within(iterates["cuda"], iterates["cpu"])
    if not all(e["within"] for e in early):
        raise AssertionError(f"classify_scale: early iterates part from the CPU's: {early}")
    result["early_iterates_max_abs"] = max(e["max_abs"] for e in early)
    value_and_grad = classify.logistic_value_and_grad(
        classify.example_mesh(None, "cuda"), xd, yd,
        torch.ones(SCALE_MESSAGES, device="cuda"), 1e-4)
    params = [torch.from_numpy(lr.weights).cuda(), torch.from_numpy(lr.bias).cuda()]
    ms = cuda_ms(lambda: value_and_grad(params), runs=10, warmup=2)
    bytes_moved = (2 * x.nbytes + 2 * (lr.weights.nbytes + lr.bias.nbytes)
                   + 4 * SCALE_MESSAGES)  # the unit weights
    ops = 2 * (2 * SCALE_MESSAGES * HASH_DIM * 2)
    bound = max(bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    result["evaluation"] = {
        "ms": ms, "bound_ms": bound,
        "bound_by": "bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations",
        "train_s_per_evaluation": result["logistic_regression_train_s"] / stats["evaluations"]}
    accuracy = float((lr.scores(x[:20_000]).argmax(axis=1) == y[:20_000]).mean())
    result["train_accuracy_first_20000"] = accuracy
    del xd, yd, x
    torch.cuda.empty_cache()
    emit({"phase": "classify_scale", **result})
    return result


def km_blobs(rng: np.random.Generator) -> np.ndarray:
    """``KM_POINTS`` points of ``KM_DIM`` around ``KM_BLOBS`` seeded centers."""
    centers = rng.normal(0.0, KM_SPREAD, (KM_BLOBS, KM_DIM)).astype(np.float32)
    which = rng.integers(0, KM_BLOBS, KM_POINTS)
    return centers[which] + rng.standard_normal((KM_POINTS, KM_DIM), dtype=np.float32)


def lloyd_steps_within(what: str, steps, x, reference, iterations_run: int,
                       final_cost: float) -> tuple[int, float, float]:
    """Each recorded Lloyd step ``(input centers, new centers, assignment,
    cost)`` of a fit on ``x`` held to ``reference(x, centers)``, the step
    from the same input centers on ``x``'s device: assignments equal but
    for near ties (the two distances within f32 rounding of each other),
    the centers of the recorded assignment within ``KM_CENTER_ATOL`` of
    the recorded ones, the cost within ``KM_COST_RTOL``; and the
    reference's costs along that path stop it at ``iterations_run`` with
    the final pass's cost within ``KM_COST_RTOL`` of ``final_cost``.
    Returns the near-tie moves and the largest center and cost errors."""
    import torch

    xc = x.cpu()
    ties, center_err, cost_err, ref_costs = 0, 0.0, 0.0, []
    for centers, new, assign, cost in steps:
        _, ref_assign, ref_cost = reference(x, centers.to(x.device))
        ref_assign = ref_assign.cpu()
        ref_costs.append(float(ref_cost))
        moved = torch.nonzero(ref_assign != assign).flatten()
        if moved.numel():
            pts = xc[moved].double()
            da = ((pts - centers[assign[moved]].double()) ** 2).sum(1)
            db = ((pts - centers[ref_assign[moved]].double()) ** 2).sum(1)
            scale = (pts * pts).sum(1) + 2 * pts.norm(dim=1) * centers.double().norm(dim=1).max() + (
                centers.double() ** 2).sum(1).max()
            if bool(((da - db).abs() > 2.0 ** -20 * scale).any()):
                raise AssertionError(f"{what}: {moved.numel()} points assigned apart, not ties")
            ties += moved.numel()
        onehot = torch.nn.functional.one_hot(assign, centers.shape[0]).float()
        counts = onehot.sum(0)[:, None]
        from_assign = torch.where(counts > 0, (onehot.T @ xc) / counts.clamp(min=1.0), centers)
        center_err = max(center_err, float((from_assign - new).abs().max()))
        cost_err = max(cost_err, abs(cost - float(ref_cost)) / float(ref_cost))
    if center_err > KM_CENTER_ATOL or cost_err > KM_COST_RTOL:
        raise AssertionError(f"{what}: centers {center_err}, cost {cost_err} from the reference's")
    stop = 0
    for stop, cost in enumerate(ref_costs[:-1], 1):  # the last entry is the final pass
        if stop > 1 and ref_costs[stop - 2] - cost <= 1e-4 * abs(ref_costs[stop - 2]):
            break
    if stop != iterations_run or abs(ref_costs[-1] - final_cost) > KM_COST_RTOL * final_cost:
        raise AssertionError(f"{what}: the reference's costs stop at {stop}, the fit at "
                             f"{iterations_run}")
    return ties, center_err, cost_err


def phase_kmeans_check(rng: np.random.Generator, seed: int) -> dict:
    """e2's ``kmeans`` on the card (k-means++ on the host, the Lloyd steps
    in torch): every step held to the CPU's step from the same centers
    -- assignments equal but for near ties (the two distances within f32
    rounding of each other), centers of the card's assignment within
    ``KM_CENTER_ATOL``, cost within ``KM_COST_RTOL`` -- and the CPU's
    costs along that path stop it at the card's iteration. A Lloyd step
    timed beside its bound."""
    import torch

    from predictionio_tpu_torch.models import e2
    from predictionio_tpu_torch.ops import kmeans as port_kmeans

    x = km_blobs(rng)
    steps, timings = [], {}
    real, real_init = port_kmeans.lloyd_step, port_kmeans._kmeanspp_init

    def recorded(xs, centers):
        new, assign, cost = real(xs, centers)
        steps.append((centers.cpu(), new.cpu(), assign.cpu(), float(cost)))
        return new, assign, cost

    def timed_init(*args):
        t0 = time.perf_counter()
        out = real_init(*args)
        timings["init_s"] = time.perf_counter() - t0
        return out

    port_kmeans.lloyd_step, port_kmeans._kmeanspp_init = recorded, timed_init
    try:
        t0 = time.perf_counter()
        model = e2.kmeans(x, k=KM_K, iterations=KM_ITERATIONS, seed=seed, device="cuda")
        fit_s = time.perf_counter() - t0
    finally:
        port_kmeans.lloyd_step, port_kmeans._kmeanspp_init = real, real_init
    ties, center_err, cost_err = lloyd_steps_within(
        "kmeans", steps, torch.from_numpy(x), real, model.iterations_run, model.cost)
    xd = torch.from_numpy(x).cuda()
    cd = torch.from_numpy(model.centers).cuda()
    ms = cuda_ms(lambda: real(xd, cd), runs=10, warmup=2)
    ops = 2 * KM_POINTS * KM_DIM * KM_K + KM_POINTS * KM_DIM  # distances; the sums
    bytes_moved = x.nbytes + model.centers.nbytes * 2 + KM_POINTS * 8 + 4
    result = {
        "points": KM_POINTS, "dim": KM_DIM, "k": KM_K, "iterations_run": model.iterations_run,
        "cost": model.cost, "fit_s": fit_s, "kmeanspp_s": timings["init_s"],
        "lloyd_s": fit_s - timings["init_s"], "steps": len(steps), "near_tie_moves": ties,
        "center_max_abs_err": center_err, "cost_max_rel_err": cost_err,
        "lloyd_step": {"ms": ms, "bound_ms": max(ops / F32_OPS_PER_S,
                                                 bytes_moved / HBM_BYTES_PER_S) * 1e3,
                       "bound_by": "operations" if ops / F32_OPS_PER_S >= bytes_moved /
                       HBM_BYTES_PER_S else "bytes"},
    }
    del xd
    emit({"phase": "kmeans_check", **result})
    return result, x, model


def kernel_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    from predictionio_tpu_torch.models.ncf import kernel as ncf_kernel
    from predictionio_tpu_torch.ops import als_gram, mips

    return {"mips_block_topk": mips.mips_block_topk.launches,
            "gram_rhs": als_gram.gram_rhs.launches,
            "ncf_score_all_items": ncf_kernel.ncf_score_all_items.launches, **flash_counts()}


def phase_classification(rng: np.random.Generator, seed: int, repo: str, workdir: str) -> dict:
    """The classification part: classify_path, classify_scale and
    kmeans_check. Every kernel's count is set to 0 first; none of B1-B6
    may launch in it."""
    from predictionio_tpu_torch.models.ncf import kernel as ncf_kernel
    from predictionio_tpu_torch.ops import als_gram, mips

    als_gram.gram_rhs.launches = 0           # counts start at 0 here
    mips.mips_block_topk.launches = 0
    ncf_kernel.ncf_score_all_items.launches = 0
    zero_flash_counts()
    seconds = {}
    t0 = time.perf_counter()
    _, handoff = phase_classify_path(rng, repo, workdir)
    seconds["classify_path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_classify_scale(rng)
    seconds["classify_scale"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, handoff["km_points"], handoff["kmeans"] = phase_kmeans_check(rng, seed)
    seconds["kmeans_check"] = time.perf_counter() - t0
    launches = kernel_counts()                # read here
    if any(launches.values()):
        raise AssertionError(f"the classification part launched kernels: {launches}")
    result = {"launches": launches, "seconds": seconds}
    emit({"phase": "classification", **result})
    return {**result, "handoff": handoff}


# --------------------------------------------------------------------------
# dist_classify: the classifiers and k-means over the data axis of a
# two-rank launch (the ranks share the card over gloo)
# --------------------------------------------------------------------------

#: the launch's pio.mesh_shape and pio.dcn_mesh_shape, given to ``pio
#: train`` after ``--``
DIST_CLASSIFY_MESH, DIST_CLASSIFY_DCN = [2, 1], [1, 1]
DIST_CLASSIFY_PASSTHROUGH = ["--", "--mesh-shape", "2,1", "--dcn-mesh-shape", "1,1"]
#: the launch's second k-means fit: the first 100,003 of kmeans_check's
#: points, which 8 x 2 = 16 does not divide, so the ranks' zero-weight pad
#: rows run on the card
KM_PAD_POINTS = 100_003


def classify_worker(spec: dict) -> int:
    """One rank of the dist_classify launch: ``pio train -- --mesh-shape
    2,1 --dcn-mesh-shape 1,1`` of ``spec["lr_json"]`` (its L-BFGS run
    recorded: stats and the first ``LR_EARLY`` iterates) and of
    ``spec["nb_json"]`` on the store ``PIO_FS_BASEDIR`` names, then e2's
    ``kmeans`` of ``spec["km_points"]`` and of their first
    ``KM_PAD_POINTS`` over the same mesh, every Lloyd step recorded (its
    input and new centers and cost; the rank's assignment to
    -RANK-assign.npz). Every mesh the
    rank built is recorded (``build_mesh`` wrapped). Writes the rank's
    seconds, instance ids, meshes, collective counts, kernel launches
    (each counted from 0 here) and pack routes to ``spec["out"]``-RANK.json,
    its iterates and centers to -RANK.npz."""
    from predictionio_tpu_torch.models import e2
    from predictionio_tpu_torch.models.ncf import kernel as ncf_kernel
    from predictionio_tpu_torch.ops import als_gram, mips, ragged
    from predictionio_tpu_torch.ops import kmeans as port_kmeans
    from predictionio_tpu_torch.parallel import distributed as dist_lib
    from predictionio_tpu_torch.parallel import mesh as mesh_lib

    rank = int(os.environ["PIO_PROCESS_ID"])
    als_gram.gram_rhs.launches = 0           # counts start at 0 here
    mips.mips_block_topk.launches = 0
    ncf_kernel.ncf_score_all_items.launches = 0
    zero_flash_counts()
    meshes, real_build = [], dist_lib.build_mesh

    def recorded(shape, axes, dcn_mesh_shape=None, device=None):
        mesh = real_build(shape, axes, dcn_mesh_shape=dcn_mesh_shape, device=device)
        meshes.append({"mesh_shape": list(shape), "dcn_mesh_shape": dcn_mesh_shape,
                       "shape": mesh.shape, "grid": mesh.grid.tolist()})
        return mesh

    dist_lib.build_mesh = recorded
    report, arrays = {"rank": rank, "trains": {}}, {}
    for name, engine_json in (("logistic_regression", spec["lr_json"]),
                              ("naive_bayes", spec["nb_json"])):
        records = {}
        t0 = time.perf_counter()
        with lbfgs_recorder(records):
            out = cli_out(["train", "--engine-json", engine_json, "--device", "cuda",
                           *DIST_CLASSIFY_PASSTHROUGH])
        entry = {"train_s": time.perf_counter() - t0,
                 "instance_id": said(out, "Engine instance ID") if rank == 0 else None}
        if rank != 0 and "Training completed on rank" not in out:
            raise AssertionError(f"rank {rank} said {out}")
        if records:
            entry["lbfgs"] = records["stats"]
            for k, (w, b) in enumerate(records["iterates"], 1):
                arrays[f"w{k}"], arrays[f"b{k}"] = w, b
        report["trains"][name] = entry
    x = np.load(spec["km_points"])
    mesh = dist_lib.build_mesh(DIST_CLASSIFY_MESH, ("data", "model"),
                               dcn_mesh_shape=DIST_CLASSIFY_DCN, device="cuda")
    real_step, steps, assigns = port_kmeans.lloyd_step, [], {}

    def recorded(xs, centers, weights=None, step_mesh=None):
        new, assign, cost = real_step(xs, centers, weights, step_mesh)
        steps.append((centers.cpu().numpy(), new.cpu().numpy(),
                      assign.cpu().numpy().astype(np.int32), float(cost)))
        return new, assign, cost

    port_kmeans.lloyd_step = recorded
    try:
        for key, points in (("kmeans", x), ("kmeans_pad", x[:KM_PAD_POINTS])):
            steps.clear()
            t0 = time.perf_counter()
            km = e2.kmeans(points, k=KM_K, iterations=KM_ITERATIONS, seed=spec["seed"],
                           mesh=mesh)
            report[key] = {"fit_s": time.perf_counter() - t0, "cost": km.cost,
                           "iterations_run": km.iterations_run,
                           "step_costs": [cost for *_, cost in steps]}
            arrays[f"{key}_centers"] = km.centers
            for i, (centers, new, assign, _) in enumerate(steps):
                arrays[f"{key}_in{i}"], arrays[f"{key}_new{i}"] = centers, new
                assigns[f"{key}_{i}"] = assign  # this rank's rows
    finally:
        port_kmeans.lloyd_step = real_step
    dist_lib.build_mesh = real_build
    report.update(meshes=meshes, distributed=dist_lib.distributed_info(),
                  collectives=mesh_lib.collective_counts(), launches=kernel_counts(),
                  pack_routes=ragged.pack_routes())
    np.savez(f"{spec['out']}-{rank}.npz", **arrays)
    np.savez(f"{spec['out']}-{rank}-assign.npz", **assigns)
    with open(f"{spec['out']}-{rank}.json", "w") as f:
        json.dump(report, f)
    return 0


def phase_dist_classify(handoff: dict, workdir: str, seed: int) -> dict:
    """dist_classify: one launch of two ranks (``classify_worker``) on
    classify_path's store. Gates: both ranks over gloo on a ``[2, 1]``
    mesh built with ``dcn_mesh_shape [1, 1]`` (every mesh they built),
    all-reduces on both, no kernel launched; rank 0 alone recorded the
    two COMPLETED instances. Logistic regression (100 updates on 5,574
    messages): rank 0's first ``LR_EARLY`` iterates within ``LR_RTOL`` /
    ``LR_ATOL`` of the one-process card fit's (rank 1's equal rank
    0's), the blob's labels on every message the one-process model's and
    its loss within ``LR_LOSS_RTOL``; the blob deployed, ``SMS_QUERIES``
    queries over HTTP answered with the one-process model's labels.
    Naive Bayes: the blob within ``NB_RTOL`` of the one-process card
    model (``naive_bayes_within``). k-means (kmeans_check's points and
    seed, and their first ``KM_PAD_POINTS``, whose pad rows the ranks
    weigh 0): both ranks' centers equal; every Lloyd step of the ranks
    held to the one-process step on the card from the same input centers
    (``lloyd_steps_within``: the pad rows count nothing); the same
    ``iterations_run`` as the one-process card fit and the cost within
    ``KM_COST_RTOL``; the centers within ``KM_CENTER_ATOL`` of that fit's
    for the 1M points, whose paths stay together, and reported for the
    padded fit, whose one-process path parts from the ranks' at a near
    tie (``trajectory_moves``: per step, the points the two fits assign
    apart). Two ranks on one card measure correctness and
    overhead, not scaling."""
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.workflow.core_workflow import load_instance_models
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    points = os.path.join(workdir, "km_points.npy")
    np.save(points, handoff["km_points"])
    spec = {"name": "dist_classify", "template": "classification",
            "out": os.path.join(workdir, "dist_classify"), "lr_json": handoff["lr_json"],
            "nb_json": handoff["nb_json"], "km_points": points, "seed": seed}
    with fresh_store(workdir, "classify"):
        before = {i.id for i in storage.get_meta_data_engine_instances().get_all()}
        reports, launch_s = run_launch(spec, 2)
        storage.reset()
        recorded = sorted((i.id, i.status)
                          for i in storage.get_meta_data_engine_instances().get_all()
                          if i.id not in before)
        ids = {name: [r["trains"][name]["instance_id"] for r in reports]
               for name in ("logistic_regression", "naive_bayes")}
        if (any(v[1] is not None for v in ids.values())
                or recorded != sorted((v[0], "COMPLETED") for v in ids.values())):
            raise AssertionError(f"dist_classify: new instances {recorded}, ranks said {ids}")
        for r in reports:
            if r["distributed"]["backend"] != "gloo" or r["distributed"]["world_size"] != 2:
                raise AssertionError(f"dist_classify: rank {r['rank']} {r['distributed']}")
            if len(r["meshes"]) != 3 or any(
                    m["shape"] != {"data": 2, "model": 1}
                    or m["dcn_mesh_shape"] != DIST_CLASSIFY_DCN for m in r["meshes"]):
                raise AssertionError(f"dist_classify: rank {r['rank']} meshes {r['meshes']}")
            if not r["collectives"].get("gloo:all_reduce") or any(r["launches"].values()):
                raise AssertionError(f"dist_classify: rank {r['rank']} collectives "
                                     f"{r['collectives']}, launches {r['launches']}")
        arrays = [np.load(f"{spec['out']}-{r}.npz") for r in range(2)]
        for key in arrays[0].files:
            if not np.array_equal(arrays[0][key], arrays[1][key]):
                raise AssertionError(f"dist_classify: the ranks' {key} differ")
        result = {"mesh_shape": DIST_CLASSIFY_MESH, "dcn_mesh_shape": DIST_CLASSIFY_DCN,
                  "launch_s": launch_s, "backends": [r["distributed"]["backend"]
                                                    for r in reports],
                  "meshes": reports[0]["meshes"],
                  "collectives": [r["collectives"] for r in reports],
                  "train_s": {name: [r["trains"][name]["train_s"] for r in reports]
                              for name in ids},
                  "kmeans_fit_s": [[r[key]["fit_s"] for key in ("kmeans", "kmeans_pad")]
                                   for r in reports],
                  "pack_routes": [r["pack_routes"] for r in reports]}
        # logistic regression: rank 0's blob against the one-process card fit
        one = handoff["logistic_regression"]
        lr_json = handoff["lr_json"]
        _, [model] = load_instance_models(load_engine_variant(lr_json), ids["logistic_regression"][0])
        records = {"cuda": {"iterates": [[arrays[0][f"w{k}"], arrays[0][f"b{k}"]]
                                         for k in range(1, LR_EARLY + 1)],
                            "stats": reports[0]["trains"]["logistic_regression"]["lbfgs"]},
                   "cpu": {"iterates": one["iterates"], "stats": None}}
        lr = compare_classifiers("logistic_regression", model, one["model"], one["x"],
                                 one["y"], records)
        lr.pop("cpu_lbfgs")
        lr["serve"] = serve_classifier(lr_json, handoff["queries"], one["algorithm"], model,
                                       one["algorithm"], one["model"], False,
                                       instance_id=ids["logistic_regression"][0])
        result["logistic_regression"] = lr
        _, [nb] = load_instance_models(load_engine_variant(handoff["nb_json"]),
                                    ids["naive_bayes"][0])
        result["naive_bayes"] = naive_bayes_within("dist_naive_bayes", nb.inner,
                                                   handoff["naive_bayes"]["model"].inner)
    import torch

    from predictionio_tpu_torch.models import e2
    from predictionio_tpu_torch.ops import kmeans as port_kmeans

    real_step, one_assign = port_kmeans.lloyd_step, []

    def recorded(xs, centers, *rest):
        new, assign, cost = real_step(xs, centers, *rest)
        one_assign.append(assign.cpu())
        return new, assign, cost

    port_kmeans.lloyd_step = recorded
    try:
        pad_one = e2.kmeans(handoff["km_points"][:KM_PAD_POINTS], k=KM_K,
                            iterations=KM_ITERATIONS, seed=seed, device="cuda")
    finally:
        port_kmeans.lloyd_step = real_step
    assigns = [np.load(f"{spec['out']}-{r}-assign.npz") for r in range(2)]
    for key, points, km_one in (("kmeans", handoff["km_points"], handoff["kmeans"]),
                                ("kmeans_pad", handoff["km_points"][:KM_PAD_POINTS], pad_one)):
        km, n = reports[0][key], points.shape[0]
        steps = [(torch.from_numpy(arrays[0][f"{key}_in{i}"]),
                  torch.from_numpy(arrays[0][f"{key}_new{i}"]),
                  torch.from_numpy(np.concatenate([a[f"{key}_{i}"] for a in assigns])[:n]).long(),
                  cost) for i, cost in enumerate(km["step_costs"])]
        ties, step_center_err, step_cost_err = lloyd_steps_within(
            f"dist_classify {key}", steps, torch.from_numpy(points).cuda(), real_step,
            km["iterations_run"], km["cost"])
        center_err = float(np.abs(arrays[0][f"{key}_centers"] - km_one.centers).max())
        cost_err = abs(km["cost"] - km_one.cost) / km_one.cost
        # the padded fit is held step by step: its one-process twin's path
        # parts from the ranks' at a near tie (trajectory_moves)
        gated_centers = center_err if key == "kmeans" else 0.0
        if (km["iterations_run"] != km_one.iterations_run or gated_centers > KM_CENTER_ATOL
                or cost_err > KM_COST_RTOL):
            raise AssertionError(f"dist_classify {key}: {km['iterations_run']} iterations "
                                 f"against {km_one.iterations_run}, centers {center_err}, "
                                 f"cost {cost_err} from one process")
        result[key] = {"points": n, "iterations_run": km["iterations_run"], "cost": km["cost"],
                       "center_max_abs_err": center_err, "cost_rel_err": cost_err,
                       "step_center_max_abs_err": step_center_err,
                       "step_cost_max_rel_err": step_cost_err, "step_near_tie_moves": ties}
    result["kmeans_pad"]["trajectory_moves"] = [
        int((one_assign[i] != s[2]).sum()) for i, s in enumerate(steps[:len(one_assign)])]
    emit({"phase": "dist_classify", **result})
    return result


def phase_dist_classify_path(handoff: dict, workdir: str, seed: int) -> dict:
    """dist_classify with every kernel's count set to 0 before and read
    after: none of B1-B6 launches in it, here or in a rank."""
    from predictionio_tpu_torch.models.ncf import kernel as ncf_kernel
    from predictionio_tpu_torch.ops import als_gram, mips

    als_gram.gram_rhs.launches = 0           # counts start at 0 here
    mips.mips_block_topk.launches = 0
    ncf_kernel.ncf_score_all_items.launches = 0
    zero_flash_counts()
    t0 = time.perf_counter()
    phase_dist_classify(handoff, workdir, seed)
    launches = kernel_counts()                # read here
    if any(launches.values()):
        raise AssertionError(f"the dist_classify part launched kernels: {launches}")
    result = {"launches": launches, "seconds": time.perf_counter() - t0}
    emit({"phase": "dist_classify_path", **result})
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


def b3_bound(items: int, e: int, h0: int, h1: int) -> tuple[float, str, float, float, float]:
    """(bound ms, what bounds it, bytes, operations, f32 bound ms) of one
    B3 call. Bytes: the two item tables read once and the scores written
    once, with the user rows and the weights (noise at the template's
    widths). Operations per item: 2 E H0 + 2 H0 H1 in the two dense
    layers' products, on the tensor cores in 3xTF32 (F32_3XTF32_OPS_PER_S);
    outside them in f32 3E (the gmf products, their weights and sum), 2 H1
    (the output dot) and H0 + H1 relus; per call once more 2 E H0 + H0 for
    the user's half of the first layer, in f32. The f32 bound counts every
    operation at F32_OPS_PER_S, as runs before the tensor-core kernel did."""
    nbytes = 2.0 * items * e * 4 + items * 4 + (2 * e + 2 * e * h0 + h0 * h1) * 4
    dense = float(items) * (2 * e * h0 + 2 * h0 * h1)
    rest = float(items * (3 * e + 2 * h1 + h0 + h1) + 2 * e * h0 + h0)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = dense / F32_3XTF32_OPS_PER_S + rest / F32_OPS_PER_S
    bound_f32_ms = max(t_bytes, (dense + rest) / F32_OPS_PER_S) * 1e3
    return (max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes,
            dense + rest, bound_f32_ms)


def b3_layout(lib, e: int, h0: int, h1: int) -> dict:
    """B3's staging at these widths, decoded from ``ncf_score_layout``."""
    code = lib.ncf_score_layout(e, h0, h1)
    def held(bit):
        return "resident" if code >> bit & 1 else "chunked"
    return {"w0i": held(0), "w1": held(1), "c0": held(2),
            "ring_stages": 2 if code >> 3 & 1 else 1,
            "h1_chunk": 32 if code >> 4 & 1 else 64, "ring_e_chunks": code >> 5}


def phase_check_b3(seed: int) -> dict:
    """Kernel B3 against its plain version on the card: the template's
    widths (E=32, hidden 64, 32) at 1,000,000 items for several users
    (the last one included) and over the small catalogs at the edges of
    its tiles, the odd widths (``NCF_ODD``) and the wide towers over
    27,000 items; each case's staging layout, grid and shared memory
    emitted beside its error."""
    import torch

    from predictionio_tpu_torch import _kernels
    from predictionio_tpu_torch.models.ncf.kernel import head_tensors

    cases = [(NCF_SERVE_USERS, NCF_SERVE_ITEMS, NCF_E, NCF_HIDDEN)]
    cases += [(64, n, NCF_E, NCF_HIDDEN) for n in NCF_SMALL_ITEMS]
    cases += [(64, n, e, hidden) for n, e, hidden in NCF_ODD]
    cases += [(64, NCF_TRAIN_ITEMS, e, hidden) for e, hidden in NCF_WIDE]
    lib = _kernels.library("ncf_score")
    worst = worst_ratio = 0.0
    for users, items, e, hidden in cases:
        state = random_ncf_state(users, items, e, hidden, seed)
        gmf_users, mlp_users, head = head_tensors(state, items, "cuda")
        picked = sorted({0, 1, users // 2, users - 2, users - 1})
        err, ratio = compare_b3(gmf_users, mlp_users, head, picked)
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
        emit({"phase": "check_b3", "items": items, "embed": e, "hidden": list(hidden),
              "users_checked": picked, "max_abs_err": err,
              "max_err_over_bound": ratio, "tolerance": b3_tolerance(e, *hidden),
              "layout": b3_layout(lib, e, *hidden),
              "grid": lib.ncf_score_grid(items, e, *hidden),
              "smem_bytes": lib.ncf_score_smem_bytes(e, *hidden)})
        del gmf_users, mlp_users, head, state
        torch.cuda.empty_cache()
    return {"max_abs_err": worst, "max_err_over_bound": worst_ratio, "cases": len(cases)}


def phase_time_b3(seed: int) -> dict:
    """B3 and its plain version at 1,000,000 and at 27,000 items (the
    template's widths) and at the wide towers over 27,000 items: the
    CUDA-event median (``ms``) and the profiler's device time
    (``device_ms``) of each, beside the bound and the f32 bound. A row's
    ``reported`` names the time PERF.md quotes: the device time for the
    template's 27,000 items, whose event pair brackets the wrapper's host
    work, the event time elsewhere."""
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
        device, ms = timed_pair(lambda: ncf_score_all_items(*args))
        plain_device, plain_ms = timed_pair(lambda: ncf_score_plain(*args))
        bound_ms, bound_by, nbytes, ops, bound_f32_ms = b3_bound(items, embed, *hidden)
        reported = "device_ms" if (items, embed, tuple(hidden)) == (
            NCF_TRAIN_ITEMS, NCF_E, NCF_HIDDEN) else "ms"
        row = {"items": items, "embed": embed, "hidden": list(hidden),
               "ms": ms, "device_ms": device, "plain_ms": plain_ms,
               "plain_device_ms": plain_device, "reported": reported,
               "bound_ms": bound_ms, "bound_by": bound_by, "bound_f32_ms": bound_f32_ms,
               "bytes": nbytes, "operations": ops,
               "fraction_of_bound": bound_ms / (device if reported == "device_ms" else ms)}
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
    the first ``NCF_TRAIN_RATINGS`` of the ALS phase's 20M ratings (the
    full tables), through NCFPreparator -> NCFAlgorithm.train on cuda;
    epochs cut 5 -> 1."""
    import torch

    from predictionio_tpu_torch.controller.base import TrainContext
    from predictionio_tpu_torch.models.ncf import NCFAlgorithm, NCFPreparator
    from predictionio_tpu_torch.models.ncf.model import NeuMF
    from predictionio_tpu_torch.models.recommendation import RatingsData

    users, items, values, times = (a[:NCF_TRAIN_RATINGS] for a in ratings)
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
    server, service = build_query_server(engine_json, model_dir, port=0, device="cuda",
                                         batching=unbatched())
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
        service.close()
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


def phase_serve_ncf_wide(rng: np.random.Generator, seed: int, repo: str, workdir: str) -> list:
    """NeuMF models at two wide widths (E=64, hidden 256, 128 and 1600,
    800), random weights from ``seed``, 27,000 items, each saved,
    deployed through the ``deploy`` code path on cuda with an engine.json
    of its width, and asked for the top 10 of known users over HTTP: each
    answer 200 through B3 (launches counted from 0 before the queries) and
    each list the plain head's on the card up to near-ties."""
    return [serve_ncf_width(rng, seed, repo, workdir, embed, hidden)
            for embed, hidden in NCF_SERVED_WIDE]


def serve_ncf_width(rng: np.random.Generator, seed: int, repo: str, workdir: str,
                    embed: int, hidden) -> dict:
    from predictionio_tpu_torch.models.ncf import kernel as ncf_kernel
    from predictionio_tpu_torch.models.ncf import model_from_state, save_model
    from predictionio_tpu_torch.models.ncf.kernel import head_tensors, ncf_score_plain

    items = NCF_TRAIN_ITEMS
    state = random_ncf_state(NCF_WIDE_USERS, items, embed, hidden, seed)
    seen_users = np.repeat(np.arange(NCF_WIDE_USERS), 20)
    seen_items = rng.integers(0, items, seen_users.size)
    model = model_from_state(state, [f"u{u}" for u in range(NCF_WIDE_USERS)],
                             [f"i{i}" for i in range(items)], seen_users, seen_items)
    model_dir = os.path.join(workdir, f"ncf_wide_{embed}_{hidden[0]}")
    save_model(model, model_dir)
    with open(ncf_engine(repo)[0]) as f:
        variant = json.load(f)
    variant["algorithms"][0]["params"].update({"embedDim": embed, "hidden": list(hidden)})
    engine_json = os.path.join(workdir, f"ncf_wide_{embed}_{hidden[0]}_engine.json")
    with open(engine_json, "w") as f:
        json.dump(variant, f)
    picked = rng.choice(NCF_WIDE_USERS, size=NCF_WIDE_QUERIES, replace=False)
    queries = [{"user": f"u{u}", "num": 10} for u in picked]
    before = ncf_kernel.ncf_score_all_items.launches     # counts start here
    served, deployed, deploy_s = serve_model(engine_json, model_dir, queries,
                                             batching=unbatched())
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
    event set read from the store (``import``ed into an app of a fresh
    store), and ``deploy`` of the engine instance it recorded."""
    from predictionio_tpu_torch.models.ncf import kernel as ncf_kernel

    engine_json, _ = ncf_engine(repo)
    events = os.path.join(workdir, "ncf_events.jsonl")
    n_events, user = small_events(rng, events)
    with fresh_store(workdir, "ncf_store"):
        t0 = time.perf_counter()
        variant, _ = store_train("NcfApp", engine_json, events,
                                 os.path.join(workdir, "ncf_small.json"))
        verb_s = time.perf_counter() - t0
        before = ncf_kernel.ncf_score_all_items.launches
        served, small, _ = serve_model(variant, None, [{"user": user, "num": 5}],
                                       batching=unbatched())
    launches = ncf_kernel.ncf_score_all_items.launches - before
    if len(served[0]["itemScores"]) != 5 or user not in small.user_index or launches < 2:
        raise AssertionError(f"the trained small NCF model answered {served[0]} "
                             f"with {launches} B3 launches (warm-up and query)")
    result = {"events": n_events, "read_from": "store", "train_verb_s": verb_s,
              "b3_launches": launches, "epochs": small.config.epochs}
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
    the training shape and Ulysses' local shape (``SEQ_ULYSSES_SHAPE``)
    with the packed rows' own masks, with random right padding
    (serving's prefixes) and with left padding; every listed
    T x D, causal and not, with a fully-masked batch row and left-padded
    rows; head dims 24 and 136 (padded), 128 and 256 at T 64 and 1024,
    and 512 at T 200; then 20 SASRec steps at embedDim 48 / 2 heads (D =
    24) and at 256 / 1 (D = 256) through the kernels against the same
    steps through the plain versions."""
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
    for heads, tag in ((h, ""), (SEQ_ULYSSES_SHAPE[1], "_ulysses_local")):
        for name, (mask, dead) in masks.items():
            for causal in (True, False):
                errs = compare_flash(*flash_inputs(gen, b, heads, t, d, mask), causal,
                                     dead if causal else ())
                cases += 1
                emit({"phase": "check_flash", "case": name + tag, "shape": [b, t, heads, d],
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
    shapes = [(t, d) for t in FLASH_PADDED_T for d in FLASH_PADDED_D]
    for t, d in shapes + [(FLASH_WIDE_T, FLASH_WIDE_D)]:
        pads = (0, t // 3, t)
        mask = torch.from_numpy(np.arange(t)[None] >= np.asarray(pads)[:, None])
        for causal in (True, False):
            dead = [(1, t // 3), (2, t)] if causal else [(2, t)]
            errs = compare_flash(*flash_inputs(gen, 3, 2, t, d, mask), causal, dead)
            cases += 1
            for k, e in errs.items():
                worst[k] = max(worst.get(k, 0.0), e)
                padded[f"{k}_d{d}"] = max(padded.get(f"{k}_d{d}", 0.0), e)
        torch.cuda.empty_cache()
    emit({"phase": "check_flash", "case": "head_dims", "t": list(FLASH_PADDED_T),
          "d": list(FLASH_PADDED_D), "wide": [FLASH_WIDE_T, FLASH_WIDE_D],
          "max_abs_err": padded})
    # SASRec at head dims 24 (embedDim 48, 2 heads; zero-padded to 32) and
    # 256 (embedDim 256, 1 head; the chunked instances): 20 steps through
    # B4 and the fused backward against the plain versions, from the same
    # seeded init
    params = seq["variant"]["algorithms"][0]["params"]
    prepared = seq["prepared"]
    loss_diffs = {}
    for embed, heads in SEQ_PADDED_WIDTHS:
        config = SASRecConfig(
            num_items=TRAIN_ITEMS, max_len=prepared.matrix.shape[1], embed_dim=embed,
            num_heads=heads, num_blocks=params.get("numBlocks", 2),
            ffn_dim=params.get("ffnDim", 64), learning_rate=params.get("learningRate", 1e-3),
            batch_size=params.get("batchSize", 256), epochs=1, seed=params.get("seed", 0))
        part = prepared.matrix[: SEQ_PLAIN_STEPS * config.batch_size]
        before = flash_counts()
        _, kernel_losses = train_sasrec(config, part, "cuda", log_every=1)
        launched = {k: n - before[k] for k, n in flash_counts().items()}
        head_dim = embed // heads
        if launched != {k: config.num_blocks * SEQ_PLAIN_STEPS for k in FLASH_KERNELS}:
            raise AssertionError(f"head dim {head_dim} steps launched {launched}")
        with plain_flash():
            _, plain_losses = train_sasrec(config, part, "cuda", log_every=1)
        diff = float(np.abs(np.asarray(kernel_losses) - np.asarray(plain_losses)).max())
        if len(kernel_losses) != SEQ_PLAIN_STEPS or diff > 1e-4:
            raise AssertionError(f"{len(kernel_losses)} head-dim-{head_dim} steps through the "
                                 f"kernels differ from the plain versions by {diff} > 1e-4")
        emit({"phase": "check_flash", "case": f"sasrec_head_dim_{head_dim}", "embed": embed,
              "heads": heads, "steps": SEQ_PLAIN_STEPS, "launches": launched,
              "kernel_vs_plain_max_loss_diff": diff})
        loss_diffs[f"d{head_dim}"] = diff
    return {"max_abs_err": worst, "cases": cases, "padded_max_abs_err": padded,
            "sasrec_loss_diff": loss_diffs}


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


def chunked_extra_ops(kernel: str, b: int, h: int, t: int, d: int, pairs: int) -> float:
    """Operations the chunked instances (head dims past 128) do beyond
    ``flash_bound``'s count: each of the D / 64 chunk blocks of a tile
    forms the whole S (B4) or S, dP and delta (the fused backward), so
    every further chunk adds 2 D a pair (B4), 4 D a pair and 2 D a row
    (the backward), D the padded head dim. 0 at D <= 128."""
    from predictionio_tpu_torch.ops.flash_attention import HEAD_DIM_CHUNK, built_head_dim

    dp = built_head_dim(d)
    if dp <= 128:
        return 0.0
    further = dp // HEAD_DIM_CHUNK - 1
    if kernel == "flash_forward":
        return float(further * 2 * dp * pairs * h)
    return float(further * (4 * dp * pairs * h + 2 * dp * b * h * t))


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
    again at head dims 24 (padded), 128 and 256 (the chunked instances,
    their extra operations beside); beside each kernel's bound."""
    import torch
    import torch.nn.functional as F

    from predictionio_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = []
    for name, (b, h, t, d) in (("train", SEQ_TRAIN_SHAPE), ("long", SEQ_LONG_SHAPE),
                               ("train_d24", SEQ_TRAIN24_SHAPE),
                               ("long_d128", SEQ_LONG128_SHAPE),
                               ("long_d256", SEQ_LONG256_SHAPE)):
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
            extra = chunked_extra_ops(kernel, b, h, t, d, pairs)
            lib_ms, lib_call_ms = library["fwd" if kernel == "flash_forward" else "bwd"]
            row["kernels"][kernel] = {
                "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                "plain_call_ms": plain_call_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes": nbytes, "operations": ops, "fraction_of_bound": bound_ms / ms,
                "library_ms": lib_ms, "library_call_ms": lib_call_ms,
                # the chunked instances' recomputed S (and dP, delta), not in the bound
                "chunked_extra_operations": extra,
                "chunked_extra_ms_at_roof": extra / F32_3XTF32_OPS_PER_S * 1e3,
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
    20M-event sequences (epochs cut to ``SEQ_TRAIN_EPOCHS``) through
    SASRecAlgorithm.train on cuda, B4 and the
    fused backward counted; then the quality and kernel-against-plain
    checks."""
    import torch

    from predictionio_tpu_torch.controller.base import TrainContext
    from predictionio_tpu_torch.models.sequence import SASRecAlgorithm
    from predictionio_tpu_torch.models.sequence.model import train_sasrec

    variant, prepared = seq["variant"], seq["prepared"]
    algorithm = SASRecAlgorithm(dict(variant["algorithms"][0]["params"],
                                     epochs=SEQ_TRAIN_EPOCHS), device="cuda")
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
        service.close()
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


def phase_serve_seq_wide(seed: int, repo: str, workdir: str) -> dict:
    """A random SASRec at embedDim 256 / 1 head (head dim 256: B4's
    chunked instance) over the 27,000 items, its init from ``seed`` and
    random histories, saved, deployed through the ``deploy`` code path on
    cuda with an engine.json of that width and asked for the top 10 of
    known users over HTTP: each answer 200 through B4 (launches counted
    from 0 before the queries, less the deploy's warm-up: numBlocks a
    query) and each list the plain path's on the card up to near-ties."""
    from predictionio_tpu_torch.models.sequence import (
        SASRecConfig,
        model_from_state,
        save_model,
        score_next_items,
    )
    from predictionio_tpu_torch.models.sequence.model import init_model

    rng = np.random.default_rng(seed)
    _, variant = sequence_engine(repo)
    params = variant["algorithms"][0]["params"]
    embed, heads = SEQ_PADDED_WIDTHS[-1]
    config = SASRecConfig(num_items=TRAIN_ITEMS, max_len=variant["preparator"]["params"]["maxLen"],
                          embed_dim=embed, num_heads=heads,
                          num_blocks=params.get("numBlocks", 2), ffn_dim=params.get("ffnDim", 64),
                          seed=seed)
    state = init_model(config).state_dict()
    lengths = rng.integers(2, config.max_len + 1, SEQ_WIDE_USERS)
    histories = {f"u{u}": rng.integers(1, TRAIN_ITEMS + 1, n) for u, n in enumerate(lengths)}
    model = model_from_state(state, config, [f"i{i}" for i in range(TRAIN_ITEMS)], histories)
    model_dir = os.path.join(workdir, "seq_wide")
    save_model(model, model_dir)
    variant["algorithms"][0]["params"].update({"embedDim": embed, "numHeads": heads})
    engine_json = os.path.join(workdir, "seq_wide_engine.json")
    with open(engine_json, "w") as f:
        json.dump(variant, f)
    picked = rng.choice(SEQ_WIDE_USERS, size=SEQ_WIDE_QUERIES, replace=False)
    queries = [{"user": f"u{u}", "num": 10} for u in picked]
    before = flash_counts()["flash_forward"]            # counts start here
    served, deployed, deploy_s = serve_model(engine_json, model_dir, queries)
    blocks = deployed.config.num_blocks
    launches = flash_counts()["flash_forward"] - before - blocks  # less the warm-up's
    if launches != blocks * len(queries):
        raise AssertionError(f"{launches} B4 launches for {len(queries)} head-dim-{embed} "
                             f"queries of {blocks} blocks")
    net = deployed.network("cuda")
    for q, body in zip(queries, served):
        prefix = deployed.histories[q["user"]]
        with plain_flash():
            plain = score_next_items(net, prefix).astype(np.float64)
        plain[list({int(i) - 1 for i in prefix})] = -np.inf
        check_seq_list(body, plain,
                       SEQ_SCORE_TOL * max(1.0, float(np.abs(plain[np.isfinite(plain)]).max())))
    result = {"embed": embed, "heads": heads, "head_dim": embed // heads,
              "users": SEQ_WIDE_USERS, "items": TRAIN_ITEMS, "queries": len(queries),
              "launches": {"flash_forward": launches}, "deploy_s": deploy_s}
    emit({"phase": "serve_seq_wide", **result})
    return result


def phase_train_verb_seq(rng: np.random.Generator, repo: str, workdir: str) -> dict:
    """The ``train`` verb with the sequence template's engine.json on a
    small event set read from the store, and ``deploy`` of the engine
    instance it recorded."""
    engine_json, _ = sequence_engine(repo)
    events = os.path.join(workdir, "seq_events.jsonl")
    n_events, user = small_events(rng, events)
    with fresh_store(workdir, "seq_store"):
        before = flash_counts()
        t0 = time.perf_counter()
        variant, _ = store_train("SeqApp", engine_json, events,
                                 os.path.join(workdir, "seq_small.json"))
        verb_s = time.perf_counter() - t0
        trained = {k: n - before[k] for k, n in flash_counts().items()}
        if min(trained["flash_forward"], trained["flash_backward"]) < 1:
            raise AssertionError(f"the train verb's flash launches: {trained}; B4 and the "
                                 "fused backward must launch")
        before = flash_counts()["flash_forward"]
        served, small, _ = serve_model(variant, None, [{"user": user, "num": 5}])
    launches = flash_counts()["flash_forward"] - before
    if len(served[0]["itemScores"]) != 5 or user not in small.histories or launches < 4:
        raise AssertionError(f"the trained small SASRec model answered {served[0]} "
                             f"with {launches} B4 launches (warm-up and query)")
    result = {"events": n_events, "read_from": "store", "users": len(small.histories),
              "train_verb_s": verb_s,
              "train_launches": trained, "serve_b4_launches": launches,
              "epochs": small.config.epochs}
    emit({"phase": "train_verb_seq", **result})
    return result


def flash_rows(check: dict, timed: dict, train_launches: dict, serve_launches: int,
               eval_launches: dict, profile_launches: dict, template_launches: dict) -> list:
    """The ``{"kernels": [...]}`` rows of B4 and the fused backward: times
    at the training shape, the other timed shapes beside them; launches on the
    training path (B4 also on the serving path), on the evaluation path,
    on the profiled fit and on the templates part."""
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
            "eval_path_launches": eval_launches[name],
            "profile_train_launches": profile_launches[name],
            "templates_launches": template_launches[name],
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
                                  "library_ms", "chunked_extra_operations",
                                  "chunked_extra_ms_at_roof")}} for o in other],
        })
    rows[0]["serve_launches"] = serve_launches
    rows[1]["also_replaces"] = "predictionio_tpu/ops/flash_attention.py:148"
    return rows


# --------------------------------------------------------------------------
# bench_tools: the six tools/*_bench.py tools of the port on the card
# --------------------------------------------------------------------------

#: train_bench's depth cut: 50,000 events of its 2,000,000, and of the
#: refresh identity's 200,000 (the sqlite populates run on the host at
#: ~15,000 events/s; 200,000 and the identity's own before the pio_check
#: phase, 100,000 before the dase_engine phase)
BENCH_TRAIN_EVENTS = 50_000
#: serving_bench's depth cut: 480 requests of its 960 a client pool
BENCH_SERVING_REQUESTS = 480
#: eval_bench past its defaults: at 192 items the catalog is the 512-item
#: shortlist and the guard's mips arm skips stage 1 (B2), as in the
#: reference; 2,048 items (4 genres of 512) put B2 on the guard's path
BENCH_EVAL_WIDE = {"events": 16_000, "users": 320, "items": 2_048}


@contextlib.contextmanager
def counted_calls(module, name: str, key, into: dict):
    """Wrap ``module.name`` so each call adds its B1 and B2 launches to
    ``into[key(args, kwargs)]``; the wrapped function runs as it was."""
    from predictionio_tpu_torch.ops import als_gram, mips

    original = getattr(module, name)

    def wrapper(*args, **kwargs):
        b1, b2 = als_gram.gram_rhs.launches, mips.mips_block_topk.launches
        try:
            return original(*args, **kwargs)
        finally:
            tally = into.setdefault(key(args, kwargs), {"b1": 0, "b2": 0})
            tally["b1"] += als_gram.gram_rhs.launches - b1
            tally["b2"] += mips.mips_block_topk.launches - b2

    setattr(module, name, wrapper)
    try:
        yield into
    finally:
        setattr(module, name, original)


def bench_tool(name: str, card: str, run, split=None) -> dict:
    """One tool's run with B1's and B2's counts set to 0 just before and
    read just after; ``split`` (module, function name, key) also counts
    B1 by each key of that function's calls (``b1_arms``). Prints the
    tool's line and returns it."""
    from predictionio_tpu_torch.ops import als_gram, mips

    arms: dict = {}
    als_gram.gram_rhs.launches = mips.mips_block_topk.launches = 0
    t0 = time.perf_counter()
    with counted_calls(*split, arms) if split else contextlib.nullcontext():
        report = run()
    line = {"phase": "bench_tools", "tool": name, "seconds": time.perf_counter() - t0,
            "b1_launches": als_gram.gram_rhs.launches,
            "b2_launches": mips.mips_block_topk.launches, "nvidia_smi": card,
            "report": report}
    if split:
        line["b1_arms"] = {key: tally["b1"] for key, tally in arms.items()}
    emit(line)
    return line


def phase_bench_tools(card: str, workdir: str) -> dict:
    """The port's six ``tools/*_bench.py`` tools, each through its main
    ``run_*`` on the card at the tool's own widths (``train_bench``'s
    events cut to ``BENCH_TRAIN_EVENTS``), each gated by the reference's
    own checks:

    - ingest_bench ``run_ab`` (32 clients x 50 events, sync vs WAL group
      commit): every event stored in both arms, and the SIGKILL crash
      cycle 0 lost, 0 duplicated, 0 misrouted, the second replay a no-op;
    - train_bench ``run_ab``: both extraction passes see every edge, and
      the refreshed snapshot's CSR equals the cold rebuild bit for bit;
    - eval_bench ``run_eval_quality`` at its defaults and at
      ``BENCH_EVAL_WIDE``: recall@10 and response identity of the
      scan-vs-mips guard 1.0 in both, B1 > 0 in both, B2 > 0 in the wide
      run (at the defaults the catalog is its own shortlist);
    - als_stream_bench ``run_ab`` at rank 16 and 1,500,000 edges:
      streamed factors equal to the resident ones (its
      ``factors_equivalent``), B1 in each arm (``als_fit_streamed``
      counted apart: ``b1_arms``, the rest is the resident arm's);
    - retrain_bench ``run_ab``: no load or ingest error, no probe timed
      out, B1 in the fold-in arm and in the full-retrain arm;
    - serving_bench ``run_ab("recommendation")`` (rank 64, 100,000 items,
      32 clients x ``BENCH_SERVING_REQUESTS``): no failed request, responses identical
      or equivalent across batching off and on, B1 > 0 (the training).
    Each tool's line carries its report, its seconds, its B1 and B2
    launches and the card's name and power limit."""
    from predictionio_tpu_torch.parallel import als
    from predictionio_tpu_torch.tools import (
        als_stream_bench,
        eval_bench,
        ingest_bench,
        retrain_bench,
        serving_bench,
        train_bench,
    )

    started = time.perf_counter()
    tools: dict = {}

    line = bench_tool("ingest_bench", card, lambda: ingest_bench.run_ab(
        workdir=os.path.join(workdir, "ingest")))
    rep, crash = line["report"], line["report"]["crash_cycle"]
    total = rep["clients"] * rep["events_per_client"]
    if (rep["sync"]["stored"] != total or rep["wal"]["stored"] != total
            or rep["sync"]["failures"] or rep["wal"]["failures"]):
        raise AssertionError(f"ingest_bench stored or failed: {rep}")
    if (crash["lost"] or crash["duplicated"] or crash["misrouted"]
            or crash["second_replay_records"] or crash["second_replay_delta"]
            or not crash["exactly_once"] or crash["acked"] < 200):
        raise AssertionError(f"ingest_bench crash cycle: {crash}")
    tools["ingest_bench"] = line

    line = bench_tool("train_bench", card, lambda: train_bench.run_ab(
        events=BENCH_TRAIN_EVENTS, identity_events=BENCH_TRAIN_EVENTS,
        workdir=os.path.join(workdir, "train")))
    rep = line["report"]
    if not (rep["edges_match"] and rep["cold"]["edges"] == BENCH_TRAIN_EVENTS
            and rep["refresh_identity"]["bit_identical"]):
        raise AssertionError(f"train_bench: {rep}")
    tools["train_bench"] = line

    for label, kwargs in (("eval_bench", {}), ("eval_bench_wide", BENCH_EVAL_WIDE)):
        line = bench_tool(label, card, lambda: eval_bench.run_eval_quality(
            workdir=os.path.join(workdir, label), **kwargs))
        rep = line["report"]
        if (rep["mips_recall_at_10"] != 1.0 or rep["response_identity_rate"] != 1.0
                or not line["b1_launches"] or rep["holdout_users"] <= 0):
            raise AssertionError(f"{label}: {line}")
        tools[label] = line
    if not tools["eval_bench_wide"]["b2_launches"]:
        raise AssertionError("eval_bench: the guard's mips arm never launched B2 past "
                             f"the shortlist: {tools['eval_bench_wide']}")

    line = bench_tool("als_stream_bench", card, lambda: als_stream_bench.run_ab(
        edges=1_500_000, rank=16), split=(als, "als_fit_streamed", lambda a, k: "streamed"))
    rep = line["report"]
    streamed = line["b1_arms"].get("streamed", 0)
    if not (rep["factors_equivalent"] and streamed > 0
            and line["b1_launches"] - streamed > 0):
        raise AssertionError(f"als_stream_bench: B1 in each arm, equal factors: {line}")
    tools["als_stream_bench"] = line

    line = bench_tool("retrain_bench", card, lambda: retrain_bench.run_ab(
        workdir=os.path.join(workdir, "retrain")),
        split=(retrain_bench, "_measure_arm", lambda a, k: a[0]))
    rep = line["report"]
    for arm in ("foldin", "full_retrain"):
        if (rep[arm]["load_errors"] or rep[arm]["ingest_load_errors"]
                or rep[arm]["timeouts"] or not rep[arm]["load_requests"]):
            raise AssertionError(f"retrain_bench {arm}: {rep[arm]}")
    if not (line["b1_arms"].get("fold", 0) > 0 and line["b1_arms"].get("full", 0) > 0
            and rep["foldin"]["cycles"]["foldin"] > 0
            and rep["full_retrain"]["cycles"]["full_retrain"] > 0):
        raise AssertionError(f"retrain_bench: B1 or cycles missing: {line}")
    tools["retrain_bench"] = line

    line = bench_tool("serving_bench", card, lambda: serving_bench.run_ab(
        "recommendation", concurrency=32, requests=BENCH_SERVING_REQUESTS))
    rep = line["report"]
    for arm in ("batching_off", "batching_on"):
        if rep[arm]["failures"] or rep[arm]["requests_ok"] != BENCH_SERVING_REQUESTS:
            raise AssertionError(f"serving_bench {arm}: {rep[arm]}")
    if not ((rep["responses_identical"] or rep["responses_equivalent"])
            and rep["items"] == 100_000 and line["b1_launches"]):
        raise AssertionError(f"serving_bench: {line}")
    tools["serving_bench"] = line

    result = {"seconds": {name: t["seconds"] for name, t in tools.items()},
              "b1_launches": {name: t["b1_launches"] for name, t in tools.items()},
              "b2_launches": {name: t["b2_launches"] for name, t in tools.items()},
              "serving": {arm: {k: tools["serving_bench"]["report"][arm][k]
                                for k in ("qps", "p50_ms", "p99_ms")}
                          for arm in ("batching_off", "batching_on")},
              "nvidia_smi": card, "phase_s": time.perf_counter() - started}
    emit({"phase": "bench_tools_summary", **result})
    return result


#: the check phase's subprocesses' time limit (each sweeps the package)
CHECK_TIMEOUT_S = 300


def check_process(repo: str, args: list[str], importtime: bool = False) -> dict:
    """One ``python3 [-X importtime] -m predictionio_tpu_torch.tools.cli
    ARGS`` process from the checkout's root: its exit code, standard
    output, wall seconds and, under ``-X importtime``, the top-level
    modules it imported (read off its standard error)."""
    cmd = [sys.executable, *(["-X", "importtime"] if importtime else []),
           "-m", "predictionio_tpu_torch.tools.cli", *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                          timeout=CHECK_TIMEOUT_S)
    out = {"rc": proc.returncode, "stdout": proc.stdout,
           "seconds": time.perf_counter() - t0}
    if importtime:
        out["imported"] = {
            line.rsplit("|", 1)[-1].strip().split(".")[0]
            for line in proc.stderr.splitlines() if line.startswith("import time:")}
    if proc.returncode != 0:
        out["stderr"] = proc.stderr[-4000:]
    return out


def phase_check(card: str, repo: str) -> dict:
    """``pio check`` on the port, on the host: the static analysis
    (``predictionio_tpu_torch/analysis/``) sweeps ``predictionio_tpu_torch/``
    on this machine's Python and its ``ast``, through the console a user
    calls. ``check --format json`` runs under ``-X importtime`` (its
    imports are the evidence that the verb loads neither torch nor jax)
    and ``check --self-check`` after it, each a process of its own; a
    third process times the sweep by rule family
    (``check_paths(timings=...)``: parse, package index, C, R, P). Every
    kernel's count is set to 0 before and read after: the path launches
    none. Gated: both exit 0, no unsuppressed finding, no stale baseline
    entry, torch and jax never imported."""
    started = time.perf_counter()
    from predictionio_tpu_torch.models.ncf import kernel as ncf_kernel
    from predictionio_tpu_torch.ops import als_gram, mips

    als_gram.gram_rhs.launches = mips.mips_block_topk.launches = 0
    ncf_kernel.ncf_score_all_items.launches = 0
    zero_flash_counts()
    report = check_process(repo, ["check", "--format", "json"], importtime=True)
    self_check = check_process(repo, ["check", "--self-check"])
    timed = subprocess.run(
        [sys.executable, "-c",
         "import json, time\n"
         "from predictionio_tpu_torch.analysis.engine import check_paths\n"
         "t = {}\n"
         "t0 = time.perf_counter()\n"
         "n = len(check_paths(timings=t))\n"
         "t['sweep_s'] = time.perf_counter() - t0\n"
         "print(json.dumps({'findings': n, **t}))\n"],
        cwd=repo, capture_output=True, text=True, timeout=CHECK_TIMEOUT_S)
    launches = kernel_counts()
    for what, run in (("check", report), ("check --self-check", self_check)):
        if run["rc"] != 0:
            raise AssertionError(f"pio {what} exited {run['rc']}: "
                                 f"{run['stdout'][-4000:]} {run.get('stderr', '')}")
    if timed.returncode != 0:
        raise AssertionError(f"the timed sweep failed: {timed.stderr[-4000:]}")
    doc = json.loads(report["stdout"])
    timings = json.loads(timed.stdout.strip().splitlines()[-1])
    heavy = sorted(report["imported"] & {"torch", "jax", "jaxlib", "triton"})
    line = {"phase": "pio_check", "rc": report["rc"], "self_check_rc": self_check["rc"],
            "self_check": self_check["stdout"].strip().splitlines()[-1],
            "findings": doc["analysis_findings_total"],
            "suppressed": len(doc["suppressed"]), "stale": len(doc["stale_baseline"]),
            "check_s": report["seconds"], "self_check_s": self_check["seconds"],
            "sweep_s": timings["sweep_s"], "raw_findings": timings["findings"],
            "timings_s": {"parse": timings["parse"], "index": timings["index"],
                          **timings["families"]},
            "torch_imported": "torch" in report["imported"],
            "jax_imported": "jax" in report["imported"],
            "launches": launches, "nvidia_smi": card,
            "phase_s": time.perf_counter() - started}
    emit(line)
    if doc["analysis_findings_total"] or doc["stale_baseline"] or doc["findings"]:
        raise AssertionError(f"pio check: unsuppressed or stale: {doc['findings']} "
                             f"{doc['stale_baseline']}")
    if timings["findings"] != len(doc["suppressed"]):
        raise AssertionError(f"the timed sweep found {timings['findings']}, the check "
                             f"{len(doc['suppressed'])}")
    if heavy:
        raise AssertionError(f"pio check imported {heavy}")
    if any(launches.values()):
        raise AssertionError(f"pio check launched a kernel: {launches}")
    return line


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dist-worker", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.dist_worker is not None:
        return dist_worker(json.loads(args.dist_worker))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    from predictionio_tpu_torch import _kernels, native
    from predictionio_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")  # TF32 off for the plain versions' products too
    t0 = time.perf_counter()
    _kernels.build_all()
    ptxas = [
        line.strip() for log in _kernels.build_logs.values() for line in log.splitlines()
        if any(x in line for x in ("registers", "spill", "entry function"))
    ]
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.load()  # the host packer (g++); a failed build raises
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas,
          "native_packer_s": time.perf_counter() - t0})

    repo = os.path.dirname(os.path.abspath(__file__))
    phase_check(card, repo)
    rng = np.random.default_rng(args.seed)
    stage1 = phase_check_and_time(rng)
    with pack_routes_of("serve"), tempfile.TemporaryDirectory() as workdir:
        serve = phase_serve(rng, workdir)
        fabric = phase_serve_fabric(rng, workdir)
    with pack_routes_of("train"):
        trained = phase_train(rng, repo)
    phase_pack_compare(trained["ratings"])
    with pack_routes_of("train_checks"):
        with tempfile.TemporaryDirectory() as workdir:
            profiled = phase_profile_train(trained, repo, workdir)
        b1_check = phase_check_b1(rng, trained)
        b1_time = phase_time_b1(rng, trained, b1_check)
        emit({"phase": "half_step_transfer", "transfer_s": b1_time["transfer_s"]})
        phase_foldin(rng, trained)
        with tempfile.TemporaryDirectory() as workdir:
            phase_train_verb_and_serve(rng, trained, repo, workdir)
    stream_root = tempfile.TemporaryDirectory()
    with pack_routes_of("store_follow_eval"), tempfile.TemporaryDirectory() as workdir:
        store = phase_store_path(rng, repo, workdir)
        # store_path's store as it stands, for the stream path's twin train
        shutil.copytree(os.path.join(workdir, "store"),
                        os.path.join(stream_root.name, "ml_store"))
        follow = phase_follow_path(rng, repo, workdir)
        evaluated = phase_eval_path(rng, repo, workdir)
        quickstart = phase_quickstart(repo, workdir)
        dase = phase_dase_engine(repo, workdir)
    b1_launches = trained["result"]["launches"]["gram_rhs"]
    ratings = trained["ratings"]
    resident = {"user_factors": trained["model"].als.user_factors,
                "item_factors": trained["model"].als.item_factors,
                "iteration_s_median": trained["result"]["iteration_s_median"]}
    del trained
    with pack_routes_of("templates_stream"), tempfile.TemporaryDirectory() as workdir:
        templates = phase_templates(rng, ratings, repo, workdir)
        streamed = phase_stream_path(ratings, resident, store, templates, repo, workdir,
                                     stream_root.name, args.seed)
    with pack_routes_of("dist_train"), tempfile.TemporaryDirectory() as workdir:
        dist = phase_dist_train_path(ratings, store, repo, workdir,
                                     stream_root.name, args.seed)
    stream_root.cleanup()
    del resident
    with pack_routes_of("dist_models"):
        seq = phase_seq_data(ratings, repo)
        with tempfile.TemporaryDirectory() as workdir:
            dist_models = phase_dist_models_path(ratings, seq, repo, workdir, args.seed)
    with pack_routes_of("classification"), tempfile.TemporaryDirectory() as workdir:
        classification = phase_classification(rng, args.seed, repo, workdir)
        dist_classify = phase_dist_classify_path(classification.pop("handoff"), workdir,
                                                 args.seed)

    with pack_routes_of("ncf"):
        b3_check = phase_check_b3(args.seed)
        b3_time = phase_time_b3(args.seed)
        ncf_trained = phase_train_ncf(rng, ratings, repo)
        with tempfile.TemporaryDirectory() as workdir:
            ncf_serve = phase_serve_ncf(rng, ncf_trained, repo, workdir)
            phase_serve_ncf_wide(rng, args.seed, repo, workdir)
            phase_train_verb_ncf(rng, repo, workdir)
        del ncf_trained

    del ratings
    with pack_routes_of("sequence"):
        flash_check = phase_check_flash(args.seed, seq)
        flash_time = phase_time_flash(args.seed, seq)
        seq_trained = phase_train_seq(seq)
        with tempfile.TemporaryDirectory() as workdir:
            seq_serve = phase_serve_seq(rng, seq_trained, repo, workdir)
            phase_serve_seq_wide(args.seed, repo, workdir)
            phase_train_verb_seq(rng, repo, workdir)
    with pack_routes_of("bench_tools"), tempfile.TemporaryDirectory() as workdir:
        bench = phase_bench_tools(card, workdir)
    emit({"phase": "packs", "parts": PACKS})

    main_shape = next(s for s in stage1["shapes"]
                      if s["batch"] == 256 and s["block_topk"] == BLOCK_TOPK)
    b1_main = next(s for s in b1_time["shapes"]
                   if s["side"] == "users" and s["dtype"] == "float32")
    b3_main = next(s for s in b3_time["shapes"] if s["items"] == NCF_SERVE_ITEMS)
    rows = [{
        "name": "mips_block_topk",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/mips_topk.cu",
        "replaces": "predictionio_tpu/ops/mips.py:129",
        "launches": serve["launches"]["mips_block_topk"],
        "store_path_launches": store["b2_launches"],
        "follow_path_launches": follow["b2_launches"],
        "eval_path_launches": {part: evaluated[part]["b2_launches"]
                               for part in ("replay", "pinned", "batchpredict")},
        "templates_launches": templates["b2_launches"],
        "profile_train_launches": profiled["launches"]["mips_block_topk"],
        "stream_path_launches": streamed["b2_launches"],
        "dist_train_launches": dist["b2_launches"],
        "bench_tools_launches": bench["b2_launches"],
        "batchpredict_chunk": {k: evaluated["batchpredict"]["b2_chunk"][k] for k in (
            "batch", "items", "rank", "block_items", "block_topk", "instance", "ms",
            "plain_ms", "library_pair_ms", "bound_ms", "bound_by", "max_abs_err")},
        "serve_fabric_launches": {
            deploy: fabric[deploy]["b2_launches"]
            for deploy in ("unbatched", "batched", "multiproc", "sharded")},
        "serve_fabric_flushes": fabric["batched"]["flushes"],
        "max_abs_err": stage1["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes a per-tile top-R "
                        "of an int8-dequantized product; library_pair_ms is "
                        "two calls (torch.matmul against the table dequantized "
                        "once, then torch.topk per tile), for information",
        "library_pair_ms": main_shape["library_pair_ms"],
        "shape": {k: main_shape[k] for k in ("batch", "items", "rank", "block_items",
                                             "block_topk", "instance")},
        "other_shapes": [
            {k: s[k] for k in ("batch", "bucket", "rank", "block_items", "block_topk",
                               "instance", "ms", "ms_r1", "plain_ms", "library_pair_ms",
                               "bound_ms", "bound_by", "search_recall_at_10") if k in s}
            for s in stage1["shapes"] + stage1["wide_shapes"] if s is not main_shape
        ],
    }, {
        "name": "gram_rhs",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/als_gram.cu",
        "replaces": "predictionio_tpu/ops/als_gram.py:86",
        "launches": b1_launches,
        "store_path_launches": store["b1_launches"],
        "follow_path_launches": follow["b1_launches"],
        "eval_path_launches": evaluated["b1_launches"],
        "templates_launches": templates["b1_launches"],
        "profile_train_launches": profiled["launches"]["gram_rhs"],
        "stream_path_launches": streamed["b1_launches"],
        "dist_train_launches": dist["b1_launches"],
        "bench_tools_launches": bench["b1_launches"],
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
        "gather_l2_bytes": b1_main["gather_l2_bytes"],
        "other_shapes": [
            {k: s[k] for k in ("side", "rank", "dtype", "ms", "plain_ms", "bound_ms", "bound_by")}
            for s in b1_time["shapes"] + b1_time["wide_shapes"] if s is not b1_main
        ],
        "fit_rank128_s": {"fused": b1_time["fit"]["fused_s"], "xla": b1_time["fit"]["xla_s"]},
    }, {
        "name": "ncf_score_all_items",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/ncf_score.cu",
        "replaces": "predictionio_tpu/models/ncf/kernel.py:32",
        "launches": ncf_serve["launches"]["ncf_score_all_items"],
        "eval_path_launches": evaluated["b3_launches"],
        "templates_launches": templates["other_launches"]["ncf_score_all_items"],
        "profile_train_launches": profiled["launches"]["ncf_score_all_items"],
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
        "device_ms": b3_main["device_ms"],
        "bound_f32_ms": b3_main["bound_f32_ms"],
        "other_shapes": [
            {k: s[k] for k in ("items", "embed", "hidden", "ms", "device_ms", "reported",
                               "plain_ms", "plain_device_ms", "bound_ms", "bound_by",
                               "bound_f32_ms")}
            for s in b3_time["shapes"] if s is not b3_main
        ],
    }] + flash_rows(flash_check, flash_time, seq_trained["result"]["launches"],
                    seq_serve["launches"]["flash_forward"], evaluated["flash_launches"],
                    profiled["launches"], templates["other_launches"])
    for row in rows:
        row["classification_launches"] = classification["launches"][row["name"]]
        row.setdefault("stream_path_launches", streamed["other_launches"].get(row["name"]))
        row.setdefault("dist_train_launches", dist["other_launches"].get(row["name"]))
        row["dist_models_launches"] = dist_models["launches"][row["name"]]
        row["dist_classify_launches"] = dist_classify["launches"][row["name"]]
        row["quickstart_launches"] = quickstart["launches"][row["name"]]
        row["dase_engine_launches"] = dase["launches"][row["name"]]
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
