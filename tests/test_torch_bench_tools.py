"""The port's ``tools/*_bench.py`` tools against the JAX package's, on the CPU.

- The code: the functions the port keeps as they are equal the
  reference's after the package rename; the others differ only by the
  device they are handed (``device="cpu"`` here).
- The synthetic streams: event for event (or array for array) the
  reference's for the same seed, and ``_percentile`` /
  ``_responses_equivalent`` answer the same inputs the same way.
- The reports: at the same toy arguments each port ``run_*`` returns
  exactly the reference's keys, nested keys included.
- The values: eval's NDCG and hit rate within 1e-4 of the JAX run, both
  with a scan-vs-mips recall and identity of 1.0 (the reference's
  ``tests/test_eval.py:576`` bar); retrain's quality arms within the
  same 1e-4; the port's pack equal to the reference's bit for bit
  (``als_data_identical`` empty); the streamed-ALS transfer model equal
  to the reference's exactly with identical arms; the crash cycle 0 lost
  and 0 duplicated (``tests/test_ingest.py:546-580``); ``run_load``
  against a port server and ``run_sharded_ab`` at 2 shards on the CPU.
- The device: every tool that trains or serves raises without a card
  unless asked for the CPU, and the load client imports no torch.
"""

import ast
import datetime as dt
import importlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from predictionio_tpu.data import storage as jax_storage
from predictionio_tpu_torch.data import storage
from test_torch_leakwatch import port_span_watch, port_span_watch_session  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("ingest_bench", "train_bench", "eval_bench", "als_stream_bench", "retrain_bench",
         "serving_bench")


def _tool(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.tools.{name}")


def port(name: str):
    return _tool("predictionio_tpu_torch", name)


def ref(name: str):
    return _tool("predictionio_tpu", name)


@pytest.fixture()
def stores(tmp_path, monkeypatch):
    """Both registries on ``tmp_path``; the tools point them elsewhere
    themselves (``ingest_bench._Env``) and put them back."""
    for key in [k for k in os.environ if k.startswith(("PIO_STORAGE_", "PIO_SNAPSHOT"))]:
        monkeypatch.delenv(key)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    storage.reset()
    jax_storage.reset()
    yield tmp_path
    storage.reset()
    jax_storage.reset()


def keys(report) -> object:
    """The nested key structure of a report (values dropped)."""
    if isinstance(report, dict):
        return {k: keys(v) for k, v in report.items()}
    return None


# -- the code ------------------------------------------------------------------

#: functions each tool keeps as the reference wrote them
VERBATIM = {
    "ingest_bench": ["_event_obj", "_Env", "_drive", "_stored_count", "run_ab", "run_sweep",
                     "_crash_child", "main"],
    "train_bench": ["_populate", "_two_pass", "als_data_identical", "run_ab"],
    "eval_bench": ["_engine_json", "_populate"],
    "als_stream_bench": ["chunked_synthetic_source", "_materialize", "_config", "peak_rss_mb"],
    "retrain_bench": ["_engine_json", "_populate", "_timed_events", "_ingest_one",
                      "_post_query"],
    "serving_bench": ["_percentile", "run_load", "_responses_equivalent", "_ingest_synthetic",
                      "_concurrent_bodies", "_sequential_bodies", "_scorer_gauges",
                      "_set_blas_threads"],
}


def _defs(source: str) -> dict:
    lines = source.splitlines()
    return {node.name: "\n".join(lines[node.lineno - 1:node.end_lineno])
            for node in ast.parse(source).body
            if isinstance(node, (ast.FunctionDef, ast.ClassDef))}


def _sources(name: str) -> tuple[str, str]:
    with open(os.path.join(REPO, "predictionio_tpu", "tools", f"{name}.py")) as f:
        original = re.sub(r"\bpredictionio_tpu\b", "predictionio_tpu_torch", f.read())
    with open(os.path.join(REPO, "predictionio_tpu_torch", "tools", f"{name}.py")) as f:
        return original, f.read()


@pytest.mark.parametrize("name,fn", [(n, f) for n, fns in VERBATIM.items() for f in fns])
def test_kept_functions_equal_the_references(name, fn):
    original, copy = _sources(name)
    assert _defs(copy)[fn] == _defs(original)[fn]


@pytest.mark.parametrize("name", TOOLS)
def test_each_tool_has_the_references_functions_and_names_it(name):
    """Every function of the reference's module is the port's, and the
    port's docstring names the reference module."""
    original, copy = _sources(name)
    assert set(_defs(copy)) == set(_defs(original))
    doc = " ".join(ast.get_docstring(ast.parse(copy)).split())
    assert f"``predictionio_tpu/tools/{name}.py``" in doc


def test_engine_factories_resolve_to_the_ports_templates():
    from predictionio_tpu_torch.workflow.json_extractor import resolve_engine_factory

    serving = port("serving_bench")
    assert {n: resolve_engine_factory(s["factory"]).__module__
            for n, s in serving.AB_ENGINES.items()} == {
        n: f"predictionio_tpu_torch.models.{n}.engine" for n in ("recommendation", "ncf")}
    assert serving.AB_ENGINES["ncf"]["algorithms"][0]["params"]["usePallas"] is False
    assert {n: {k: v for k, v in s.items() if k != "factory"}
            for n, s in serving.AB_ENGINES.items()} == {
        n: {k: v for k, v in s.items() if k != "factory"}
        for n, s in ref("serving_bench").AB_ENGINES.items()}


# -- the synthetic streams -------------------------------------------------------

class _Capture:
    """An ``LEvents`` stand-in: what ``batch_insert`` was handed."""

    def __init__(self):
        self.events = []

    def batch_insert(self, events, app_id):
        self.events.extend(events)


def _event_rows(events, times: bool = True) -> list:
    rows = []
    for e in events:
        obj = e.to_json_obj()
        obj.pop("eventId", None)
        obj.pop("creationTime", None)
        if not times:
            obj.pop("eventTime")
        rows.append(obj)
    return rows


@pytest.mark.parametrize("implicit", [True, False])
def test_chunked_synthetic_source_equals_the_references(implicit):
    got = port("als_stream_bench").chunked_synthetic_source(10_000, 300, 120, seed=3,
                                                            chunk_rows=3_000, implicit=implicit)
    want = ref("als_stream_bench").chunked_synthetic_source(10_000, 300, 120, seed=3,
                                                            chunk_rows=3_000, implicit=implicit)
    chunks = list(zip(got(), want()))
    assert len(chunks) == 4
    for g, w in chunks:
        for a, b in zip(g[:3], w[:3]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert g[3] is None and w[3] is None


@pytest.mark.parametrize("tool,args", [
    ("train_bench", (900, 40, 15)),
    ("eval_bench", (700, 30, 64)),
])
def test_populate_streams_equal_the_references(tool, args):
    got, want = _Capture(), _Capture()
    port(tool)._populate(got, *args)
    ref(tool)._populate(want, *args)
    assert len(got.events) == args[0]
    assert _event_rows(got.events) == _event_rows(want.events)


def test_retrain_streams_equal_the_references():
    got = port("retrain_bench")._timed_events(500, 20, 10)
    assert _event_rows(got) == _event_rows(ref("retrain_bench")._timed_events(500, 20, 10))
    got, want = _Capture(), _Capture()
    port("retrain_bench")._populate(got, 500, 20, 10)
    ref("retrain_bench")._populate(want, 500, 20, 10)
    # the live stream's time base is the clock: the same events, the same
    # 13 ms spacing
    assert _event_rows(got.events, times=False) == _event_rows(want.events, times=False)
    for events in (got.events, want.events):
        steps = {(b.event_time - a.event_time) for a, b in zip(events, events[1:])}
        assert steps == {dt.timedelta(milliseconds=13)}


def test_percentile_and_equivalence_answer_as_the_references():
    got, want = port("serving_bench"), ref("serving_bench")
    rng = np.random.default_rng(5)
    for n in (0, 1, 7, 100):
        data = sorted(rng.random(n).tolist())
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert got._percentile(data, q) == want._percentile(data, q)

    def body(items, scores):
        return json.dumps({"itemScores": [{"item": i, "score": s}
                                          for i, s in zip(items, scores)]}).encode()

    pairs = [
        (body("ab", [1.0, 0.5]), body("ab", [1.0, 0.5])),
        (body("ab", [1.0, 0.5]), body("ab", [1.0 + 1e-7, 0.5])),
        (body("ab", [1.0, 0.5]), body("ab", [1.1, 0.5])),
        (body("ab", [1.0, 0.5]), body("ba", [1.0, 0.5])),
        (b"not json", b"other"),
        (b'{"x": 1}', b'{"x": 1}'),
        (b'{"x": 1}', b'{"x": 2}'),
    ]
    for a, b in pairs:
        assert got._responses_equivalent(a, b) == want._responses_equivalent(a, b)


# -- ingest ---------------------------------------------------------------------

def test_ingest_ab_and_sweep_report_the_references_keys(stores):
    reports = {}
    for pkg, mod in (("port", port("ingest_bench")), ("jax", ref("ingest_bench"))):
        ab = mod.run_ab(clients=4, events_per_client=5, crash_events=0,
                        workdir=str(stores / pkg / "ab"))
        sweep = mod.run_sweep(partitions=(1, 2), clients=2, events_per_client=5,
                              workdir=str(stores / pkg / "sweep"))
        reports[pkg] = (ab, sweep)
    assert keys(reports["port"]) == keys(reports["jax"])
    ab, sweep = reports["port"]
    assert ab["sync"]["stored"] == ab["wal"]["stored"] == 20
    assert ab["sync"]["failures"] == ab["wal"]["failures"] == 0
    assert {p: arm["stored"] for p, arm in sweep["partitions"].items()} == {"1": 10, "2": 10}


@pytest.mark.parametrize("partitions", [1, 4])
def test_crash_cycle_is_exactly_once(partitions, stores):
    """SIGKILL the port's crash child mid-stream, replay its WAL: every
    acknowledged event lands once, the second replay changes nothing,
    no frame sits in another partition than its entity's; the report
    has the reference's keys."""
    rep = port("ingest_bench").run_crash_cycle(str(stores / "crash"), min_acked=48,
                                               timeout_s=90.0, partitions=partitions)
    assert rep["acked"] >= 48
    assert rep["lost"] == rep["duplicated"] == rep["misrouted"] == 0
    assert rep["second_replay_records"] == rep["second_replay_delta"] == 0
    assert rep["exactly_once"] is True
    assert len(rep["replayed_per_partition"]) == partitions
    assert set(rep) == {
        "partitions", "acked", "stored_before_replay", "replayed", "replayed_per_partition",
        "stored_after_replay", "lost", "duplicated", "misrouted", "second_replay_records",
        "second_replay_delta", "exactly_once"}


# -- train ----------------------------------------------------------------------

def test_train_bench_equals_the_reference(stores):
    args = dict(events=1500, users=60, items=20, identity_events=900, chunk_rows=256)
    got = port("train_bench").run_ab(workdir=str(stores / "port"), **args)
    want = ref("train_bench").run_ab(workdir=str(stores / "jax"), **args)
    assert keys(got) == keys(want)
    assert got["edges_match"] and got["cold"]["edges"] == 1500
    assert got["refresh_identity"]["bit_identical"]
    assert got["refresh_identity"]["rows_after_refresh"] == \
        want["refresh_identity"]["rows_after_refresh"] == 900 + 225
    assert got["snapshot_build"]["rows"] == want["snapshot_build"]["rows"]


def test_the_ports_pack_is_the_references(stores):
    """The store the identity check reads, packed by both packages: the
    port's one-process pack (``mesh=None``) against the reference's 1 x
    1 mesh, field by field (``als_data_identical`` empty)."""
    from predictionio_tpu.data import storage as jax_registry
    from predictionio_tpu.parallel.als import ALSConfig as JaxConfig
    from predictionio_tpu.parallel.mesh import local_mesh
    from predictionio_tpu.parallel.reader import build_als_data_sharded as jax_build
    from predictionio_tpu.parallel.reader import store_coo_chunks as jax_chunks
    from predictionio_tpu_torch.parallel.als import ALSConfig
    from predictionio_tpu_torch.parallel.reader import build_als_data_sharded, store_coo_chunks

    bench = port("train_bench")
    with bench._Env(str(stores / "store")):
        le = storage.get_l_events()
        le.init_channel(bench.APP_ID)
        bench._populate(le, 2_000, 70, 25, seed=11)
        src, users, items = store_coo_chunks(le, bench.APP_ID, event_names=bench.EVENT_NAMES,
                                             chunk_rows=300)
        got = build_als_data_sharded(src, None, None, ALSConfig(rank=4, buckets=2, max_len=64))
        jax_registry.reset()
        jax_le = jax_registry.get_l_events()
        src, jax_users, jax_items = jax_chunks(jax_le, bench.APP_ID,
                                               event_names=bench.EVENT_NAMES, chunk_rows=300)
        want = jax_build(src, None, None, JaxConfig(rank=4, buckets=2, max_len=64),
                         local_mesh(1, 1))
        jax_registry.reset()
    assert bench.als_data_identical(got, want) == []
    assert users.ids == jax_users.ids and items.ids == jax_items.ids


# -- eval -----------------------------------------------------------------------

def test_eval_bench_equals_the_reference(stores):
    """The reference's toy quality gate (``tests/test_eval.py:576``) on
    both packages: the guard's recall and identity 1.0, NDCG and hit
    rate within 1e-4 of the JAX run."""
    args = dict(events=400, users=16, items=48, rank=4, iterations=2)
    got = port("eval_bench").run_eval_quality(workdir=str(stores / "port"), device="cpu",
                                              **args)
    want = ref("eval_bench").run_eval_quality(workdir=str(stores / "jax"), **args)
    assert keys(got) == keys(want)
    assert got["holdout_users"] == want["holdout_users"] > 0
    for report in (got, want):
        assert report["mips_recall_at_10"] == report["response_identity_rate"] == 1.0
    for key in ("eval_ndcg_at_10", "eval_hit_rate_at_10"):
        assert abs(got[key] - want[key]) <= 1e-4, (key, got[key], want[key])


def test_eval_bench_past_the_shortlist_equals_the_reference(stores, monkeypatch):
    """A catalog past the 512-item shortlist (1,024 items) puts the
    guard's mips arm through stage 1 (B2's wrapper; here its plain
    version), and the report equals the JAX run's: the guard's recall
    and identity, and NDCG and hit rate within 1e-4."""
    from predictionio_tpu_torch.ops import mips

    calls = []
    plain = mips.mips_block_topk_plain
    monkeypatch.setattr(mips, "mips_block_topk_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    args = dict(events=8_000, users=160, items=1_024, rank=8, iterations=2)
    got = port("eval_bench").run_eval_quality(workdir=str(stores / "port"), device="cpu",
                                              **args)
    want = ref("eval_bench").run_eval_quality(workdir=str(stores / "jax"), **args)
    assert calls
    for key in ("mips_recall_at_10", "response_identity_rate", "holdout_users"):
        assert got[key] == want[key], key
    for key in ("eval_ndcg_at_10", "eval_hit_rate_at_10"):
        assert abs(got[key] - want[key]) <= 1e-4, (key, got[key], want[key])


# -- streamed ALS -------------------------------------------------------------

def test_als_stream_ab_equals_the_reference():
    """Resident against streamed at a toy shape: the report's keys, the
    transfer model (bytes a half-step, blocks) equal to the reference's
    exactly, the port's measured host-to-device bytes its model's, and
    its two arms identical."""
    args = dict(edges=20_000, users=500, items=200, rank=8, iterations=2, buckets=2,
                max_len=64)
    got = port("als_stream_bench").run_ab(device="cpu", **args)
    want = ref("als_stream_bench").run_ab(**args)
    assert keys(got) == keys(want)
    assert got["resident"]["reship_bytes_per_half_step"] == \
        want["resident"]["reship_bytes_per_half_step"]
    for key in ("h2d_modeled_bytes_per_half_step", "reship_bytes_per_half_step", "blocks"):
        assert got["streamed"][key] == want["streamed"][key], key
    assert got["streamed"]["h2d_bytes_per_half_step"] == \
        got["streamed"]["h2d_modeled_bytes_per_half_step"]
    assert got["factors_identical"] is True and got["factors_equivalent"] is True


def test_als_stream_scale_runs_one_streamed_epoch(tmp_path):
    """``run_scale`` at 2,000,000 edges (its 100M acceptance size is the
    card's): one streamed epoch over at least two blocks, the measured
    host-to-device bytes the model's."""
    rep = port("als_stream_bench").run_scale(edges=2_000_000, users=20_000, items=4_000,
                                             cache_dir=str(tmp_path), device="cpu")
    assert rep["real_edges"] > 0 and rep["blocks"] >= 2
    assert rep["h2d_bytes_per_half_step"] == rep["h2d_modeled_bytes_per_half_step"]


# -- retrain --------------------------------------------------------------------

def test_retrain_ab_reports_the_references_keys(stores):
    """The freshness A/B at a toy size on both packages: the same report
    keys; on the port every probe became visible with no load error,
    the fold-in arm folded and the full arm retrained."""
    args = dict(events=600, users=30, items=12, rank=4, iterations=2, probes=2,
                load_clients=1)
    got = port("retrain_bench").run_ab(workdir=str(stores / "port"), device="cpu", **args)
    want = ref("retrain_bench").run_ab(workdir=str(stores / "jax"), **args)
    assert keys(got) == keys(want)
    for arm in ("foldin", "full_retrain"):
        assert got[arm]["timeouts"] == got[arm]["load_errors"] == 0, got[arm]
    assert got["foldin"]["cycles"]["foldin"] > 0
    assert got["full_retrain"]["cycles"]["full_retrain"] > 0


def test_retrain_quality_equals_the_reference(stores):
    """Folded against forced-full-retrain on one held-out replay split
    (``tests/test_eval.py:595``): both packages fold one window, and
    each arm's metrics are within 1e-4 of the JAX run's."""
    args = dict(events=900, users=30, items=20, rank=8, iterations=3)
    got = port("retrain_bench").run_quality(workdir=str(stores / "port"), device="cpu", **args)
    want = ref("retrain_bench").run_quality(workdir=str(stores / "jax"), **args)
    assert keys(got) == keys(want)
    assert got["cycles"]["foldin"] == 1 and got["folded_source"] == "foldin"
    assert got["holdout_users"] == want["holdout_users"]
    for arm in ("folded_metrics", "full_retrain_metrics"):
        assert got[arm].keys() == want[arm].keys()
        for key, value in got[arm].items():
            assert abs(value - want[arm][key]) <= 1e-4, (arm, key, value, want[arm][key])
    assert got["ndcg_delta_full_minus_folded"] == pytest.approx(
        got["full_retrain_metrics"]["ndcg_at_10"] - got["folded_metrics"]["ndcg_at_10"],
        abs=1e-6)


# -- serving --------------------------------------------------------------------

SERVING_TOY = dict(concurrency=4, requests=80, users=30, items=400, events=1_500)


@pytest.mark.parametrize("run", ["run_ab", "run_trace_ab"])
def test_serving_ab_reports_the_references_keys(run, stores):
    extra = {"rounds": 1} if run == "run_trace_ab" else {}
    got = getattr(port("serving_bench"), run)("recommendation", device="cpu",
                                              **SERVING_TOY, **extra)
    want = getattr(ref("serving_bench"), run)("recommendation", **SERVING_TOY, **extra)
    assert keys(got) == keys(want)
    assert got["responses_equivalent"] is True
    for arm in [k for k, v in got.items() if isinstance(v, dict)]:
        assert got[arm]["failures"] == 0 and got[arm]["requests_ok"] == 80, got[arm]


def test_run_load_against_a_port_server(stores):
    """The load tool against a served port model (``tests/
    test_server_ops.py:125``): every request of 8 keep-alive clients
    answers 200, with either client, and the report has the
    reference's keys."""
    bench = port("serving_bench")
    with bench._synthetic_deployment("recommendation", 20, 100, 600, "cpu") as (variant, _):
        from predictionio_tpu_torch.workflow.create_server import create_query_server

        thread, service = create_query_server(variant, host="127.0.0.1", port=0, device="cpu")
        thread.start()
        try:
            url = f"http://127.0.0.1:{thread.port}"
            reports = [bench.run_load(url, {"user": "u1", "num": 4}, clients=8, requests=96,
                                      client=client) for client in ("http", "raw")]
        finally:
            thread.stop()
            service.close()
    for rep in reports:
        assert rep["requests_ok"] == 96 and rep["failures"] == 0, rep
        assert rep["p50_ms"] is not None and rep["qps"] > 0
        assert set(rep) == {"clients", "requests_ok", "failures", "p50_ms", "p90_ms", "p99_ms",
                            "qps"}


def test_sharded_ab_at_two_shards(stores):
    """The sharded sweep at 2 shards on the CPU (``tests/
    test_sharding.py:717``): batch-size-1 bodies byte-identical to the
    unsharded server's, coalescing bodies equivalent, no failure."""
    rep = port("serving_bench").run_sharded_ab("recommendation", concurrency=4, requests=80,
                                               shards=(1, 2), users=30, items=300,
                                               events=1_500, device="cpu")
    assert rep["responses_identical"] and rep["responses_equivalent"], rep
    for n in (1, 2):
        assert rep[f"shards_{n}"]["failures"] == 0 and rep[f"shards_{n}"]["qps"] > 0
    assert rep["shards"] == [1, 2] and "qps_speedup_shards_2" in rep


def test_multiproc_sweep(stores):
    """The multi-process sweep at 1 and 2 frontend workers on the CPU:
    batch-size-1 bodies byte-identical across every arm, coalescing
    bodies equivalent, no failure."""
    rep = port("serving_bench").run_multiproc_ab("recommendation", concurrency=8,
                                                 requests=240, workers=(1, 2), users=30,
                                                 items=400, events=1_500, device="cpu")
    assert rep["responses_identical"] and rep["responses_equivalent"], rep
    for label in ("singleproc", "workers_1", "workers_2"):
        assert rep[label]["failures"] == 0, rep[label]


# -- the device ---------------------------------------------------------------

@pytest.mark.parametrize("name,argv", [
    ("eval_bench", []),
    ("als_stream_bench", ["--edges", "1000"]),
    ("als_stream_bench", ["--feed", "scale", "--edges", "1000"]),
    ("retrain_bench", []),
    ("retrain_bench", ["--quality"]),
    ("serving_bench", ["--engine", "recommendation"]),
    ("serving_bench", ["--scorer-shards", "2"]),
    ("serving_bench", ["--frontend-workers", "2"]),
    ("serving_bench", ["--trace-overhead", "--engine", "recommendation"]),
])
def test_main_without_a_card_raises(name, argv, monkeypatch, stores):
    """Each tool that trains or serves runs on the card by default: with
    no card and no ``--device cpu`` its ``main`` raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port(name).main(argv)


@pytest.mark.parametrize("name,argv", [
    ("eval_bench", ["--events", "300", "--users", "12", "--items", "40", "--rank", "4",
                    "--iterations", "1"]),
    ("als_stream_bench", ["--edges", "3000", "--users", "100", "--items", "50",
                          "--iterations", "1", "--max-len", "32"]),
])
def test_main_runs_on_the_cpu_when_asked(name, argv, stores, capsys):
    assert port(name).main(argv + ["--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)


def test_als_feed_env_pins_one_arm(monkeypatch, capsys):
    monkeypatch.setenv("PIO_BENCH_ALS_FEED", "streamed")
    assert port("als_stream_bench").main(["--edges", "3000", "--users", "100", "--items", "50",
                                          "--iterations", "1", "--max-len", "32",
                                          "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["feed"] == "streamed" and "streamed" in rep and "resident" not in rep


def test_the_load_client_imports_no_torch():
    """``_load_in_subprocess`` runs this module's ``--url`` mode: the
    module, and the crash child's module, import no torch."""
    probe = ("import sys\n"
             "import predictionio_tpu_torch.tools.serving_bench\n"
             "import predictionio_tpu_torch.tools.ingest_bench\n"
             "assert 'torch' not in sys.modules, 'torch imported'\n"
             "print('OK')\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr
