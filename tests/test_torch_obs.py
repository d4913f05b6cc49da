"""The port's observability layer against the JAX package's, on the CPU.

- ``pio train --profile``: both packages train the same variant on the
  same events with ``pio.profile``; the port's ALS telemetry journal has
  the reference's lines (``meta`` first, one ``step`` per iteration) with
  the same edge count, bytes model and keys, ``recompile_count`` aside
  (the port compiles nothing per shape). The port writes a Chrome trace
  (``*.pt.trace.json``) where the reference writes an xplane, with one
  ``als.iteration`` range per iteration; a minibatch template writes an
  epoch journal. The counterpart of reference
  ``tests/test_obs.py:1010-1076``.
- ``obs/logs.py``: ``JsonLogFormatter`` lines equal the reference's, and
  ``--log-format`` is on the four service verbs.
- ``obs/top.py``: ``parse_prometheus``, ``compute_stats`` and ``render``
  equal the reference's on captured snapshots, and ``run_top`` renders a
  live port query server on the CPU.
"""

import glob
import json
import logging
import threading

import pytest

from predictionio_tpu.obs import logs as jax_logs
from predictionio_tpu.obs import top as jax_top
from predictionio_tpu.obs.trace import Tracer as JaxTracer
from predictionio_tpu.workflow.core_workflow import run_train as jax_run_train
from predictionio_tpu.workflow.json_extractor import load_engine_variant as jax_load_variant
from predictionio_tpu_torch.controller.base import TrainContext
from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.obs import logs, top
from predictionio_tpu_torch.obs.telemetry import TrainTelemetry
from predictionio_tpu_torch.obs.trace import Tracer
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.workflow.core_workflow import run_train
from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant
from test_torch_eval import ALS, stores, variant_obj  # noqa: F401
from test_torch_store_train import basedir, write_json  # noqa: F401
from test_torch_leakwatch import port_span_watch, port_span_watch_session  # noqa: F401


def journal(path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_als_journal_equals_the_reference(stores, tmp_path):  # noqa: F811
    engine_json = write_json(tmp_path / "engine.json",
                             variant_obj(**dict(ALS, numIterations=3)))
    stores("jax")
    jax_variant = jax_load_variant(engine_json)
    jax_variant.runtime_conf["pio.profile"] = str(tmp_path / "jax-prof")
    jax_run_train(jax_variant)
    stores("port")
    variant = load_engine_variant(engine_json)
    variant.runtime_conf["pio.profile"] = str(tmp_path / "port-prof")
    instance = run_train(variant, device="cpu")
    want = journal(tmp_path / "jax-prof" / "als-telemetry.jsonl")
    got = journal(tmp_path / "port-prof" / "als-telemetry.jsonl")
    assert len(got) == len(want) == 4
    strip = lambda line: {k: v for k, v in line.items() if k != "ts"}
    assert strip(got[0]) == strip(want[0])  # meta: edges, bytes model, run shape
    assert got[0]["edges"] > 0 and got[0]["solver"] == "xla"
    for g, w in zip(got[1:], want[1:]):
        assert set(g) == set(w) - {"recompile_count"}
        assert g["event"] == "step" and g["step"] == w["step"]
        assert g["edges_per_sec"] > 0 and g["achieved_gbps"] > 0
    assert [g["step"] for g in got[1:]] == [0, 1, 2]
    # the instance recorded the profile dir in its runtime conf, as the
    # reference's does
    assert json.loads(json.dumps(
        storage.get_meta_data_engine_instances().get(instance.id).runtime_conf
    ))["pio.profile"] == str(tmp_path / "port-prof")


def test_run_train_profile_writes_a_chrome_trace_and_journal(stores, tmp_path):  # noqa: F811
    """``pio.profile`` on the CPU: a loadable Chrome trace of the
    training call with one ``als.iteration`` range per iteration, and
    the journal with one step line per iteration."""
    stores("port")
    engine_json = write_json(tmp_path / "engine.json",
                             variant_obj(**dict(ALS, numIterations=2)))
    variant = load_engine_variant(engine_json)
    profile_dir = tmp_path / "prof"
    variant.runtime_conf["pio.profile"] = str(profile_dir)
    instance = run_train(variant, device="cpu")
    assert instance.status == "COMPLETED"
    (trace_path,) = glob.glob(f"{profile_dir}/*.pt.trace.json")
    assert trace_path.endswith(f"{instance.id}.pt.trace.json")
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("name") == "als.iteration" and e.get("ph") == "X"]
    assert len(ranges) == 2
    assert not [e for e in events if e.get("cat") == "kernel"]  # CPU activity only
    steps = [s for s in journal(profile_dir / "als-telemetry.jsonl") if s["event"] == "step"]
    assert len(steps) == 2
    assert all("edges_per_sec" in s and "achieved_gbps" in s for s in steps)


def test_minibatch_templates_write_an_epoch_journal(stores, tmp_path):  # noqa: F811
    stores("port")
    ncf = {"embedDim": 4, "hidden": [8, 4], "epochs": 2, "batchSize": 512,
           "implicit": True, "checkpoint": False}
    engine_json = write_json(tmp_path / "engine.json", variant_obj("ncf", **ncf))
    variant = load_engine_variant(engine_json)
    variant.runtime_conf["pio.profile"] = str(tmp_path / "prof")
    run_train(variant, device="cpu")
    lines = journal(tmp_path / "prof" / "ncf-telemetry.jsonl")
    assert lines[0]["event"] == "meta" and lines[0]["name"] == "ncf"
    epochs = [line for line in lines if line["event"] == "step"]
    assert [e["step"] for e in epochs] == [0, 1]
    assert all(e["unit"] == "epoch" and e["steps"] > 0 and "loss" in e for e in epochs)
    phases = [line["phase"] for line in lines if line["event"] == "phase"]
    assert phases == ["negative_sampling", "permutation", "permutation"]
    assert glob.glob(f"{tmp_path}/prof/*.pt.trace.json")


def test_journal_methods(tmp_path):
    with TrainTelemetry(str(tmp_path / "t.jsonl"), edges=1000,
                        modeled_bytes_per_iter=2e9) as tel:
        step = tel.record_step(0, 0.5)
        epoch = tel.record_epoch(1, 0.25, [0.5, 1.5])
        phase = tel.record_phase("permutation", 0.125, 77)
    assert step == {"event": "step", "step": 0, "wall_s": 0.5, "edges_per_sec": 2000.0,
                    "achieved_gbps": 4.0, "ts": step["ts"]}
    assert epoch["loss"] == 1.0 and epoch["steps"] == 2 and epoch["edges_per_sec"] == 4000.0
    assert phase["rows"] == 77 and phase["phase"] == "permutation"
    assert [line["event"] for line in journal(tmp_path / "t.jsonl")] == [
        "meta", "step", "step", "phase"]


def test_each_trainer_owns_its_journal(tmp_path):
    """``TrainContext.journal``: the caller's telemetry when it gave one,
    none on an un-profiled run, else ``<profile>/<name>-telemetry.jsonl``
    with the trainer's fields, closed when the fit ends."""
    given = object()
    with TrainContext(telemetry=given).journal("als") as tel:
        assert tel is given
    with TrainContext(device="cpu").journal("als") as tel:
        assert tel is None
    ctx = TrainContext(device="cpu", runtime_conf={"pio.profile": str(tmp_path)})
    with ctx.journal("sasrec", lambda: {"edges": 10, "meta": {"rank": 4}}) as tel:
        tel.record_epoch(0, 0.5, [1.0, 3.0])
    assert tel._f is None            # closed
    meta, epoch = journal(tmp_path / "sasrec-telemetry.jsonl")
    assert meta["event"] == "meta" and meta["edges"] == 10
    assert (meta["name"], meta["platform"], meta["rank"]) == ("sasrec", "cpu", 4)
    assert epoch["event"] == "step" and epoch["loss"] == 2.0


def test_train_profile_cli_flag(tmp_path):
    parser = cli.build_parser()
    assert parser.parse_args(["train", "--profile"]).profile == "__default__"
    assert parser.parse_args(["train", "--profile", "/tmp/x"]).profile == "/tmp/x"
    assert parser.parse_args(["train"]).profile is None


def test_train_verb_profile_default_dir(stores, tmp_path, capsys):  # noqa: F811
    stores("port")
    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    write_json(engine_dir / "engine.json", variant_obj(**dict(ALS, numIterations=2)))
    assert cli.main(["train", "--engine-dir", str(engine_dir), "--profile",
                     "--device", "cpu"]) == 0
    assert "Engine instance ID" in capsys.readouterr().out
    assert glob.glob(f"{engine_dir}/pio-profile/*.pt.trace.json")
    assert (engine_dir / "pio-profile" / "als-telemetry.jsonl").exists()


# --------------------------------------------------------------------------
# structured logs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("level, under_span, exc", [
    (logging.INFO, True, False), (logging.WARNING, False, False), (logging.ERROR, True, True)])
def test_json_log_lines_equal_the_reference(level, under_span, exc):
    try:
        raise ValueError("boom")
    except ValueError:
        import sys

        info = sys.exc_info() if exc else None
    record = logging.LogRecord("pio.test", level, __file__, 1, "hello %s", ("world",), info)
    ours, theirs = logs.JsonLogFormatter(), jax_logs.JsonLogFormatter()
    if under_span:
        # the two packages' tracers keep separate context stacks
        with Tracer().span("op") as sp, JaxTracer().span("op") as jsp:
            got, want = json.loads(ours.format(record)), json.loads(theirs.format(record))
        assert got["trace_id"] == sp.trace_id and want["trace_id"] == jsp.trace_id
        for obj in (got, want):
            obj.pop("trace_id"), obj.pop("span_id")
    else:
        got, want = json.loads(ours.format(record)), json.loads(theirs.format(record))
        assert "trace_id" not in got
    assert got == want


def test_configure_logging_json_and_reset():
    root = logging.getLogger()
    prior_handlers, prior_level = root.handlers[:], root.level
    try:
        logs.configure_logging("json")
        assert len(root.handlers) == 1
        assert isinstance(root.handlers[0].formatter, logs.JsonLogFormatter)
        with pytest.raises(ValueError):
            logs.configure_logging("xml")
    finally:
        root.handlers[:] = prior_handlers
        root.setLevel(prior_level)


@pytest.mark.parametrize("verb", ["eventserver", "train", "deploy", "retrain"])
def test_log_format_on_the_service_verbs(verb):
    parser = cli.build_parser()
    assert parser.parse_args([verb, "--log-format", "json"]).log_format == "json"
    assert parser.parse_args([verb]).log_format == "text"
    with pytest.raises(SystemExit):
        parser.parse_args([verb, "--log-format", "xml"])


# --------------------------------------------------------------------------
# pio top
# --------------------------------------------------------------------------

PROM = """\
# TYPE pio_http_requests_total counter
pio_http_requests_total{method="POST",route="/queries.json",status="200"} %d
pio_http_requests_total{method="POST",route="/queries.json",status="429"} %d
# TYPE pio_http_request_duration_seconds histogram
pio_http_request_duration_seconds_bucket{route="/queries.json",le="0.001"} %d
pio_http_request_duration_seconds_bucket{route="/queries.json",le="0.01"} %d
pio_http_request_duration_seconds_bucket{route="/queries.json",le="+Inf"} %d
# TYPE pio_ingest_queue_depth gauge
pio_ingest_queue_depth 5
# TYPE pio_serving_batch_size histogram
pio_serving_batch_size_sum %d
pio_serving_batch_size_count %d
pio_frontend_workers 2
pio_scorer_shard_count 4
pio_model_version{shard="0"} 7
pio_model_version{shard="1"} 6
label_escape{path="a\\"b\\\\c"} 1
"""


def _snap(module, t, values, traces=None):
    return {"url": "http://x:1", "time": t,
            "metrics": module.parse_prometheus(PROM % values), "traces": traces}


def test_top_pieces_equal_the_reference():
    first, second = (100, 2, 50, 90, 102, 400, 40), (160, 5, 80, 150, 165, 900, 90)
    traces = {"slowest": [{"name": "query", "duration_ms": 12.5, "trace_id": "ab" * 16}]}
    for module in (top, jax_top):
        assert module.parse_prometheus(PROM % first) == jax_top.parse_prometheus(PROM % first)
    got = top.compute_stats(_snap(top, 10.0, first), _snap(top, 12.0, second, traces))
    want = jax_top.compute_stats(_snap(jax_top, 10.0, first),
                                 _snap(jax_top, 12.0, second, traces))
    assert got == want and got["qps"] > 0
    assert top.render([got], [_snap(top, 12.0, second, traces)]) == jax_top.render(
        [want], [_snap(jax_top, 12.0, second, traces)])


def test_run_top_against_a_live_port_server(stores, tmp_path):  # noqa: F811
    """One frame of ``pio top`` over a query server of the port on the
    CPU, with traffic between the polls."""
    import http.client

    stores("port")
    engine_json = write_json(tmp_path / "engine.json",
                             variant_obj(**dict(ALS, numIterations=2)))
    run_train(load_engine_variant(engine_json), device="cpu")
    server, service = cli.build_query_server(engine_json, port=0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    stop = threading.Event()

    def traffic():
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=30)
        while not stop.is_set():
            conn.request("POST", "/queries.json", body=b'{"user": "u1", "num": 3}')
            conn.getresponse().read()
        conn.close()

    client = threading.Thread(target=traffic, daemon=True)
    client.start()
    frames = []
    try:
        top.run_top([url], interval=0.5, iterations=1, clear=False, out=frames.append)
    finally:
        stop.set()
        client.join(timeout=30)
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    (frame,) = frames
    row = next(line for line in frame.splitlines() if url in line)
    assert float(row.split()[1]) > 0  # qps of the traffic between the polls
    assert "P50" in frame.upper()


def test_top_verb_parses():
    args = cli.build_parser().parse_args(["top", "http://a:1", "--iterations", "1",
                                          "--no-clear", "--interval", "0.1"])
    assert args.urls == ["http://a:1"] and args.iterations == 1 and args.no_clear
    assert cli.build_parser().parse_args(["top"]).urls == ["http://localhost:8000"]
