"""The port's ``pio batchpredict`` against the JAX package's, on the CPU.

Each package trains an instance on its own store of the same events
(ALS, ``retrieval: {"mode": "mips"}`` over a catalog past 512 items, so
the plain twin of B2 runs stage 1), then scores one query file through
``run_batch_predict``: the same queries come back in order, each
prediction equal to the reference's up to near-ties (scores within
1e-4). The port's rows equal its own deployed ``/queries.json`` bodies.
A malformed query yields an error row and leaves its chunk's other rows
scored; a device failure, or a kernel wrapper's refusal, fails the run
instead of filling a chunk with error rows.
"""

import json

import pytest

from predictionio_tpu.data import storage as jax_storage
from predictionio_tpu.workflow.batch_predict import run_batch_predict as jax_batch_predict
from predictionio_tpu.workflow.core_workflow import run_train as jax_run_train
from predictionio_tpu.workflow.json_extractor import load_engine_variant as jax_load_variant
from predictionio_tpu_torch.models.recommendation import ALSAlgorithm
from predictionio_tpu_torch.ops import mips
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.workflow import batch_predict
from predictionio_tpu_torch.workflow.batch_predict import run_batch_predict
from predictionio_tpu_torch.workflow.core_workflow import run_train
from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant
from test_torch_eval import ALS, same_ranking, stores, variant_obj  # noqa: F401
from test_torch_store_train import _serve, basedir, write_json  # noqa: F401
from test_torch_leakwatch import port_span_watch, port_span_watch_session  # noqa: F401

QUERIES = (
    [{"user": f"u{u}", "num": 10} for u in range(0, 120, 3)]
    + [{"user": "u1", "num": 5, "blackList": ["i1", "i2"]},
       {"user": "u2", "num": 4, "unseenOnly": False},
       {"user": "ghost", "num": 3},
       {"items": ["i5", "i9"], "num": 6}]
)


def write_lines(path, rows) -> str:
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    return str(path)


def read_lines(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture()
def trained(stores, tmp_path):  # noqa: F811
    """``(engine_json, use)``: an instance trained by each package on its
    own store; ``use(name)`` points the registries at that store."""
    engine_json = write_json(tmp_path / "engine.json", variant_obj(**ALS))
    stores("jax")
    jax_run_train(jax_load_variant(engine_json))
    stores("port")
    run_train(load_engine_variant(engine_json), device="cpu")
    return engine_json, stores


def test_batch_predict_equals_the_reference(trained, tmp_path):
    engine_json, use = trained
    queries = write_lines(tmp_path / "queries.jsonl", QUERIES)
    use("jax")
    assert jax_batch_predict(jax_load_variant(engine_json), queries,
                             str(tmp_path / "want.jsonl")) == len(QUERIES)
    use("port")
    assert run_batch_predict(load_engine_variant(engine_json), queries,
                             str(tmp_path / "got.jsonl"), device="cpu") == len(QUERIES)
    got, want = read_lines(tmp_path / "got.jsonl"), read_lines(tmp_path / "want.jsonl")
    assert [r["query"] for r in got] == [r["query"] for r in want] == QUERIES
    for g, w in zip(got, want):
        assert "error" not in g and "error" not in w
        same_ranking(g["prediction"]["itemScores"], w["prediction"]["itemScores"])
    assert sum(bool(r["prediction"]["itemScores"]) for r in got) == len(QUERIES) - 1


def test_rows_equal_the_deployed_bodies(trained, tmp_path, capsys):
    """Through the verb: each row's prediction is the body the port's own
    deploy of the instance answers."""
    engine_json, use = trained
    use("port")
    queries = write_lines(tmp_path / "queries.jsonl", QUERIES)
    out = tmp_path / "out.jsonl"
    assert cli.main(["batchpredict", "--variant", engine_json, "--input", queries,
                     "--output", str(out), "--device", "cpu"]) == 0
    assert f"{len(QUERIES)} queries" in capsys.readouterr().out
    rows = read_lines(out)
    served = _serve(engine_json, QUERIES)
    assert [status for status, _ in served] == [200] * len(QUERIES)
    assert [r["prediction"] for r in rows] == [body for _, body in served]


def test_a_malformed_query_is_an_error_row(trained, tmp_path, monkeypatch):
    engine_json, use = trained
    use("port")
    monkeypatch.setattr(batch_predict, "_CHUNK", 4)
    rows = QUERIES[:3] + [{"num": 3}] + QUERIES[3:6]
    out = tmp_path / "out.jsonl"
    run_batch_predict(load_engine_variant(engine_json),
                      write_lines(tmp_path / "queries.jsonl", rows), str(out), device="cpu")
    got = read_lines(out)
    assert [r["query"] for r in got] == rows
    assert "user' or 'items" in got[3]["error"]
    assert all("prediction" in r for i, r in enumerate(got) if i != 3)
    clean = tmp_path / "clean.jsonl"
    run_batch_predict(load_engine_variant(engine_json),
                      write_lines(tmp_path / "clean_q.jsonl", QUERIES[:3] + QUERIES[3:6]),
                      str(clean), device="cpu")
    assert [r for i, r in enumerate(got) if i != 3] == read_lines(clean)


def test_a_device_failure_fails_the_run(trained, tmp_path, monkeypatch):
    """A kernel error is not a malformed query: the run raises instead of
    writing a chunk of error rows."""
    engine_json, use = trained
    use("port")

    def launch_fails(*args, **kwargs):
        raise RuntimeError("mips_block_topk launch failed with CUDA error 700")

    monkeypatch.setattr(ALSAlgorithm, "batch_predict", launch_fails)
    monkeypatch.setattr(ALSAlgorithm, "predict", launch_fails)
    out = tmp_path / "out.jsonl"
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        run_batch_predict(load_engine_variant(engine_json),
                          write_lines(tmp_path / "queries.jsonl", QUERIES), str(out),
                          device="cpu")
    assert read_lines(out) == []


def test_a_kernel_refusal_fails_the_run(trained, tmp_path, monkeypatch):
    """A kernel wrapper's ValueError (a batch past the grid, a shape it has
    no instance for) is no malformed query either: the run raises and
    writes no error row."""
    engine_json, use = trained
    use("port")
    calls = []

    def refused(*args, **kwargs):
        calls.append(1)
        raise ValueError("batch 5000 exceeds the kernel grid's 4096 rows")

    monkeypatch.setattr(mips, "mips_block_topk", refused)
    out = tmp_path / "out.jsonl"
    with pytest.raises(ValueError, match="kernel grid"):
        run_batch_predict(load_engine_variant(engine_json),
                          write_lines(tmp_path / "queries.jsonl", QUERIES), str(out),
                          device="cpu")
    assert calls
    assert not any("error" in row for row in read_lines(out))
