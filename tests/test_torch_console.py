"""The port's ``pio`` console against the JAX package's, on the CPU.

Each verb runs through both packages' ``tools/cli.py::main`` on stores
made the same way, and what a user reads is compared:

- text: the whole stdout of ``version``, ``template list``, ``run`` and
  ``build`` of a valid engine directory and of one under a
  ``template.json`` that asks for a newer pio (its warning line
  included); of ``build`` of an invalid engine.json the exit code and
  the ``Error: `` prefix (the reasons name each package's own
  resolution); of ``status`` every line but the accelerator line, the
  first line with the package's name;
- files: ``template get``'s directory, byte for byte;
- JSON: the admin server's ``/cmd/app`` routes and the dashboard's
  ``/evaluation_instances.json`` routes, equal but for ids, access keys
  and times; the dashboard's HTML pages list the same instances;
- the shell's namespace, with the console's start patched out.
"""

import datetime as dt
import json
import os
import subprocess

import pytest
import requests

from predictionio_tpu.data import storage as jax_storage
from predictionio_tpu.data.storage import base as jax_base
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu.tools.adminserver import create_admin_server as jax_admin
from predictionio_tpu.tools.dashboard import create_dashboard as jax_dashboard
from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.tools.adminserver import create_admin_server
from predictionio_tpu_torch.tools.dashboard import create_dashboard
from test_torch_leakwatch import port_span_watch, port_span_watch_session  # noqa: F401

TEMPLATES = ["classification", "ecommerce", "ncf", "recommendation", "sequence",
             "similarproduct", "universal"]


@pytest.fixture()
def stores(tmp_path, monkeypatch):
    """``use(name)`` points both packages' registries at ``tmp_path/name``."""
    for key in [k for k in os.environ if k.startswith(("PIO_STORAGE_", "PIO_SNAPSHOT"))]:
        monkeypatch.delenv(key)

    def use(name: str) -> str:
        path = str(tmp_path / name)
        monkeypatch.setenv("PIO_FS_BASEDIR", path)
        storage.reset()
        jax_storage.reset()
        return path

    yield use
    storage.reset()
    jax_storage.reset()


def both(capsys, *argv) -> tuple[tuple[int, str], tuple[int, str]]:
    """``(exit code, stdout)`` of the JAX package's console, then the port's."""
    out = []
    for main in (jax_cli.main, cli.main):
        code = main(list(argv))
        out.append((code, capsys.readouterr().out))
    return out[0], out[1]


def test_version_equals_the_reference(capsys):
    want, got = both(capsys, "version")
    assert got == want == (0, "0.1.0\n")


def test_no_verb_prints_help_and_exits_2(capsys):
    assert cli.main([]) == 2
    assert "template" in capsys.readouterr().out


def test_template_list_equals_the_reference(capsys):
    want, got = both(capsys, "template", "list")
    assert got == want
    assert got[0] == 0 and all(name in got[1] for name in TEMPLATES)


def tree_bytes(root) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("template", TEMPLATES)
@pytest.mark.parametrize("app_name", [None, "QuickApp"])
def test_template_get_writes_the_references_bytes(template, app_name, tmp_path, capsys):
    app = ["--app-name", app_name] if app_name else []
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    assert jax_cli.main(["template", "get", template, str(jax_dir), *app]) == 0
    assert cli.main(["template", "get", template, str(port_dir), *app]) == 0
    jax_said, port_said = capsys.readouterr().out.splitlines()
    assert port_said == jax_said.replace(str(jax_dir), str(port_dir))
    assert tree_bytes(port_dir) == tree_bytes(jax_dir)
    if app_name:
        with open(port_dir / "engine.json") as f:
            assert json.load(f)["datasource"]["params"]["appName"] == app_name


def test_template_get_refusals_equal_the_reference(tmp_path, capsys):
    target = tmp_path / "notes.txt"
    target.write_text("keep me")
    for argv in (["template", "get", "recommendation", str(target)],
                 ["template", "get", "nope", str(tmp_path / "x")]):
        want, got = both(capsys, *argv)
        assert got == want and got[0] == 1
    assert target.read_text() == "keep me"


@pytest.mark.parametrize("template", ["recommendation", "classification", "ncf"])
def test_build_of_a_valid_engine_equals_the_reference(template, tmp_path, capsys):
    engine_dir = tmp_path / "engine"
    assert cli.main(["template", "get", template, str(engine_dir)]) == 0
    capsys.readouterr()
    want, got = both(capsys, "build", "--engine-dir", str(engine_dir), "--clean")
    assert got == want
    assert got == (0, "Build finished: engine is importable and engine.json is valid.\n")
    code = cli.main(["build", "--engine-dir", str(engine_dir), "--verbose"])
    out = capsys.readouterr().out
    assert code == 0 and f"Template: {template}" in out


def test_build_template_json_version_gate_equals_the_reference(tmp_path, capsys):
    engine_dir = tmp_path / "engine"
    assert cli.main(["template", "get", "recommendation", str(engine_dir)]) == 0
    capsys.readouterr()
    (engine_dir / "template.json").write_text(
        json.dumps({"pio": {"version": {"min": "999.0.0"}}}))
    want, got = both(capsys, "build", "--engine-dir", str(engine_dir))
    assert got == want
    assert got[0] == 0 and "Warning: template.json requires pio >= 999.0.0" in got[1]
    (engine_dir / "template.json").write_text("{not json")
    want, got = both(capsys, "build", "--engine-dir", str(engine_dir))
    assert got == want and "template.json unreadable" in got[1]


@pytest.mark.parametrize("engine_json", [
    '{"engineFactory": "no.such.module"}',
    '{"engineFactory": "no.such.module", "algorithms": [{"name": "als"}]}',
    "{not json",
    None,
])
def test_build_of_an_invalid_engine_fails_as_the_reference(engine_json, tmp_path, capsys):
    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    if engine_json is not None:
        (engine_dir / "engine.json").write_text(engine_json)
    (want_code, want), (code, out) = both(capsys, "build", "--engine-dir", str(engine_dir))
    assert code == want_code == 1
    assert out.startswith("Error: ") and want.startswith("Error: ")
    assert out.count("\n") == want.count("\n") == 1


def test_build_refuses_an_algorithm_of_another_template(tmp_path, capsys):
    engine_dir = tmp_path / "engine"
    assert cli.main(["template", "get", "recommendation", str(engine_dir)]) == 0
    variant = json.loads((engine_dir / "engine.json").read_text())
    variant["algorithms"].append({"name": "ncf", "params": {}})
    (engine_dir / "engine.json").write_text(json.dumps(variant))
    capsys.readouterr()
    assert cli.main(["build", "--engine-dir", str(engine_dir)]) == 1
    assert "Error: the 'recommendation' template's algorithm is 'als'" in (
        capsys.readouterr().out)


@pytest.mark.parametrize("argv", [["hello"], ["--epochs", "5"]])
def test_run_equals_the_reference(argv, tmp_path, capsys):
    script = tmp_path / "main.py"
    script.write_text("import sys\nimport helper\nprint('argv:', sys.argv[1:], helper.X)\n")
    (tmp_path / "helper.py").write_text("X = 7\n")
    want, got = both(capsys, "run", "--engine-dir", str(tmp_path), str(script), *argv)
    assert got == want == (0, f"argv: {argv} 7\n")
    script.write_text("raise SystemExit('stopped')\n")
    want, got = both(capsys, "run", str(script))
    assert got == want and got[0] == 1


def status_lines(text: str) -> list[str]:
    return [line for line in text.splitlines() if not line.startswith("Accelerator:")]


def test_status_equals_the_reference_but_the_accelerator(stores, capsys):
    stores("shared")
    want, got = both(capsys, "status")
    assert got[0] == want[0] == 0
    assert status_lines(got[1]) == [
        line.replace("(predictionio_tpu)", "(predictionio_tpu_torch)")
        for line in status_lines(want[1])]
    assert got[1].splitlines()[-1] == "Storage check OK. Your system is all ready to go."
    # this box has no card: the port says what raises, and no fallback
    assert ("Accelerator: none (no CUDA device) -- train, deploy, retrain, eval and "
            "batchpredict raise unless --device cpu is given") in got[1].splitlines()


class _Probe:
    def __init__(self, stdout):
        self.stdout = stdout


@pytest.mark.parametrize("stdout, line", [
    ("PIO_ACCEL|cuda|1|NVIDIA H100 80GB HBM3\n", "Accelerator: cuda x1 (NVIDIA H100 80GB HBM3)"),
    ("PIO_ACCEL|cuda|4|NVIDIA H100 80GB HBM3\n", "Accelerator: cuda x4 (NVIDIA H100 80GB HBM3)"),
    ("PIO_ACCEL|cuda|0|\n", "Accelerator: none (no CUDA device) -- train, deploy, retrain, "
                            "eval and batchpredict raise unless --device cpu is given"),
    ("Traceback: no torch\n", "Accelerator: probe failed -- train, deploy, retrain, eval "
                              "and batchpredict raise unless --device cpu is given"),
])
def test_status_probe_lines(stdout, line, monkeypatch):
    seen = {}

    def run(argv, **kw):
        seen.update(argv=argv, timeout=kw["timeout"])
        return _Probe(stdout)

    monkeypatch.setenv("PIO_STATUS_PROBE_TIMEOUT_S", "7")
    monkeypatch.setattr(subprocess, "run", run)
    assert cli.accelerator_line() == line
    assert seen["timeout"] == 7.0 and "torch.cuda.device_count()" in seen["argv"][-1]


def test_status_probe_is_bounded(monkeypatch):
    def run(argv, **kw):
        raise subprocess.TimeoutExpired(argv, kw["timeout"])

    monkeypatch.setattr(subprocess, "run", run)
    assert cli.accelerator_line().startswith("Accelerator: probe timed out -- the CUDA")


def test_status_reports_a_broken_store(stores, monkeypatch, capsys):
    stores("shared")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "NOPE")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_NOPE_TYPE", "sqlite")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_NOPE_PATH", "/dev/null/events.db")
    storage.reset()
    jax_storage.reset()
    want, got = both(capsys, "status")
    assert got[0] == want[0] == 1
    assert status_lines(got[1])[1:] == status_lines(want[1])[1:]


# --------------------------------------------------------------------------
# the admin server and the dashboard
# --------------------------------------------------------------------------


def without(obj, keys=("id", "accessKey", "accessKeys", "key", "startTime", "endTime",
                       "traceId")):
    if isinstance(obj, (list, tuple)):
        return [without(x, keys) for x in obj]
    if isinstance(obj, dict):
        return {k: without(v, keys) for k, v in obj.items() if k not in keys}
    return obj


ADMIN_CALLS = [
    ("GET", "/", None), ("POST", "/cmd/app", {"name": "A1", "description": "d"}),
    ("POST", "/cmd/app", {"name": "A2"}), ("POST", "/cmd/app", {"name": "A1"}),
    ("POST", "/cmd/app", {}), ("POST", "/cmd/app", b"{not json"),
    ("GET", "/cmd/app", None), ("GET", "/cmd/app/A1", None), ("GET", "/cmd/app/zzz", None),
    ("DELETE", "/cmd/app/A1/data", None), ("DELETE", "/cmd/app/zzz/data", None),
    ("DELETE", "/cmd/app/A1", None), ("DELETE", "/cmd/app/A1", None),
    ("GET", "/cmd/app/A1", None), ("GET", "/cmd/app", None),
]


def drive(base_url: str, calls) -> list:
    out = []
    for method, path, body in calls:
        kw = {"data": body} if isinstance(body, bytes) else {"json": body}
        r = requests.request(method, base_url + path, timeout=30, **kw)
        out.append((r.status_code, r.headers["Content-Type"], r.json()))
    return out


def test_admin_server_answers_as_the_reference(stores):
    answers = {}
    for name, create in (("jax", jax_admin), ("port", create_admin_server)):
        stores(name)
        svc = create(host="127.0.0.1", port=0).start()
        try:
            answers[name] = drive(f"http://127.0.0.1:{svc.port}", ADMIN_CALLS)
        finally:
            svc.stop()
    assert without(answers["port"]) == without(answers["jax"])
    assert [a[0] for a in answers["port"]] == [
        200, 201, 201, 409, 400, 400, 200, 200, 404, 200, 404, 200, 404, 404, 200]
    listed = answers["port"][6][2]
    assert [(a["name"], a["id"], len(a["accessKeys"])) for a in listed] == [
        ("A1", 1, 1), ("A2", 2, 1)]
    assert answers["port"][1][2]["accessKey"] == listed[0]["accessKeys"][0]


def fill_instances(base_module, registry) -> list[str]:
    """Two evaluation instances (one finished) and two engine instances,
    the same fields in either package's store."""
    when = dt.datetime(2024, 3, 1, 12, 0, tzinfo=dt.timezone.utc)
    evals = registry.get_meta_data_evaluation_instances()
    ids = [
        evals.insert(base_module.EvaluationInstance(
            status=base_module.STATUS_COMPLETED, evaluation_class="my.Eval<1>",
            engine_params_generator_class="my.Gen", start_time=when,
            end_time=when + dt.timedelta(minutes=3), evaluator_results="score 0.9",
            evaluator_results_html="<pre>score 0.9</pre>",
            evaluator_results_json='{"bestScore": 0.9}')),
        evals.insert(base_module.EvaluationInstance(
            status="EVALUATING", evaluation_class="other.Eval", start_time=when)),
    ]
    engines = registry.get_meta_data_engine_instances()
    for status in ("COMPLETED", "FAILED"):
        engines.insert(base_module.EngineInstance(
            status=status, start_time=when, end_time=when, engine_id="rec",
            engine_version="1", engine_variant="/x/engine.json",
            engine_factory="predictionio_tpu.models.recommendation.engine_factory"))
    return ids


def test_dashboard_answers_as_the_reference(stores):
    answers, pages = {}, {}
    for name, module, registry, create in (
            ("jax", jax_base, jax_storage, jax_dashboard),
            ("port", base, storage, create_dashboard)):
        stores(name)
        done, running = fill_instances(module, registry)
        svc = create(host="127.0.0.1", port=0).start()
        url = f"http://127.0.0.1:{svc.port}"
        try:
            answers[name] = drive(url, [
                ("GET", "/evaluation_instances.json", None),
                ("GET", f"/evaluation_instances/{done}.json", None),
                ("GET", f"/evaluation_instances/{running}.json", None),
                ("GET", "/evaluation_instances/zzz.json", None)])
            pages[name] = [(r.status_code, r.text) for r in (
                requests.get(url + path, timeout=30) for path in (
                    "/", "/engine_instances", f"/evaluation_instances/{done}",
                    "/evaluation_instances/zzz"))]
            ids = (done, running)
        finally:
            svc.stop()
        answers[name + "_ids"] = ids
    assert without(answers["port"]) == without(answers["jax"])
    listing = answers["port"][0][2]
    assert [(e["id"], e["evaluationClass"], e["status"]) for e in listing] == sorted(
        [(answers["port_ids"][0], "my.Eval<1>", "COMPLETED"),
         (answers["port_ids"][1], "other.Eval", "EVALUATING")],
        key=lambda e: [x["id"] for x in listing].index(e[0]))
    assert answers["port"][1][2]["resultsJson"] == '{"bestScore": 0.9}'
    assert answers["port"][3][0] == 404

    def rows(html: str) -> list[str]:
        # one <tr> per instance, less the header row; ids differ per store
        return [r.split("</td>", 1)[1] for r in html.split("<tr>")[2:]]

    for (code, got), (want_code, want) in zip(pages["port"], pages["jax"]):
        assert code == want_code
        assert rows(got) == rows(want)
    assert [code for code, _ in pages["port"]] == [200, 200, 200, 404]
    assert "my.Eval&lt;1&gt;" in pages["port"][0][1]
    assert pages["port"][1][1].count("<tr>") == 3  # header + two engine instances
    assert "<pre>score 0.9</pre>" in pages["port"][2][1]


# --------------------------------------------------------------------------
# the shell
# --------------------------------------------------------------------------


def test_shell_preloads_the_ports_counterparts(monkeypatch, capsys):
    """The namespace the console opens with: the reference's names, less
    ``RuntimeContext``, plus the port's ``WorkflowParams`` and
    ``TrainContext``; every object is the port's."""
    import builtins
    import code

    from predictionio_tpu.tools import shell as jax_shell
    from predictionio_tpu_torch.controller.base import TrainContext
    from predictionio_tpu_torch.workflow.core_workflow import WorkflowParams

    real_import = builtins.__import__

    def no_ipython(name, *args, **kw):
        if name == "IPython" or name.startswith("IPython."):
            raise ImportError("no IPython here")
        return real_import(name, *args, **kw)

    seen = {}
    monkeypatch.setattr(builtins, "__import__", no_ipython)
    monkeypatch.setattr(code, "interact", lambda banner, local: seen.update(local))
    assert jax_shell.run_shell() == 0
    want = dict(seen)
    seen.clear()
    assert cli.main(["shell"]) == 0
    assert set(seen) == set(want) - {"RuntimeContext"} | {"WorkflowParams", "TrainContext"}
    assert seen["WorkflowParams"] is WorkflowParams and seen["TrainContext"] is TrainContext
    for name, obj in seen.items():
        assert getattr(obj, "__module__", getattr(obj, "__name__", "")).startswith(
            "predictionio_tpu_torch"), name
    banner = capsys.readouterr().out
    assert "predictionio_tpu_torch shell" in banner and "TrainContext" in banner


def test_every_reference_verb_is_answered_but_check():
    """Every verb of the reference's console is answered, ``check``
    included now that the port carries its analyzer
    (``predictionio_tpu_torch/analysis/``), and ``check`` takes the
    reference's flags with the same defaults."""
    import argparse

    def verbs(parser):
        action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
        return action.choices

    ours, theirs = verbs(cli.build_parser()), verbs(jax_cli.build_parser())
    assert set(ours) == set(theirs)

    def flags(sub):
        return {(tuple(a.option_strings), a.dest, a.default, a.nargs)
                for a in sub._actions if not isinstance(a, argparse._HelpAction)}

    assert flags(ours["check"]) == flags(theirs["check"])


# -- the eventserver's WAL flags and train's --als-solver --------------------

WAL_FLAGS = ("ingest_mode", "ingest_queue_size", "group_commit_ms", "fsync_policy",
             "wal_dir", "wal_partitions", "slow_commit_ms")


def _option(parser, verb: str, flag: str):
    """The ``argparse`` action of ``verb``'s ``flag``."""
    import argparse

    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return next(a for a in action.choices[verb]._actions if flag in a.option_strings)


@pytest.mark.parametrize("flag", ["--ingest-mode", "--ingest-queue-size", "--group-commit-ms",
                                  "--fsync-policy", "--wal-dir", "--wal-partitions",
                                  "--slow-commit-ms"])
def test_eventserver_flags_equal_the_reference(flag):
    """Each WAL flag of the reference's ``pio eventserver`` is the port's,
    with the same default, type and choices."""
    want = _option(jax_cli.build_parser(), "eventserver", flag)
    got = _option(cli.build_parser(), "eventserver", flag)
    assert (got.default, got.type, got.choices) == (want.default, want.type, want.choices)


@pytest.mark.parametrize("argv", [
    [],
    ["--ingest-mode", "wal", "--ingest-queue-size", "64", "--group-commit-ms", "1.5",
     "--fsync-policy", "interval", "--wal-dir", "/tmp/w", "--wal-partitions", "4",
     "--slow-commit-ms", "25"],
    ["--ingest-mode", "wal", "--fsync-policy", "never"],
])
def test_eventserver_flags_reach_the_ingest_config_as_the_references(argv, monkeypatch):
    """Both packages' ``cmd_eventserver`` hand ``run_event_server`` the
    same ``IngestConfig`` and ``slow_commit_ms`` for the same command
    line (the server itself is patched out)."""
    import dataclasses

    from predictionio_tpu.data.api import eventserver as jax_es
    from predictionio_tpu_torch.data.api import eventserver as es

    seen = {}
    for name, module, console in (("jax", jax_es, jax_cli), ("port", es, cli)):
        monkeypatch.setattr(module, "run_event_server",
                            lambda name=name, **kw: seen.__setitem__(name, kw))
        args = console.build_parser().parse_args(["eventserver", *argv])
        assert args.func(args) == 0
    want, got = seen["jax"], seen["port"]
    assert dataclasses.asdict(got.pop("ingest_config")) == dataclasses.asdict(
        want.pop("ingest_config"))
    assert got == want


def test_slow_commit_ms_sets_the_commit_threshold(tmp_path, monkeypatch):
    """``--slow-commit-ms`` becomes the tracer's ``ingest.commit``
    threshold in seconds, as in the reference, on a WAL event server
    built from an ``IngestConfig``."""
    from predictionio_tpu_torch.data.api.eventserver import EventService
    from predictionio_tpu_torch.data.ingest import IngestConfig

    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    storage.reset()
    service = EventService(ingest_config=IngestConfig(mode="wal", group_commit_ms=1.0,
                                                       wal_dir=str(tmp_path / "wal")),
                           slow_commit_ms=25.0)
    try:
        assert service.router.tracer._slow_log_threshold("ingest.commit") == 0.025
        assert service.ingest is not None and service._wal.partitions == 1
        assert os.path.isdir(tmp_path / "wal")
    finally:
        service.shutdown_ingest()
        storage.reset()


def test_train_als_solver_flag_equals_the_reference():
    want = _option(jax_cli.build_parser(), "train", "--als-solver")
    got = _option(cli.build_parser(), "train", "--als-solver")
    assert (got.default, got.choices) == (want.default, want.choices) == (
        None, ("auto", "xla", "pallas"))


@pytest.mark.parametrize("solver,fused", [(None, True), ("auto", True), ("pallas", True),
                                          ("xla", False)])
def test_train_als_solver_picks_the_half_step(solver, fused, tmp_path, monkeypatch):
    """``train --als-solver`` reaches the fit as ``pio.als_solver``
    (``models/_als_common.py::resolve_solver_override``): "xla" trains
    through ``gram_rhs_plain``, "auto", "pallas" and no flag through the
    B1 wrapper ``gram_rhs`` (the calls are counted by spies on the names
    ``parallel/als.py::half_step_fn`` returns)."""
    from predictionio_tpu_torch.parallel import als

    calls = {"gram_rhs": 0, "gram_rhs_plain": 0}
    for name in calls:
        original = getattr(als, name)

        def spy(*args, _name=name, _original=original, **kwargs):
            calls[_name] += 1
            return _original(*args, **kwargs)

        monkeypatch.setattr(als, name, spy)
    events = tmp_path / "events.jsonl"
    with open(events, "w") as f:
        for k in range(200):
            f.write(json.dumps({"event": "rate", "entityType": "user", "entityId": f"u{k % 17}",
                                "targetEntityType": "item", "targetEntityId": f"i{k % 11}",
                                "properties": {"rating": float(k % 5 + 1)}}) + "\n")
    engine_json = os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples",
                               "recommendation", "engine.json")
    argv = ["train", "--engine-json", engine_json, "--events", str(events), "--model-out",
            str(tmp_path / "model"), "--device", "cpu"]
    assert cli.main(argv + (["--als-solver", solver] if solver else [])) == 0
    if fused:
        assert calls["gram_rhs"] > 0 and calls["gram_rhs_plain"] == 0, calls
    else:
        assert calls["gram_rhs"] == 0 and calls["gram_rhs_plain"] > 0, calls


def test_train_from_the_store_sets_pio_als_solver(stores, monkeypatch, tmp_path):
    """From the store, ``--als-solver`` lands in the variant's runtime
    conf as the reference's ``pio.als_solver`` (``run_train`` patched
    out: the fit reads it as the file path above does)."""
    from predictionio_tpu_torch.workflow import core_workflow

    stores("store")
    seen = {}

    class _Instance:
        id = "instance"

    def run_train(variant, params, device=None):
        seen.update(variant.runtime_conf)
        return _Instance()

    monkeypatch.setattr(core_workflow, "run_train", run_train)
    engine_dir = os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples",
                              "recommendation")
    assert cli.main(["train", "--engine-dir", engine_dir, "--device", "cpu",
                     "--als-solver", "xla"]) == 0
    assert seen["pio.als_solver"] == "xla"
