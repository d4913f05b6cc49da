"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding a new workload or metric by its files alone."""

import json
import os
import re
import shutil

import pytest

from pio_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
#: what the contract forbids ``reduced`` to name: widths
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|"
                   r"expansion|experts_per_token|^rank$|embedDim|ffnDim")


def one_line(text: str) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.fixture(scope="module")
def spec():
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return harness.load_spec(root), root


def test_top_level_keys_and_size(spec):
    data, root = spec
    assert set(data) == TOP_KEYS
    assert os.path.getsize(os.path.join(root, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= int(data["run_seconds"]) <= 51 and data["run_seconds"] == int(data["run_seconds"])


def test_command_and_paths(spec):
    data, root = spec
    assert 1 <= len(data["paths"]) <= 16
    for path in data["paths"]:
        assert PATH.match(path) and not path.startswith("/") and ".." not in path.split("/")
        assert os.path.isdir(os.path.join(root, path))
    assert 1 <= len(data["command"]) <= 32 and all(one_line(w) for w in data["command"])
    for word in data["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("part", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(spec, part):
    data, _ = spec
    names = [entry["name"] for entry in data[part]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs(spec):
    data, root = spec
    used = {w["config"] for w in data["workloads"]}
    files = set()
    for c in data["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and one_line(c["source"]) and one_line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in data["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        body = harness.load_json(os.path.join(root, c["file"]))
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
        assert os.path.exists(os.path.join(root, c["file"][:-len(".json")] + ".reference.py"))


def test_workloads(spec):
    data, root = spec
    configs = {c["name"] for c in data["configs"]}
    pairs = set()
    for w in data["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and one_line(w["why"])
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = harness.load_json(os.path.join(root, "pio_bench", "workloads", f"{w['name']}.json"))
        assert (cell["config"], cell["traffic"], cell["chips"]) == (w["config"], w["traffic"],
                                                                    w["chips"])
        assert os.path.exists(os.path.join(root, "pio_bench", "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(root, "pio_bench", "windows", f"{cell['window']}.py"))
    four = sum(1 for w in data["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(data["workloads"]) // 4)


def test_metrics(spec):
    data, root = spec
    cells = {w["name"] for w in data["workloads"]}
    e2e = {m["name"] for m in data["end_to_end"]}
    assert "setup_s" in e2e
    for m in data["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in data["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and one_line(m["layer"]) and m["moves"] in e2e
        assert os.path.exists(os.path.join(root, "pio_bench", "metrics", f"{m['name']}.py"))
        for cell in m.get("workloads", cells):
            assert cell in cells
            moved = next(e for e in data["end_to_end"] if e["name"] == m["moves"])
            assert harness.applies(moved, cell), (m["name"], cell)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(spellings) == 1 for spellings in layers.values())


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_cell_reports_enough(spec, kind):
    data, _ = spec
    for w in data["workloads"]:
        reported = [m["name"] for m in data[kind] if harness.applies(m, w["name"])]
        assert reported and (kind == "per_layer" or len(reported) >= 2), w["name"]


def test_run_seconds_fit_a_full_check(spec):
    data, _ = spec
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (data["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_files_use_the_allowed_characters(spec):
    data, root = spec
    for path in data["paths"]:
        for folder, _, files in os.walk(os.path.join(root, path)):
            if "__pycache__" in folder:
                continue
            for name in files:
                rel = os.path.relpath(os.path.join(folder, name), root)
                assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def _copy_bench(root: str, into: str) -> str:
    shutil.copy(os.path.join(root, "BENCHMARK.json"), into)
    for sub in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(os.path.join(root, "pio_bench", sub), os.path.join(into, "pio_bench", sub))
    return into


def test_a_new_metric_file_is_found_by_its_name(tmp_path, root):
    new_root = _copy_bench(root, str(tmp_path))
    with open(os.path.join(new_root, "pio_bench", "metrics", "sasrec.new_count.py"), "w") as f:
        f.write("def read(run):\n    return run.facts.get('count')\n")
    spec = harness.load_spec(new_root)
    spec["per_layer"].append({"name": "sasrec.new_count", "unit": "count", "better": "lower",
                              "source": "program_counter", "layer": "device",
                              "moves": "train_samples_per_s",
                              "workloads": ["sasrec-ml20m.train"]})
    with open(os.path.join(new_root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)

    class FakeRun:
        facts = {"count": 7}

    read = harness.reader(new_root, "sasrec.new_count")
    assert read(FakeRun()) == 7


def test_a_new_workload_file_is_found_by_its_name(tmp_path, root):
    new_root = _copy_bench(root, str(tmp_path))
    spec = harness.load_spec(new_root)
    spec["workloads"].append({"name": "sasrec-ml20m.train_flat", "config": "sasrec-ml20m",
                              "traffic": "flat_users", "chips": 1, "why": "a test cell"})
    with open(os.path.join(new_root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    traffic = harness.load_json(os.path.join(root, "pio_bench", "traffic", "ml20m_users.json"))
    traffic["users"] = {"law": "power", "exponent": 1.0}
    with open(os.path.join(new_root, "pio_bench", "traffic", "flat_users.json"), "w") as f:
        json.dump(traffic, f)
    cell = harness.load_json(os.path.join(root, "pio_bench", "workloads",
                                          "sasrec-ml20m.train.json"))
    cell["traffic"] = "flat_users"
    with open(os.path.join(new_root, "pio_bench", "workloads",
                           "sasrec-ml20m.train_flat.json"), "w") as f:
        json.dump(cell, f)
    run = harness.prepare(new_root, harness.load_spec(new_root), "sasrec-ml20m.train_flat",
                          5, 1.0, "cpu")
    assert run.traffic["users"]["exponent"] == 1.0 and run.cell["window"] == "train_sasrec"


def test_a_cell_file_that_disagrees_with_benchmark_json_is_refused(tmp_path, root):
    new_root = _copy_bench(root, str(tmp_path))
    path = os.path.join(new_root, "pio_bench", "workloads", "sasrec-ml20m.train.json")
    cell = harness.load_json(path)
    cell["chips"] = 4
    with open(path, "w") as f:
        json.dump(cell, f)
    with pytest.raises(ValueError, match="chips"):
        harness.prepare(new_root, harness.load_spec(new_root), "sasrec-ml20m.train", 5, 1.0,
                        "cpu")
