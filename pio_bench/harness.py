"""The benchmark's harness: one run of one cell, driven by data.

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric sits in a file of its own, found by the name
``BENCHMARK.json`` gives it, so a later change adds a cell or a metric by
adding files and entries:

- ``workloads/<workload>.json``: the cell: its configuration, traffic and
  chips (as ``BENCHMARK.json`` has them), the window entry that drives it
  (``windows/<window>.py``), that entry's parameters, the traced
  stretch's steps and the limits of the numbers that decide ``correct``;
- the configuration's ``file`` (``configs/<config>.json``) and its plain
  reference beside it (``configs/<config>.reference.py``);
- ``traffic/<traffic>.json``: the generator's parameters;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``,
  which returns the value or None where it finds nothing to read.

A window entry module has ``setup(run)``, ``window(run, state)`` (the
timed part, on the card's clock when it returns), ``outcome(run, state,
wall_s)`` (the end-to-end values, answers attempted and failed),
``release(run, state)`` (the program's device state freed), ``checks(run,
state, control)`` and ``faults()``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field

#: top-level module names a run may not load (compared whole)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "predictionio_tpu")
#: caches of the program and of the libraries under it, inside the
#: checkout at fixed paths
CACHE_DIRS = {
    "PIO_NATIVE_CACHE": "native",
    "TRITON_CACHE_DIR": "triton",
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "CUDA_CACHE_PATH": "nv",
}
CACHE_ROOT = ".bench_cache"


@dataclass
class Run:
    workload: dict
    cell: dict
    config: dict
    traffic: dict
    reference: object
    window: object
    seed: int
    seconds: float
    device: str
    #: host-clock seconds of the harness's own spans, by name
    spans: dict = field(default_factory=dict)
    #: shapes and counts of the run that the readers need, by name
    facts: dict = field(default_factory=dict)
    tracer: object = None
    #: the parsed trace of a traced run (``trace.Trace``)
    traced: object = None


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def bench_dir(root: str) -> str:
    return os.path.join(root, "pio_bench")


def load_module(path: str, name: str):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def workload_entry(spec: dict, name: str) -> dict:
    for entry in spec["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in spec['workloads']]}")


def config_entry(spec: dict, name: str) -> dict:
    for entry in spec["configs"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def reader(root: str, metric: str):
    """The ``read`` function of a per-layer metric's reader file."""
    path = os.path.join(bench_dir(root), "metrics", f"{metric}.py")
    return load_module(path, "pio_bench_metric_" + metric.replace(".", "_").replace("-", "_")).read


def prepare(root: str, spec: dict, workload: str, seed: int, seconds: float, device: str,
            overrides: dict | None = None) -> Run:
    """The run's files, read and cross-checked; ``overrides`` updates
    the cell, configuration and traffic (tests run a cell at toy size)."""
    entry = workload_entry(spec, workload)
    cell = load_json(os.path.join(bench_dir(root), "workloads", f"{workload}.json"))
    for key in ("config", "traffic", "chips"):
        if cell.get(key) != entry[key]:
            raise ValueError(f"workloads/{workload}.json has {key}={cell.get(key)!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    config_file = os.path.join(root, config_entry(spec, entry["config"])["file"])
    config = load_json(config_file)
    traffic = load_json(os.path.join(bench_dir(root), "traffic", f"{entry['traffic']}.json"))
    overrides = overrides or {}
    for part, into in (("cell", cell), ("config", config), ("traffic", traffic)):
        for key, value in overrides.get(part, {}).items():
            into[key] = value
    reference = load_module(config_file[: -len(".json")] + ".reference.py",
                            "pio_bench_reference_" + entry["config"].replace("-", "_"))
    window = importlib.import_module(f"pio_bench.windows.{cell['window']}")
    return Run(workload=entry, cell=cell, config=config, traffic=traffic,
               reference=reference, window=window, seed=int(seed), seconds=float(seconds),
               device=device)


def use_checkout_caches(root: str) -> None:
    for var, sub in CACHE_DIRS.items():
        path = os.path.join(root, CACHE_ROOT, sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


def forbidden_modules() -> list[str]:
    loaded = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN_MODULES))


def _stage(name: str, started: float) -> None:
    print(f"[pio_bench] {name} at {time.perf_counter() - started:.3f} s", file=sys.stderr,
          flush=True)


def _sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def execute(root: str, workload: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", started: float | None = None, control: bool = False,
            fault: str | None = None, overrides: dict | None = None) -> dict:
    """One run; returns the result object (its ``checks`` last). With
    ``control``, the control's readings join ``checks`` as
    ``control.<name>``; ``fault`` plants one of the window entry's
    ``faults()`` in the program for set-up and the window."""
    import torch

    started = time.perf_counter() if started is None else started
    spec = load_spec(root)
    run = prepare(root, spec, workload, seed, seconds, device, overrides)
    planted = run.window.faults()[fault]() if fault else contextlib.nullcontext()
    with planted:
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        state = run.window.setup(run)
        _stage("set-up done", started)
        if trace:
            from pio_bench.trace import Tracer

            if device == "cuda":
                Tracer.start_cupti()
            run.tracer = Tracer(**run.cell["trace"])
            run.tracer.__enter__()
        _sync(device)
        t0 = time.perf_counter()
        setup_s = t0 - started
        try:
            run.window.window(run, state)
            _sync(device)
            wall_s = time.perf_counter() - t0
            _stage("window closed", started)
        finally:
            if run.tracer is not None:
                run.tracer.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    values, attempted, failed = run.window.outcome(run, state, wall_s)
    run.window.release(run, state)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    checks = run.window.checks(run, state, control)
    _stage("checked", started)
    if run.tracer is not None:
        run.traced = run.tracer.read()
        _stage("trace read", started)
        if device == "cuda" and (run.traced is None or not run.traced.busy_s()):
            raise RuntimeError("the traced run recorded no device work: the window ended "
                               "before the traced stretch did")

    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            if applies(m, workload):
                value = reader(root, m["name"])(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(values, setup_s=setup_s)
        for m in spec["end_to_end"]:
            if applies(m, workload):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result = {
        "correct": all(c.ok for c in checks if not c.name.startswith("control.")),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": device_info(run, peak),
    }
    if run.traced is not None and run.traced.window() is not None:
        result["breakdown"] = run.traced.breakdown()
    print("[pio_bench] spans " + json.dumps(run.spans) + " facts " + json.dumps(run.facts),
          file=sys.stderr, flush=True)
    # a gap that is not finite prints as null (strict JSON) and fails
    result["checks"] = {c.name: {"value": c.value if math.isfinite(c.value) else None,
                                 "limit": c.limit} for c in checks}
    return result


def device_info(run: Run, peak: int) -> dict:
    import torch

    info = {"platform": "gpu" if run.device == "cuda" else run.device,
            "kind": torch.cuda.get_device_name(0) if run.device == "cuda" else "cpu",
            "count": int(run.workload["chips"]), "memory_peak_bytes": int(peak)}
    if run.traced is not None and run.traced.window() is not None:
        info["busy_s"] = run.traced.busy_s()
        info["window_s"] = run.traced.window_s()
    return info


def check_lines(result: dict) -> list[str]:
    """Each compared number beside its limit, one line each."""
    return [f"check {name} {c['value']!r} limit {c['limit']!r}"
            + ("" if c["value"] is not None and c["value"] <= c["limit"] else " FAILS")
            for name, c in result["checks"].items()]
