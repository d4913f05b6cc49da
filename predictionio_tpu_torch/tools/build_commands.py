"""``pio build / run / template`` verbs.

Port of ``predictionio_tpu/tools/build_commands.py``. ``build`` checks
``template.json``'s minimum pio version (a warning, as the reference's)
and validates the engine directory as the reference's does: engine.json
parses and its ``engineFactory``, imported from the engine directory,
builds the port's ``Engine`` (``workflow/json_extractor.py::
build_engine``; a factory of the JAX package's templates resolves to the
port's own); ``--clean`` drops stale bytecode caches first.

``run`` runs a python script or module with the engine directory on
``sys.path`` (the reference's "run a main class with the pio classpath").

``template list`` / ``template get`` serve the repo's bundled
``examples/`` gallery, found from this file's own path; ``get`` copies a
template and with ``--app-name`` sets its datasource's ``appName``. The
ported templates read the same engine.json files.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

from predictionio_tpu_torch.version import __version__


def register(sub: argparse._SubParsersAction) -> None:
    build = sub.add_parser("build", help="validate and prepare an engine directory")
    build.add_argument("--engine-dir", default=".", help="engine directory")
    build.add_argument("--variant", default=None, help="engine variant JSON")
    build.add_argument("--clean", action="store_true", help="drop bytecode caches first")
    build.add_argument("--verbose", action="store_true")
    build.set_defaults(func=cmd_build)

    run = sub.add_parser(
        "run", help="run a python script/module with the pio runtime importable"
    )
    run.add_argument("main", help="path to a .py file or a dotted module name")
    run.add_argument("--engine-dir", default=".", help="added to sys.path")
    # REMAINDER: everything after `main` belongs to the target, including
    # option-style tokens like --epochs
    run.add_argument("args", nargs=argparse.REMAINDER, help="argv passed to the target")
    run.set_defaults(func=cmd_run)

    template = sub.add_parser("template", help="list or scaffold engine templates")
    tsub = template.add_subparsers(dest="template_command")
    tlist = tsub.add_parser("list", help="list bundled engine templates")
    tlist.set_defaults(func=cmd_template_list)
    tget = tsub.add_parser("get", help="scaffold a bundled template into a new dir")
    tget.add_argument("name", help="template name (see `pio template list`)")
    tget.add_argument("directory", help="destination engine directory")
    tget.add_argument("--app-name", default=None, help="rewrite datasource appName")
    tget.set_defaults(func=cmd_template_get)
    template.set_defaults(func=lambda args: (template.print_help(), 2)[1])


# ---------------------------------------------------------------------------
# pio build


def _check_template_json(engine_dir: str) -> str | None:
    """Reference parity: template.json carries a minimum pio version
    (``{"pio": {"version": {"min": "0.10.0"}}}``). Returns a warning or None."""
    path = os.path.join(engine_dir, "template.json")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            spec = json.load(f)
        min_version = spec.get("pio", {}).get("version", {}).get("min")
    except (json.JSONDecodeError, AttributeError) as exc:
        return f"template.json unreadable: {exc}"
    if not min_version:
        return None

    def key(v: str):
        return tuple(int(p) for p in v.split(".") if p.isdigit())

    if key(__version__) < key(str(min_version)):
        return (
            f"template.json requires pio >= {min_version}, this is {__version__}"
        )
    return None


def cmd_build(args: argparse.Namespace) -> int:
    from predictionio_tpu_torch.workflow.json_extractor import (
        EngineConfigError,
        build_engine,
        load_engine_variant,
    )

    engine_dir = os.path.abspath(args.engine_dir)
    if args.clean:
        removed = 0
        for root, dirs, _files in os.walk(engine_dir):
            for d in list(dirs):
                if d == "__pycache__":
                    shutil.rmtree(os.path.join(root, d), ignore_errors=True)
                    dirs.remove(d)
                    removed += 1
        if args.verbose:
            print(f"Removed {removed} __pycache__ dir(s).")

    warning = _check_template_json(engine_dir)
    if warning:
        print(f"Warning: {warning}")

    variant_path = args.variant or os.path.join(engine_dir, "engine.json")
    try:
        variant = load_engine_variant(variant_path)
        engine = build_engine(variant)
    except EngineConfigError as exc:
        print(f"Error: {exc}")
        return 1
    if args.verbose:
        print(f"Engine factory: {variant.engine_factory}")
        print(f"Engine: {type(engine).__name__}")
        for name, _params in variant.engine_params.algorithm_params_list:
            print(f"  algorithm: {name}")
    print("Build finished: engine is importable and engine.json is valid.")
    return 0


# ---------------------------------------------------------------------------
# pio run


def cmd_run(args: argparse.Namespace) -> int:
    import runpy

    engine_dir = os.path.abspath(args.engine_dir)
    if engine_dir not in sys.path:
        sys.path.insert(0, engine_dir)
    old_argv = sys.argv
    sys.argv = [args.main] + list(args.args)
    try:
        if args.main.endswith(".py") or os.path.sep in args.main:
            runpy.run_path(args.main, run_name="__main__")
        else:
            runpy.run_module(args.main, run_name="__main__", alter_sys=True)
    except SystemExit as exc:
        if exc.code is None:
            return 0
        if isinstance(exc.code, int):
            return exc.code
        print(exc.code, file=sys.stderr)
        return 1
    finally:
        sys.argv = old_argv
    return 0


# ---------------------------------------------------------------------------
# pio template


def _examples_root() -> str:
    # repo layout: predictionio_tpu_torch/tools/build_commands.py -> repo/examples
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "examples")


_TEMPLATE_BLURBS = {
    "recommendation": "ALS matrix factorization (MLlib recommender parity)",
    "classification": "Naive Bayes / logistic regression (classification parity)",
    "similarproduct": "item cooccurrence similar-product recommender",
    "ecommerce": "implicit ALS + live business rules (categories, stock)",
    "universal": "Universal-Recommender-style LLR cross-occurrence",
    "ncf": "Neural Collaborative Filtering (NeuMF) on the dp x tp mesh",
    "sequence": "SASRec sequential recommender (ring-attention sp mesh)",
}


def cmd_template_list(args: argparse.Namespace) -> int:
    root = _examples_root()
    if not os.path.isdir(root):
        print("No bundled templates found (examples/ missing).")
        return 1
    print("Bundled engine templates (scaffold with `pio template get <name> <dir>`):")
    for name in sorted(os.listdir(root)):
        if os.path.isdir(os.path.join(root, name)):
            blurb = _TEMPLATE_BLURBS.get(name, "")
            print(f"  {name:18s} {blurb}")
    return 0


def cmd_template_get(args: argparse.Namespace) -> int:
    src = os.path.join(_examples_root(), args.name)
    if not os.path.isdir(src):
        print(f"Error: no bundled template named {args.name!r}; try `pio template list`")
        return 1
    dst = os.path.abspath(args.directory)
    if os.path.exists(dst) and (not os.path.isdir(dst) or os.listdir(dst)):
        print(f"Error: destination {dst} exists and is not empty")
        return 1
    shutil.copytree(src, dst, dirs_exist_ok=True)
    if args.app_name:
        variant_path = os.path.join(dst, "engine.json")
        if os.path.exists(variant_path):
            with open(variant_path) as f:
                variant = json.load(f)
            variant.setdefault("datasource", {}).setdefault("params", {})[
                "appName"
            ] = args.app_name
            with open(variant_path, "w") as f:
                json.dump(variant, f, indent=2)
                f.write("\n")
    print(f"Engine template {args.name!r} scaffolded at {dst}")
    return 0
