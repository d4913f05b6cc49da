"""The port stands alone: no JAX, nothing of the JAX package, the card
by default.

Every module of ``predictionio_tpu_torch`` is imported in a fresh
interpreter where ``import jax`` fails and a meta-path finder refuses the
EXACT top-level name ``predictionio_tpu`` (a prefix match would also
refuse ``predictionio_tpu_torch`` and prove nothing). Importing never
runs a function body, so a static guard walks every source's syntax tree
too, function bodies included, and the verbatim copies of the JAX
package's framework-free modules are held to their originals.
"""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

class RefuseReference(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "predictionio_tpu":
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, RefuseReference())
sys.modules["jax"] = None
import predictionio_tpu_torch as pkg

names = [pkg.__name__] + [
    m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
]
for name in names:
    importlib.import_module(name)
leaked = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "predictionio_tpu", "triton")
    and sys.modules[m] is not None
)
assert not leaked, leaked
print(len(names), " ".join(names))
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    count, *walked = out.stdout.split()
    # every module of the slices was walked, not just the package root
    assert int(count) >= 54
    for module in ("__init__", "model", "kernel", "engine", "convert"):
        assert f"predictionio_tpu_torch.models.ncf.{module}".removesuffix(".__init__") in walked
    for module in ("models.sequence", "models.sequence.model", "models.sequence.engine",
                   "models.sequence.convert", "ops.flash_attention",
                   "parallel.ring_attention", "models._flax_init",
                   # the evaluation, batch-predict and observability slice
                   "eval", "eval.metrics", "eval.split", "eval.replay",
                   "controller.metrics", "workflow.batch_predict", "obs.logs",
                   "obs.telemetry", "obs.top",
                   # the e-commerce, similar-product and universal slice
                   "ops.cooccurrence", "models.ecommerce", "models.ecommerce.engine",
                   "models.ecommerce.convert", "models.similarproduct",
                   "models.similarproduct.engine", "models.similarproduct.convert",
                   "models.universal", "models.universal.engine",
                   "models.universal.convert",
                   # the classification and e2 slice, and the remote backends
                   "ops.features", "ops.lbfgs", "ops.classify", "ops.kmeans", "models.e2",
                   "models.classification", "models.classification.engine",
                   "models.classification.convert", "data.storage.postgres",
                   "data.storage.postgres.client", "data.storage.mysql",
                   "data.storage.mysql.client", "data.storage.jdbc",
                   "data.storage.elasticsearch", "data.storage.elasticsearch.client",
                   "data.storage.elasticsearch.transport", "data.storage.hbase",
                   "data.storage.hbase.client", "data.storage.hbase.transport",
                   "data.storage.s3", "data.storage.hdfs",
                   # the streamed epochs and the streaming reader
                   "parallel.stream", "parallel.reader",
                   # multi-process training on torch.distributed
                   "parallel.distributed", "parallel.mesh",
                   # the neural templates across ranks
                   "parallel.ulysses",
                   # the native host packer
                   "native",
                   # the console and the client SDK
                   "client", "pypio", "tools.commands", "tools.engine_commands",
                   "tools.server_commands", "tools.build_commands",
                   "tools.daemon_commands", "tools.top_command", "tools.adminserver",
                   "tools.dashboard", "tools.shell"):
        assert f"predictionio_tpu_torch.{module}" in walked


_RESOLVE_EXAMPLES = r"""
import glob, importlib.abc, os, sys

class RefuseReference(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "predictionio_tpu":
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, RefuseReference())
sys.modules["jax"] = None
from predictionio_tpu_torch.controller.engine import Engine
from predictionio_tpu_torch.workflow.json_extractor import build_engine, load_engine_variant

paths = sorted(glob.glob(os.path.join("examples", "*", "engine.json")))
for path in paths:
    variant = load_engine_variant(path)
    assert variant.engine_factory.startswith("predictionio_tpu."), path
    engine = build_engine(variant)
    assert isinstance(engine, Engine), path
    names = [name for name, _ in variant.engine_params.algorithm_params_list]
    assert set(names) <= set(engine.algorithm_class_map), (path, names)
    assert type(engine).__module__ == "predictionio_tpu_torch.controller.engine"
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "predictionio_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(len(paths))
"""


def test_the_example_engine_factories_resolve_without_the_reference():
    """Every ``examples/*/engine.json`` names a factory of the JAX
    package's templates; building it gives the port's ``Engine`` of the
    port's template, and neither ``jax`` nor ``predictionio_tpu`` is
    imported on the way."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _RESOLVE_EXAMPLES], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) == 7


def test_default_device_without_cuda_raises(monkeypatch):
    import numpy as np

    from predictionio_tpu_torch.models.recommendation import ALSAlgorithm
    from predictionio_tpu_torch.online.foldin import fold_in_users
    from predictionio_tpu_torch.ops.mips import RetrievalConfig, RetrievalIndex
    from predictionio_tpu_torch.parallel.als import ALSConfig, als_fit, build_als_data
    from predictionio_tpu_torch.tools.cli import load_variant
    from predictionio_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ALSAlgorithm({})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RetrievalIndex([[1.0, 2.0]], RetrievalConfig(mode="mips"))
    config = ALSConfig(rank=4, iterations=1)
    data = build_als_data([0, 1], [1, 0], [5.0, 3.0], 2, 2, config)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        als_fit(data, config)
    engine_json = os.path.join(REPO, "examples", "recommendation", "engine.json")
    variant, engine = load_variant(engine_json)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine._algorithms(variant.engine_params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fold_in_users(np.ones((2, 4), np.float32), [0], [1], [5.0], 1, config)
    for template in ("ecommerce", "similarproduct", "universal", "classification"):
        variant, engine = load_variant(os.path.join(REPO, "examples", template, "engine.json"))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            engine._algorithms(variant.engine_params)
    from predictionio_tpu_torch.models import e2
    from predictionio_tpu_torch.ops import classify

    x, y = np.ones((4, 3), np.float32), np.array([0, 1, 0, 1])
    for train in (classify.train_naive_bayes, classify.train_logistic_regression):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train(x, y, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        e2.kmeans(x, k=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        e2.categorical_naive_bayes([{"a": "x"}, {"a": "y"}], ["p", "q"])
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """A non-CPU tensor launches the kernel or raises: the wrapper has
    no path that quietly computes the plain version instead."""
    from predictionio_tpu_torch.ops import mips

    monkeypatch.setattr(
        mips, "mips_block_topk_plain",
        lambda *a, **k: pytest.fail("plain version taken for a device tensor"),
    )
    meta = [
        torch.empty((8, 16), dtype=torch.float32, device="meta"),
        torch.empty((512, 16), dtype=torch.int8, device="meta"),
        torch.empty((1, 1), dtype=torch.float32, device="meta"),
    ]
    with pytest.raises(ValueError, match="no stage-1 kernel"):
        mips.mips_block_topk(*meta, block_topk=16, num_items=500)


def test_gram_rhs_device_tensor_never_takes_the_plain_path(monkeypatch):
    """The ALS kernel's wrapper: a non-CPU tensor launches or raises."""
    from predictionio_tpu_torch.ops import als_gram

    monkeypatch.setattr(
        als_gram, "gram_rhs_plain",
        lambda *a, **k: pytest.fail("plain version taken for a device tensor"),
    )
    meta = [
        torch.empty((8, 16), dtype=torch.int32, device="meta"),
        torch.empty((8, 16), dtype=torch.float32, device="meta"),
        torch.empty((33, 16), dtype=torch.float32, device="meta"),
    ]
    with pytest.raises(ValueError, match="no gram_rhs kernel"):
        als_gram.gram_rhs(*meta, 0.5, implicit=True)


def test_ncf_scorer_device_tensor_never_takes_the_plain_path(monkeypatch):
    """The NCF scorer's wrapper: a non-CPU tensor launches B3 or raises,
    at any depth; a launch the card refuses raises too."""
    from predictionio_tpu_torch import _kernels
    from predictionio_tpu_torch.models.ncf import kernel

    monkeypatch.setattr(
        kernel, "ncf_score_plain",
        lambda *a, **k: pytest.fail("plain version taken for a device tensor"),
    )
    for hidden in ((64, 32), (64, 32, 16)):
        meta = lambda *shape: torch.empty(shape, dtype=torch.float32, device="meta")
        widths = (64,) + hidden
        kernels = [meta(a, b) for a, b in zip(widths, widths[1:])]
        with pytest.raises(ValueError, match="no NCF scorer kernel"):
            kernel.ncf_score_all_items(
                meta(1000, 32), meta(1000, 32), meta(32), meta(32), kernels,
                [meta(h) for h in hidden], meta(32 + hidden[-1], 1), meta(1),
            )
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _kernels.check(700, "ncf_score launch")


def test_flash_attention_device_tensor_never_takes_the_plain_path(monkeypatch):
    """The sequence template's kernels: a non-CPU tensor launches B4 or
    the fused backward or raises, through the wrappers and the autograd
    Function; a head dim past 128 (here 136) reaches the launchers
    zero-padded to the chunked instance's 192, with the caller's scale,
    and never a plain version."""
    import contextlib

    from predictionio_tpu_torch.ops import flash_attention as fa

    for name in ("flash_forward_plain", "flash_backward_plain", "flash_dq_plain",
                 "flash_dkv_plain"):
        monkeypatch.setattr(
            fa, name, lambda *a, **k: pytest.fail("plain version taken for a device tensor"))
    meta = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    q, k, v, do = (meta(2, 64, 2, 16) for _ in range(4))
    mask = meta(2, 64, dtype=torch.bool)
    lse = meta(2, 2, 64)
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        fa.flash_forward(q, k, v, mask)
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        fa.flash_backward(q, k, v, mask, do, q, lse)
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        fa.flash_attention(q, k, v, mask)
    # every tensor reads as a card's; what the wrappers allocate stays on
    # "meta", and the launchers record their arguments instead of launching
    wide, wide_do = meta(2, 64, 2, 136), meta(2, 64, 2, 136)
    for name in ("empty", "zeros", "empty_like"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, real=real, **kw: real(*a, **{**kw, "device": "meta"}))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    calls = []
    monkeypatch.setattr(fa, "_call", lambda fn, *args, **kw: calls.append((fn, args)))
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda")))
    out, _ = fa.flash_forward(wide, wide, wide)
    grads = fa.flash_backward(wide, wide, wide, None, wide_do, wide, lse)
    assert [fn for fn, _ in calls] == ["flash_fwd_launch", "flash_bwd_launch"]
    for (_, args), first in zip(calls, (6, 10)):  # B, T, H, D after the pointers
        b, t, h, d, _, _, scale, causal = args[first:]
        assert (b, t, h, d, causal) == (2, 64, 2, 192, 1) and scale == pytest.approx(136 ** -0.5)
    assert tuple(out.shape) == (2, 64, 2, 136)
    assert [tuple(g.shape) for g in grads] == [(2, 64, 2, 136)] * 3


#: top-level names the port never imports, anywhere in a source
_FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "predictionio_tpu"}
#: a string that names a module of the JAX package (an importlib target)
_REFERENCE_MODULE = re.compile(r"^predictionio_tpu(\.[A-Za-z_]\w*)+$")


def _port_sources() -> list[str]:
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "predictionio_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _forbidden_imports(source: str) -> list[tuple[int, str]]:
    """(line, name) of every import of a forbidden top-level name, and of
    every string that names a JAX-package module, at any depth."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) and (
                _REFERENCE_MODULE.match(node.value)):
            names = ["predictionio_tpu"]
        else:
            continue
        found += [(node.lineno, n) for n in names if n.split(".")[0] in _FORBIDDEN]
    return found


def test_no_port_source_imports_jax_or_the_reference_anywhere():
    sources = _port_sources()
    assert len(sources) >= 60
    leaks = {
        os.path.relpath(path, REPO): hits
        for path in sources
        if (hits := _forbidden_imports(open(path).read()))
    }
    assert leaks == {}


def test_the_static_guard_sees_function_bodies():
    """The guard's own check: lazy imports deep in a body, aliased and
    from-imports, and importlib targets are all caught; the port's own
    name is not."""
    probe = (
        "import os\n"
        "def f():\n"
        "    class C:\n"
        "        def g(self):\n"
        "            from predictionio_tpu.data import snapshot\n"
        "            import jax.numpy as jnp\n"
        "    import optax, flax.linen\n"
        "    return {'x': 'predictionio_tpu.data.storage.postgres'}\n"
        "from predictionio_tpu_torch.data import store\n"
    )
    assert sorted(n for _, n in _forbidden_imports(probe)) == [
        "flax.linen", "jax.numpy", "optax", "predictionio_tpu", "predictionio_tpu.data",
    ]


#: verbatim copies -> the lines allowed to differ, as (reference line,
#: port line) after the package rename
VERBATIM = {
    "data/storage/base.py": set(),
    "data/storage/sql_common.py": set(),
    "data/storage/sqlite/client.py": set(),
    "data/storage/sqlite/__init__.py": set(),
    "data/storage/memory.py": set(),
    "data/storage/localfs.py": set(),
    "data/storage/__init__.py": set(),
    "data/storage/postgres/__init__.py": set(),
    "data/storage/postgres/client.py": set(),
    "data/storage/mysql/__init__.py": set(),
    "data/storage/mysql/client.py": set(),
    "data/storage/jdbc/__init__.py": set(),
    "data/storage/elasticsearch/__init__.py": set(),
    "data/storage/elasticsearch/client.py": set(),
    "data/storage/elasticsearch/transport.py": set(),
    "data/storage/hbase/__init__.py": set(),
    "data/storage/hbase/client.py": set(),
    "data/storage/hbase/transport.py": set(),
    "data/storage/s3.py": set(),
    "data/storage/hdfs.py": set(),
    "data/aggregation.py": set(),
    "data/datamap.py": set(),
    "data/event.py": set(),
    "data/webhooks.py": set(),
    "obs/trace.py": set(),
    "tools/app_ops.py": set(),
    "tools/app_commands.py": set(),
    "tools/import_export.py": set(),
    "utils/stablehash.py": set(),
    "data/wal.py": set(),
    "data/ingest.py": set(),
    "data/snapshot.py": set(),
    # the block store: the planner, the layout key, the manifest and the
    # transfer models, plus load_block_into (WHOLE_DEFS)
    "parallel/stream.py": set(),
    "online/registry.py": set(),
    "online/follower.py": set(),
    "utils/http.py": {(
        "    # jax gets imported); zero out a superseded series so dashboards see",
        "    # torch gets imported); zero out a superseded series so dashboards see",
    )},
    "workflow/microbatch.py": set(),
    "ops/features.py": set(),
    "serving/__init__.py": set(),
    "serving/shardmap.py": set(),
    # a counter store in one 8-byte write: pack_into zeroes the field first
    "serving/shmring.py": {(
        '        struct.pack_into("<Q", self._mm, off, value)',
        '        memoryview(self._mm)[off:off + 8].cast("Q")[0] = value',
    )},
    "serving/frontend.py": set(),
    "serving/procserver.py": set(),
    "eval/__init__.py": set(),
    "eval/metrics.py": set(),
    "eval/split.py": set(),
    "obs/logs.py": set(),
    "obs/top.py": set(),
    # less jit_cache_size, plus record_epoch, record_phase and record_stream
    # (WHOLE_DEFS)
    "obs/telemetry.py": set(),
    # the device pass-through to every shard process
    "client.py": set(),
    "pypio.py": set(),
    "tools/commands.py": set(),
    "tools/top_command.py": set(),
    "tools/adminserver.py": set(),
    "tools/dashboard.py": set(),
    "serving/fabric.py": {
        ("        max_batch_size: int | None = None,",
         '        max_batch_size: int | None = None, device: str = "cuda",'),
        ("        self._max_batch_size = max_batch_size",
         "        self._max_batch_size, self._device = max_batch_size, device"),
        ('            "--server-name", self._server_name,',
         '            "--server-name", self._server_name, "--device", self._device,'),
    },
}


#: copies that drop whole functions of the original or add whole
#: functions of their own: (qualified names dropped, qualified names added)
WHOLE_DEFS = {
    "obs/telemetry.py": ({"jit_cache_size"},
                         {"TrainTelemetry.record_epoch", "TrainTelemetry.record_phase",
                          "TrainTelemetry.record_stream"}),
    "parallel/stream.py": (set(), {"StreamedSide.load_block_into"}),
}


#: functions and classes copied verbatim into modules that are not copies
#: as a whole: port module -> qualified names, each equal to the same
#: name of the same path in the JAX package after the package rename
VERBATIM_DEFS = {
    "ops/cooccurrence.py": ["_pad_rows_sentinel", "distinct_user_counts", "top_k_sparsify"],
    "parallel/reader.py": [
        "IncrementalEncoder", "store_coo_chunks", "store_multi_event_chunks",
        "_kept_user_remap", "_prefilled", "snapshot_coo_chunks", "snapshot_multi_event_chunks",
        "universe_pass", "_SideAccumulator", "_grow_bincount", "ShardedPaddedCSR",
        "array_coo_chunks",
    ],
    "models/_streaming.py": [
        "streaming_handle_or_none", "live_target_events", "live_seen_indices",
        "snapshot_ratings_arrays", "streaming_coo_source", "streaming_multi_event_sources",
        "resolve_als_feed",
    ],
    "models/ecommerce/engine.py": [
        "ECommerceData", "_buy_confidences", "_category_index",
        "ECommerceDataSource.read_eval", "ECommerceDataSource.read_replay",
        "ECommercePreparator.prepare", "ECommerceModel",
        "ECommAlgorithm._unavailable_items", "ECommAlgorithm._recently_viewed",
        "ECommAlgorithm._seen", "ECommAlgorithm._apply_rules",
    ],
    "models/similarproduct/engine.py": [
        "InteractionData", "SimilarProductDataSource.read_eval",
        "SimilarProductDataSource.read_replay", "SimilarityModel", "_user_anchor_items",
        "CooccurrenceAlgorithm._resolve_anchors",
        "CooccurrenceAlgorithm._anchor_contributions",
        "CooccurrenceAlgorithm._compact_scores", "CooccurrenceAlgorithm._topk_response",
        "CooccurrenceAlgorithm.predict", "CooccurrenceAlgorithm.batch_predict",
    ],
    "ops/classify.py": ["NaiveBayesModel", "LogisticRegressionModel"],
    "controller/base.py": ["EmptyParams", "PersistentModel", "EngineFactory",
                           "component_name"],
    "controller/serving.py": ["FirstServing", "AverageServing"],
    "controller/engine.py": ["EngineParams", "Engine.serving", "Engine._maybe_sanity_check"],
    "workflow/json_extractor.py": ["resolve_dotted"],
    "parallel/als.py": ["ALSModel.score_items_for_user", "ALSModel.score_users_for_item"],
    "tools/engine_commands.py": ["cmd_undeploy"],
    "tools/server_commands.py": ["load_plugins", "cmd_dashboard", "cmd_adminserver",
                                 "cmd_shell"],
    "tools/build_commands.py": ["register", "_check_template_json", "cmd_build", "cmd_run",
                                "_examples_root", "cmd_template_list", "cmd_template_get"],
    "tools/daemon_commands.py": ["register", "_base_dir", "_read_pid", "_spawn",
                                 "cmd_start_all", "cmd_stop_all"],
    "ops/kmeans.py": ["_kmeanspp_init", "KMeansModel"],
    "models/e2.py": ["CategoricalNBModel", "MarkovChain", "cross_validation_folds"],
    "models/classification/engine.py": [
        "LabeledRecords", "ClassificationDataSource.read_training",
        "ClassificationDataSource.read_eval", "FeatureSpace",
        "ClassificationPreparator", "ClassifierModel", "_ClassifierBase.predict",
    ],
    "models/universal/engine.py": [
        "MultiEventData", "URDataSource.read_eval", "URModel", "_invert_indicators",
        "_user_history", "URAlgorithm._rule_multiplier", "URAlgorithm._predict_impl",
        "URAlgorithm.predict", "URAlgorithm.batch_predict",
    ],
}


def _def_sources(source: str) -> dict[str, str]:
    """Qualified name -> source text (decorators included) of every
    function and class of ``source``."""
    lines = source.splitlines()
    out = {}

    def walk(body, prefix):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                name = prefix + node.name
                start = min([node.lineno] + [d.lineno for d in node.decorator_list])
                out[name] = "\n".join(lines[start - 1:node.end_lineno])
                if isinstance(node, ast.ClassDef):
                    walk(node.body, name + ".")

    walk(ast.parse(source).body, "")
    return out


@pytest.mark.parametrize("path,name", [
    (path, name) for path, names in sorted(VERBATIM_DEFS.items()) for name in names])
def test_verbatim_definitions_equal_their_originals(path, name):
    """Each listed function or class is its original with
    ``predictionio_tpu`` renamed to ``predictionio_tpu_torch``, and the
    port module's docstring names the original module."""
    with open(os.path.join(REPO, "predictionio_tpu", path)) as f:
        original = re.sub(r"\bpredictionio_tpu\b", "predictionio_tpu_torch", f.read())
    with open(os.path.join(REPO, "predictionio_tpu_torch", path)) as f:
        copy = f.read()
    assert f"``predictionio_tpu/{path}``" in " ".join(ast.get_docstring(ast.parse(copy)).split())
    assert _def_sources(copy)[name] == _def_sources(original)[name]


def _without_defs(source: str, names: set) -> str:
    """``source`` less the named (qualified) functions, each with the
    blank lines before it."""
    drop = set()

    def walk(body, prefix):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                name = prefix + node.name
                if name in names:
                    start = min([node.lineno] + [d.lineno for d in node.decorator_list])
                    drop.update(range(start, node.end_lineno + 1))
                elif isinstance(node, ast.ClassDef):
                    walk(node.body, name + ".")

    walk(ast.parse(source).body, "")
    lines = source.splitlines()
    for n in sorted(drop):
        back = n - 1
        while back >= 1 and back not in drop and not lines[back - 1].strip():
            drop.add(back)
            back -= 1
    return "\n".join(line for i, line in enumerate(lines, 1) if i not in drop) + "\n"


def _split_docstring(source: str) -> tuple[str, list[str]]:
    tree = ast.parse(source)
    end = tree.body[0].end_lineno
    return ast.get_docstring(tree, clean=False), source.splitlines()[end:]


@pytest.mark.parametrize("path", sorted(VERBATIM))
def test_verbatim_copies_equal_their_originals(path):
    """Each copy is its original with ``predictionio_tpu`` renamed to
    ``predictionio_tpu_torch``, a module docstring that names the
    original, and only the listed lines changed."""
    with open(os.path.join(REPO, "predictionio_tpu", path)) as f:
        original = re.sub(r"\bpredictionio_tpu\b", "predictionio_tpu_torch", f.read())
    with open(os.path.join(REPO, "predictionio_tpu_torch", path)) as f:
        copy = f.read()
    dropped, added = WHOLE_DEFS.get(path, (set(), set()))
    original, copy = _without_defs(original, dropped), _without_defs(copy, added)
    _, want_body = _split_docstring(original)
    got_doc, got_body = _split_docstring(copy)
    assert f"``predictionio_tpu/{path}``" in " ".join(got_doc.split())
    assert len(got_body) == len(want_body)
    changed = {(a, b) for a, b in zip(want_body, got_body) if a != b}
    assert changed == VERBATIM[path]



_ANALYZER_PROBE = r"""
import importlib, pkgutil, sys

for name in ("torch", "jax", "numpy"):
    sys.modules[name] = None  # any import of them raises ImportError
import predictionio_tpu_torch.analysis as pkg

names = [pkg.__name__] + [
    m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
] + ["predictionio_tpu_torch.tools.precommit"]
for name in names:
    importlib.import_module(name)
from predictionio_tpu_torch.tools.cli import build_parser

build_parser()  # the console, the check verb's flags included
leaked = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("torch", "jax", "jaxlib", "numpy", "triton", "predictionio_tpu")
    and sys.modules[m] is not None
)
assert not leaked, leaked
print(len(names), " ".join(names))
"""


def test_the_analyzer_imports_neither_torch_nor_the_reference():
    """``pio check`` analyzes the package without importing it: every
    module of ``predictionio_tpu_torch/analysis/``, the pre-commit entry
    and the console's parser import in a fresh interpreter where torch,
    jax and numpy cannot be imported, and no analyzer source names them
    at any depth."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _ANALYZER_PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    count, *walked = out.stdout.split()
    for module in ("astutil", "callgraph", "threadroles", "locksets", "packageindex",
                   "flowgraph", "protocols", "engine", "rules_concurrency",
                   "rules_resources", "rules_protocol", "lockwatch", "leakwatch",
                   "__main__"):
        assert f"predictionio_tpu_torch.analysis.{module}" in walked
    assert int(count) == 16
    analyzer = os.path.join(REPO, "predictionio_tpu_torch", "analysis")
    for name in sorted(os.listdir(analyzer)):
        if name.endswith(".py"):
            with open(os.path.join(analyzer, name)) as f:
                tree = ast.parse(f.read())
            imported = {alias.name.split(".")[0] for node in ast.walk(tree)
                        if isinstance(node, ast.Import) for alias in node.names}
            imported |= {node.module.split(".")[0] for node in ast.walk(tree)
                         if isinstance(node, ast.ImportFrom) and node.level == 0
                         and node.module}
            assert not imported & {"torch", "jax", "numpy", "triton"}, name
            assert imported - {"__future__"} <= set(sys.stdlib_module_names) | {
                "predictionio_tpu_torch"}, (name, imported)
