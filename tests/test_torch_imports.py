"""The port stands alone: no JAX, nothing of the JAX package, the card
by default.

Every module of ``predictionio_tpu_torch`` is imported in a fresh
interpreter where ``import jax`` fails and a meta-path finder refuses the
EXACT top-level name ``predictionio_tpu`` (a prefix match would also
refuse ``predictionio_tpu_torch`` and prove nothing).
"""

import os
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
    assert int(count) >= 43
    for module in ("__init__", "model", "kernel", "engine", "convert"):
        assert f"predictionio_tpu_torch.models.ncf.{module}".removesuffix(".__init__") in walked
    for module in ("models.sequence", "models.sequence.model", "models.sequence.engine",
                   "models.sequence.convert", "ops.flash_attention",
                   "parallel.ring_attention", "models._flax_init"):
        assert f"predictionio_tpu_torch.{module}" in walked


def test_default_device_without_cuda_raises(monkeypatch, tmp_path):
    import numpy as np

    from predictionio_tpu_torch.models.recommendation import ALSAlgorithm
    from predictionio_tpu_torch.online.foldin import fold_in_users
    from predictionio_tpu_torch.ops.mips import RetrievalConfig, RetrievalIndex
    from predictionio_tpu_torch.parallel.als import ALSConfig, als_fit, build_als_data
    from predictionio_tpu_torch.tools.cli import build_trainer
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
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_trainer(engine_json, str(tmp_path / "events.jsonl"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fold_in_users(np.ones((2, 4), np.float32), [0], [1], [5.0], 1, config)
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
    Function, and a head dim past the largest the kernels take (128)
    raises before any launch."""
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
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda")))
    wide = meta(2, 64, 2, 136)
    with pytest.raises(ValueError, match="head dim 136"):
        fa.flash_forward(wide, wide, wide)
