"""The port's native host packer (``predictionio_tpu_torch/native``) on the CPU.

``ops/ragged.py::pack_padded_csr`` takes the native route (the C++
row-bucket counting sort, built with g++ at first use) unless
``PIO_NATIVE=0`` asks for numpy or the input is one the kernel does not
take. The cases are the reference's own (``tests/test_native.py``): each
native pack equals the ``PIO_NATIVE=0`` pack byte for byte and equals the
JAX package's ``pack_padded_csr``; ``PACK_ROUTES`` counts each pack on
its route. Unlike the reference, a library that does not build raises.
"""

import os
import re

import numpy as np
import pytest

from predictionio_tpu.ops.ragged import pack_padded_csr as jax_pack
from predictionio_tpu_torch import native
from predictionio_tpu_torch.ops import ragged

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_coo(n, num_rows, num_cols, with_times, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, num_rows, size=n)
    cols = rng.integers(0, num_cols, size=n)
    vals = rng.random(n).astype(np.float32)
    times = rng.integers(0, 10_000, size=n) if with_times else None
    return rows, cols, vals, times


def packed_both_ways(monkeypatch, *args, route="native", **kwargs):
    """(the default pack, the ``PIO_NATIVE=0`` pack, the JAX package's), the
    default one counted on ``route`` and the second on numpy."""
    before = ragged.pack_routes()
    got = ragged.pack_padded_csr(*args, **kwargs)
    monkeypatch.setenv("PIO_NATIVE", "0")
    numpy_pack = ragged.pack_padded_csr(*args, **kwargs)
    monkeypatch.delenv("PIO_NATIVE")
    after = ragged.pack_routes()
    want = {"native": 0, "numpy": 1}
    want[route] += 1
    assert {k: after[k] - before[k] for k in after} == want
    return got, numpy_pack, jax_pack(*args, **kwargs)


def assert_same_bytes(*packs):
    first = packs[0]
    for other in packs[1:]:
        for name in ("indices", "values", "mask"):
            a, b = getattr(first, name), getattr(other, name)
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
        assert (first.truncated, first.num_rows, first.num_cols) == (
            other.truncated, other.num_rows, other.num_cols)


def test_library_builds_and_loads():
    assert native.load() is not None, "g++ builds the packer here"


def test_the_source_is_the_references():
    """``csr_pack.cpp`` is the reference's below its header comment."""
    def body(path):
        with open(path) as f:
            return f.read().split("#include", 1)[1]

    assert body(os.path.join(REPO, "predictionio_tpu_torch", "native", "csr_pack.cpp")) == \
        body(os.path.join(REPO, "predictionio_tpu", "native", "csr_pack.cpp"))


@pytest.mark.parametrize("with_times", [False, True])
@pytest.mark.parametrize("max_len", [None, 4])
def test_native_equals_numpy_and_the_reference(monkeypatch, with_times, max_len):
    rows, cols, vals, times = _random_coo(5_000, 64, 40, with_times, seed=7)
    assert_same_bytes(*packed_both_ways(monkeypatch, rows, cols, vals, 64, 40,
                                        max_len=max_len, times=times))


def test_float_timestamps_order_like_numpy(monkeypatch):
    rows = np.zeros(3, dtype=np.int64)
    cols = np.array([0, 1, 2], dtype=np.int64)
    vals = np.ones(3, dtype=np.float32)
    times = np.array([0.9, 0.1, 0.5])
    packs = packed_both_ways(monkeypatch, rows, cols, vals, 1, 4, max_len=2, times=times,
                             len_multiple=2)
    assert_same_bytes(*packs)
    # the two newest (0.5, 0.9) survive, in ascending time order
    np.testing.assert_array_equal(packs[0].indices[0][packs[0].mask[0] > 0], [2, 0])


@pytest.mark.parametrize("case", ["out-of-range-cols", "times-past-2^53"])
def test_input_the_kernel_refuses_takes_the_numpy_route(monkeypatch, case):
    """An out-of-range column (the kernel would not remap it) and integer
    times the kernel's float64 would merge go the numpy way, counted."""
    if case == "out-of-range-cols":
        args = (np.array([0, 0]), np.array([1, 7]), np.ones(2, np.float32), 1, 4)
        kwargs = {}
    else:
        args = (np.zeros(3, np.int64), np.arange(3), np.ones(3, np.float32), 1, 3)
        kwargs = {"max_len": 2, "len_multiple": 2,
                  "times": np.array([2**53 + 2, 2**53, 2**53 + 1], np.int64)}
    packs = packed_both_ways(monkeypatch, *args, route="numpy", **kwargs)
    assert_same_bytes(*packs)


def test_truncation_keeps_most_recent(monkeypatch):
    rows = np.zeros(6, dtype=np.int64)
    cols = np.arange(6, dtype=np.int64)
    vals = np.arange(6, dtype=np.float32)
    times = np.array([5, 4, 3, 2, 1, 0], dtype=np.int64)
    packs = packed_both_ways(monkeypatch, rows, cols, vals, 1, 6, max_len=2, times=times,
                             len_multiple=2)
    assert_same_bytes(*packs)
    np.testing.assert_array_equal(packs[0].indices[0][packs[0].mask[0] > 0], [1, 0])
    assert packs[0].truncated == 4


def test_empty_rows_padded(monkeypatch):
    packs = packed_both_ways(monkeypatch, np.array([2]), np.array([1]),
                             np.array([1.0], np.float32), 5, 3)
    assert_same_bytes(*packs)
    packed = packs[0]
    assert packed.mask[0].sum() == 0 and packed.mask[2].sum() == 1
    assert (packed.indices[packed.mask == 0] == 3).all()


def test_env_disable_uses_numpy(monkeypatch):
    monkeypatch.setenv("PIO_NATIVE", "0")
    assert native.load() is None
    before = ragged.pack_routes()
    rows, cols, vals, _ = _random_coo(100, 8, 8, False, seed=1)
    assert ragged.pack_padded_csr(rows, cols, vals, 8, 8).mask.sum() == 100
    assert ragged.pack_routes()["numpy"] == before["numpy"] + 1
    assert ragged.pack_routes()["native"] == before["native"]


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """Where the reference falls back to numpy, the port raises: a source
    g++ refuses stops the pack with the compiler's message."""
    broken = tmp_path / "src"
    broken.mkdir()
    (broken / "csr_pack.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_HERE", str(broken))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PIO_NATIVE_CACHE", str(tmp_path / "cache"))
    before = ragged.pack_routes()
    rows, cols, vals, _ = _random_coo(100, 8, 8, False, seed=1)
    with pytest.raises(native.NativeBuildError, match="g\\+\\+"):
        ragged.pack_padded_csr(rows, cols, vals, 8, 8)
    assert ragged.pack_routes() == before
    assert not [p for p in os.listdir(tmp_path / "cache") if re.search(r"\.so$", p)]
