"""The native host packer: ``csr_pack.cpp``, built with g++, loaded by ctypes.

Port of ``predictionio_tpu/native/__init__.py``. The C++ source beside
this file packs COO triples into padded CSR blocks with a row-bucket
counting sort (``ops/ragged.py::pack_padded_csr`` calls it before its
numpy path). It is compiled on first use with ``g++ -O3 -shared -fPIC
-std=c++17`` into a library named by the source's hash, cached in
``PIO_NATIVE_CACHE`` (default ``predictionio_tpu_torch/_build/``, which
git ignores); an unchanged source loads at once.

One departure from the reference, on purpose: there a failed build or
load returns None and every caller quietly takes the numpy path; here it
raises ``NativeBuildError`` with the compiler's output, so a pack never
changes route unasked. ``PIO_NATIVE=0``, the reference's own knob,
picks the numpy route explicitly (``load`` returns None).

Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ["csr_pack.cpp"]
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class NativeBuildError(RuntimeError):
    """The native library did not build or load."""


def enabled() -> bool:
    """False when ``PIO_NATIVE=0`` asks for the numpy route."""
    return os.environ.get("PIO_NATIVE", "1") != "0"


def _cache_dir() -> str:
    return os.environ.get("PIO_NATIVE_CACHE",
                          os.path.join(os.path.dirname(_HERE), "_build"))


def _source_digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_HERE, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build() -> str:
    """The library's path, compiled first if no copy of this source is
    cached; raises ``NativeBuildError`` when g++ fails."""
    cache = _cache_dir()
    lib_path = os.path.join(cache, f"libpio_native_{_source_digest()}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(cache, exist_ok=True)
    # build to a temp name, then rename: concurrent builders (the ranks of
    # one launch) race benignly instead of loading a half-written library
    fd, tmp_path = tempfile.mkstemp(suffix=".so", dir=cache)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, "-o", tmp_path, *(os.path.join(_HERE, s) for s in _SOURCES)]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if done.returncode != 0:
            raise NativeBuildError(f"{' '.join(cmd)} failed ({done.returncode}):\n"
                                   f"{done.stderr}")
        os.rename(tmp_path, lib_path)
    except (OSError, subprocess.SubprocessError) as exc:
        raise NativeBuildError(f"{' '.join(cmd)}: {exc}") from exc
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
    return lib_path


def load() -> ctypes.CDLL | None:
    """The native library, built on first call; None under
    ``PIO_NATIVE=0``. A failed build or load raises
    ``NativeBuildError``."""
    global _lib
    if not enabled():
        return None
    with _lock:
        if _lib is not None:
            return _lib
        path = _build()
        try:
            lib = ctypes.CDLL(path)
        except OSError as exc:
            raise NativeBuildError(f"loading {path}: {exc}") from exc
        from numpy.ctypeslib import ndpointer

        lib.pack_padded_csr.restype = ctypes.c_int64
        lib.pack_padded_csr.argtypes = [
            ndpointer(np.int64, flags="C_CONTIGUOUS"),   # rows
            ndpointer(np.int64, flags="C_CONTIGUOUS"),   # cols
            ndpointer(np.float32, flags="C_CONTIGUOUS"), # vals
            ctypes.c_void_p,                             # times (nullable)
            ctypes.c_int64,                              # n
            ctypes.c_int64,                              # num_rows
            ctypes.c_int64,                              # length
            ctypes.c_int64,                              # padded_rows
            ctypes.c_int64,                              # num_cols
            ndpointer(np.int32, flags="C_CONTIGUOUS"),   # out_indices
            ndpointer(np.float32, flags="C_CONTIGUOUS"), # out_values
            ndpointer(np.float32, flags="C_CONTIGUOUS"), # out_mask
        ]
        _lib = lib
        return _lib


def pack_padded_csr_native(
    rows, cols, vals, times, num_rows, length, padded_rows, num_cols,
    indices, values, mask,
) -> int | None:
    """Run the native pack into the pre-filled ``indices``, ``values``,
    ``mask``; returns the truncated count. None, as in the reference,
    for what the kernel does not take, where the numpy path decides:
    ``PIO_NATIVE=0``, arrays of unequal length, integer times at 2^53 or
    beyond (float64 would merge neighbours), ids out of range."""
    lib = load()
    if lib is None:
        return None
    if cols.size != rows.size or vals.size != rows.size:
        return None  # the numpy path raises the proper shape error
    times_arg = None
    if times is not None:
        times = np.asarray(times)
        if times.size != rows.size:
            return None
        # float64 keeps float timestamps in the order the numpy path sees;
        # integer epochs past 2^53 would collapse adjacent values
        if np.issubdtype(times.dtype, np.integer) and times.size:
            if np.abs(times.astype(np.float64)).max() >= 2.0**53:
                return None
        times = np.ascontiguousarray(times, dtype=np.float64)
        times_arg = times.ctypes.data_as(ctypes.c_void_p)
    truncated = lib.pack_padded_csr(
        np.ascontiguousarray(rows, dtype=np.int64),
        np.ascontiguousarray(cols, dtype=np.int64),
        np.ascontiguousarray(vals, dtype=np.float32),
        times_arg,
        rows.size,
        num_rows,
        length,
        padded_rows,
        num_cols,
        indices,
        values,
        mask,
    )
    return None if truncated < 0 else int(truncated)
