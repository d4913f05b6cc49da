"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` has a plain C interface and is compiled on
first use with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``_build/`` (a directory git ignores), named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
kernel or header rebuilds and an unchanged one loads at once. Libraries
load with ``ctypes``; every pointer and the stream are declared
``c_void_p`` (ctypes would otherwise pass a 32-bit int and cut the
pointer).

Nothing here runs at import: the CPU tests import every module of the
port on a host with no ``nvcc`` and no card.

    build_all()          # compile every source at once, one nvcc each
    library("mips_topk") # the loaded ctypes.CDLL, built if needed
    library("als_gram")
    library("ncf_score")
    library("flash_attention")
    library("flash_backward")
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: shared memory one block may use on Hopper (227 KB); the wrappers
#: refuse widths whose block needs more before they launch
MAX_SMEM_BYTES = 232_448

#: kernel name -> (source under csrc/, {C function: (restype, argtypes)})
_VP, _INT = ctypes.c_void_p, ctypes.c_int
#: B, T, H, D, the batch and time strides, scale, causal, stream
_FLASH_TAIL = [_INT] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_float, _INT, _VP]
KERNELS = {
    "mips_topk": (
        "mips_topk.cu",
        {
            "mips_block_topk_launch": (
                _INT, [_VP, _VP, _VP, _VP, _VP] + [_INT] * 6 + [_VP]
            ),
            "mips_block_topk_smem_bytes": (_INT, [_INT, _INT]),
        },
    ),
    "als_gram": (
        "als_gram.cu",
        {
            "als_gram_rhs_launch": (
                _INT, [_VP] * 5 + [_INT] * 3 + [ctypes.c_float] + [_INT] * 2 + [_VP]
            ),
        },
    ),
    "ncf_score": (
        "ncf_score.cu",
        {
            "ncf_score_launch": (_INT, [_VP] * 13 + [_INT] * 4 + [_VP]),
            "ncf_score_smem_bytes": (_INT, [_INT] * 3),
        },
    ),
    "flash_attention": (
        "flash_attention.cu",
        {
            "flash_fwd_launch": (_INT, [_VP] * 6 + _FLASH_TAIL),
        },
    ),
    "flash_backward": (
        "flash_backward.cu",
        {"flash_bwd_launch": (_INT, [_VP] * 10 + _FLASH_TAIL)},
    ),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
#: compiler output (ptxas register/shared-memory report) per kernel name
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME/bin); the "
        "port's CUDA kernels are built from source at first use"
    )


def _target(name: str) -> tuple[str, str]:
    """``(source, library path)``: the path names a hash of the source,
    of every header under ``csrc/`` (a source may include any of them)
    and of the flags, so an edited header rebuilds its includers too."""
    source = os.path.join(_CSRC, KERNELS[name][0])
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source] + [os.path.join(_CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return source, os.path.join(_BUILD, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start one nvcc for ``name`` if its library is missing; returns
    ``(process, tmp_path, so_path)`` or None when already built."""
    source, so_path = _target(name)
    if os.path.exists(so_path):
        return None
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, tmp, so_path


def _finish(name: str, started) -> None:
    proc, tmp, so_path = started
    out, _ = proc.communicate()
    build_logs[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{out}")
    os.replace(tmp, so_path)  # atomic: a concurrent loader sees all or nothing


def _load(name: str) -> ctypes.CDLL:
    _, so_path = _target(name)
    lib = ctypes.CDLL(so_path)
    for fn, (restype, argtypes) in KERNELS[name][1].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    _loaded[name] = lib
    return lib


def build_all() -> None:
    """Compile every kernel source that has no current library, all
    ``nvcc`` processes started together, then load them."""
    with _lock:
        started = {name: _start(name) for name in KERNELS if name not in _loaded}
        errors = []
        for name, job in started.items():
            if job is not None:
                try:
                    _finish(name, job)  # waits for its nvcc either way
                except RuntimeError as exc:
                    errors.append(str(exc))
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in started:
            _load(name)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _loaded:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            _load(name)
        return _loaded[name]


def check(status: int, what: str) -> None:
    """Raise if a C launch entry returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what} failed with CUDA error {status}")
