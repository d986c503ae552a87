"""ctypes bindings to the C++ host runtime (csrc/host_runtime.cpp, shipped
inside the package).

Replaces the reference's pybind11 boundary (hash_join.cpp:598-640) for the
HOST-side runtime pieces only: CSV column ingest and the exact join oracle.
The compute path never touches this — it runs on the JAX device.

Builds the shared library on first use (g++ -O3) and caches it next to the
source, falling back to ~/.cache/fhj_native when site-packages is
read-only.  Gate: if no toolchain is available, callers fall back to numpy
(benchmark.py does).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "host_runtime.cpp")

_lock = threading.Lock()
_lib = None


def _build_dir() -> str:
    d = os.path.join(_PKG, "csrc", "build")
    try:
        os.makedirs(d, exist_ok=True)
        probe = os.path.join(d, ".w")
        with open(probe, "w"):
            pass
        os.remove(probe)
        return d
    except OSError:  # read-only install (e.g. system site-packages)
        d = os.path.join(
            os.path.expanduser(os.environ.get("FHJ_CACHE_DIR",
                                              "~/.cache/fhj_native")))
        os.makedirs(d, exist_ok=True)
        return d


def _so_path() -> str:
    return os.path.join(_build_dir(), "libfhj_host.so")


def _build(so: str) -> str:
    if not os.path.exists(_SRC):
        raise FileNotFoundError(
            f"C++ host-runtime source missing: {_SRC}. The wheel must ship "
            "flash_hash_join_tpu/csrc/host_runtime.cpp (pyproject "
            "package-data); reinstall the package or use the numpy "
            "fallbacks.")
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-pthread", _SRC, "-o", so,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    return so


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _so_path()
        if not os.path.exists(so) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(so)
        ):
            _build(so)
        lib = ctypes.CDLL(so)
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        lib.fhj_oracle_join_count.restype = ctypes.c_int64
        lib.fhj_oracle_join_count.argtypes = [
            u64p, ctypes.c_int64, u64p, ctypes.c_int64, ctypes.c_int32,
        ]
        lib.fhj_oracle_join_materialize.restype = ctypes.c_int64
        lib.fhj_oracle_join_materialize.argtypes = [
            u64p, u64p, ctypes.c_int64, u64p, ctypes.c_int64, u64p, u64p,
        ]
        lib.fhj_load_csv_u64.restype = ctypes.c_int64
        lib.fhj_load_csv_u64.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, u64p, ctypes.c_int64,
            ctypes.c_int32,
        ]
        lib.fhj_version.restype = ctypes.c_int32
        _lib = lib
        return _lib


def host_join_count(build_keys: np.ndarray, probe_keys: np.ndarray,
                    nthreads: int = 0) -> int:
    lib = get_lib()
    bk = np.ascontiguousarray(build_keys, np.uint64)
    pk = np.ascontiguousarray(probe_keys, np.uint64)
    return int(lib.fhj_oracle_join_count(bk, len(bk), pk, len(pk), nthreads))


def host_join_materialize(build_keys, build_values, probe_keys):
    lib = get_lib()
    bk = np.ascontiguousarray(build_keys, np.uint64)
    bv = np.ascontiguousarray(build_values, np.uint64)
    pk = np.ascontiguousarray(probe_keys, np.uint64)
    ok = np.empty(len(pk), np.uint64)
    ov = np.empty(len(pk), np.uint64)
    n = int(lib.fhj_oracle_join_materialize(bk, bv, len(bk), pk, len(pk), ok, ov))
    return ok[:n], ov[:n]


def load_csv_u64(path: str, column: int, max_rows: int = 1 << 28,
                 nthreads: int = 0) -> np.ndarray:
    """Parse one numeric uint64 column (0-indexed) from a headered CSV."""
    lib = get_lib()
    out = np.empty(max_rows, np.uint64)
    n = int(lib.fhj_load_csv_u64(path.encode(), column, out, max_rows, nthreads))
    if n == -1:
        raise FileNotFoundError(path)
    if n == -2:
        raise ValueError(f"non-numeric or missing column {column} in {path}")
    if n == -3:
        raise ValueError(f"{path} exceeds max_rows={max_rows}")
    return out[:n].copy()
