"""ctypes wrapper for the native parallel .npy loader (port of
``cmtts_tpu/data/native_loader.py``).

The library (``cmtts_tpu_torch/native/featloader.cc``, a host C++ thread
pool) loads a whole batch's feature files at once; ``FeatureDataset.
get_many`` reads through it.  At first use it is built with ``g++`` into
``build/`` under a name hashed from the source and the flags.  When it
cannot be built, the compiler's message is printed once on stderr and the
callers load with ``np.load``, the JAX package's fallback.

``native_loads`` counts the files loaded through the library since
import, so that a run can show which path it took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "cmtts_tpu_torch", "native", "featloader.cc")
_BUILD = os.path.join(_ROOT, "build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_DTYPES = {0: np.float32, 1: np.float64, 2: np.int32, 3: np.int64,
           4: np.int16, 5: np.uint8}

native_loads = 0


class _FLItem(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.c_void_p),
        ("nbytes", ctypes.c_int64),
        ("dtype", ctypes.c_int32),
        ("ndim", ctypes.c_int32),
        ("shape", ctypes.c_int64 * 8),
        ("ok", ctypes.c_int32),
        ("fortran", ctypes.c_int32),
    ]


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> str:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update("\0".join((_cxx(),) + CXX_FLAGS).encode())
    return os.path.join(_BUILD, f"libfeatloader-{h.hexdigest()[:16]}.so")


def build_library(force: bool = False) -> float:
    """Compile the loader unless the library of this source and flags
    exists; returns the seconds spent.  Raises with the compiler's output
    when it fails."""
    lib = library_path()
    if not force and os.path.exists(lib):
        return 0.0
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        res = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, _SRC],
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{_cxx()} could not run: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"{_cxx()} failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return time.perf_counter() - t0


_lib = None
_lib_error: str | None = None
_lock = threading.Lock()


def _load(path: str):
    lib = ctypes.CDLL(path)
    lib.fl_create.restype = ctypes.c_void_p
    lib.fl_create.argtypes = [ctypes.c_int]
    lib.fl_destroy.argtypes = [ctypes.c_void_p]
    lib.fl_submit.restype = ctypes.c_long
    lib.fl_submit.argtypes = [ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_char_p), ctypes.c_int]
    lib.fl_wait.restype = ctypes.c_int
    lib.fl_wait.argtypes = [ctypes.c_void_p, ctypes.c_long,
                            ctypes.POINTER(_FLItem), ctypes.c_int]
    lib.fl_release.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.fl_gather.restype = ctypes.c_int
    lib.fl_gather.argtypes = [ctypes.c_void_p, ctypes.c_long,
                              ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
    return lib


def _get_lib():
    """The loaded library, built at the first call; None (after one
    warning on stderr) when it cannot be built or loaded."""
    global _lib, _lib_error
    with _lock:
        if _lib is None and _lib_error is None:
            try:
                build_library()
                _lib = _load(library_path())
            except (RuntimeError, OSError) as e:
                _lib_error = str(e)
                print(f"native_loader: the native npy loader is "
                      f"unavailable, loading with np.load: {_lib_error}",
                      file=sys.stderr)
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


class NativeNpyLoader:
    """Parallel multi-file npy loader; ``load(paths) -> [np.ndarray]``."""

    def __init__(self, n_threads: int = 8):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError(f"native featloader unavailable: {_lib_error}")
        self._lib = lib
        self._handle = lib.fl_create(n_threads)

    def submit(self, paths: list[str]) -> int:
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        return self._lib.fl_submit(self._handle, arr, len(paths))

    def collect(self, job: int, n: int) -> list[np.ndarray]:
        global native_loads
        items = (_FLItem * n)()
        got = self._lib.fl_wait(self._handle, job, items, n)
        if got < 0:
            raise RuntimeError("unknown native loader job")
        out, dests = [], (ctypes.c_void_p * got)()
        for i in range(got):
            it = items[i]
            if not it.ok:
                self._lib.fl_release(self._handle, job)
                raise IOError("native loader failed to read a file")
            a = np.empty(tuple(it.shape[: it.ndim]),
                         dtype=_DTYPES[it.dtype],
                         order="F" if it.fortran else "C")
            out.append(a)
            dests[i] = a.ctypes.data_as(ctypes.c_void_p)
        # parallel memcpy into the numpy buffers on the C++ pool
        self._lib.fl_gather(self._handle, job, dests, got)
        self._lib.fl_release(self._handle, job)
        native_loads += got
        return out

    def load(self, paths: list[str]) -> list[np.ndarray]:
        return self.collect(self.submit(paths), len(paths))

    def close(self):
        if self._handle:
            self._lib.fl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
