"""ctypes bindings for the native data-path core (dataio.cpp).

The port's own copy of training_operator_tpu/native (the port imports
nothing of the JAX package). The shared library is compiled on demand with
the host toolchain (g++) into training_operator_tpu_torch/build/, keyed by a
hash of the source and the compile command. Without a compiler
`available()` returns False and `build_error()` says why; a DataLoader that
asks for the native path (`use_native=True`) then raises. No pybind11: the
ABI is plain C, the marshalling is ctypes + numpy's ctypes bridge.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SOURCE = Path(__file__).with_name("dataio.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
# lockcheck: allow CL008 — leaf lock around the one-time build; the port does not import the JAX package's tracked locks
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None

_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _build() -> Optional[ctypes.CDLL]:
    src = _SOURCE.read_bytes()
    flags = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
    # Cache key covers source AND compile command: changing flags (or the
    # file paths baked into the command) must not load a stale .so.
    tag = hashlib.sha256(src + "\0".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"dataio-{tag}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [*flags, str(_SOURCE), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed: {proc.stderr[:500]}")
        os.replace(tmp, out)  # atomic: concurrent builds race benignly
    lib = ctypes.CDLL(str(out))
    lib.tod_gather_rows.restype = ctypes.c_int
    lib.tod_gather_rows.argtypes = [
        _I32P, ctypes.c_int64, ctypes.c_int64,
        _I64P, ctypes.c_int64, _I32P, ctypes.c_int32,
    ]
    lib.tod_pack_tokens.restype = ctypes.c_int
    lib.tod_pack_tokens.argtypes = [_I32P, ctypes.c_int64, ctypes.c_int64, _I32P]
    lib.tod_prefetcher_create.restype = ctypes.c_void_p
    lib.tod_prefetcher_create.argtypes = [
        _I32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.tod_prefetcher_submit.restype = ctypes.c_int
    lib.tod_prefetcher_submit.argtypes = [
        ctypes.c_void_p, _I64P, ctypes.c_int64, _I32P,
    ]
    lib.tod_prefetcher_wait.restype = ctypes.c_int
    lib.tod_prefetcher_wait.argtypes = [ctypes.c_void_p]
    lib.tod_prefetcher_destroy.restype = None
    lib.tod_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    with _lock:
        if _lib is None and _build_error is None:
            try:
                _lib = _build()
            except Exception as e:  # no compiler / read-only fs / bad cache
                _build_error = f"{type(e).__name__}: {e}"
    return _lib


def available() -> bool:
    """True when the native library built (or loaded from cache)."""
    return _get() is not None


def build_error() -> Optional[str]:
    """Why the native path is unavailable (None when it is)."""
    _get()
    return _build_error


def default_threads() -> int:
    return min(8, os.cpu_count() or 1)


def gather_rows(
    rows: np.ndarray,
    idx: np.ndarray,
    out: Optional[np.ndarray] = None,
    threads: Optional[int] = None,
) -> np.ndarray:
    """out[i] = rows[idx[i]] via the threaded native gather. `rows` must be a
    C-contiguous int32 [N, R] array (an np.memmap over a token file counts);
    raises if the native library is unavailable — callers gate on
    `available()`."""
    lib = _get()
    if lib is None:
        raise RuntimeError(f"native dataio unavailable: {_build_error}")
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if out is None:
        out = np.empty((len(idx), rows.shape[1]), dtype=np.int32)
    elif out.shape != (len(idx), rows.shape[1]) or out.dtype != np.int32:
        # The C ABI takes no output capacity — a short buffer would be
        # silent out-of-bounds heap writes, so shape is checked here.
        raise ValueError(
            f"out must be int32 {(len(idx), rows.shape[1])}, "
            f"got {out.dtype} {out.shape}"
        )
    rc = lib.tod_gather_rows(
        rows, rows.shape[0], rows.shape[1], idx, len(idx), out,
        threads or default_threads(),
    )
    if rc != 0:
        raise ValueError(f"tod_gather_rows rc={rc} (index out of range?)")
    return out


class Prefetcher:
    """Background gather pipeline over a fixed row arena: `submit` the next
    batch's shuffle indices while the device runs the current step; `wait`
    returns the filled staging buffer. The arena reference is held so the
    memory outlives the worker thread."""

    def __init__(self, rows: np.ndarray, threads: Optional[int] = None):
        lib = _get()
        if lib is None:
            raise RuntimeError(f"native dataio unavailable: {_build_error}")
        self._lib = lib
        self._rows = np.ascontiguousarray(rows, dtype=np.int32)
        self._handle = lib.tod_prefetcher_create(
            self._rows, self._rows.shape[0], self._rows.shape[1],
            threads or default_threads(),
        )
        if not self._handle:
            raise RuntimeError("tod_prefetcher_create failed")
        self._out: Optional[np.ndarray] = None

    def submit(self, idx: np.ndarray) -> None:
        if self._out is not None:
            raise RuntimeError("submit while a gather is in flight")
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        out = np.empty((len(idx), self._rows.shape[1]), dtype=np.int32)
        rc = self._lib.tod_prefetcher_submit(self._handle, idx, len(idx), out)
        if rc != 0:
            raise RuntimeError(f"tod_prefetcher_submit rc={rc}")
        self._out = out

    def wait(self) -> np.ndarray:
        if self._out is None:
            raise RuntimeError("wait without a submitted gather")
        rc = self._lib.tod_prefetcher_wait(self._handle)
        out, self._out = self._out, None
        if rc != 0:
            raise RuntimeError(f"tod_prefetcher_wait rc={rc}")
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.tod_prefetcher_destroy(self._handle)
            self._handle = None

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass
