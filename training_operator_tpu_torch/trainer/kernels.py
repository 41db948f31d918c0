"""Builds and loads the hand-written CUDA kernels of the trainer.

Each `csrc/*.cu` source is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface and loaded with `ctypes` (the
pattern of the JAX package's native data loader, with nvcc in place of g++).
The sources compile in parallel, one nvcc per file, at first use, into
`training_operator_tpu_torch/build/` under a name keyed by a hash of every
source, every header in HEADERS and the compile command, so an edited source
or header is never served from a stale library. The TMA kernels build their
tensor maps with libcuda's cuTensorMapEncodeTiled, looked up at run time
through the CUDA runtime, so nothing links against libcuda.

There is no fallback: without nvcc, or when a source fails to compile,
`load()` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
SOURCES = ("flash_fwd.cu", "flash_bwd_dq.cu", "flash_bwd_dkv.cu")
HEADERS = ("flash_common.cuh", "sm90_common.cuh")
# How each source computes: a "wgmma+tma" kernel must show HGMMA and UTMALDG
# instructions in its SASS (`sass_counts`).
DESIGN = {
    "flash_fwd.cu": "wgmma+tma",
    "flash_bwd_dq.cu": "wgmma+tma",
    "flash_bwd_dkv.cu": "wgmma+tma",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures, in argument order (see each source's extern "C" block).
_SIGNATURES = {
    "flash_fwd_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "flash_bwd_dq_bf16": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "flash_bwd_dkv_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
}
_LIB_OF = {
    "flash_fwd_bf16": "flash_fwd.cu",
    "flash_bwd_dq_bf16": "flash_bwd_dq.cu",
    "flash_bwd_dkv_bf16": "flash_bwd_dkv.cu",
}


@dataclass
class Kernels:
    """The loaded entry points, by C name, plus what the build reported."""

    fns: Dict[str, ctypes._CFuncPtr]
    error_string: ctypes._CFuncPtr
    build_seconds: float
    log: str  # ptxas register/shared-memory/spill report of a fresh build
    libraries: Dict[str, Path]  # source -> built shared library

    def call(self, name: str, *args) -> None:
        """Calls one C entry point and raises on a non-zero CUDA error."""
        err = self.fns[name](*args)
        if err != 0:
            msg = self.error_string(err).decode()
            raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")


# lockcheck: allow CL008 — leaf lock around the one-time build; the port does not import the JAX package's tracked locks
_lock = threading.Lock()
_loaded: Optional[Kernels] = None


def nvcc_path() -> str:
    """The nvcc to build with; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.access(default, os.X_OK):
        return default
    raise RuntimeError(
        "nvcc not found: the flash-attention kernels are built from "
        "training_operator_tpu_torch/trainer/csrc at first use on a CUDA machine"
    )


def _tag() -> str:
    h = hashlib.sha256()
    for name in (*SOURCES, *HEADERS):
        h.update(name.encode() + b"\0" + (CSRC / name).read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> tuple:
    """Compiles every source that has no library for the current tag;
    returns ({source: library path}, seconds, compiler log)."""
    nvcc = nvcc_path()
    tag = _tag()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = {src: BUILD_DIR / f"{Path(src).stem}-{tag}.so" for src in SOURCES}
    t0 = time.perf_counter()
    procs = {}
    for src, out in outs.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), str(CSRC / src), "-o", str(tmp)]
        procs[src] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ), tmp)
    log = []
    failed = []
    for src, (proc, tmp) in procs.items():
        out_s, err_s = proc.communicate(timeout=900)
        log.append(f"== {src}\n{out_s}{err_s}")
        if proc.returncode != 0:
            failed.append(f"{src}:\n{err_s[-4000:]}")
        else:
            os.replace(tmp, outs[src])  # atomic: concurrent builds race benignly
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return outs, time.perf_counter() - t0, "".join(log)


def sass_counts(libraries: Dict[str, Path]) -> Dict[str, Dict[str, int]]:
    """{source: {"HGMMA": n, "UTMALDG": n}}: Hopper tensor-core (wgmma) and
    TMA-load instructions in each library's SASS, read with cuobjdump."""
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    counts = {}
    for src, lib in libraries.items():
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        counts[src] = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    return counts


def load() -> Kernels:
    """Builds (once per process and source hash) and loads the kernels."""
    global _loaded
    with _lock:
        if _loaded is not None:
            return _loaded
        outs, seconds, log = build()
        libs = {src: ctypes.CDLL(str(path)) for src, path in outs.items()}
        fns = {}
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(libs[_LIB_OF[name]], name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            fns[name] = fn
        err = libs["flash_fwd.cu"].flash_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _loaded = Kernels(fns=fns, error_string=err, build_seconds=seconds, log=log,
                          libraries=outs)
        return _loaded
