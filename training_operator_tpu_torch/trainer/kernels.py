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
import re
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
SOURCES = ("flash_fwd.cu", "flash_bwd_dq.cu", "flash_bwd_dkv.cu",
           "flash_fwd_fp32.cu", "flash_bwd_dq_fp32.cu", "flash_bwd_dkv_fp32.cu",
           "head_gemm_fp32.cu", "adamw_fp32.cu", "moe_permute.cu")
HEADERS = ("flash_common.cuh", "sm90_common.cuh", "flash_fp32.cuh")
# How each source computes. The wgmma+tma sources hold the bf16 and fp16
# instantiations of each kernel; the fp32 kernels run 3xTF32 products on
# mma.sync (flash_fp32.cuh): mma.sync-3xtf32-ring (dq and dk/dv) splits each
# operand element once into fragment-ordered planes, the streamed one (K
# and V for dq, q and dO for dk/dv) by a producer warpgroup through an
# mbarrier ring, for partner warps that share their tiles by named barriers;
# mma.sync-3xtf32-stream (the forward) stages q once per block in A planes
# and streams K and V raw through an mbarrier ring filled by cp.async, split
# as read, for groups of warps that share partial scores by named barriers.
# The head's fp32 products (head_gemm_fp32.cu) are wgmma-3xtf32+tma: TMA
# loads of raw fp32 tiles through an mbarrier ring, B split once per stage
# into tf32 planes in shared memory, A split in registers, three wgmma per
# k step. Clip and AdamW (adamw_fp32.cu) are multi-tensor-stream: every
# tensor's chunks in one grid, a block a chunk, moved in 128-bit accesses.
# The dropless expert layer's permutation (moe_permute.cu) is
# warp-row-permute: a warp a token, whole rows moved in 128-bit accesses,
# one writer a row and sums in a fixed order.
DESIGN = {
    "flash_fwd.cu": "wgmma+tma",
    "flash_bwd_dq.cu": "wgmma+tma",
    "flash_bwd_dkv.cu": "wgmma+tma",
    "flash_fwd_fp32.cu": "mma.sync-3xtf32-stream",
    "flash_bwd_dq_fp32.cu": "mma.sync-3xtf32-ring",
    "flash_bwd_dkv_fp32.cu": "mma.sync-3xtf32-ring",
    "head_gemm_fp32.cu": "wgmma-3xtf32+tma",
    "adamw_fp32.cu": "multi-tensor-stream",
    "moe_permute.cu": "warp-row-permute",
}
# The SASS instructions every kernel instantiation of a design must show
# (`kernel_sass_counts`): Hopper's tensor-core wgmma (HGMMA) and TMA loads
# (UTMALDG), or mma.sync on TF32 operands with the ring's mbarrier
# operations (SYNCS), or 128-bit global loads and stores (LDG.128, STG.128)
# for a stream that a scalar fallback would run at a fraction of its rate.
DESIGN_SASS = {
    "wgmma+tma": ("HGMMA", "UTMALDG"),
    "wgmma-3xtf32+tma": ("HGMMA", "UTMALDG"),
    "mma.sync-3xtf32-ring": ("HMMA.TF32", "SYNCS"),
    "mma.sync-3xtf32-stream": ("HMMA.TF32", "SYNCS"),
    "multi-tensor-stream": ("LDG.128", "STG.128"),
    "warp-row-permute": ("LDG.128", "STG.128"),
}
# Kernels held to less than their source's design, by a fragment of their
# name: the global norm's first pass reads the gradients 128 bits at a time
# but writes one sum a block, and its finishing pass (one block) reads and
# writes a few sums a tensor; the permutation's mark_kernel reads dest's
# int64 rows and writes a byte each.
KERNEL_SASS = {"adamw_fp32.cu": {"sumsq_kernel": ("LDG.128",), "sumsq_finish_kernel": ()},
               "moe_permute.cu": {"mark_kernel": ()}}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# The element types of the entry points: `<kernel>_<type>`.
TYPES = ("bf16", "fp16", "fp32")
# C signatures, in argument order (see each source's extern "C" block); the
# same for every type of a kernel.
_KERNEL_SIGNATURES = {
    "flash_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "flash_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "flash_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
}
# The head's three fp32 products (x, w or dL, out, T, D, V, chunk, group,
# stream; head_gemm.py).
HEAD_ENTRIES = ("head_logits_fp32", "head_dx_fp32", "head_dw_fp32")
_HEAD_SIGNATURE = (_P, _P, _P, _I, _I, _I, _I, _I, _P)
# Clip and AdamW (adamw.py): the norm (table, rows, chunks, partials, sums,
# norm, stream) and the update (table, rows, chunks, norm, clip_norm, lr,
# b1, b2, bc1, bc2, eps, weight_decay, stream).
_L = ctypes.c_longlong
_D = ctypes.c_double
ADAMW_SIGNATURES = {
    "adamw_sumsq_fp32": (_P, _I, _L, _P, _P, _P, _P),
    "adamw_update_fp32": (_P, _I, _L, _P, _D, _D, _D, _D, _D, _D, _D, _D, _P),
}
# The dropless expert layer's permutation (permute.py): the scatter (src,
# dest, gate, y, out, grad_gate, named, tokens, k, d, rows, stream) and the
# gather-sum (buf, dest, gate, out, tokens, k, d, stream).
PERMUTE_SIGNATURES = {
    "moe_scatter_bf16": (_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _L, _P),
    "moe_gather_sum_bf16": (_P, _P, _P, _P, _L, _I, _I, _P),
}
_SIGNATURES = {**{f"{k}_{t}": sig for k, sig in _KERNEL_SIGNATURES.items() for t in TYPES},
               **dict.fromkeys(HEAD_ENTRIES, _HEAD_SIGNATURE), **ADAMW_SIGNATURES,
               **PERMUTE_SIGNATURES}
# The library of each entry point: bf16 and fp16 in one wgmma source, fp32
# in its own; the head's in head_gemm_fp32.cu, the optimizer's in
# adamw_fp32.cu, the permutation's in moe_permute.cu.
_LIB_OF = {**{f"{k}_{t}": f"{k}_fp32.cu" if t == "fp32" else f"{k}.cu"
              for k in _KERNEL_SIGNATURES for t in TYPES},
           **dict.fromkeys(HEAD_ENTRIES, "head_gemm_fp32.cu"),
           **dict.fromkeys(ADAMW_SIGNATURES, "adamw_fp32.cu"),
           **dict.fromkeys(PERMUTE_SIGNATURES, "moe_permute.cu")}


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
        "nvcc not found: the port's kernels are built from "
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


SASS_OPS = ("HGMMA", "UTMALDG", "HMMA.TF32", "SYNCS", "LDG.128", "STG.128")
# What each op counts in a line of SASS: HMMA.TF32 is mma.sync with TF32
# operands (HMMA.1688.F32.TF32 for m16n8k8); SYNCS an mbarrier operation
# (init, arrive, phase check); LDG.128 and STG.128 a 128-bit global load or
# store, whatever its cache qualifiers (LDG.E.128, LDG.E.128.CONSTANT).
_SASS_PATTERNS = {"HGMMA": re.compile(r"HGMMA"), "UTMALDG": re.compile(r"UTMALDG"),
                  "HMMA.TF32": re.compile(r"HMMA\.\w+\.F32\.TF32"),
                  "SYNCS": re.compile(r"\bSYNCS\."),
                  "LDG.128": re.compile(r"\bLDG\.E(?:\.\w+)*?\.128\b"),
                  "STG.128": re.compile(r"\bSTG\.E(?:\.\w+)*?\.128\b")}


def _sass(lib) -> str:
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def _counts(text: str) -> Dict[str, int]:
    return {op: len(_SASS_PATTERNS[op].findall(text)) for op in SASS_OPS}


def sass_counts(libraries: Dict[str, Path]) -> Dict[str, Dict[str, int]]:
    """{source: {op: n for op in SASS_OPS}}: Hopper tensor-core (wgmma),
    TMA-load, TF32 mma.sync, mbarrier and 128-bit global load and store
    instructions in each library's SASS, read with cuobjdump."""
    return {src: _counts(_sass(lib)) for src, lib in libraries.items()}


def kernel_sass_counts(libraries: Dict[str, Path]) -> Dict[str, Dict[str, Dict[str, int]]]:
    """{source: {kernel: {op: n}}}: the same counts per compiled kernel
    (each template instantiation, by its mangled name, from cuobjdump's
    "Function :" headers), so one instantiation of another form cannot hide
    behind the others of its source."""
    counts = {}
    for src, lib in libraries.items():
        per = counts[src] = {}
        name = None
        for line in _sass(lib).splitlines():
            if "Function :" in line:
                name = line.split("Function :", 1)[1].strip()
                per[name] = dict.fromkeys(SASS_OPS, 0)
            elif name is not None:
                for op, n in _counts(line).items():
                    per[name][op] += n
    return counts


def required_sass(src: str, kernel: str) -> tuple:
    """The instructions kernel `kernel` (a mangled name) of source `src`
    must show: its design's (DESIGN_SASS) unless KERNEL_SASS names it."""
    for fragment, ops in KERNEL_SASS.get(src, {}).items():
        if fragment in kernel:
            return ops
    return DESIGN_SASS[DESIGN[src]]


def missing_sass(per_kernel: Dict[str, Dict[str, Dict[str, int]]]) -> Dict[str, list]:
    """{source: [kernel, ...]}: the kernel instantiations (mangled names
    holding "_kernel") that lack an instruction they require
    (`required_sass`), and every source with no kernel at all."""
    missing = {}
    for src, fns in per_kernel.items():
        short = [f for f, n in fns.items()
                 if "_kernel" in f and not all(n[op] for op in required_sass(src, f))]
        if short or not any("_kernel" in f for f in fns):
            missing[src] = short or ["no kernel"]
    return missing


def loaded() -> Optional[Kernels]:
    """The kernels this process has loaded, or None before the first load."""
    return _loaded


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
