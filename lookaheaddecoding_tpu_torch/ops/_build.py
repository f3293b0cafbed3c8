"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``
(``csrc/*.cuh`` are headers that the sources share). The build runs at
first use, into ``build/kernels/`` at the repository root
(or the directory ``LADE_KERNEL_BUILD_DIR`` names, for an installed
package), keyed on a hash of the source and the flags, so a fresh checkout
builds once and later processes load the cached library. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(os.environ.get("LADE_KERNEL_BUILD_DIR") or
                 Path(__file__).resolve().parents[2] / "build" / "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of each kernel's entry point: (symbol, argtypes)
SIGNATURES = {
    "lookahead_attention": (
        "lookahead_attention_launch",
        # q, k, v, k_scale, v_scale, kv_lens, tables, out, dtype, kv_int8,
        # lanes, s_len, hq, hkv, m, pool_slots, page_size, nb, d, level,
        # window, guess_size, causal, sliding_window, row0, stream
        [_P] * 8 + [_I] * 17 + [_P]),
    "quant_matmul": (
        "quant_matmul_launch",
        # x, w, scale, out, mode, dtype, t, k, n, w_rows, k2, stream
        [_P] * 4 + [_I] * 7 + [_P]),
    "int4_micro": (
        "int4_micro_launch",
        # x, w, scale, out, part, variant, dtype, t, k, n, w_rows, k2,
        # slab_rows, stream
        [_P] * 5 + [_I] * 8 + [_P]),
    "graph_cond": (
        "graph_cond_launch",
        # op (0 begin an IF node, 1 end its body, 2 make a body stream, 3
        # begin a WHILE node, 4 end its body), stream, pred, n, iters, cap,
        # body_stream, handle, info
        [_I, _P, _P, _I] + [_P] * 5),
}

_libs: dict = {}       # name -> loaded ctypes.CDLL (one load per process)
build_info: dict = {}  # name -> {"seconds": float, "log": str, "path": str}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's conventional install prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name: str) -> Path:
    # the source and every header beside it (a source may include any)
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists. Records
    the compile time and nvcc's output (``-Xptxas -v``: registers, shared
    memory and spills per kernel) in ``build_info[name]``."""
    out = library_path(name)
    if out.exists():
        build_info.setdefault(name, {"seconds": 0.0, "log": "(cached)",
                                     "path": str(out)})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent build never sees a partial file
    build_info[name] = {"seconds": secs, "log": log, "path": str(out)}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib
