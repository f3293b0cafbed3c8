#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's quantized matmul kernels under other tile
knobs, on one CUDA card.

    python3 scripts/torch_matmul_tile_sweep.py

``lookaheaddecoding_tpu_torch/ops/csrc/quant_matmul.cu`` has two
compile-time knobs: ``QM_ROW_BN``, the output columns a block owns in the
one-row variant (T <= 8; the block is [256 / QM_ROW_BN, QM_ROW_BN]), and
``QM_SKIP_DEAD_ROWS``, whether threads whose rows lie past T skip the FMAs
(0 nowhere, 1 in the one-row variant, 2 in the [64, 64] variant as well).
This script builds the source once for each setting below (all ``nvcc``
runs started together), checks that every build gives the default build's
bits, and times each kernel in bfloat16 on the decode path's two large
shapes, with the weight cold in L2 (the calls rotate over more copies of
the weight than the 50 MB L2 holds). It answers what holds the one-row call
(T = 1) far above its byte bound: too few blocks (narrower tiles give
4x as many) or the work inside a block. No setting changes the order of
any sum, so a row's result is the same in all of them.

Prints one line a (kernel, shape, T) with every variant's time in ms, then
``nvidia-smi``'s name and power limit. Exits non-zero without a CUDA
device or when a variant's output differs.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# (QM_ROW_BN, QM_SKIP_DEAD_ROWS); the first is the package's build
VARIANTS = [(64, 1), (64, 0), (64, 2), (32, 1), (32, 0), (16, 1)]
# (mode, bits, [(K, N), ...]): the gate/up and the down projection of
# TinyLlama-1.1B, unfused for int8 and fused for int4
CASES = [("int8", 8, [(2048, 5632), (5632, 2048)]),
         ("int4", 4, [(2048, 11264), (5632, 2048)]),
         ("int4_pipe", 4, [(2048, 11264), (5632, 2048)])]
ROWS = (1, 8, 141, 240)   # AR row, widest one-row tile, logits rows, composite


def build_variant(bn: int, skip: int):
    from lookaheaddecoding_tpu_torch.ops import _build
    out = _build.BUILD_DIR / f"libquant_matmul-sweep-bn{bn}-skip{skip}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    cmd = [_build.nvcc(), *flags, f"-DQM_ROW_BN={bn}",
           f"-DQM_SKIP_DEAD_ROWS={skip}", "-o", str(out),
           str(_build.CSRC / "quant_matmul.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for BN={bn} skip={skip}:\n"
                           f"{proc.stdout}{proc.stderr}")
    symbol, argtypes = _build.SIGNATURES["quant_matmul"]
    fn = getattr(ctypes.CDLL(str(out)), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_matmul_tile_sweep: no CUDA device", file=sys.stderr)
        return 1
    from lookaheaddecoding_tpu_torch.ops import quant
    from lookaheaddecoding_tpu_torch.ops.quant_matmul import (_DTYPE_CODES,
                                                              _MODES)

    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        fns = list(ex.map(lambda v: build_variant(*v), VARIANTS))
    print(f"built {len(VARIANTS)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    stream = torch.cuda.current_stream(device).cuda_stream
    rng = np.random.default_rng(0)

    def randn(*shape, scale=1.0):
        x = rng.standard_normal(shape, dtype=np.float32) * scale
        return torch.from_numpy(x).to(device)

    def launch(fn, mode, x, wq, out):
        w = wq["q" if mode == "int8" else "q4"]
        t, k = x.shape
        err = fn(x.data_ptr(), w.data_ptr(), wq["scale"].data_ptr(),
                 out.data_ptr(), _MODES[mode], _DTYPE_CODES[x.dtype], t, k,
                 w.shape[1], w.shape[0], 0 if mode == "int8" else k // 2,
                 stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    def time_ms(fn, mode, x, wqs, out, reps=50, warm=5):
        for i in range(warm):
            launch(fn, mode, x, wqs[i % len(wqs)], out)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps):
            launch(fn, mode, x, wqs[i % len(wqs)], out)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    names = [f"bn{bn}/skip{skip}" for bn, skip in VARIANTS]
    print("ms a call, bfloat16, weight cold in L2; variants: "
          + ", ".join(names), flush=True)
    for mode, bits, kns in CASES:
        for k, n in kns:
            copies = 1 + (64 << 20) // (k * n * bits // 8)
            wqs = [quant.quantize_weight(randn(k, n, scale=0.02), bits)
                   for _ in range(copies)]
            for t in ROWS:
                x = randn(t, k).bfloat16()
                outs = []
                for fn in fns:
                    out = torch.empty((t, n), dtype=x.dtype, device=device)
                    launch(fn, mode, x, wqs[0], out)
                    outs.append(out)
                torch.cuda.synchronize()
                for name, out in zip(names, outs):
                    if not torch.equal(out, outs[0]):
                        raise AssertionError(
                            f"{name} differs from {names[0]}: {mode} T={t} "
                            f"K={k} N={n}")
                times = [time_ms(fn, mode, x, wqs, outs[0]) for fn in fns]
                print(f"{mode:9s} K={k:4d} N={n:5d} T={t:3d}: "
                      + "  ".join(f"{ms:.4f}" for ms in times), flush=True)
            del wqs
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
