#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's quantized matmul kernels under other tile
knobs, on one CUDA card.

    python3 scripts/torch_matmul_tile_sweep.py [--group fma|mma|all]

``lookaheaddecoding_tpu_torch/ops/csrc/quant_matmul.cu`` has compile-time
knobs of two kernel designs, each reached by the rows of its group:

- ``mma``: the tensor-core int8, int4 and pipelined int4 kernels that
  bfloat16 x runs (``quant_matmul_mma.cuh``): the ring's stages for
  T <= 16 (``QM_MMA_SMALL_STAGES``) and for larger T (``QM_MMA_STAGES``),
  the rows of the large tile where K is not split (``QM_MMA_BIG_BM``, 0:
  64 or 80 by the waves), the fewest blocks for which the large tile is
  taken over the [64, 64] one (``QM_MMA_BIG_MIN_BLOCKS``) and the widest
  weight whose K is split over a cluster at any K of 1024 input rows or
  more (``QM_MMA_SPLIT_N``). Rows: int8 and int4, in bfloat16.
- ``fma``: the float32-FMA kernels (``quant_matmul.cuh``), which only a
  float32 x reaches: ``QM_ROW_BN``, the output
  columns a block owns in the one-row variant (T <= 8), and
  ``QM_SKIP_DEAD_ROWS``, whether threads whose rows lie past T skip the
  FMAs (0 nowhere, 1 in the one-row variant, 2 in the [64, 64] variant as
  well). Rows: int8, in float32 (bfloat16 x runs every product on the
  tensor cores, which these knobs do not reach).

The script builds the source once for each setting of the chosen groups
(all ``nvcc`` runs started together), checks that every build gives the
default build's bits (a setting that moves the split of K: within one
bf16 ulp) and that in every build a row alone gives the same row's bits
among T, and times each kernel in its group's dtype on the decode path's
shapes with the weight cold in L2 (the calls rotate over more copies of
the weight than the 50 MB L2 holds). Times are of the device alone: 20
calls captured in a CUDA graph and replayed, so the Python wrapper's time
is not in them.

Prints one line a (kernel, shape, T) with every setting's time in ms, then
``nvidia-smi``'s name and power limit. Exits non-zero without a CUDA
device or when a setting's output differs.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import graph_ms  # noqa: E402  (the device-alone yardstick)

# (name, -D definitions); the first of each group is the package's build
GROUPS = {
    "mma": [("default", {}),
            ("stages=6", {"QM_MMA_STAGES": 6}),
            ("bm=64", {"QM_MMA_BIG_BM": 64}),
            ("split-n=0", {"QM_MMA_SPLIT_N": 0}),
            ("small-stages=12", {"QM_MMA_SMALL_STAGES": 12})],
    "fma": [("bn64/skip1", {}),
            ("bn64/skip0", {"QM_SKIP_DEAD_ROWS": 0}),
            ("bn64/skip2", {"QM_SKIP_DEAD_ROWS": 2}),
            ("bn32/skip1", {"QM_ROW_BN": 32}),
            ("bn16/skip1", {"QM_ROW_BN": 16})],
}
# (mode, bits, [(K, N), ...]) a group times: the gate/up and the down
# projection of TinyLlama-1.1B, unfused for int8 and fused for int4
CASES = {"mma": [("int8", 8, [(2048, 5632), (5632, 2048), (2048, 2048),
                                (2048, 256), (2048, 32000)]),
                 ("int4", 4, [(2048, 11264), (5632, 2048), (2048, 2560)])],
         "fma": [("int8", 8, [(2048, 5632), (5632, 2048)])]}
# AR row, a small composite, the prefill chunk, the logits rows, composite,
# the paged step of four lanes
ROWS = (1, 16, 64, 128, 141, 240, 960)
# settings that move the K split (of narrow weights): still one order for
# every T, but not the default's order
MOVES_ORDER = ("SPLIT_N",)


def build_variant(group: str, name: str, defines: dict):
    from lookaheaddecoding_tpu_torch.ops import _build
    tag = "".join(ch if ch.isalnum() else "_" for ch in name)
    out = _build.BUILD_DIR / f"libquant_matmul-sweep-{group}-{tag}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    cmd = [_build.nvcc(), *flags,
           *(f"-D{key}={value}" for key, value in defines.items()),
           "-o", str(out), str(_build.CSRC / "quant_matmul.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    symbol, argtypes = _build.SIGNATURES["quant_matmul"]
    fn = getattr(ctypes.CDLL(str(out)), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def main() -> int:
    import torch
    parser = argparse.ArgumentParser()
    parser.add_argument("--group", choices=("fma", "mma", "all"),
                        default="all")
    group_arg = parser.parse_args().group
    groups = ["mma", "fma"] if group_arg == "all" else [group_arg]
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
    jobs = [(g, name, defs) for g in groups for name, defs in GROUPS[g]]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as ex:
        fns = list(ex.map(lambda job: build_variant(*job), jobs))
    print(f"built {len(jobs)} settings in {time.perf_counter() - t0:.1f} s",
          flush=True)
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
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    for group in groups:
        chosen = [(name, fn) for (g, name, _), fn in zip(jobs, fns)
                  if g == group]
        names = [name for name, _ in chosen]
        dtype = torch.bfloat16 if group == "mma" else torch.float32
        print(f"[{group}] device ms a call, {dtype}, weight cold in L2; "
              f"settings: " + ", ".join(names), flush=True)
        for mode, bits, kns in CASES[group]:
            for k, n in kns:
                copies = 1 + (64 << 20) // (k * n * bits // 8)
                wqs = [quant.quantize_weight(randn(k, n, scale=0.02), bits)
                       for _ in range(copies)]
                for t in ROWS:
                    x = randn(t, k).to(dtype)
                    outs = []
                    for _, fn in chosen:
                        out = torch.empty((t, n), dtype=x.dtype,
                                          device=device)
                        launch(fn, mode, x, wqs[0], out)
                        outs.append(out)
                    torch.cuda.synchronize()
                    for (name, out), (_, _, defs) in zip(
                            zip(names, outs),
                            [j for j in jobs if j[0] == group]):
                        if any(m in key for key in defs for m in MOVES_ORDER):
                            same = torch.allclose(out.float(), outs[0].float(),
                                                  atol=1e-3, rtol=2.0 ** -7)
                        else:
                            same = torch.equal(out, outs[0])
                        if not same:
                            raise AssertionError(
                                f"{name} differs from {names[0]}: {mode} "
                                f"T={t} K={k} N={n}")
                    if t > 8:   # a row alone gives the same row's bits
                        for (name, fn), out in zip(chosen, outs):
                            one = torch.empty((1, n), dtype=x.dtype,
                                              device=device)
                            launch(fn, mode, x[7:8].contiguous(), wqs[0], one)
                            if not torch.equal(one[0], out[7]):
                                raise AssertionError(
                                    f"{name}: a row alone differs: {mode} "
                                    f"T={t} K={k} N={n}")
                    times = [graph_ms(lambda i, fn=fn: launch(
                        fn, mode, x, wqs[i % copies], outs[0]))
                        for _, fn in chosen]
                    print(f"{mode:9s} K={k:4d} N={n:5d} T={t:3d}: "
                          + "  ".join(f"{ms:.4f}" for ms in times),
                          flush=True)
                del wqs
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
