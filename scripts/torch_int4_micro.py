#!/usr/bin/env python3
"""Micro-benchmark of the PyTorch/CUDA port's int4 unpack-matmul variants,
on one CUDA card: the counterpart of ``scripts/int4_micro.py``.

    python3 scripts/torch_int4_micro.py

Times ``x[T, K] @ W[K, N]`` in bfloat16 on TinyLlama-1.1B's four weight
shapes at the decode row counts, with the weight cold in L2 (the calls
rotate over more copies of the weight than the 50 MB L2 holds), comparing

  - ``torch.matmul`` on the bf16 weight (the library's product),
  - the int8 kernel and the int4 kernel of ``ops/quant_matmul.py``,
  - the int4 kernel with the shift decode (``ops/int4_micro.py``; bit-equal
    to the int4 kernel, so its time says what the decode costs),
  - the K-outer int4 variant (a split over K summed in slab order; its
    time says what a one-row call gains from more blocks).

The first line is ``nvidia-smi``'s card name and power limit; then one row
a (shape, T) in microseconds a call, with the least time the card could
take for the int4 bytes. Every variant is checked against its plain
version before it is timed. Exits non-zero without a CUDA device or when
a variant disagrees.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SHAPES = [(2048, 5632), (2048, 2048), (5632, 2048), (2048, 32000)]
ROWS = (8,)
HBM_BYTES_S = 3.35e12        # H100 SXM
# kernel against plain version: the same float32 sum in another order; in
# bf16 both round it once, so they differ by one bf16 ulp (2**-7 of |y|) at
# most where the sums straddle a rounding edge
TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
       "bfloat16": dict(atol=1e-3, rtol=2.0 ** -7)}


def time_us(fn, reps=50, warm=5) -> float:
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return 1e3 * start.elapsed_time(end) / reps


def check_variants(x, wq, b4):
    """Both variants on one input: the shift variant equals the int4
    kernel's output ``b4`` bit for bit, each is within TOL of its plain
    version, the K-outer variant within TOL of the int4 kernel, and one of
    its rows alone gives the bits of the same row among the others.
    Returns each variant's largest error against its plain version."""
    import torch
    from lookaheaddecoding_tpu_torch.ops import int4_micro as im
    from lookaheaddecoding_tpu_torch.ops import quant

    k2 = quant.logical_packed_rows(wq)
    q4, scale = wq["q4"], wq["scale"]
    tol = TOL[str(x.dtype).split(".")[1]]
    where = f"{x.dtype} T={x.shape[0]} K={x.shape[1]} N={q4.shape[1]}"
    shift = im.int4_matmul_shift(x, q4, scale, logical_k2=k2)
    kouter = im.int4_matmul_kouter(x, q4, scale, logical_k2=k2)
    if not torch.equal(shift, b4):
        raise AssertionError(f"shift variant differs from the int4 kernel: "
                             f"{where}")
    errs = {}
    for name, got, ref in (("shift", shift, im.int4_matmul_shift_ref),
                           ("kouter", kouter, im.int4_matmul_kouter_ref)):
        want = ref(x, q4, scale).float()
        errs[name] = (got.float() - want).abs().max().item()
        if not torch.allclose(got.float(), want, **tol):
            raise AssertionError(f"{name} variant disagrees with its plain "
                                 f"version: {where} max_abs_err={errs[name]}")
    if not torch.allclose(kouter.float(), b4.float(), **tol):
        raise AssertionError(f"K-outer variant disagrees with the int4 "
                             f"kernel: {where}")
    r = x.shape[0] // 2
    one = im.int4_matmul_kouter(x[r:r + 1].contiguous(), q4, scale,
                                logical_k2=k2)
    if not torch.equal(one[0], kouter[r]):
        raise AssertionError(f"K-outer variant: a row alone differs from "
                             f"the same row among {x.shape[0]}: {where}")
    return errs


def run(device, shapes=SHAPES, rows=ROWS, log=print, seed=0, check=True):
    """Check (unless ``check`` is False) and time every variant on
    ``shapes`` at ``rows``. Returns a list of dicts, one a (K, N, T), with
    each product's microseconds."""
    import torch
    from lookaheaddecoding_tpu_torch.ops import int4_micro as im
    from lookaheaddecoding_tpu_torch.ops import quant
    from lookaheaddecoding_tpu_torch.ops import quant_matmul as qm

    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        x = rng.standard_normal(shape, dtype=np.float32) * scale
        return torch.from_numpy(x).to(device)

    results = []
    for k, n in shapes:
        copies = 1 + (64 << 20) // (k * n // 2)
        ws = [randn(k, n, scale=0.02) for _ in range(copies)]
        w4 = [quant.quantize_weight(w, 4) for w in ws]
        w8 = [quant.quantize_weight(w, 8) for w in ws]
        wb = [w.bfloat16() for w in ws]
        del ws
        k2 = quant.logical_packed_rows(w4[0])
        for t in rows:
            errs = None
            for dtype in (torch.float32, torch.bfloat16):
                x = randn(t, k).to(dtype)
                if check:
                    b4 = qm.int4_matmul(x, w4[0]["q4"], w4[0]["scale"],
                                        logical_k2=k2)
                    errs = check_variants(x, w4[0], b4)
            turn = iter(range(10 ** 9))

            def rotate(fn):
                return lambda: fn(next(turn) % copies)
            us = {
                "bf16": time_us(rotate(lambda i: torch.matmul(x, wb[i]))),
                "int8": time_us(rotate(lambda i: qm.int8_matmul(
                    x, w8[i]["q"], w8[i]["scale"]))),
                "int4": time_us(rotate(lambda i: qm.int4_matmul(
                    x, w4[i]["q4"], w4[i]["scale"], logical_k2=k2))),
                "int4_shift": time_us(rotate(lambda i: im.int4_matmul_shift(
                    x, w4[i]["q4"], w4[i]["scale"], logical_k2=k2))),
                "int4_kouter": time_us(rotate(lambda i: im.int4_matmul_kouter(
                    x, w4[i]["q4"], w4[i]["scale"], logical_k2=k2))),
                "shift_plain": time_us(rotate(lambda i: im.int4_matmul_shift_ref(
                    x, w4[i]["q4"], w4[i]["scale"])), reps=10),
                "kouter_plain": time_us(rotate(
                    lambda i: im.int4_matmul_kouter_ref(
                        x, w4[i]["q4"], w4[i]["scale"])), reps=10),
            }
            sol = 1e6 * (k * n // 2) / HBM_BYTES_S
            log(f"K={k:5d} N={n:5d} T={t:3d}  sol_i4={sol:6.1f}us  "
                f"bf16={us['bf16']:7.1f}  int8={us['int8']:7.1f}  "
                f"int4={us['int4']:7.1f}  int4_shift={us['int4_shift']:7.1f}  "
                f"int4_kouter={us['int4_kouter']:7.1f}")
            results.append(dict(k=k, n=n, t=t, us=us, max_abs_err=errs))
        del w4, w8, wb
    return results


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_int4_micro: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    print("us a call, bfloat16, weight cold in L2", flush=True)
    run(torch.device("cuda"), log=lambda *a: print(*a, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
