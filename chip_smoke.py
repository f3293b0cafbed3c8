#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card (an H100 is the
target). It imports no JAX. Phases, each printed as it runs:

1. device: the card's name, the device count, and ``nvidia-smi``'s name
   and power limit;
2. build: every kernel compiled with ``nvcc`` from the sources in the
   checkout (in parallel, one ``nvcc`` a source), with its build time and
   the ``-Xptxas -v`` report;
3. kernels: each kernel against its plain PyTorch version on the card, in
   bfloat16 and float32, each with the tolerance stated below, then its
   time beside the plain version's, the bound of the card and one
   library call (a yardstick the port never calls): the attention kernel
   on a plain and on an int8 KV cache, and the int8, int4 and pipelined
   int4 matrix products (the pipelined one also bit-equal to the int4 one);
   the paged attention call on a shared page pool with shuffled tables
   (plain and int8 pool, page sizes 128 and 48, lanes of different
   ``kv_len``), also bit-equal, lane by lane, to the flat call on the
   contiguous cache; and the int4 product's two micro-benchmark variants
   (shift decode: bit-equal to the int4 kernel; K-outer: a row alone equal
   to the same row among others), then ``scripts/torch_int4_micro.py``'s
   timing loop, the path that launches them;
4. main path: the headline configuration, a synthetic TinyLlama-1.1B
   model at full width (random weights from a seed, with an embedding and
   head that make greedy decoding follow a token cycle), greedy lookahead
   ``generate`` and AR ``generate_baseline`` (64-token prompt, 256 new
   tokens in bfloat16, 128 in the quantized configurations), first in
   bfloat16, then quantized on the card by the port's
   ``quantize_params``: ``int8_weights``, ``int4_weights`` (fused
   projections, int8 LM head), ``int8_weights_int8_kv``, and
   ``int4_weights_pipelined`` (the int4 engine with
   ``ops.quant.INT4_PIPELINE`` set). In every configuration the tokens must
   equal its own baseline's and follow the cycle, and each path must have
   gone through the kernels (counted for each path alone: launches > 0,
   plain-version calls 0);
5. profile: lookahead and AR runs under ``torch.profiler``, for the
   device's busy and idle share and the kernels that take the most time
   (bfloat16, and the lookahead run of ``int8_weights``);
6. paged serving: ``PagedServingEngine`` on the same model (4 lanes, pages
   of 128 slots, 24 data pages, 4 steps between host reads), ``paged_bf16``
   with ten requests (shared prefixes with a partial tail page and ending
   on a page boundary, conversation carry, streaming, an interactive
   request) and ``paged_int8_weights_int8_kv`` with four. Every result
   must equal the flat ``generate`` on the same prompt, admission must have
   waited for pages at least once, every page must be free at the end, and
   the path must have gone through the paged attention kernel with no
   plain-version call; then a profile of the batched step.

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``. Any failed phase
raises, so the script exits non-zero and prints no result; it also exits
non-zero when no CUDA device is present.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# Peaks of an H100 SXM (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # f32 off the tensor cores
# kernel vs plain version: fp32 sums in another order and an online softmax
# (f32); in bf16 both round p to bf16 before the PV product, but relative to
# a running maximum in the kernel and the row maximum in the plain version,
# and the plain version rounds its PV product to bf16 before it divides by
# the denominator (one ulp at |x| in [2, 4) is 0.0156)
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# That bf16 tolerance is wide beside an output of a few 1e-2 (~750 visible
# keys), so the bf16 kernel is also held against the float32 kernel on the
# same inputs, rounded to bf16, within what its two roundings can do: p to
# bf16 (half an ulp, 2**-8, of every term: 2**-8 * sum_j p_j |v_j|, which
# the float32 kernel computes from |v|) and the output to bf16 (the two may
# land one ulp apart, 2**-7 |out|), plus the float32 tolerance
BF16_HALF_ULP, BF16_ULP, F32_SLACK = 2.0 ** -8, 2.0 ** -7, 1e-4
# quantized products vs plain version: the same float32 sum in another
# order (f32: outputs of magnitude ~1-8 from K up to 11008 terms); in bf16
# both round that float32 value, so they differ by at most one bf16 ulp
# (2**-7 of |y| at most: 0.031 at |y| in [4, 8)) where the sums straddle a
# rounding edge, and by the float32 difference near zero
MM_TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
          "bfloat16": dict(atol=1e-3, rtol=2.0 ** -7)}
TPU_KERNELS = ("lookaheaddecoding_tpu/ops/lookahead_attention.py:128, "
               "lookaheaddecoding_tpu/ops/lookahead_attention.py:201")
TPU_PAGED_KERNEL = "lookaheaddecoding_tpu/ops/lookahead_attention.py:281"
CSRC = "lookaheaddecoding_tpu_torch/ops/csrc/"

# headline configuration (bench.py): TinyLlama-1.1B widths, L7/W20/G20
ARCH = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
            num_hidden_layers=22, num_attention_heads=32,
            num_key_value_heads=4, max_position_embeddings=2048)
LEVEL, WINDOW, GUESS = 7, 20, 20
# composite rows a step, and those whose logits are read (row 0, the newest
# window level, the verification branch): the LM head's row count
S_COMP = (LEVEL - 1) * WINDOW + GUESS * (LEVEL - 1)        # 240
LOGITS_ROWS = 1 + WINDOW + GUESS * (LEVEL - 1)             # 141
MAX_SEQ, PREFILL_CHUNK, PROMPT_LEN, N_NEW = 1024, 128, 64, 256
N_NEW_QUANT = 128     # new tokens of the four quantized flat configurations
WARM_NEW = 32         # tokens of the untimed warm-up pass of each path
# paged serving: lanes, slots a page, data pages (fewer than the flat
# engine's 4 * 8 = 32, so admission has to wait), steps between host reads
LANES, PAGE, N_PAGES, STEPS_PER_SYNC, PAGED_NEW = 4, 128, 24, 4, 128
PROFILE_NEW = 64      # tokens a profiled run: the trace grows with the steps


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=50, warm=5) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def attention_bound(vis, hq, hkv, d, dtype_name, int8_kv=False):
    """Least time for one call on this run's mask ``vis`` [S, M]: the bytes
    (q read and the output written once, each K/V column that some row sees
    read once: at 1 byte a value plus a 4-byte scale a slot and head in an
    int8 cache) against the FLOPs of the visible (row, key) pairs only
    (4*D a pair and query head: QK^T and PV)."""
    s = vis.shape[0]
    pairs = int(vis.sum())
    live_cols = int(vis.any(dim=0).sum())
    elem = 2 if dtype_name == "bfloat16" else 4
    kv_bytes = 2 * hkv * live_cols * ((d + 4) if int8_kv else d * elem)
    nbytes = elem * 2 * s * hq * d + kv_bytes
    flops = 4 * d * hq * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                        else "operations")


def check_attention(device):
    """The attention kernel on a plain cache and on an int8 cache written
    by the port's ``kv_cache_write``. Returns the headline call's numbers
    for each."""
    import torch
    import torch.nn.functional as F
    from lookaheaddecoding_tpu_torch.models.llama import kv_cache_write
    from lookaheaddecoding_tpu_torch.ops.lookahead_attention import (
        _block_mask, lookahead_attention, lookahead_attention_ref)

    rng = np.random.default_rng(0)
    hq, hkv, d = 32, 4, 64
    geo = dict(level=LEVEL, window=WINDOW, guess_size=LEVEL - 1)
    s_comp = S_COMP
    cases = ([(s_comp, 1024, kv, False, 0) for kv in (0, 37, 512, 784)]
             + [(s_comp, 2048, kv, False, 0) for kv in (1000, 1808)]
             + [(PREFILL_CHUNK, 1024, kv, True, 0) for kv in (0, 640)]
             + [(s_comp, 1024, 600, False, 300),
                (PREFILL_CHUNK, 1024, 600, True, 300),
                (1, 1024, 700, True, 0)])          # the AR baseline's call
    timed = {(s_comp, 1024, 512, False, 0), (s_comp, 2048, 1808, False, 0),
             (PREFILL_CHUNK, 1024, 640, True, 0), (1, 1024, 700, True, 0)}
    headline = {}
    for int8_kv in (False, True):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            for s, m, kv, causal, sw in cases:
                def mk(*shape):
                    x = rng.standard_normal(shape, dtype=np.float32)
                    return torch.from_numpy(x).to(device, dtype)
                q = mk(s, hq, d)
                if int8_kv:
                    def cache():
                        c = {"q": torch.zeros((hkv, m, d), dtype=torch.int8,
                                              device=device),
                             "s": torch.full((hkv, m, 1), 1e-8,
                                             device=device)}
                        return kv_cache_write(c, mk(m, hkv, d), 0)
                    k, v = cache(), cache()
                    # the yardstick's inputs: the dequantized cache
                    kd, vd = ((c["q"].float() * c["s"]).to(dtype)
                              for c in (k, v))
                else:
                    k, v = mk(hkv, m, d), mk(hkv, m, d)
                    kd, vd = k, v
                kv_len = torch.tensor([kv], dtype=torch.int32, device=device)
                kw = dict(geo, causal=causal, sliding_window=sw)
                got = lookahead_attention(q, k, v, kv_len, **kw)
                want = lookahead_attention_ref(q, k, v, kv_len, **kw)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ok = torch.allclose(got.float(), want.float(), **TOL[dname])
                line = (f"  {'int8-KV ' if int8_kv else ''}{dname:8s} "
                        f"S={s:3d} M={m} kv_len={kv:4d} "
                        f"{'causal' if causal else 'composite'} sw={sw}: "
                        f"max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("kernel disagrees with plain "
                                         "version:" + line)
                if dtype == torch.bfloat16:
                    if int8_kv:
                        kf, vf = k, v
                        v_abs = {"q": v["q"].abs(), "s": v["s"]}
                    else:
                        kf, vf = k.float(), v.float()
                        v_abs = vf.abs()
                    exact = lookahead_attention(q.float(), kf, vf, kv_len,
                                                **kw)
                    weight = lookahead_attention(q.float(), kf, v_abs, kv_len,
                                                 **kw)
                    limit = (BF16_HALF_ULP * weight + BF16_ULP * exact.abs()
                             + F32_SLACK)
                    err32 = (got.float() - exact.bfloat16().float()).abs()
                    share = (err32 / limit).max().item()
                    line += (f"; vs float32 kernel max_abs_err="
                             f"{err32.max().item():.3e}, at most {share:.2f} "
                             f"of its rounding limit")
                    if not share <= 1.0:
                        raise AssertionError("bf16 kernel outside its "
                                             "rounding limit:" + line)
                if (s, m, kv, causal, sw) in timed:
                    vis = _block_mask(kv_len, m, s_len=s, causal=causal,
                                      sliding_window=sw, device=device, **geo)
                    q4 = q.transpose(0, 1)[None]
                    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                        q4, kd[None], vd[None], attn_mask=vis,
                        enable_gqa=True)
                    ms = time_ms(
                        lambda: lookahead_attention(q, k, v, kv_len, **kw))
                    plain_ms = time_ms(
                        lambda: lookahead_attention_ref(q, k, v, kv_len, **kw),
                        reps=10)
                    lib_ms = time_ms(lib)
                    bound, by = attention_bound(vis, hq, hkv, d, dname,
                                                int8_kv)
                    line += (f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                             f"ms, sdpa {lib_ms:.4f} ms, bound {bound:.5f} "
                             f"ms ({by})")
                    if (dtype == torch.bfloat16 and (s, m, kv, causal, sw)
                            == (s_comp, 1024, 512, False, 0)):
                        headline[int8_kv] = dict(
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound, bound_by=by, library_ms=lib_ms)
                log(line)
    return dict(headline[False], int8_kv=headline[True])


def check_paged_attention(device):
    """The paged attention call against its plain version and, lane by
    lane and bit for bit, against the flat call on the contiguous cache:
    bfloat16 and float32, a plain and an int8 pool, composite and causal,
    with and without a sliding window, four lanes whose ``kv_len`` are 0,
    one past a page boundary, 512 and the capacity less S, shuffled
    tables, pages of 128 and of 48 slots. Then its time at the headline
    shape (four lanes at kv_len 512) beside the plain version's, the bound
    and one library call on the gathered cache. Returns the headline
    numbers, plain pool and int8 pool."""
    import torch
    import torch.nn.functional as F
    from lookaheaddecoding_tpu_torch.core.paged import (paged_gather,
                                                        paged_write)
    from lookaheaddecoding_tpu_torch.ops.lookahead_attention import (
        _block_mask, lookahead_attention, paged_lookahead_attention,
        paged_lookahead_attention_ref)

    rng = np.random.default_rng(2)
    hq, hkv, d, lanes = 32, 4, 64, LANES
    geo = dict(level=LEVEL, window=WINDOW, guess_size=LEVEL - 1)
    headline = {}

    def lane_of(tree, b):
        if isinstance(tree, dict):
            return {n: leaf[b].contiguous() for n, leaf in tree.items()}
        return tree[b].contiguous()

    def make(page, nb, dtype, int8_kv, s, kv_lens):
        """q, the pool filled through shuffled tables, tables, kv_lens."""
        def mk(*shape):
            x = rng.standard_normal(shape, dtype=np.float32)
            return torch.from_numpy(x).to(device, dtype)
        n_pages = lanes * nb + lanes
        slots_total = n_pages * page
        tables = torch.from_numpy(
            lanes + rng.permutation(lanes * nb)).to(device).int().view(
                lanes, nb).contiguous()

        def pool():
            if int8_kv:
                buf = {"q": torch.zeros((hkv, slots_total, d),
                                        dtype=torch.int8, device=device),
                       "s": torch.full((hkv, slots_total, 1), 1e-8,
                                       device=device)}
            else:
                buf = torch.zeros((hkv, slots_total, d), dtype=dtype,
                                  device=device)
            slots = (tables.long()[:, :, None] * page
                     + torch.arange(page, device=device)).reshape(-1)
            return paged_write(buf, slots, mk(lanes * nb * page, hkv, d))
        return (mk(lanes, s, hq, d), pool(), pool(), tables,
                torch.tensor(kv_lens, dtype=torch.int32, device=device))

    for page, nb in ((128, 8), (48, 22)):
        mlog = page * nb
        for int8_kv in (False, True):
            for dtype in (torch.bfloat16, torch.float32):
                dname = str(dtype).split(".")[1]
                for causal, sw, s in ((False, 0, S_COMP),
                                      (True, 0, PREFILL_CHUNK),
                                      (False, 300, S_COMP),
                                      (True, 300, PREFILL_CHUNK)):
                    q, k, v, tables, kv_lens = make(
                        page, nb, dtype, int8_kv, s,
                        [0, page + 1, 512, mlog - s])
                    kw = dict(geo, causal=causal, sliding_window=sw)
                    got = paged_lookahead_attention(
                        q, k, v, kv_lens, tables, page_size=page, **kw)
                    want = paged_lookahead_attention_ref(
                        q, k, v, kv_lens, tables, page_size=page, **kw)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    where = (f"{'int8-KV ' if int8_kv else ''}{dname} "
                             f"page={page} S={s} "
                             f"{'causal' if causal else 'composite'} sw={sw}")
                    if not torch.allclose(got.float(), want.float(),
                                          **TOL[dname]):
                        raise AssertionError(
                            f"paged kernel disagrees with its plain "
                            f"version: {where} max_abs_err={err:.3e}")
                    kg = paged_gather(k, tables, page)
                    vg = paged_gather(v, tables, page)
                    for b in range(lanes):
                        flat = lookahead_attention(
                            q[b], lane_of(kg, b), lane_of(vg, b),
                            kv_lens[b:b + 1], **kw)
                        if not torch.equal(flat, got[b]):
                            raise AssertionError(
                                f"paged kernel, lane {b}, differs from the "
                                f"flat kernel on the contiguous cache: "
                                f"{where}")
                    log(f"  {where}: max_abs_err={err:.3e} ok, every lane == "
                        f"the flat kernel bit for bit")

    # times at the headline shape: four lanes at kv_len 512, pages of 128
    for int8_kv in (False, True):
        dtype = torch.bfloat16
        q, k, v, tables, kv_lens = make(PAGE, MAX_SEQ // PAGE, dtype, int8_kv,
                                        S_COMP, [512] * lanes)
        kw = dict(geo, causal=False, sliding_window=0)
        args = (q, k, v, kv_lens, tables)
        got = paged_lookahead_attention(*args, page_size=PAGE, **kw)
        want = paged_lookahead_attention_ref(*args, page_size=PAGE, **kw)
        err = (got.float() - want.float()).abs().max().item()
        assert torch.allclose(got.float(), want.float(), **TOL["bfloat16"])
        ms = time_ms(lambda: paged_lookahead_attention(
            *args, page_size=PAGE, **kw))
        plain_ms = time_ms(lambda: paged_lookahead_attention_ref(
            *args, page_size=PAGE, **kw), reps=10)
        vis = torch.stack([_block_mask(
            kv_lens[b], MAX_SEQ, s_len=S_COMP, causal=False,
            sliding_window=0, device=device, **geo) for b in range(lanes)])

        def gathered():
            kd, vd = (paged_gather(c, tables, PAGE) for c in (k, v))
            if int8_kv:
                kd, vd = ((c["q"].float() * c["s"]).to(dtype)
                          for c in (kd, vd))
            return kd, vd
        kd, vd = gathered()
        q4 = q.transpose(1, 2)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=vis[:, None], enable_gqa=True))
        gather_ms = time_ms(gathered, reps=10)
        per_lane = [attention_bound(vis[b], hq, hkv, d, "bfloat16", int8_kv)
                    for b in range(lanes)]
        bound = sum(t for t, _ in per_lane)
        by = per_lane[0][1]
        log(f"  {'int8-KV ' if int8_kv else ''}bfloat16 B={lanes} S={S_COMP} "
            f"kv_len=512 page={PAGE}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa on the gathered cache {lib_ms:.4f} ms "
            f"(+ {gather_ms:.4f} ms to gather"
            f"{' and dequantize' if int8_kv else ''}), bound {bound:.5f} ms "
            f"({by})")
        headline[int8_kv] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound, bound_by=by,
                                 library_ms=lib_ms, gather_ms=gather_ms)
    return headline


def load_int4_micro():
    """The micro-benchmark script, ``scripts/torch_int4_micro.py``, as a
    module."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent / "scripts" / "torch_int4_micro.py"
    spec = importlib.util.spec_from_file_location("torch_int4_micro", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check_int4_micro(device):
    """The int4 product's two variants: held against their plain versions
    and the int4 kernel by the micro-benchmark's own checks on its four
    shapes at T = 1, 8 and 240 (and one padded Llama-2-7B shape), then the
    micro-benchmark's timing loop, counted as the path that launches them.
    Returns each variant's numbers at T = 8 on (2048, 5632) and its
    launches in the timing loop."""
    import torch
    from lookaheaddecoding_tpu_torch.ops import int4_micro as im
    from lookaheaddecoding_tpu_torch.ops import quant
    from lookaheaddecoding_tpu_torch.ops import quant_matmul as qm

    micro = load_int4_micro()
    rng = np.random.default_rng(3)
    rows = (1, 8, S_COMP)
    worst = {"shift": 0.0, "kouter": 0.0}
    for k, n in micro.SHAPES + [(11008, 4096)]:
        w = torch.from_numpy(
            rng.standard_normal((k, n), dtype=np.float32) * 0.02).to(device)
        wq = quant.quantize_weight(w, 4)
        for dtype in (torch.bfloat16, torch.float32):
            for t in rows:
                x = torch.from_numpy(rng.standard_normal(
                    (t, k), dtype=np.float32)).to(device, dtype)
                b4 = qm.int4_matmul(x, wq["q4"], wq["scale"],
                                    logical_k2=quant.logical_packed_rows(wq))
                errs = micro.check_variants(x, wq, b4)
                if dtype == torch.bfloat16:
                    for name, err in errs.items():
                        worst[name] = max(worst[name], err)
        log(f"  int4 variants K={k:5d} N={n:5d} T in {rows}, bfloat16 and "
            f"float32: shift == int4 kernel bit for bit, K-outer within "
            f"tolerance of its plain version and of the int4 kernel, a row "
            f"alone == the same row among T: ok")
        del w, wq

    # the micro-benchmark's timing loop is the path that launches them
    im.counts.update(dict.fromkeys(im.counts, 0))
    results = micro.run(device, rows=rows, log=lambda line: log("  " + line),
                        check=False)
    launches = dict(im.counts)
    assert launches["shift"] > 0 and launches["kouter"] > 0, launches
    assert launches["plain"] == 0, launches
    head = next(r for r in results if (r["k"], r["n"], r["t"])
                == (2048, 5632, 8))["us"]
    bound, by = matmul_bound(8, 2048, 5632, 4, "bfloat16")
    out = {}
    for name in ("shift", "kouter"):
        out[name] = dict(
            max_abs_err=worst[name], ms=head[f"int4_{name}"] / 1e3,
            plain_ms=head[f"{name}_plain"] / 1e3, bound_ms=bound,
            bound_by=by, library_ms=head["bf16"] / 1e3,
            launches=launches[name])
    return out


def matmul_bound(t, k, n, bits, dtype_name):
    """Least time for one quantized product: the bytes (the weight at its
    stored width, the float32 scales, x read and y written once) against
    2*T*K*N operations at the peak rate of x's type."""
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = k * n * bits // 8 + 4 * n + elem * t * (k + n)
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = 2 * t * k * n / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                        else "operations")


def check_matmuls(device):
    """The int8, int4 and pipelined int4 products against their plain
    versions at the main path's shapes and row counts (the AR row, a
    ragged count, the prefill chunk, the logits rows, the composite) and at
    one padded Llama-2-7B shape and one stacked weight, then their times.
    Returns each kernel's numbers for the composite call (T=240) on the
    gate/up shape."""
    import torch
    from lookaheaddecoding_tpu_torch.ops import quant
    from lookaheaddecoding_tpu_torch.ops import quant_matmul as qm

    rng = np.random.default_rng(1)
    s_comp = S_COMP

    def randn(*shape, scale=1.0):
        x = rng.standard_normal(shape, dtype=np.float32) * scale
        return torch.from_numpy(x).to(device)

    def run(mode, x, wq):
        if mode == "int8":
            return qm.int8_matmul(x, wq["q"], wq["scale"])
        return qm.int4_matmul(x, wq["q4"], wq["scale"],
                              pipeline=mode == "int4_pipe",
                              logical_k2=quant.logical_packed_rows(wq))

    def ref(mode, x, wq):
        if mode == "int8":
            return qm.int8_matmul_ref(x, wq["q"], wq["scale"])
        return qm.int4_matmul_ref(x, wq["q4"], wq["scale"])

    # (K, N): the unfused int8 projections and the LM head; the fused int4
    # projections; Llama-2-7B's down projection, whose K/2 = 5504 packed
    # rows are stored as 5632
    shapes = {8: [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048),
                  (2048, 32000), (11008, 4096)],
              4: [(2048, 2560), (2048, 2048), (2048, 11264), (5632, 2048),
                  (11008, 4096)]}
    rows = (1, 17, PREFILL_CHUNK, LOGITS_ROWS, s_comp)
    worst = dict.fromkeys(("int8", "int4", "int4_pipe"), 0.0)
    for bits, kns in shapes.items():
        for k, n in kns:
            wq = quant.quantize_weight(randn(k, n, scale=0.02), bits)
            if (bits, k) == (4, 11008):
                assert wq["q4"].shape[0] == 5632, wq["q4"].shape
            for dtype in (torch.bfloat16, torch.float32):
                dname = str(dtype).split(".")[1]
                errs = []
                for t in rows:
                    x = randn(t, k).to(dtype)
                    outs = {}
                    for mode in (("int8",) if bits == 8
                                 else ("int4", "int4_pipe")):
                        got, want = run(mode, x, wq), ref(mode, x, wq)
                        torch.cuda.synchronize()
                        err = (got.float() - want.float()).abs().max().item()
                        if not torch.allclose(got.float(), want.float(),
                                              **MM_TOL[dname]):
                            raise AssertionError(
                                f"{mode} kernel disagrees with its plain "
                                f"version: {dname} T={t} K={k} N={n} "
                                f"max_abs_err={err:.3e}")
                        if dtype == torch.bfloat16:
                            worst[mode] = max(worst[mode], err)
                        errs.append(err)
                        outs[mode] = got
                    if bits == 4 and not torch.equal(outs["int4"],
                                                     outs["int4_pipe"]):
                        raise AssertionError(
                            f"pipelined int4 kernel differs from the int4 "
                            f"kernel: {dname} T={t} K={k} N={n}")
                    # a row's product does not depend on the rows beside it
                    if t == s_comp:
                        for mode, full in outs.items():
                            one = run(mode, x[7:8].contiguous(), wq)
                            if not torch.equal(one[0], full[7]):
                                raise AssertionError(
                                    f"{mode}: a row alone differs from the "
                                    f"same row among {t}: {dname} K={k} N={n}")
                log(f"  int{bits} {dname:8s} K={k:5d} N={n:5d} "
                    f"T in {rows}: max_abs_err="
                    f"{max(errs):.3e} ok"
                    + (", pipelined == plain bit for bit" if bits == 4 else ""))
            del wq

    # one stacked [L, K, N] weight, multiplied layer by layer
    for bits in (8, 4):
        stack = quant.quantize_weight(randn(3, 2048, 256, scale=0.02), bits)
        x = randn(s_comp, 2048).bfloat16()
        for li in range(3):
            layer = {name: leaf[li] for name, leaf in stack.items()}
            for mode in (("int8",) if bits == 8 else ("int4", "int4_pipe")):
                got, want = run(mode, x, layer), ref(mode, x, layer)
                if not torch.allclose(got.float(), want.float(),
                                      **MM_TOL["bfloat16"]):
                    raise AssertionError(f"{mode}: stacked weight, layer {li}")
        log(f"  int{bits} stacked [3, 2048, 256] indexed by layer: ok")

    # Times, bf16, with the weight cold in L2 as the decode loop finds it:
    # the calls rotate over enough copies of the weight to exceed the 50 MB
    # L2. library = torch.matmul on the dequantized bf16 weight.
    headline = {}
    for bits, kns in ((8, [(2048, 5632), (5632, 2048), (2048, 32000)]),
                      (4, [(2048, 11264), (5632, 2048)])):
        for k, n in kns:
            copies = 1 + (64 << 20) // (k * n * bits // 8)
            wqs = [quant.quantize_weight(randn(k, n, scale=0.02), bits)
                   for _ in range(copies)]
            dense = [quant.dequantize_weight(w, torch.bfloat16) for w in wqs]
            # the LM head multiplies the AR row or the logits rows
            for t in (1, LOGITS_ROWS if n == 32000 else s_comp):
                x = randn(t, k).bfloat16()
                turn = iter(range(10 ** 9))

                def rotate(fn, ws):
                    return lambda: fn(x, ws[next(turn) % copies])
                lib_ms = time_ms(rotate(torch.matmul, dense))
                bound, by = matmul_bound(t, k, n, bits, "bfloat16")
                for mode in (("int8",) if bits == 8
                             else ("int4", "int4_pipe")):
                    ms = time_ms(rotate(lambda x, w: run(mode, x, w), wqs))
                    plain_ms = time_ms(
                        rotate(lambda x, w: ref(mode, x, w), wqs), reps=10)
                    nums = dict(t=t, k=k, n=n, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound, bound_by=by,
                                library_ms=lib_ms)
                    log(f"  {mode:9s} bfloat16 T={t:3d} K={k} N={n}: kernel "
                        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul "
                        f"on bf16 weights {lib_ms:.4f} ms, bound {bound:.5f} "
                        f"ms ({by})")
                    entry = headline.setdefault(
                        mode, dict(max_abs_err=worst[mode], timings=[]))
                    entry["timings"].append(nums)
                    if t == s_comp and k == 2048:
                        entry.update({key: nums[key] for key in (
                            "ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms")})
            del wqs, dense
    return headline


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

def transition_embed_head(seed, h, vocab):
    """Unit-vector embeddings and an LM head whose columns realize a
    deterministic token-transition cycle (a copy of bench.py's
    ``_transition_embed_head``)."""
    rng = np.random.RandomState(seed)
    embed = rng.randn(vocab, h).astype(np.float32)
    embed /= np.linalg.norm(embed, axis=1, keepdims=True)
    cycle = rng.choice(vocab, size=64, replace=False)
    nxt = np.full(vocab, cycle[0], np.int64)
    nxt[cycle] = np.roll(cycle, -1)
    head = np.zeros((h, vocab), np.float32)
    head[:, nxt[cycle]] = embed[cycle].T          # logits peak at nxt(token)
    return embed, head, nxt


def make_prompt(nxt, start=0, n=PROMPT_LEN):
    t = int(nxt[start])
    prompt = [t]
    for _ in range(n - 1):
        t = int(nxt[t])
        prompt.append(t)
    return prompt


def build_headline(device):
    """The headline model and prompt: synthetic TinyLlama-1.1B weights in
    bfloat16 and the transition cycle they follow."""
    import torch
    import lookaheaddecoding_tpu_torch as lt

    t0 = time.perf_counter()
    mcfg = lt.LlamaConfig(**ARCH, dtype=torch.bfloat16)
    # layer weights small enough that the residual stream stays dominated
    # by the token embedding, so the transition cycle survives 22 layers
    params = lt.init_params(mcfg, seed=0, scale=0.002, device=device)
    embed, head, nxt = transition_embed_head(0, mcfg.hidden_size,
                                             mcfg.vocab_size)
    params["embed"] = torch.from_numpy(embed * np.sqrt(mcfg.hidden_size)).to(
        device, mcfg.dtype)
    params["lm_head"] = torch.from_numpy(head).to(device, mcfg.dtype)
    log(f"  model built in {time.perf_counter() - t0:.1f} s")
    return mcfg, params, make_prompt(nxt), nxt


def build_engine(mcfg, params, kv_quant=None):
    """The headline engine on ``params``: L7/W20/G20, pool from the prompt,
    M=1024, prefill chunk 128 (bench.py's)."""
    import lookaheaddecoding_tpu_torch as lt

    eng = lt.LookaheadEngine(
        mcfg, params,
        lt.LookaheadConfig(level=LEVEL, window_size=WINDOW,
                           guess_set_size=GUESS, pool_from_prompt=True),
        lt.EngineConfig(max_seq_len=MAX_SEQ, prefill_chunk=PREFILL_CHUNK,
                        kv_quant=kv_quant))
    assert eng.lcfg.attention_impl == "kernel", eng.lcfg.attention_impl
    return eng


def main_path(name, eng, prompt, nxt, card, matmul_kernels, n_new=N_NEW):
    """One configuration's ``generate`` and ``generate_baseline``: token
    exactness, the cycle, and for each path alone the kernels' launches
    (every kernel named in ``matmul_kernels`` and the attention kernel
    > 0, every other kernel and both plain versions 0). One warm-up pass of
    WARM_NEW tokens, then one timed run of ``n_new`` tokens of each path."""
    import torch
    from lookaheaddecoding_tpu_torch.ops import lookahead_attention as la
    from lookaheaddecoding_tpu_torch.ops import quant_matmul as qm

    eng.generate(prompt, WARM_NEW)
    eng.generate_baseline(prompt, WARM_NEW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches, runs = {}, {}
    # each path's launches are counted alone: reset just before, read after
    for path, gen in (("lookahead", eng.generate),
                      ("ar_baseline", eng.generate_baseline)):
        la.counts.update(kernel=0, plain=0)
        qm.counts.update(dict.fromkeys(qm.counts, 0))
        runs[path] = gen(prompt, n_new)
        got = dict(qm.counts, attention=la.counts["kernel"],
                   plain=qm.counts["plain"] + la.counts["plain"])
        launches[path] = got
        assert got["attention"] > 0 and got["plain"] == 0, (name, path, got)
        for kernel in ("int8", "int4", "int4_pipe"):
            assert (got[kernel] > 0) == (kernel in matmul_kernels), \
                (name, path, got)
    r, rb = runs["lookahead"], runs["ar_baseline"]
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    leaves = [eng.params]
    while any(isinstance(x, dict) for x in leaves):
        leaves = [y for x in leaves
                  for y in (x.values() if isinstance(x, dict) else [x])]
    weights_mb = sum(x.numel() * x.element_size() for x in leaves) / 2**20

    exact = bool(np.array_equal(r.tokens, rb.tokens))
    toks = rb.tokens
    fidelity = float(np.mean([toks[i + 1] == nxt[toks[i]]
                              for i in range(len(prompt) - 1, len(toks) - 1)]))
    log(f"  [{card}] {name} lookahead: {r.num_generated} tokens in {r.steps} "
        f"steps (compression {r.compression_ratio:.3f}), "
        f"{r.tokens_per_sec:.1f} tok/s (one timed run), wall/steps "
        f"{1e3 * r.wall_time_s / r.steps:.2f} ms")
    log(f"  [{card}] {name} AR baseline: {rb.num_generated} tokens in "
        f"{rb.steps} steps, {rb.tokens_per_sec:.1f} tok/s (one timed run), "
        f"wall/steps {1e3 * rb.wall_time_s / rb.steps:.2f} ms")
    log(f"  [{card}] {name} speedup {r.tokens_per_sec / rb.tokens_per_sec:.3f}"
        f"x, token_exact={exact}, transition fidelity {fidelity:.3f}, "
        f"launches lookahead {launches['lookahead']}, AR baseline "
        f"{launches['ar_baseline']}, weights {weights_mb:.0f} MiB, peak "
        f"device memory {peak_mb:.0f} MiB (with every configuration's "
        f"weights resident)")
    assert r.num_generated == n_new and rb.num_generated == n_new
    assert exact, f"{name}: lookahead output != AR output"
    assert fidelity > 0.95, f"{name}: synthetic model degenerated ({fidelity})"
    return (launches, r.tokens,
            {"lookahead": r.wall_time_s / r.steps,
             "ar_baseline": rb.wall_time_s / rb.steps})


def profile_path(name, eng, prompt, card, step_s, paths):
    """Where a generate call's time goes: one run of PROFILE_NEW tokens for
    each of ``paths`` under torch.profiler. Device busy time is the sum of
    the kernels' durations (one stream, so they do not overlap). The idle
    share is given against the wall time per step of the unprofiled runs
    (``step_s``), and against the profiled run's own wall time, which the
    profiler lengthens. Prints "not measured" if the profiler records no
    kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for path in paths:
        gen = eng.generate if path == "lookahead" else eng.generate_baseline
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            r = gen(prompt, PROFILE_NEW)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if not kernels:
            log(f"  [{card}] {name} {path}: device time not measured "
                f"(the profiler recorded no kernel)")
            continue
        busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        step_ms = 1e3 * step_s[path]
        log(f"  [{card}] {name} {path}: {r.steps} steps, {len(kernels)} "
            f"kernels ({len(kernels) / r.steps:.0f} a step); device busy "
            f"{busy_ms / r.steps:.3f} ms a step, idle "
            f"{1 - busy_ms / r.steps / step_ms:.3f} of the unprofiled "
            f"{step_ms:.2f} ms wall a step (idle {1 - busy_ms / wall_ms:.3f} "
            f"of {wall_ms:.1f} ms under the profiler)")
        for kname, ms in top:
            log(f"    {ms / r.steps:9.4f} ms a step  {kname[:90]}")


def paged_path(name, mcfg, params, flat, nxt, card, kv_quant, full):
    """One configuration of ``PagedServingEngine``: requests through shared
    prefixes (a partial tail page; a prefix that ends on a page boundary
    and is the whole prompt), a conversation carried over, a streaming and
    an interactive request, all of PAGED_NEW new tokens (ten requests when
    ``full``, else four). Every result must equal ``flat.generate`` on the
    same prompt. Returns (launches, stats)."""
    import torch
    import lookaheaddecoding_tpu_torch as lt
    from lookaheaddecoding_tpu_torch.ops import lookahead_attention as la
    from lookaheaddecoding_tpu_torch.ops import quant_matmul as qm

    eng = lt.PagedServingEngine(
        mcfg, params,
        lt.LookaheadConfig(level=LEVEL, window_size=WINDOW,
                           guess_set_size=GUESS, pool_from_prompt=True),
        lt.EngineConfig(max_seq_len=MAX_SEQ, prefill_chunk=PREFILL_CHUNK,
                        kv_quant=kv_quant),
        num_lanes=LANES, page_size=PAGE, n_pages=N_PAGES,
        steps_per_sync=STEPS_PER_SYNC)
    assert eng.lcfg.attention_impl == "kernel", eng.lcfg.attention_impl

    def prompt(start, n):
        return make_prompt(nxt, start=start, n=n)

    def more(p, n):                 # p continued along the cycle
        return p + make_prompt(nxt, start=p[-1], n=n)

    # warm-up: one request through admission, the step and the harvest
    eng.generate(prompt(1, 48), WARM_NEW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    la.counts.update(kernel=0, plain=0)
    la.paged_counts.update(kernel=0, plain=0)
    qm.counts.update(dict.fromkeys(qm.counts, 0))
    eng.admission_waits = eng.steps_run = 0
    t0 = time.perf_counter()

    px_tail = eng.precompute_prefix(prompt(3, 200))     # 1 page + 72 slots
    px_edge = eng.precompute_prefix(prompt(5, 2 * PAGE))  # exactly 2 pages
    streamed = []
    results, prompts = {}, {}

    def submit(rid, p, **kw):
        prompts[rid] = p
        eng.submit(lt.Request(prompt=p, max_new_tokens=PAGED_NEW,
                              request_id=rid, **kw))

    def drain():
        low = eng.pages_free
        while eng.step():
            low = min(low, eng.pages_free)
        for r in eng._results:
            results[r.request_id] = r
        eng._results = []
        return low

    # first the turn whose KV is carried over: its pages stay held, so the
    # requests after it find the pool two pages smaller
    submit("carry", prompt(7, 40), return_prefix=True)
    low = drain()
    carried = results["carry"].prefix
    assert carried is not None and carried.pool is not None
    if full:
        submit("stream", prompt(9, 200), on_tokens=streamed.append)
        submit("plain", prompt(11, 200))
        submit("tail0", more(list(px_tail.tokens), 8), prefix=px_tail)
        submit("tail1", more(list(px_tail.tokens), 24), prefix=px_tail)
        submit("tail2", more(list(px_tail.tokens), 40), prefix=px_tail)
        submit("edge0", list(px_edge.tokens), prefix=px_edge)
        submit("edge1", list(px_edge.tokens), prefix=px_edge)
        submit("turn2", more(list(carried.tokens), 8), prefix=carried)
        submit("chat", prompt(13, 180), interactive=True)
    else:
        submit("stream", prompt(9, 200), on_tokens=streamed.append)
        submit("tail0", more(list(px_tail.tokens), 8), prefix=px_tail)
        submit("edge0", list(px_edge.tokens), prefix=px_edge)
    eng.step()
    active = {m["req"].request_id for m in eng._meta.values()}
    if full:
        assert "chat" in active, active     # it jumped the queue
    low = min(low, eng.pages_free, drain())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = eng.memory_stats()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    got = dict(qm.counts, paged_attention=la.paged_counts["kernel"],
               flat_attention=la.counts["kernel"],
               plain=(qm.counts["plain"] + la.counts["plain"]
                      + la.paged_counts["plain"]))
    assert got["paged_attention"] > 0 and got["plain"] == 0, (name, got)
    assert len(results) == (10 if full else 4), sorted(results)
    assert all(r.error is None for r in results.values())
    if full:
        # a lane was free and the pool could not serve the next request
        assert eng.admission_waits > 0, "admission never waited for pages"
    steps_run, waits = eng.steps_run, eng.admission_waits
    for px in (px_tail, px_edge, carried):
        eng.release_prefix(px)
    assert eng.pages_free == N_PAGES, eng.memory_stats()

    tokens = sum(r.num_generated for r in results.values())
    assert all(r.num_generated == PAGED_NEW for r in results.values())
    np.testing.assert_array_equal(
        np.concatenate([prompts["stream"]] + streamed),
        results["stream"].tokens)
    assert len(streamed) > 1
    # token exactness: the flat engine's generate on each prompt (its
    # launches are not the paged path's: the counts were read above)
    for rid, r in results.items():
        single = flat.generate(prompts[rid], PAGED_NEW)
        assert np.array_equal(r.tokens, single.tokens), \
            f"{name}: request {rid} differs from the flat generate"
    log(f"  [{card}] {name}: {len(results)} requests, {tokens} tokens in "
        f"{steps_run} batched steps, {tokens / wall:.1f} tok/s summed over "
        f"{LANES} lanes (prefix prefills, admissions and host reads "
        f"included), wall {1e3 * wall / steps_run:.2f} ms a batched step; "
        f"admission waited {waits} times, fewest free pages {low}; every "
        f"request == flat generate; launches {got}; memory {stats}; peak "
        f"device memory {peak_mb:.0f} MiB")
    return got, dict(step_s=wall / steps_run, engine=eng)


def profile_paged(name, eng, nxt, card, step_s):
    """The batched paged step under torch.profiler: four lanes admitted and
    warmed by one untimed ``step``, then three profiled ones (12 decode
    steps, no admission)."""
    import torch
    import lookaheaddecoding_tpu_torch as lt
    from torch.profiler import ProfilerActivity, profile

    for i in range(LANES):
        eng.submit(lt.Request(prompt=make_prompt(nxt, start=20 + i, n=64),
                              max_new_tokens=PAGED_NEW, request_id=i))
    eng.step()
    torch.cuda.synchronize()
    n_steps = 3 * STEPS_PER_SYNC
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    while eng.step():
        pass
    eng._results = []
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"  [{card}] {name} paged step: device time not measured (the "
            f"profiler recorded no kernel)")
        return
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    step_ms = 1e3 * step_s
    log(f"  [{card}] {name} paged step, {LANES} lanes live: {len(kernels)} "
        f"kernels in {n_steps} steps ({len(kernels) / n_steps:.0f} a step); "
        f"device busy {busy_ms / n_steps:.3f} ms a step, idle "
        f"{1 - busy_ms / wall_ms:.3f} of {wall_ms / n_steps:.2f} ms a step "
        f"under the profiler (the unprofiled run, admissions included, took "
        f"{step_ms:.2f} ms a step)")
    for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {ms / n_steps:9.4f} ms a step  {kname[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 for f32 checks
    torch.backends.cudnn.allow_tf32 = False
    import lookaheaddecoding_tpu_torch as lt
    from lookaheaddecoding_tpu_torch.core.layout import build_layout
    from lookaheaddecoding_tpu_torch.ops import _build, quant

    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi()
    log(f"[device] {kind}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; {card}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SIGNATURES)) as ex:
        list(ex.map(_build.build, _build.SIGNATURES))
    for name in _build.SIGNATURES:
        _build.load(name)
        info = _build.build_info[name]
        log(f"[build] {name}: {info['seconds']:.1f} s\n{info['log'].strip()}")
    log(f"[build] all kernels in {time.perf_counter() - t0:.1f} s")

    lay = build_layout(lt.LookaheadConfig(level=LEVEL, window_size=WINDOW,
                                          guess_set_size=GUESS))
    assert (lay.seq_len, 1 + lay.inp_stop - lay.inp_start + lay.seq_len
            - lay.guess_start) == (S_COMP, LOGITS_ROWS), lay
    log(f"[kernels] lookahead_attention vs plain version ({card})")
    att = check_attention(device)
    log(f"[kernels] quantized matmuls vs plain versions ({card})")
    mm = check_matmuls(device)
    log(f"[kernels] paged lookahead_attention vs plain version and vs the "
        f"flat kernel ({card})")
    patt = check_paged_attention(device)
    log(f"[kernels] int4 micro-benchmark variants vs plain versions and the "
        f"int4 kernel, then the micro-benchmark ({card}; us a call, "
        f"bfloat16, weight cold in L2)")
    micro = check_int4_micro(device)

    log(f"[main path] ({card}); one timed run a path after a warm-up pass")
    mcfg, params, prompt, nxt = build_headline(device)
    q8 = lt.quantize_params(params, bits=8, quantize_lm_head=True,
                            lm_head_bits=8)
    q4 = lt.fuse_params(lt.quantize_params(params, bits=4,
                                           quantize_lm_head=True,
                                           lm_head_bits=8))
    # configuration -> (engine, matmul kernels its paths must launch); the
    # int4 trees keep an int8 LM head, so they launch both kernels
    int4_eng = build_engine(mcfg, q4)
    configs = {
        "bf16": (build_engine(mcfg, params), ()),
        "int8_weights": (build_engine(mcfg, q8), ("int8",)),
        "int4_weights": (int4_eng, ("int4", "int8")),
        "int8_weights_int8_kv": (build_engine(mcfg, q8, kv_quant="int8"),
                                 ("int8",)),
        "int4_weights_pipelined": (int4_eng, ("int4_pipe", "int8")),
    }
    launches, tokens, step_s = {}, {}, {}
    for name, (eng, kernels) in configs.items():
        quant.INT4_PIPELINE = name == "int4_weights_pipelined"
        try:
            launches[name], tokens[name], step_s[name] = main_path(
                name, eng, prompt, nxt, card, kernels,
                N_NEW if name == "bf16" else N_NEW_QUANT)
        finally:
            quant.INT4_PIPELINE = False
    # the pipelined kernel gives the int4 kernel's bits, hence its tokens
    assert np.array_equal(tokens["int4_weights"],
                          tokens["int4_weights_pipelined"])

    log(f"[profile] ({card})")
    profile_path("bf16", configs["bf16"][0], prompt, card, step_s["bf16"],
                 ("lookahead", "ar_baseline"))
    profile_path("int8_weights", configs["int8_weights"][0], prompt, card,
                 step_s["int8_weights"], ("lookahead",))

    log(f"[paged serving] ({card}); {LANES} lanes, pages of {PAGE}, "
        f"{N_PAGES} data pages, {STEPS_PER_SYNC} steps between host reads")
    paged_launches, paged_stats = {}, {}
    for name, tree, kvq, flat_name, full in (
            ("paged_bf16", params, None, "bf16", True),
            ("paged_int8_weights_int8_kv", q8, "int8",
             "int8_weights_int8_kv", False)):
        paged_launches[name], paged_stats[name] = paged_path(
            name, mcfg, tree, configs[flat_name][0], nxt, card, kvq, full)
    assert paged_launches["paged_int8_weights_int8_kv"]["int8"] > 0
    log(f"[profile, paged] ({card})")
    for name, st in paged_stats.items():
        profile_paged(name, st["engine"], nxt, card, st["step_s"])

    def on_paged_path(int8_kv):
        by_path = {name: got["paged_attention"]
                   for name, got in paged_launches.items()
                   if name.endswith("int8_kv") == int8_kv}
        total = sum(by_path.values())
        assert total > 0, "the paged path never launched its kernel"
        return dict(launches=total, launches_by_path=by_path)

    def on_main_path(kernel):
        by_path = {name: {path: got[kernel] for path, got in paths.items()}
                   for name, paths in launches.items()}
        total = sum(n for paths in by_path.values() for n in paths.values())
        assert total > 0, f"the main path never launched {kernel}"
        return dict(launches=total, launches_by_path=by_path)

    tpu_mm = "lookaheaddecoding_tpu/ops/quant_matmul.py"
    log(json.dumps({"kernels": [
        dict(name="lookahead_attention", route="cuda",
             source=CSRC + "lookahead_attention.cu", replaces=TPU_KERNELS,
             main_path="generate and generate_baseline, every configuration",
             **on_main_path("attention"), **att),
        dict(name="int8_matmul", route="cuda", source=CSRC + "quant_matmul.cu",
             replaces=tpu_mm + ":274", main_path="int8_weights, "
             "int8_weights_int8_kv, the int4 configurations' LM head",
             **on_main_path("int8"), **mm["int8"]),
        dict(name="int4_matmul", route="cuda", source=CSRC + "quant_matmul.cu",
             replaces=tpu_mm + ":32", main_path="int4_weights",
             **on_main_path("int4"), **mm["int4"]),
        dict(name="int4_matmul_pipe", route="cuda",
             source=CSRC + "quant_matmul.cu", replaces=tpu_mm + ":69",
             main_path="int4_weights_pipelined",
             **on_main_path("int4_pipe"), **mm["int4_pipe"]),
        dict(name="paged_lookahead_attention", route="cuda",
             source=CSRC + "lookahead_attention.cu",
             replaces=TPU_PAGED_KERNEL, main_path="paged_bf16",
             **on_paged_path(False), **patt[False]),
        dict(name="paged_lookahead_attention_int8_kv", route="cuda",
             source=CSRC + "lookahead_attention.cu",
             replaces=TPU_PAGED_KERNEL,
             main_path="paged_int8_weights_int8_kv",
             **on_paged_path(True), **patt[True]),
        dict(name="int4_matmul_shift", route="cuda",
             source=CSRC + "int4_micro.cu", replaces="scripts/int4_micro.py:53",
             main_path="scripts/torch_int4_micro.py (micro-benchmark only)",
             **micro["shift"]),
        dict(name="int4_matmul_kouter", route="cuda",
             source=CSRC + "int4_micro.cu", replaces="scripts/int4_micro.py:90",
             main_path="scripts/torch_int4_micro.py (micro-benchmark only)",
             **micro["kouter"]),
    ]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
