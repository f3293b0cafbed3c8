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
4. main path: the headline configuration, a synthetic TinyLlama-1.1B
   model at full width (random weights from a seed, with an embedding and
   head that make greedy decoding follow a token cycle), greedy lookahead
   ``generate`` and AR ``generate_baseline`` (64-token prompt, 256 new
   tokens), first in bfloat16, then quantized on the card by the port's
   ``quantize_params``: ``int8_weights``, ``int4_weights`` (fused
   projections, int8 LM head), ``int8_weights_int8_kv``, and
   ``int4_weights_pipelined`` (the int4 engine with
   ``ops.quant.INT4_PIPELINE`` set). In every configuration the tokens must
   equal its own baseline's and follow the cycle, and each path must have
   gone through the kernels (counted for each path alone: launches > 0,
   plain-version calls 0);
5. profile: lookahead and AR runs under ``torch.profiler``, for the
   device's busy and idle share and the kernels that take the most time
   (bfloat16, and the lookahead run of ``int8_weights``).

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
WARM_NEW = 32         # tokens of the untimed warm-up pass of each path
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


def main_path(name, eng, prompt, nxt, card, matmul_kernels):
    """One configuration's ``generate`` and ``generate_baseline``: token
    exactness, the cycle, and for each path alone the kernels' launches
    (every kernel named in ``matmul_kernels`` and the attention kernel
    > 0, every other kernel and both plain versions 0). One warm-up pass of
    WARM_NEW tokens, then one timed run of each path."""
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
        runs[path] = gen(prompt, N_NEW)
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
    assert r.num_generated == N_NEW and rb.num_generated == N_NEW
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
                name, eng, prompt, nxt, card, kernels)
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
             **on_main_path("attention"), **att),
        dict(name="int8_matmul", route="cuda", source=CSRC + "quant_matmul.cu",
             replaces=tpu_mm + ":274", **on_main_path("int8"), **mm["int8"]),
        dict(name="int4_matmul", route="cuda", source=CSRC + "quant_matmul.cu",
             replaces=tpu_mm + ":32", **on_main_path("int4"), **mm["int4"]),
        dict(name="int4_matmul_pipe", route="cuda",
             source=CSRC + "quant_matmul.cu", replaces=tpu_mm + ":69",
             **on_main_path("int4_pipe"), **mm["int4_pipe"]),
    ]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
