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
   library call (a yardstick the port never calls);
4. main path: the headline configuration, a synthetic TinyLlama-1.1B
   model at full width (random weights from a seed, with an embedding and
   head that make greedy decoding follow a token cycle), greedy lookahead
   ``generate`` and AR ``generate_baseline`` (64-token prompt, 256 new
   tokens). The tokens must be equal, follow the cycle, and each path's
   attention must have gone through the kernel (counted for each path
   alone: launches > 0, plain-version calls 0);
5. profile: one lookahead and one AR run under ``torch.profiler``, for the
   device's busy and idle share and the kernels that take the most time.

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``. Any failed phase
raises, so the script exits non-zero and prints no result; it also exits
non-zero when no CUDA device is present.
"""

from __future__ import annotations

import json
import statistics
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
# and the output is bf16 (one ulp at |x| in [2, 4) is 0.0156)
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
TPU_KERNELS = ("lookaheaddecoding_tpu/ops/lookahead_attention.py:128, "
               "lookaheaddecoding_tpu/ops/lookahead_attention.py:201")

# headline configuration (bench.py): TinyLlama-1.1B widths, L7/W20/G20
ARCH = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
            num_hidden_layers=22, num_attention_heads=32,
            num_key_value_heads=4, max_position_embeddings=2048)
LEVEL, WINDOW, GUESS = 7, 20, 20
MAX_SEQ, PREFILL_CHUNK, PROMPT_LEN, N_NEW, REPS = 1024, 128, 64, 256, 3
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
# Phase 3: the attention kernel against its plain version
# ---------------------------------------------------------------------------

def attention_bound(vis, hq, hkv, d, dtype_name):
    """Least time for one call on this run's mask ``vis`` [S, M]: the bytes
    (q read and the output written once, each K/V column that some row sees
    read once) against the FLOPs of the visible (row, key) pairs only
    (4*D a pair and query head: QK^T and PV)."""
    s = vis.shape[0]
    pairs = int(vis.sum())
    live_cols = int(vis.any(dim=0).sum())
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = elem * (2 * s * hq * d + 2 * hkv * live_cols * d)
    flops = 4 * d * hq * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                        else "operations")


def check_attention(device):
    import torch
    import torch.nn.functional as F
    from lookaheaddecoding_tpu_torch.ops.lookahead_attention import (
        _block_mask, lookahead_attention, lookahead_attention_ref)

    rng = np.random.default_rng(0)
    hq, hkv, d = 32, 4, 64
    geo = dict(level=LEVEL, window=WINDOW, guess_size=LEVEL - 1)
    s_comp = (LEVEL - 1) * WINDOW + GUESS * (LEVEL - 1)        # 240
    cases = ([(s_comp, 1024, kv, False, 0) for kv in (0, 37, 512, 784)]
             + [(s_comp, 2048, kv, False, 0) for kv in (1000, 1808)]
             + [(PREFILL_CHUNK, 1024, kv, True, 0) for kv in (0, 640)]
             + [(s_comp, 1024, 600, False, 300),
                (PREFILL_CHUNK, 1024, 600, True, 300),
                (1, 1024, 700, True, 0)])          # the AR baseline's call
    timed = {(s_comp, 1024, 512, False, 0), (s_comp, 2048, 1808, False, 0),
             (PREFILL_CHUNK, 1024, 640, True, 0), (1, 1024, 700, True, 0)}
    headline = None
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for s, m, kv, causal, sw in cases:
            def mk(*shape):
                x = rng.standard_normal(shape, dtype=np.float32)
                return torch.from_numpy(x).to(device, dtype)
            q, k, v = mk(s, hq, d), mk(hkv, m, d), mk(hkv, m, d)
            kv_len = torch.tensor([kv], dtype=torch.int32, device=device)
            kw = dict(geo, causal=causal, sliding_window=sw)
            got = lookahead_attention(q, k, v, kv_len, **kw)
            want = lookahead_attention_ref(q, k, v, kv_len, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), **TOL[dname])
            line = (f"  {dname:8s} S={s:3d} M={m} kv_len={kv:4d} "
                    f"{'causal' if causal else 'composite'} sw={sw}: "
                    f"max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("kernel disagrees with plain version:"
                                     + line)
            if (s, m, kv, causal, sw) in timed:
                vis = _block_mask(kv_len, m, s_len=s, causal=causal,
                                  sliding_window=sw, device=device, **geo)
                q4 = q.transpose(0, 1)[None]
                lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
                    q4, k[None], v[None], attn_mask=vis, enable_gqa=True)
                ms = time_ms(lambda: lookahead_attention(q, k, v, kv_len, **kw))
                plain_ms = time_ms(
                    lambda: lookahead_attention_ref(q, k, v, kv_len, **kw),
                    reps=10)
                lib_ms = time_ms(lib)
                bound, by = attention_bound(vis, hq, hkv, d, dname)
                line += (f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                         f"sdpa {lib_ms:.4f} ms, bound {bound:.5f} ms ({by})")
                if (dtype == torch.bfloat16 and (s, m, kv, causal, sw)
                        == (s_comp, 1024, 512, False, 0)):
                    headline = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                    bound_ms=bound, bound_by=by,
                                    library_ms=lib_ms)
            log(line)
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
    """The headline engine: synthetic TinyLlama-1.1B weights, L7/W20/G20,
    pool from the prompt, M=1024, prefill chunk 128 (bench.py's)."""
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
    eng = lt.LookaheadEngine(
        mcfg, params,
        lt.LookaheadConfig(level=LEVEL, window_size=WINDOW,
                           guess_set_size=GUESS, pool_from_prompt=True),
        lt.EngineConfig(max_seq_len=MAX_SEQ, prefill_chunk=PREFILL_CHUNK))
    log(f"  model built in {time.perf_counter() - t0:.1f} s; "
        f"attention_impl={eng.lcfg.attention_impl}")
    assert eng.lcfg.attention_impl == "kernel", eng.lcfg.attention_impl
    return eng, make_prompt(nxt), nxt


def main_path(eng, prompt, nxt, card):
    import torch
    from lookaheaddecoding_tpu_torch.ops.lookahead_attention import counts

    eng.generate(prompt, N_NEW)               # warm passes
    eng.generate_baseline(prompt, N_NEW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches = {}
    runs = {}
    # each path's launches are counted alone: reset just before, read after
    for name, gen in (("lookahead", eng.generate),
                      ("ar_baseline", eng.generate_baseline)):
        counts.update(kernel=0, plain=0)
        runs[name] = gen(prompt, N_NEW)
        launches[name] = dict(counts)
        assert counts["kernel"] > 0 and counts["plain"] == 0, (name, counts)
    r, rb = runs["lookahead"], runs["ar_baseline"]
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    lade = [r.tokens_per_sec] + [eng.generate(prompt, N_NEW).tokens_per_sec
                                 for _ in range(REPS - 1)]
    ar = [rb.tokens_per_sec] + [
        eng.generate_baseline(prompt, N_NEW).tokens_per_sec
        for _ in range(REPS - 1)]

    exact = bool(np.array_equal(r.tokens, rb.tokens))
    toks = rb.tokens
    fidelity = float(np.mean([toks[i + 1] == nxt[toks[i]]
                              for i in range(len(prompt) - 1, len(toks) - 1)]))
    lade_tps, ar_tps = statistics.median(lade), statistics.median(ar)
    log(f"  [{card}] lookahead: {r.num_generated} tokens in {r.steps} steps "
        f"(compression {r.compression_ratio:.3f}), median {lade_tps:.1f} "
        f"tok/s over {REPS} runs {[round(x, 1) for x in lade]}, wall/steps "
        f"{1e3 * r.wall_time_s / r.steps:.2f} ms")
    log(f"  [{card}] AR baseline: {rb.num_generated} tokens in {rb.steps} "
        f"steps, median {ar_tps:.1f} tok/s {[round(x, 1) for x in ar]}, "
        f"wall/steps {1e3 * rb.wall_time_s / rb.steps:.2f} ms")
    log(f"  [{card}] speedup {lade_tps / ar_tps:.3f}x, token_exact={exact}, "
        f"transition fidelity {fidelity:.3f}, attention kernel launches "
        f"(plain-version calls): lookahead {launches['lookahead']['kernel']} "
        f"({launches['lookahead']['plain']}), AR baseline "
        f"{launches['ar_baseline']['kernel']} "
        f"({launches['ar_baseline']['plain']}), peak device memory "
        f"{peak_mb:.0f} MiB")
    assert r.num_generated == N_NEW and rb.num_generated == N_NEW
    assert exact, "lookahead output != AR output"
    assert fidelity > 0.95, f"synthetic model degenerated ({fidelity})"
    return ({k: v["kernel"] for k, v in launches.items()},
            {"lookahead": r.wall_time_s / r.steps,
             "AR baseline": rb.wall_time_s / rb.steps})


def profile_path(eng, prompt, card, step_s):
    """Where a generate call's time goes: one lookahead and one AR run of
    PROFILE_NEW tokens under torch.profiler. Device busy time is the sum of
    the kernels' durations (one stream, so they do not overlap). The idle
    share is given against the wall time per step of the unprofiled runs
    (``step_s``), and against the profiled run's own wall time, which the
    profiler lengthens. Prints "not measured" if the profiler records no
    kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for name, gen in (("lookahead", eng.generate),
                      ("AR baseline", eng.generate_baseline)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            r = gen(prompt, PROFILE_NEW)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if not kernels:
            log(f"  [{card}] {name}: device time not measured "
                f"(the profiler recorded no kernel)")
            continue
        busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        step_ms = 1e3 * step_s[name]
        log(f"  [{card}] {name}: {r.steps} steps, {len(kernels)} kernels "
            f"({len(kernels) / r.steps:.0f} a step); device busy "
            f"{busy_ms / r.steps:.3f} ms a step, idle "
            f"{1 - busy_ms / r.steps / step_ms:.3f} of the unprofiled "
            f"{step_ms:.2f} ms wall a step (idle {1 - busy_ms / wall_ms:.3f} "
            f"of {wall_ms:.1f} ms under the profiler)")
        for kname, ms in top:
            log(f"    {ms:9.3f} ms  {kname[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 for f32 checks
    torch.backends.cudnn.allow_tf32 = False
    from lookaheaddecoding_tpu_torch.ops import _build

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

    log(f"[kernels] lookahead_attention vs plain version ({card})")
    att = check_attention(device)

    log(f"[main path] ({card})")
    eng, prompt, nxt = build_headline(device)
    launches, step_s = main_path(eng, prompt, nxt, card)

    log(f"[profile] ({card})")
    profile_path(eng, prompt, card, step_s)

    log(json.dumps({"kernels": [dict(
        name="lookahead_attention", route="cuda",
        source="lookaheaddecoding_tpu_torch/ops/csrc/lookahead_attention.cu",
        replaces=TPU_KERNELS, launches=sum(launches.values()),
        launches_by_path=launches, **att)]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
