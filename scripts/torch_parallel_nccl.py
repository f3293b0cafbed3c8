#!/usr/bin/env python3
"""chip_smoke.py's phase 12 over NCCL, one rank a card, on four cards.

    python3 scripts/torch_parallel_nccl.py

Builds the kernels, runs phase 4's one-process bfloat16 headline run on
card 0 (its tokens and ms a step are the reference), then starts four
ranks over NCCL (``parallel/launch.py --backend nccl``), one a card, and
runs ``chip_smoke.parallel_rank`` on the headline model at tp=4 and at
pp=2 x tp=2: tokens equal to AR, to the one-process run and across ranks,
the attention kernel launched on every rank, ms a step and collectives a
step. Then it profiles one lookahead and one AR ``generate`` of 64 tokens
at tp=4 on every rank under ``torch.profiler``: kernels a step, device
busy a step, the NCCL kernels' share of it (an NCCL kernel runs until
every rank's has started, so its time includes waiting for the other
ranks), and the largest kernels. Needs four CUDA cards; no test or
default of chip_smoke.py depends on it.
"""

from __future__ import annotations

import os
import sys
import time

MESHES = (("tp4", dict(tp=4), "bf16"), ("pp2_tp2", dict(pp=2, tp=2), "bf16"))
PROFILE_NEW = 64


def profile_rank(device):
    """One rank of the tp=4 profile: per path, steps, wall ms a step,
    kernels a step, device busy ms a step, NCCL kernels' ms a step and the
    five largest kernels (ms a step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    import lookaheaddecoding_tpu_torch as lt
    from lookaheaddecoding_tpu_torch.parallel import make_mesh, shard_params

    torch.backends.cuda.matmul.allow_tf32 = False
    mcfg, params, prompt, _ = cs.synthetic.build_headline(device)
    mesh = make_mesh(tp=4, devices=device)
    eng = lt.LookaheadEngine(
        mcfg, shard_params(params, mesh, mcfg),
        lt.LookaheadConfig(level=cs.LEVEL, window_size=cs.WINDOW,
                           guess_set_size=cs.GUESS, pool_from_prompt=True),
        lt.EngineConfig(max_seq_len=cs.MAX_SEQ,
                        prefill_chunk=cs.PREFILL_CHUNK, tp=4), mesh=mesh)
    del params
    out = {}
    for path, gen in (("lookahead", eng.generate),
                      ("ar_baseline", eng.generate_baseline)):
        gen(prompt, cs.PAR_WARM)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            r = gen(prompt, PROFILE_NEW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # the device's events, less the profiler's "nccl:*" annotations,
        # which span their NCCL kernels and would count them twice
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith("nccl:")]
        by_name = {}
        for e in kernels:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
        steps = r.steps
        out[path] = dict(
            steps=steps, wall_ms_step=1e3 * wall / steps,
            kernels_step=len(kernels) / steps,
            busy_ms_step=sum(by_name.values()) / steps,
            nccl_ms_step=sum(ms for k, ms in by_name.items()
                             if "nccl" in k.lower()) / steps,
            top=[(k[:70], ms / steps) for k, ms in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:5]])
    return out


def main() -> int:
    import torch
    if torch.cuda.device_count() < 4:
        print("needs four CUDA cards", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from concurrent.futures import ThreadPoolExecutor
    from lookaheaddecoding_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi()
    cs.log(f"[device] {torch.cuda.get_device_name(0)}; count "
           f"{torch.cuda.device_count()}; torch {torch.__version__}; {card}")
    with ThreadPoolExecutor(len(_build.SIGNATURES)) as ex:
        list(ex.map(_build.build, _build.SIGNATURES))
    dev = torch.device("cuda:0")
    mcfg, params, prompt, nxt = cs.build_headline(dev)
    _, tokens, step_s = cs.main_path("bf16", cs.build_engine(mcfg, params),
                                     prompt, nxt, card, (), cs.PAR_NEW)
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cs.parallel_phase(card, {"bf16": tokens}, {"bf16": step_s}, MESHES,
                      ranks=4, backend="nccl")
    cs.log(f"[seconds] nccl phase: {time.perf_counter() - t0:.1f}")
    from lookaheaddecoding_tpu_torch.parallel.launch import launch
    t0 = time.perf_counter()
    ranks = launch(f"{os.path.abspath(__file__)}:profile_rank", 4, "nccl",
                   "cuda", timeout=cs.PAR_TIMEOUT_S)
    for path in ("lookahead", "ar_baseline"):
        for rank, r in enumerate(ranks):
            p = r[path]
            cs.log(f"  [{card}] tp4 {path} rank {rank} under the profiler: "
                   f"{p['steps']} steps, {p['wall_ms_step']:.2f} ms a step, "
                   f"{p['kernels_step']:.0f} kernels a step, device busy "
                   f"{p['busy_ms_step']:.3f} ms a step, of which NCCL "
                   f"{p['nccl_ms_step']:.3f}")
            for k, ms in p["top"]:
                cs.log(f"    {ms:9.4f} ms a step  {k}")
    cs.log(f"[seconds] nccl profile: {time.perf_counter() - t0:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
