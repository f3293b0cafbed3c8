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
   library call (a yardstick the port never calls), from a Python loop
   and on the device alone (a CUDA graph): the attention kernel on a plain
   and on an int8 KV cache (bfloat16 on the tensor cores, float32 on
   FMAs; the bfloat16 result also within its rounding limit of the
   float32 kernel's), at head_dim 64 with the headline's heads, at
   head_dim 256 with Gemma-2B's (8 query heads, 1 KV head; every case
   timed) and at head_dim 32, 48, 80, 96 and 112 (64, 40, 32, 32 and 24
   query heads on 8 KV heads, Hq*D 1920-3072; the D=256 cases, B1, B2,
   prefill and AR
   timed; flat and paged, the paged call bit-equal to the flat one lane
   by lane), and at a first composite row (``row0``, a lookahead-parallel
   rank's call: B1 and B2 on S=240 split in two, each half bit-equal to
   those rows of the whole call, bfloat16 and float32, plain and int8
   KV), and the int8, int4 and pipelined int4 matrix
   products (bfloat16 on the tensor cores; the pipelined one bit-equal to
   the int4 one, a row alone bit-equal to the same row among 240);
   the paged attention call on a shared page pool with shuffled tables
   (plain and int8 pool, page sizes 128 and 48, lanes of different
   ``kv_len``; at head_dim 256 pages of 128), also bit-equal, lane by
   lane, to the flat call on the contiguous cache; and the int4 product's
   two micro-benchmark variants (shift decode: bit-equal to the int4
   kernel; K-outer: a row alone equal to the same row among others), then
   ``scripts/torch_int4_micro.py``'s timing loop, the path that launches
   them (the K-outer variant through its tensor-core design alone), and
   both on the device alone; and the CUDA-graph IF node
   (``ops/graph_cond.py``, the pool's ``lax.cond``): three nodes in one
   captured graph over every pattern of their predicates, each body run
   exactly when its plain version runs it, and ms a node taken and
   skipped on the device alone; and the CUDA-graph WHILE node (the decode
   loop's ``lax.while_loop``): n, 0 and 1 iterations of a one-add body
   and three lanes finishing after 2, 5 and 3, each as its plain version
   counts, and ms an iteration on the device alone beside adds captured
   in a row; and the Philox kernel (``ops/philox.py``, the decode
   state's random stream): its raw words and uniforms bit-equal to the
   plain version's at the headline's draw (192,140 uniforms a lane, 1 and
   4 lanes, both tags), ms a call from a Python loop and on the device
   alone beside the plain version's and ``torch.rand``'s;
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
   equal its own baseline's and follow the cycle, compression must be above
   1, and each path must have gone through the kernels' tensor-core
   designs (counted for each path alone: launches > 0, FMA designs and
   plain-version calls 0);
5. profile: lookahead and AR requests under ``torch.profiler``, decoded
   by the host loop (the profiler records no kernel inside a CUDA-graph
   WHILE body, so not the device loop's), for the host loop's device busy
   and idle share (against the same host-loop request unprofiled) and the
   kernels that take the most time
   (bfloat16, and the lookahead runs of ``int8_weights`` and
   ``int4_weights``);
6. paged serving: ``PagedServingEngine`` on the same model (4 lanes, pages
   of 128 slots, 24 data pages, 4 steps between host reads), ``paged_bf16``
   with ten requests (shared prefixes with a partial tail page and ending
   on a page boundary, conversation carry, streaming, an interactive
   request) and ``paged_int8_weights_int8_kv`` with four. Every result
   must equal the flat ``generate`` on the same prompt, admission must have
   waited for pages at least once, every page must be free at the end, and
   the path must have gone through the paged attention kernel with no
   plain-version call (prints tok/s summed over the lanes and TTFT p50 and
   max); then a profile of the batched step;
7. head_dim 256: ``bf16_head_dim_256``, the LLaMA layer at Gemma-2B's
   published widths (hidden 2048, intermediate 16384, 18 layers, 8 query
   heads, 1 KV head, head_dim 256; SwiGLU and a synthetic vocab of 32000
   kept), the main path and its profile as in phases 4 and 5 (128 new
   tokens), then four requests of 64 tokens through ``PagedServingEngine``,
   two on one shared prefix, each equal to the flat ``generate``;
8. sampling, on the headline bfloat16 engine: (a) the SpecInfer
   verification on the card, 20,000 lanes of one call, each its own Philox
   stream (first-token TV < 0.02, conditional TV < 0.08), and
   ``warp_logits`` keeping the CPU's support; (b) ``generate_sample`` at
   temperature 0.01 equal to ``generate`` for seeds 0-2; (c) sampling at
   T*, the temperature that gives the cycle token probability 0.85 (from
   the measured top-2 margin): a seed repeats its tokens, another seed
   differs, every token lies in the top-50 support, and a profile of
   ``sample_step`` alone (kernels, busy and idle, one device-to-host copy a
   step: the eager read of the pool chain's predicate); (d)
   ``generate_stream`` (sampling with ``steps_per_yield`` 1 and 4, greedy,
   ``lookahead=False``) equal to the one-shot calls; (e) ``generate_batch``
   of four prompts, greedy and sampling with per-lane temperatures, each
   lane equal to its lone call; (f) a 40-token ``PrefixCache`` and a
   ``return_prefix`` second turn equal to the full prefill, the prefixes'
   tensors unchanged; (g) ``PagedServingEngine(sampling=...)`` with five
   requests (a shared prefix, a request ``top_p`` on an engine at 1.0,
   streaming), each equal to the flat ``generate_sample``, every page free.
   Each path of b-g launches the attention kernel (the paged one for e and
   g) and no plain version or FMA design; path a runs no model;
9. continuous batching, on the headline bf16 engine:
   ``ContinuousBatchingEngine(num_lanes=4, steps_per_sync=4)`` with ten
   requests of staggered prompts (32-104 tokens) and budgets (32-128 new
   tokens), one of them streaming, and a bad one (a prompt longer than M)
   that fails alone, under ``fairness``, ``throughput`` with
   ``batch_group=2`` and ``adaptive`` (the eleven queued, one fused drain,
   then an interactive request, which must take a lane and stream). Every
   greedy result equals the flat ``generate``; then sampling lanes at T*
   (per-request temperatures, a request top_p on an engine at 1.0), each
   equal to the lone ``generate_sample``. Each objective is counted alone:
   the lanes launch the paged kernel, the prefills and fused drains the
   flat one, no plain version or FMA design. Prints tok/s in all, TTFT p50
   and max, and host reads a lane step;
10. model coverage: ``LlamaConfig.from_hf`` on Llama-3.2-1B's published
   config fields (llama3 rope, vocab 128256) at full width and depth with
   the transition-cycle weights (reduced: synthetic weights, an untied
   head), ``generate`` token-exact against ``generate_baseline``; the
   headline model with dynamic-NTK rope (max_position_embeddings 512,
   factor 2, M=2048, a 600-token prompt), token-exact; and engines at
   head_dim 32, 48, 80, 96 and 112 (4 layers), token-exact through the
   mma kernel,
   with three requests each through ``ContinuousBatchingEngine`` equal to
   the flat ``generate`` (the paged kernel at that head_dim);
11. the learned model: ``training.make_train_step`` on the card against
   the CPU (three Adam and three SGD steps at 2 layers, float32, TF32
   off); ``train_synthetic``'s model (vocab 2048, hidden 512, 6 layers,
   D=64) trained in float32 on the card on the order-2 corpus over 16
   active tokens (Adam, batch 64 x 129, up to 2,500 steps or 90 s) to a
   loss below 1.5 nats; its bf16 checkpoint through ``save_params`` and
   ``load_params`` (a temporary directory), every leaf equal; then
   ``utils.tuning.autotune`` over (5,7,7), (5,15,15) and (7,20,20),
   ``measure_ar_baseline`` and ``save_tune_artifact`` in bf16 and float32
   (bench_learned's 128-token prompt, 256 new tokens, M=1024), each
   candidate's tokens against ``generate_baseline`` (float32 exact, or a
   teacher-forced top-2 margin within 1e-5 of the logit scale; bf16
   reported), through B1 (FMA design in float32), no plain version; and
   one lookahead and one AR request under ``utils.profiling.trace``
   (decoded by the host loop, as phase 5's), whose file must name the
   attention kernel. On the card the train step
   replays a CUDA graph (forward, backward and Adam captured,
   ``training/train_step.py``): the card-against-CPU steps and the
   training above run it; then on a batch already on the card it runs
   eagerly (``graphs.eager()``) and captured from one start, three steps
   each, whose losses and parameters must be bit-equal (else within the
   Adam limits, the kernels that only one way ran named), with ms a step,
   kernels a step, device busy and idle both ways and the copies in and
   out alone;
12. parallel: two ranks on the one card over gloo (``parallel/launch.py``;
   NCCL takes one rank a card), each building the headline model whole
   from its seed and keeping its shard, on four meshes: ``tp2``, ``pp2``,
   ``la2`` (S=240, 120 rows a rank) and ``int8_weights_tp2``. On each
   rank, ``generate`` equals ``generate_baseline``, follows the cycle and
   equals the first 48 new tokens of phase 4's run of the same
   configuration (a mismatch raises with the teacher-forced top-2
   margin); every rank's tokens and steps are equal; the attention
   kernel's tensor-core design is launched and its FMA design and the
   plain versions never (``int8_weights_tp2``: B3's tensor-core design
   too). Prints ms a step beside phase 4's one-process step and the
   collectives a step. Those times are two processes sharing one card
   with gloo crossing the host, not a tensor-parallel speed (a mesh with a
   gloo group steps eagerly: gloo's collectives cannot be captured; each
   rank reports the graphs it captured, which must be none);
13. the captured step: every engine on the card replays its decode step
   as a CUDA graph (``core/graphs.py``), in every phase above but 12, the
   pool update's chain rounds as an IF node (``graphs.cond``, JAX's
   ``lax.cond``) that the device takes when two valid lanes share a key.
   Here each of bf16, int8_weights, int4_weights, int8_weights_int8_kv
   (greedy lookahead), bf16's AR baseline and sampling at T*, paged_bf16
   (four requests) and phase 11's learned model in bf16 at (5,7,7),
   (5,15,15) and (7,20,20) runs eagerly (``graphs.eager()``) and graphed
   on the same engine: the tokens and steps must be equal, a greedy
   call's pool tables (rows [0, R) and the clock) bit-equal, both ways
   must evaluate the same branches and take the same chains, the graphed
   call must replay (counted alone: the kernels' launches, which a replay
   counts as many times as its capture made them), and the learned model
   must chain. It prints graphs captured, replays, the port's kernel
   launches a replay, the share of steps whose IF body ran, tok/s and
   peak device memory both ways, the step alone timed in windows (eager,
   graphed, graphed, eager) and each way's kernels a step, device busy,
   idle and IF-body share from a profile of a state's first steps (the
   headline's take the parallel insert: asserted) and of later steps.
   The request's preparation is captured too (JAX's fused prepare call):
   for each flat configuration above, phase 10's dynamic-NTK engine and a
   1,536-token prompt on the headline model at M=2048 (12 chunks through
   B2), the slot after ``_prepare`` must be bit-equal eager and graphed
   (caches, ``kv_len``, pool, window, output buffer), the graphed
   ``_prepare`` must be one launch of the slot's prepare graph whose
   prefill WHILE node runs an iteration a chunk (``graphs.stats``) with
   the attention's launches, one a layer and chunk, counted from its
   iterations. It prints ms a chunk of the host-counted prefill (a prefix
   call's: the captured chunk replayed) eager and graphed, and the call's
   wall over its steps beside the step alone. Paged admission is captured the same way
   (JAX's ``_get_prepare``): for paged_bf16, paged_int8_weights_int8_kv
   and paged_bf16_head_dim_256, a 64-token and a 700-token prompt (6
   chunks across 6 pages), a request on a 200-token ``precompute_prefix``
   (copy on write) and a turn carried from a ``return_prefix`` result, each
   admitted while three other lanes are live: the lane's row and its data
   pages must be bit-equal eager and graphed, the graphed admission must
   replay the engine's captured chunk once a chunk, one paged attention
   launch a layer and chunk counted from the replays, and from the lane's
   choice to the first batched replay nothing may sync the host. It prints
   ms a paged chunk each way, kernels and device busy a chunk, and ms from
   admission to the first batched step done each way. The decode loop
   runs on the device (JAX's ``lax.while_loop``): every greedy and AR call
   above (and in phases 4-11) launches its loop once, a WHILE node around
   the captured step; here each must run as many iterations as it takes
   steps, launch the WHILE condition kernel once before each of its loops
   (the prefill's too) and once an iteration, and make
   one read back with no host sync before it (a second call under
   ``set_sync_debug_mode("error")`` until ``graphs.fetch``); a greedy
   ``generate_batch`` of four lanes is held the same way against its
   eager call (tokens, steps, pool rows, branches), and a headline call
   ended by an EOS id runs exactly the steps it needs, beside the host
   loop (``_run(..., host_loop=True)``) on the same request. Sampling
   loops on the device too (JAX's ``sample_loop``; the state's Philox
   stream, whose kernel reads the draw counter on the device): the
   headline ``generate_sample`` at T*, int8_weights' at T*, a four-lane
   sampled ``generate_batch`` with per-lane temperatures, a sampling call
   ended by an EOS id and a greedy ``always_fwd_one=False`` call (its
   window refill draws; its tokens equal ``generate``'s) each run on the
   device loop, by the host loop and eagerly, bit-equal in tokens, steps,
   pool rows and final draw counters, with one launch, an iteration a
   step, a Philox launch a step, one read and no sync before it; each
   prints the call's wall over its steps three ways and the device ms an
   iteration beside the host loop's ms a step. Last, the request graph
   (JAX's ``_make_fused``: a flat call without a prefix is one CUDA graph
   of resets, seeding, fill, the prefill's WHILE node and the decode
   loop's, launched once and read once): the headline bf16 ``generate``
   of 256 tokens, its ``generate_baseline`` and ``generate_sample`` at T*,
   the int8_weights, int4_weights and int8_weights_int8_kv ``generate``s,
   a one-token prompt, the 1,536-token prompt at M=2048 and a call that an
   EOS id ends, each eagerly, by today's path (``_run(...,
   fused=False)``: the preparation op by op, the prefill's chunk graph
   replayed a chunk, the decode loop's own graph) and as its request
   graph, after a warm call each: tokens, steps, pool rows and the draw
   counter bit-equal, the request graph one launch with prefill
   iterations equal to the chunks (none for one token) and decode
   iterations equal to the steps, no plain version, and one read with no
   host sync before it. It prints, beside today's path, ms until the read
   is queued, the call's wall over its steps, device ms from the start to
   the read and of the launch alone (CUDA events), and the host's ops and
   graph launches a call, then its own ``[seconds]`` line;
14. the mesh step captured and the decode loop on a mesh: a world of one
   rank over NCCL (``parallel/launch.py --nproc 1 --backend nccl``; the
   card takes one NCCL rank) builds the headline model and runs an engine
   on ``make_mesh(tp=1)`` (an NCCL process group, no collective) beside
   one without a mesh: ``generate``, ``generate_baseline``,
   ``generate_sample`` at T* and a two-lane ``generate_batch`` eagerly and
   graphed on the mesh engine must give the no-mesh engine's (and, greedy,
   phase 4's) tokens, steps and (greedy) pool rows; the graphed calls
   capture, replay their prefill chunks and run their decode loop on the
   device (``graphs.stats``: one loop, an iteration a step), with one read
   back and no host sync before it. Then one WHILE node whose body calls
   ``collectives.all_reduce``, ``all_gather`` and ``broadcast`` on the
   world's NCCL group (ProcessGroupNCCL inside a conditional body) runs
   its iterations twice with the plain version's result. Meshes of more
   than one NCCL rank need a card a rank: ``scripts/torch_parallel_nccl.py``
   on four.

Each phase's seconds are printed as ``[seconds]`` lines.

Then one JSON object with every kernel's numbers, a line with the card's
name and power limit, and last ``{"ok": true, "device": {...}}``. Any
failed phase raises, so the script exits non-zero and prints no result; it
also exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from lookaheaddecoding_tpu_torch.applications import synthetic
from lookaheaddecoding_tpu_torch.applications.synthetic import make_prompt

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
ARCH = synthetic.HEADLINE_ARCH
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
PAGED_ROWS = LANES * S_COMP   # rows of a batched paged step's products (960)
PROFILE_NEW = 64      # tokens a profiled run: the trace grows with the steps
# bf16_head_dim_256: the port's LLaMA layer at Gemma-2B's published widths
# (google/gemma-2b config.json: hidden 2048, intermediate 16384, 18 layers,
# 8 query heads, 1 KV head, head_dim 256, rope_theta 10000, rms eps 1e-6),
# full depth; SwiGLU, no norm offset or embedding scale (Gemma's GeGLU and
# those are not ported), and the synthetic vocab of 32000 (Gemma's is
# 256000) so that the transition cycle makes compression real
ARCH_256 = dict(vocab_size=32000, hidden_size=2048, intermediate_size=16384,
                num_hidden_layers=18, num_attention_heads=8,
                num_key_value_heads=1, head_dim_override=256,
                rope_theta=10000.0, rms_norm_eps=1e-6,
                max_position_embeddings=8192)
N_NEW_256, PAGED_NEW_256 = 128, 64   # new tokens: flat run, paged requests
# phase 9: the scheduler's lanes and steps between host reads
CB_LANES, CB_SYNC = 4, 4
# phase 10: Llama-3.2-1B's published config.json fields
# (meta-llama/Llama-3.2-1B: hidden 2048, intermediate 8192, 16 layers,
# 32 query / 8 KV heads, rope_theta 500000, llama3 rope scaling factor 32,
# low/high frequency factors 1 and 4 over 8192 positions, rms eps 1e-5,
# vocab 128256, tied embeddings), read by LlamaConfig.from_hf
LLAMA32_1B = dict(
    model_type="llama", vocab_size=128256, hidden_size=2048,
    intermediate_size=8192, num_hidden_layers=16, num_attention_heads=32,
    num_key_value_heads=8, rms_norm_eps=1e-5, rope_theta=500000.0,
    max_position_embeddings=131072, tie_word_embeddings=True,
    rope_scaling={"rope_type": "llama3", "factor": 32.0,
                  "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 8192})
# phase 10's dynamic-NTK run: the headline model with its rotation rescaled
# past 512 positions (factor 2), M=2048, a prompt that crosses the threshold
DYN_MAX_POS, DYN_FACTOR, DYN_SEQ = 512, 2.0, 2048
DYN_PROMPT, DYN_NEW = 600, 128
# phase 10's engines at head_dim 32, 48, 80, 96 and 112 (the heads of phase
# 3), the LLaMA layer at reduced depth: 4 layers, vocab 32000, SwiGLU
ARCH_SMALL_D = {
    32: dict(hidden_size=2048, intermediate_size=5632, num_attention_heads=64,
             num_key_value_heads=8),
    48: dict(hidden_size=1920, intermediate_size=5120, num_attention_heads=40,
             num_key_value_heads=8),
    80: dict(hidden_size=2560, intermediate_size=8192, num_attention_heads=32,
             num_key_value_heads=8),
    96: dict(hidden_size=3072, intermediate_size=8192, num_attention_heads=32,
             num_key_value_heads=8),
    112: dict(hidden_size=2688, intermediate_size=7168,
              num_attention_heads=24, num_key_value_heads=8)}
SMALL_D_LAYERS, SMALL_D_NEW = 4, 64
# phase 11: the learned model (applications/train_synthetic.py's widths:
# vocab 2048, hidden 512, intermediate 1280, 6 layers, 8/4 heads, D=64) on
# the order-2 Markov corpus over 16 active tokens, trained in float32 by
# Adam at batch 64 x 129 tokens and lr 2e-3 for up to 2,500 steps or 90 s
LEARNED_ORDER, LEARNED_ACTIVE = 2, 16
LEARNED_BATCH, LEARNED_SEQ, LEARNED_LR = 64, 129, 2e-3
LEARNED_STEPS, LEARNED_BUDGET_S, LEARNED_LOG_EVERY = 2500, 90.0, 250
# the corpus floor is ~0.79 nats (0.7 of the contexts branch four ways,
# 1.127 nats each); ln 2048 = 7.62 is the untrained model's
LEARNED_LOSS_MAX = 1.5
LEARNED_CANDIDATES = ((5, 7, 7), (5, 15, 15), (7, 20, 20))
LEARNED_PROMPT, LEARNED_NEW = 128, 256   # bench_learned's prompt, new tokens
# the train step on the card against the CPU: the config at 2 layers
CHECK_LAYERS, CHECK_BATCH, CHECK_SEQ, CHECK_STEPS = 2, 8, 65, 3
# Limits, card against CPU after CHECK_STEPS steps (float32, TF32 off):
# the loss within rtol 1e-4 (the same float32 math summed in another
# order: ~1e-6 expected); SGD's parameters within 1e-6 (a move of
# lr * |m| ~ 1e-4 that agrees to ~1e-5 of itself; |p| ~ 0.1 has an ulp of
# 7e-9). Adam divides each element by its own gradient's size: an element
# whose gradient g carries a relative difference r between the two
# reduction orders moves by ~lr * r more or less a step, and one whose
# gradient is at the orders' noise can move anywhere within its bound,
# lr a step (each way). So every element within 2 * lr * steps, and 99.9%
# of them within lr * 1e-3 * steps (gradients that agree to 3 digits; a
# gradient below 1e-3 of the typical one is that rare)
CHECK_LOSS_RTOL, CHECK_SGD_ATOL = 1e-4, 1e-6
# phase 12: two ranks on the one card over gloo (NCCL takes one rank a
# card), each mesh of the headline model at full width and depth; new
# tokens compared with phase 4's run of the same configuration
# (48 new tokens: two eager ranks over gloo take hundreds of ms a step,
# which the AR baseline pays once a token; cut from 64 to keep the run
# inside its time limit)
PAR_RANKS, PAR_NEW, PAR_WARM, PAR_TIMEOUT_S = 2, 48, 16, 420
PAR_BATCH_NEW = 32    # new tokens of each mesh's two-lane generate_batch
PAR_MESHES = (("tp2", dict(tp=2), "bf16"), ("pp2", dict(pp=2), "bf16"),
              ("la2", dict(la=2), "bf16"),     # S=240: 120 rows a rank
              ("int8_weights_tp2", dict(tp=2), "int8_weights"))
# float32 token-exactness: a divergence is excused only by a teacher-forced
# top-2 margin within float32 reduction noise, 1e-5 of the row's largest
# |logit|
F32_TIE = 1e-5


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=50, warm=5, rounds=3) -> float:
    """Milliseconds a call of ``fn`` launched from Python in a loop: the
    device's time, or the host's where the call's Python is the slower.
    The fastest of ``rounds`` loops: the card's host is shared, and a stall
    there can hold up one loop of calls that the device would not."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(rounds):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def graph_ms(enqueue, calls=20, replays=5) -> float:
    """Milliseconds a call on the device alone: ``enqueue(i)`` puts call i
    on the current stream; ``calls`` of them are captured in one CUDA graph
    (so no Python between them), replayed."""
    import torch
    for i in range(3):
        enqueue(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            enqueue(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def reset_counts():
    from lookaheaddecoding_tpu_torch.ops import graph_cond, philox
    from lookaheaddecoding_tpu_torch.ops import lookahead_attention as la
    from lookaheaddecoding_tpu_torch.ops import quant_matmul as qm
    for tally in (la.counts, la.paged_counts, qm.counts, graph_cond.counts,
                  philox.counts):
        tally.update(dict.fromkeys(tally, 0))


def read_counts():
    """The attention kernels' launches by design, the IF and WHILE nodes'
    condition kernels', the Philox kernel's, and the plain versions'
    calls, since the last ``reset_counts``."""
    from lookaheaddecoding_tpu_torch.ops import graph_cond, philox
    from lookaheaddecoding_tpu_torch.ops import lookahead_attention as la
    from lookaheaddecoding_tpu_torch.ops import quant_matmul as qm
    return dict(attention_mma=la.counts["mma"],
                set_if=graph_cond.counts["set_if"],
                set_while=graph_cond.counts["set_while"],
                philox=philox.counts["kernel"],
                paged_attention=la.paged_counts["mma"],
                attention_fma=la.counts["fma"] + la.paged_counts["fma"],
                plain=(la.counts["plain"] + la.paged_counts["plain"]
                       + qm.counts["plain"] + philox.counts["plain"]))


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


# attention cases: (S, M, kv_len, causal, sliding window); the headline's
# heads (TinyLlama-1.1B: 32 query heads on 4 KV heads of 64) and Gemma-2B's
# (8 query heads on one KV head of 256)
ATT_CASES = ([(S_COMP, 1024, kv, False, 0) for kv in (0, 37, 512, 784)]
             + [(S_COMP, 2048, kv, False, 0) for kv in (1000, 1808)]
             + [(PREFILL_CHUNK, 1024, kv, True, 0) for kv in (0, 640)]
             + [(S_COMP, 1024, 600, False, 300),
                (PREFILL_CHUNK, 1024, 600, True, 300),
                (1, 1024, 700, True, 0)])          # the AR baseline's call
ATT_TIMED = {(S_COMP, 1024, 512, False, 0), (S_COMP, 2048, 1808, False, 0),
             (PREFILL_CHUNK, 1024, 640, True, 0), (1, 1024, 700, True, 0)}
HEADS_64, HEADS_256 = (32, 4, 64), (8, 1, 256)
# a tp=2 rank's share of the headline's heads (phase 12's tp2 meshes)
HEADS_TP2 = (16, 2, 64)
# head_dim 256: B1 (M=1024), B2 (M=2048), prefill, a sliding window both
# ways and the AR call, every one timed
ATT_CASES_256 = [(S_COMP, 1024, 512, False, 0), (S_COMP, 2048, 1808, False, 0),
                 (PREFILL_CHUNK, 1024, 640, True, 0),
                 (S_COMP, 1024, 600, False, 300),
                 (PREFILL_CHUNK, 1024, 600, True, 300),
                 (1, 1024, 700, True, 0)]


# head_dim 32, 48, 80, 96 and 112, each at Hq * D near 2048 (2048, 1920,
# 2560, 3072, 2688; 48 and 112 with GQA factors 5 and 3): the D=256 cases,
# four of them timed (B1, B2, prefill, AR)
HEADS_SMALL = {32: (64, 8, 32), 48: (40, 8, 48), 80: (32, 8, 80),
               96: (32, 8, 96), 112: (24, 8, 112)}
ATT_TIMED_SMALL = {(S_COMP, 1024, 512, False, 0), (S_COMP, 2048, 1808, False, 0),
                   (PREFILL_CHUNK, 1024, 640, True, 0), (1, 1024, 700, True, 0)}


def check_attention(device, heads=HEADS_64, cases=ATT_CASES, timed=ATT_TIMED,
                    seed=0):
    """The attention kernel at ``heads`` (Hq, Hkv, D) on a plain cache and
    on an int8 cache written by the port's ``kv_cache_write``. Returns the
    headline call's numbers (S=240, kv_len 512, M=1024) for each, with
    every timed call's under ``timings``."""
    import torch
    import torch.nn.functional as F
    from lookaheaddecoding_tpu_torch.models.llama import kv_cache_write
    from lookaheaddecoding_tpu_torch.ops.lookahead_attention import (
        _block_mask, lookahead_attention, lookahead_attention_ref)

    rng = np.random.default_rng(seed)
    hq, hkv, d = heads
    geo = dict(level=LEVEL, window=WINDOW, guess_size=LEVEL - 1)
    s_comp = S_COMP
    headline = {}
    for int8_kv in (False, True):
        # bf16: the worst error, every timed call, the headline call's keys
        entry = headline[int8_kv] = dict(max_abs_err=0.0, timings=[])
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
                line = (f"  D={d} {'int8-KV ' if int8_kv else ''}{dname:8s} "
                        f"S={s:3d} M={m} kv_len={kv:4d} "
                        f"{'causal' if causal else 'composite'} sw={sw}: "
                        f"max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("kernel disagrees with plain "
                                         "version:" + line)
                if dtype == torch.bfloat16:
                    entry["max_abs_err"] = max(entry["max_abs_err"], err)
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
                    dev_ms = graph_ms(lambda i: lookahead_attention(
                        q, k, v, kv_len, **kw))
                    lib_dev = graph_ms(lambda i: lib())
                    bound, by = attention_bound(vis, hq, hkv, d, dname,
                                                int8_kv)
                    line += (f" | kernel {ms:.4f} ms (device alone "
                             f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, sdpa "
                             f"{lib_ms:.4f} ms (device alone {lib_dev:.4f}), "
                             f"bound {bound:.5f} ms ({by})")
                    if dtype == torch.bfloat16:
                        nums = dict(s=s, m=m, kv_len=kv, causal=causal,
                                    sliding_window=sw, ms=ms, device_ms=dev_ms,
                                    plain_ms=plain_ms, bound_ms=bound,
                                    bound_by=by, library_ms=lib_ms,
                                    library_device_ms=lib_dev)
                        entry["timings"].append(nums)
                        if (s, m, kv, causal, sw) == (s_comp, 1024, 512,
                                                      False, 0):
                            entry.update({key: nums[key] for key in (
                                "ms", "device_ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms",
                                "library_device_ms")})
                log(line)
    return dict(headline[False], int8_kv=headline[True])


def check_row0(device, seed=6):
    """A lookahead-parallel rank's call: the kernel on composite rows
    [r0, r0 + n) with ``row0`` = r0 against the plain version's call with
    the same ``row0`` (within TOL) and against those rows of the whole
    call, bit for bit: B1 (M=1024, kv_len 512) and B2 (M=2048, kv_len
    1808) at the headline's heads and S=240 split in two (phase 12's la=2
    split), bfloat16 and float32, plain and int8 KV. Returns the worst
    bfloat16 error against the plain version."""
    import torch
    from lookaheaddecoding_tpu_torch.models.llama import kv_cache_write
    from lookaheaddecoding_tpu_torch.ops.lookahead_attention import (
        lookahead_attention, lookahead_attention_ref)

    rng = np.random.default_rng(seed)
    hq, hkv, d = HEADS_64
    geo = dict(level=LEVEL, window=WINDOW, guess_size=LEVEL - 1)
    half = S_COMP // 2
    worst = 0.0
    for int8_kv in (False, True):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            for m, kv in ((1024, 512), (2048, 1808)):
                def mk(*shape):
                    x = rng.standard_normal(shape, dtype=np.float32)
                    return torch.from_numpy(x).to(device, dtype)
                q = mk(S_COMP, hq, d)
                if int8_kv:
                    k, v = ({"q": torch.zeros((hkv, m, d), dtype=torch.int8,
                                              device=device),
                             "s": torch.full((hkv, m, 1), 1e-8,
                                             device=device)}
                            for _ in range(2))
                    kv_cache_write(k, mk(m, hkv, d), 0)
                    kv_cache_write(v, mk(m, hkv, d), 0)
                else:
                    k, v = mk(hkv, m, d), mk(hkv, m, d)
                kv_len = torch.tensor([kv], dtype=torch.int32, device=device)
                whole = lookahead_attention(q, k, v, kv_len, **geo)
                for r0 in (0, half):
                    rows = q[r0:r0 + half].contiguous()
                    part = lookahead_attention(rows, k, v, kv_len, row0=r0,
                                               **geo)
                    want = lookahead_attention_ref(rows, k, v, kv_len,
                                                   row0=r0, **geo)
                    torch.cuda.synchronize()
                    err = (part.float() - want.float()).abs().max().item()
                    ok = torch.allclose(part.float(), want.float(),
                                        **TOL[dname])
                    same = torch.equal(part, whole[r0:r0 + half])
                    line = (f"  row0={r0:3d} rows {half} of S={S_COMP} M={m} "
                            f"kv_len={kv} {dname}"
                            f"{' int8-KV' if int8_kv else ''}: plain version "
                            f"max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}, "
                            f"{'bit-equal' if same else 'DIFFERS'} to the "
                            f"whole call's rows")
                    log(line)
                    if not ok:
                        raise AssertionError("row0 call disagrees with the "
                                             "plain version:" + line)
                    if not same:
                        raise AssertionError("row0 call differs from the "
                                             "whole call's rows:" + line)
                    if dtype == torch.bfloat16:
                        worst = max(worst, err)
    return worst


def check_paged_attention(device, heads=HEADS_64, pages=((128, 8), (48, 22)),
                          seed=2, lanes=LANES, timed=True):
    """The paged attention call at ``heads`` (Hq, Hkv, D) against its plain
    version and, lane by lane and bit for bit, against the flat call on
    the contiguous cache: bfloat16 and float32, a plain and an int8 pool,
    composite and causal, with and without a sliding window, ``lanes``
    lanes whose ``kv_len`` are the last ``lanes`` of 0, one past a page
    boundary, 512 and the capacity less S, shuffled tables, ``pages`` of
    (slots, pages a lane). Then, if ``timed``, its time at the headline
    shape (four lanes at kv_len 512, pages of 128) beside the plain
    version's, the bound and one library call on the gathered cache.
    Returns the headline numbers (untimed: the worst bfloat16 error),
    plain pool and int8 pool."""
    import torch
    import torch.nn.functional as F
    from lookaheaddecoding_tpu_torch.core.paged import (paged_gather,
                                                        paged_write)
    from lookaheaddecoding_tpu_torch.ops.lookahead_attention import (
        _block_mask, lookahead_attention, paged_lookahead_attention,
        paged_lookahead_attention_ref)

    rng = np.random.default_rng(seed)
    hq, hkv, d = heads
    geo = dict(level=LEVEL, window=WINDOW, guess_size=LEVEL - 1)
    headline = {False: dict(max_abs_err=0.0), True: dict(max_abs_err=0.0)}

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

    for page, nb in pages:
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
                        [0, page + 1, 512, mlog - s][-lanes:])
                    kw = dict(geo, causal=causal, sliding_window=sw)
                    got = paged_lookahead_attention(
                        q, k, v, kv_lens, tables, page_size=page, **kw)
                    want = paged_lookahead_attention_ref(
                        q, k, v, kv_lens, tables, page_size=page, **kw)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    where = (f"D={d} {'int8-KV ' if int8_kv else ''}{dname} "
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
                    if dtype == torch.bfloat16:
                        entry = headline[int8_kv]
                        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    if not timed:
        return headline

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
        def lib():
            return F.scaled_dot_product_attention(
                q4, kd, vd, attn_mask=vis[:, None], enable_gqa=True)
        lib_ms = time_ms(lib)
        lib_dev = graph_ms(lambda i: lib())
        dev_ms = graph_ms(lambda i: paged_lookahead_attention(
            *args, page_size=PAGE, **kw))
        gather_ms = time_ms(gathered, reps=10)
        per_lane = [attention_bound(vis[b], hq, hkv, d, "bfloat16", int8_kv)
                    for b in range(lanes)]
        bound = sum(t for t, _ in per_lane)
        by = per_lane[0][1]
        log(f"  D={d} {'int8-KV ' if int8_kv else ''}bfloat16 B={lanes} "
            f"S={S_COMP} kv_len=512 page={PAGE}: kernel {ms:.4f} ms (device "
            f"alone {dev_ms:.4f}), plain {plain_ms:.4f} ms, sdpa on the "
            f"gathered cache {lib_ms:.4f} ms (device alone {lib_dev:.4f}; "
            f"+ {gather_ms:.4f} ms to gather"
            f"{' and dequantize' if int8_kv else ''}), bound {bound:.5f} ms "
            f"({by})")
        headline[int8_kv] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                                 plain_ms=plain_ms, bound_ms=bound,
                                 bound_by=by, library_ms=lib_ms,
                                 library_device_ms=lib_dev,
                                 gather_ms=gather_ms)
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


def check_graph_cond(device):
    """The IF node (``ops/graph_cond.py``, ``csrc/graph_cond.cu``) against
    its plain version: a captured graph of three nodes on three predicates,
    each body an add to its own counter, replayed over every pattern of
    the predicates, must run each body exactly when the plain version
    does. Then ms an IF node on the device alone (a graph of 20, taken and
    not taken, each body one add), the plain version's ms (the predicate
    read on the host, then the add), and the bound: the one-byte predicate
    read and the four-byte condition written, over the memory rate. No
    PyTorch call sets a graph's condition (PyTorch 2.11 has no conditional
    nodes): library_ms is null."""
    import torch
    from lookaheaddecoding_tpu_torch.ops import graph_cond

    preds = torch.zeros(3, dtype=torch.bool, device=device)
    got = torch.zeros(3, dtype=torch.int64, device=device)
    body_stream = graph_cond.body_stream(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(3):
            graph_cond.if_node(preds[i], lambda i=i: got[i].add_(1),
                               body_stream)
    want = torch.zeros(3, dtype=torch.int64)
    for pattern in range(8):
        flags = [bool(pattern >> i & 1) for i in range(3)]
        preds.copy_(torch.tensor(flags))
        graph.replay()
        for i, f in enumerate(flags):
            graph_cond.if_node_ref(torch.tensor(f),
                                   lambda i=i: want[i].add_(1))
    err = float((got.cpu() - want).abs().max())
    assert err == 0, (got, want)

    flag = torch.ones((), dtype=torch.bool, device=device)
    count = torch.zeros((), dtype=torch.int64, device=device)
    nodes, replays = 20, 5
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(nodes):
            graph_cond.if_node(flag, lambda: count.add_(1), body_stream)

    def node_ms():
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (nodes * replays)
    ms = node_ms()
    flag.fill_(False)
    ms_skipped = node_ms()
    flag.fill_(True)
    plain_ms = time_ms(lambda: graph_cond.if_node_ref(
        flag, lambda: count.add_(1)), reps=200)
    bound_ms = 1e3 * (1 + 4) / HBM_BYTES_S
    log(f"  graph_cond IF node: every body ran as the plain version's "
        f"(8 patterns of 3 predicates); {ms:.5f} ms a node taken, "
        f"{ms_skipped:.5f} skipped (device alone, a graph of 20, the body "
        f"one add); plain version (a host read) {plain_ms:.5f} ms; bound "
        f"{bound_ms:.2e} ms (bytes)")
    return dict(max_abs_err=err, ms=ms, ms_not_taken=ms_skipped,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                library_ms=None)


WHILE_ITERS = 200     # iterations of phase 3's timed WHILE node


def check_graph_while(device):
    """The WHILE node (``ops/graph_cond.py``, ``csrc/graph_cond.cu``; the
    decode loop's ``lax.while_loop``) against its plain version: one node
    over a one-add body, replayed with its flag clear (``cap`` iterations),
    set (none) and at a cap of 1, and over three lanes whose flags the body
    sets after 2, 5 and 3 iterations (the body's allocations in a
    MemPool), must run its body and count its iterations exactly as
    ``while_node_ref`` does. Then ms an iteration on the device alone (a
    loop of WHILE_ITERS one-add iterations) beside WHILE_ITERS adds
    captured one after another, whose difference is the node's overhead an
    iteration; the plain version's ms an iteration (the flags and the
    counter read on the host, then the add); and the bound: the condition
    kernel reads a flag, the counter and the cap and writes the counter, 13
    bytes over the memory rate. No PyTorch call runs a graph loop:
    library_ms is null."""
    import torch
    from lookaheaddecoding_tpu_torch.ops import graph_cond

    stream = graph_cond.body_stream(device)

    def while_graph(body, finished, cap, iters, pool=None):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            graph_cond.while_node(finished, cap, iters, body, stream, pool)
        return graph

    x = torch.zeros((), dtype=torch.int64, device=device)
    flag = torch.zeros(1, dtype=torch.bool, device=device)
    cap = torch.tensor([7], dtype=torch.int32, device=device)
    iters = torch.zeros(1, dtype=torch.int32, device=device)
    graph = while_graph(lambda: x.add_(1), flag, cap, iters)
    err = 0
    for finished, n in ((False, 7), (True, 0), (False, 1)):
        cap.fill_(n if n else 7)
        flag.fill_(finished)
        before = int(x)
        graph.replay()
        runs = []
        graph_cond.while_node(torch.tensor([finished]), cap.cpu(),
                              torch.zeros(1, dtype=torch.int32),
                              lambda: runs.append(1), None)
        err = max(err, abs(int(x) - before - len(runs)),
                  abs(int(iters) - len(runs)))
    counter = torch.zeros(3, dtype=torch.int32, device=device)
    lanes = torch.zeros(3, dtype=torch.bool, device=device)
    limit = torch.tensor([2, 5, 3], dtype=torch.int32, device=device)
    cap.fill_(100)

    def body():
        counter.add_((~lanes).int())
        lanes.copy_(counter >= limit)
    pool = torch.cuda.MemPool()
    while_graph(body, lanes, cap, iters, pool).replay()
    err = max(err, int((counter.cpu() - torch.tensor([2, 5, 3])).abs().max()),
              abs(int(iters) - 5))
    assert err == 0, (counter, iters)

    count = torch.zeros((), dtype=torch.int64, device=device)
    flag.fill_(False)
    cap.fill_(WHILE_ITERS)
    loop = while_graph(lambda: count.add_(1), flag, cap, iters)
    straight = torch.cuda.CUDAGraph()
    with torch.cuda.graph(straight):
        for _ in range(WHILE_ITERS):
            count.add_(1)

    def per_iteration(g, replays=5):
        g.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            g.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (WHILE_ITERS * replays)
    ms, ms_straight = per_iteration(loop), per_iteration(straight)
    assert int(iters) == WHILE_ITERS

    def plain():
        done = torch.zeros(1, dtype=torch.int32)
        graph_cond.while_node_ref(
            lambda: not bool(flag.any()) and int(done) < 20,
            lambda: (count.add_(1), done.add_(1)))
    plain_ms = time_ms(plain, reps=20) / 20
    bound_ms = 1e3 * (1 + 4 + 4 + 4) / HBM_BYTES_S
    log(f"  graph_cond WHILE node: every run as the plain version's (n, 0 "
        f"and 1 iterations, three lanes finishing after 2, 5 and 3); "
        f"{ms:.5f} ms an iteration (device alone, {WHILE_ITERS} iterations, "
        f"the body one add) against {ms_straight:.5f} ms an add captured "
        f"in a row: the node's overhead {ms - ms_straight:.5f} ms an "
        f"iteration; plain version (host reads) {plain_ms:.5f} ms an "
        f"iteration; bound {bound_ms:.2e} ms (bytes)")
    return dict(max_abs_err=float(err), ms=ms, ms_straight_add=ms_straight,
                overhead_ms=ms - ms_straight, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None)


# a lane's uniforms a headline sampling step: the verification's
# (ops/sampling.py:verify_noise_size(G=20, GS=6, V=32000)) and the EOS
# filter's W=20 (always_fwd_one: no refill)
PHILOX_N = (LEVEL - 1) * (GUESS + ARCH["vocab_size"]) + WINDOW   # 192,140
# a block's integer operations: 10 rounds of two 32-bit products (high
# and low words: four multiplies) and four XORs, 9 key bumps of two adds,
# and four outputs' shift, conversion and scale
PHILOX_OPS = 10 * 8 + 9 * 2 + 4 * 3


def check_philox(device):
    """The Philox kernel (``ops/philox.py``, ``csrc/philox.cu``; the
    state's random stream, JAX's ``jax.random`` draws from
    ``DecodeState.rng``) against its plain version at the headline's draw,
    PHILOX_N uniforms a lane, at 1 lane (a flat call) and 4 (phase 8e's
    batch): the raw words bit-equal to the plain version's on the CPU, for
    both tags and random keys and counters past 2**32, and the uniforms
    bit-equal to theirs. Then ms a call from a Python loop and on the
    device alone, the plain version's ms on the card (its int64 tensor
    arithmetic on CUDA tensors), ``torch.rand`` of the same count as the
    library yardstick (device alone), and the bound: the larger of the
    floats written and the keys and counters read over the memory rate,
    and the integer work (PHILOX_OPS a block of four outputs) over the
    card's 32-bit rate off the tensor cores (the float32 peak; Hopper's
    integer multiply runs no faster). Returns {lanes: numbers}."""
    import torch
    from lookaheaddecoding_tpu_torch.ops import philox

    out = {}
    for lanes in (1, 4):
        rng = np.random.RandomState(lanes)
        key = torch.from_numpy(rng.randint(-2**31, 2**31, size=(lanes, 2))
                               .astype(np.int32))
        draws = torch.from_numpy(rng.randint(0, 2**40, size=lanes)
                                 .astype(np.int64))
        kd, dd = key.to(device), draws.to(device)
        bad = 0
        for tag in (philox.STEP, philox.WINDOW):
            want = philox.bits(key, draws, PHILOX_N, tag)
            got = philox.bits(kd, dd, PHILOX_N, tag).cpu()
            u = philox.uniforms(kd, dd, PHILOX_N, tag).cpu()
            bad += int((got != want).sum())
            bad += int((u != philox.to_uniform(want)).sum())
        assert bad == 0, f"philox: {bad} words differ from the plain version"
        ms_loop = time_ms(lambda: philox.uniforms(kd, dd, PHILOX_N), reps=200)
        ms = graph_ms(lambda i: philox.uniforms(kd, dd, PHILOX_N))
        plain_ms = time_ms(lambda: philox.to_uniform(philox.bits_ref(
            kd, dd, PHILOX_N, philox.STEP)), reps=10, rounds=2)
        library_ms = graph_ms(lambda i: torch.rand(lanes, PHILOX_N,
                                                   device=device))
        moved = lanes * (4 * PHILOX_N + 8 + 8)
        ops = lanes * -(-PHILOX_N // 4) * PHILOX_OPS
        by = {"bytes": 1e3 * moved / HBM_BYTES_S,
              "operations": 1e3 * ops / PEAK_FLOPS["float32"]}
        bound_by = max(by, key=by.get)
        bound_ms = by[bound_by]
        log(f"  philox, {lanes} lane{'s' if lanes > 1 else ''} x {PHILOX_N} "
            f"uniforms: the raw words and uniforms bit-equal to the plain "
            f"version (both tags); {ms:.5f} ms a call on the device alone, "
            f"{ms_loop:.5f} from a Python loop; plain version on the card "
            f"{plain_ms:.4f} ms; torch.rand of the same count {library_ms:.5f}"
            f" ms (device alone); bound {bound_ms:.5f} ms ({bound_by}: "
            f"{moved} bytes, {ops} integer operations)")
        out[lanes] = dict(max_abs_err=0.0, ms=ms, ms_python_loop=ms_loop,
                          plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms)
    return out


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

    # the micro-benchmark's timing loop (bfloat16) is the path that launches
    # them: the K-outer variant through its tensor-core design alone
    im.counts.update(dict.fromkeys(im.counts, 0))
    results = micro.run(device, rows=rows, log=lambda line: log("  " + line),
                        check=False)
    launches = dict(im.counts, kouter=im.counts["kouter_mma"])
    assert launches["shift"] > 0 and launches["kouter_mma"] > 0, launches
    assert launches["kouter_fma"] == 0 and launches["plain"] == 0, launches
    head = next(r for r in results if (r["k"], r["n"], r["t"])
                == (2048, 5632, 8))["us"]
    bound, by = matmul_bound(8, 2048, 5632, 4, "bfloat16")

    # the same calls on the device alone (CUDA graphs), the weight cold
    k, n = 2048, 5632
    copies = 1 + (64 << 20) // (k * n // 2)
    ws = [torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)
                           * 0.02).to(device) for _ in range(copies)]
    w4 = [quant.quantize_weight(w, 4) for w in ws]
    wb = [w.bfloat16() for w in ws]
    del ws
    x = torch.from_numpy(rng.standard_normal((8, k), dtype=np.float32)).to(
        device, torch.bfloat16)
    k2 = quant.logical_packed_rows(w4[0])
    fns = {"shift": im.int4_matmul_shift, "kouter": im.int4_matmul_kouter}
    dev = {name: graph_ms(lambda i, fn=fn: fn(
        x, w4[i % copies]["q4"], w4[i % copies]["scale"], logical_k2=k2))
        for name, fn in fns.items()}
    lib_dev = graph_ms(lambda i: torch.matmul(x, wb[i % copies]))
    log(f"  T=8 K={k} N={n}, device alone: int4_shift {dev['shift']:.4f} ms, "
        f"int4_kouter {dev['kouter']:.4f} ms, torch.matmul on bf16 weights "
        f"{lib_dev:.4f} ms, bound {bound:.5f} ms ({by})")
    del w4, wb
    out = {}
    for name in ("shift", "kouter"):
        out[name] = dict(
            max_abs_err=worst[name], ms=head[f"int4_{name}"] / 1e3,
            device_ms=dev[name], plain_ms=head[f"{name}_plain"] / 1e3,
            bound_ms=bound, bound_by=by, library_ms=head["bf16"] / 1e3,
            library_device_ms=lib_dev, launches=launches[name])
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
    ragged count, the prefill chunk, the logits rows, the composite; int8
    also the paged step's four lanes) and at one padded Llama-2-7B shape
    and one stacked weight, then their times. In bfloat16 every product
    runs on the tensor cores (counted apart from the float32 FMA kernels).
    Times: a Python loop of calls (``time_ms``) and the device alone (a
    CUDA graph of the same calls).
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

    # (K, N): the unfused int8 projections and the LM head, whole and as
    # phase 12's tp=2 shards (wq, wk/wv, wo, gate/up, down, LM head); the
    # fused int4 projections; Llama-2-7B's down projection, whose K/2 =
    # 5504 packed rows are stored as 5632
    shapes = {8: [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048),
                  (2048, 32000), (11008, 4096),
                  (2048, 1024), (2048, 128), (1024, 2048), (2048, 2816),
                  (2816, 2048), (2048, 16000)],
              4: [(2048, 2560), (2048, 2048), (2048, 11264), (5632, 2048),
                  (11008, 4096)]}
    rows = (1, 17, PREFILL_CHUNK, LOGITS_ROWS, s_comp)
    worst = dict.fromkeys(("int8", "int4", "int4_pipe"), 0.0)
    for bits, kns in shapes.items():
        for k, n in kns:
            # int8 also at the paged step's four lanes of composite rows
            t_rows = rows + ((PAGED_ROWS,) if bits == 8 else ())
            wq = quant.quantize_weight(randn(k, n, scale=0.02), bits)
            if (bits, k) == (4, 11008):
                assert wq["q4"].shape[0] == 5632, wq["q4"].shape
            for dtype in (torch.bfloat16, torch.float32):
                dname = str(dtype).split(".")[1]
                errs = []
                for t in t_rows:
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
                    f"T in {t_rows}: max_abs_err="
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
            # the LM head multiplies the AR row or the logits rows; the
            # paged int8 step multiplies four lanes' composite rows
            ts = (1, LOGITS_ROWS) if n == 32000 else (1, s_comp)
            if (bits, k, n) == (8, 2048, 5632):
                ts += (PAGED_ROWS,)
            for t in ts:
                x = randn(t, k).bfloat16()
                turn = iter(range(10 ** 9))

                def rotate(fn, ws):
                    return lambda: fn(x, ws[next(turn) % copies])

                def rotate_i(fn, ws):
                    return lambda i: fn(x, ws[i % copies])
                lib_ms = time_ms(rotate(torch.matmul, dense))
                lib_dev = graph_ms(rotate_i(torch.matmul, dense))
                bound, by = matmul_bound(t, k, n, bits, "bfloat16")
                for mode in (("int8",) if bits == 8
                             else ("int4", "int4_pipe")):
                    ms = time_ms(rotate(lambda x, w: run(mode, x, w), wqs))
                    dev_ms = graph_ms(rotate_i(
                        lambda x, w: run(mode, x, w), wqs))
                    plain_ms = time_ms(
                        rotate(lambda x, w: ref(mode, x, w), wqs), reps=10)
                    nums = dict(t=t, k=k, n=n, ms=ms, device_ms=dev_ms,
                                plain_ms=plain_ms, bound_ms=bound,
                                bound_by=by, library_ms=lib_ms,
                                library_device_ms=lib_dev)
                    log(f"  {mode:9s} bfloat16 T={t:3d} K={k} N={n}: kernel "
                        f"{ms:.4f} ms (device alone {dev_ms:.4f}), plain "
                        f"{plain_ms:.4f} ms, torch.matmul on bf16 weights "
                        f"{lib_ms:.4f} ms (device alone {lib_dev:.4f}), bound "
                        f"{bound:.5f} ms ({by})")
                    entry = headline.setdefault(
                        mode, dict(max_abs_err=worst[mode], timings=[]))
                    entry["timings"].append(nums)
                    if t == s_comp and k == 2048:
                        entry.update({key: nums[key] for key in (
                            "ms", "device_ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "library_device_ms")})
            del wqs, dense
    return headline


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

def build_headline(device, arch=ARCH):
    """A model and prompt: the transition-cycle recipe
    (``applications/synthetic.py``) at ``arch`` (the headline's
    TinyLlama-1.1B widths by default) in bfloat16, and the cycle it
    follows."""
    t0 = time.perf_counter()
    built = synthetic.build_headline(device, arch)
    log(f"  model built in {time.perf_counter() - t0:.1f} s")
    return built


def build_engine(mcfg, params, kv_quant=None, max_seq=MAX_SEQ):
    """The headline engine on ``params``: L7/W20/G20, pool from the prompt,
    M=1024 unless ``max_seq`` says otherwise, prefill chunk 128
    (bench.py's)."""
    import lookaheaddecoding_tpu_torch as lt

    eng = lt.LookaheadEngine(
        mcfg, params,
        lt.LookaheadConfig(level=LEVEL, window_size=WINDOW,
                           guess_set_size=GUESS, pool_from_prompt=True),
        lt.EngineConfig(max_seq_len=max_seq, prefill_chunk=PREFILL_CHUNK,
                        kv_quant=kv_quant))
    assert eng.lcfg.attention_impl == "kernel", eng.lcfg.attention_impl
    return eng


def main_path(name, eng, prompt, nxt, card, matmul_kernels, n_new=N_NEW):
    """One configuration's ``generate`` and ``generate_baseline``: token
    exactness, the cycle, and for each path alone the kernels' launches
    (every kernel named in ``matmul_kernels`` and the attention kernel's
    tensor-core design > 0, every other kernel, the attention's FMA design
    and both plain versions 0). One warm-up pass of WARM_NEW tokens, then
    one timed run of ``n_new`` tokens of each path."""
    import torch
    from lookaheaddecoding_tpu_torch.ops import graph_cond, philox
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
        la.counts.update(dict.fromkeys(la.counts, 0))
        qm.counts.update(dict.fromkeys(qm.counts, 0))
        graph_cond.counts.update(dict.fromkeys(graph_cond.counts, 0))
        philox.counts.update(dict.fromkeys(philox.counts, 0))
        runs[path] = gen(prompt, n_new)
        got = dict(qm.counts, attention_mma=la.counts["mma"],
                   set_if=graph_cond.counts["set_if"],
                   set_while=graph_cond.counts["set_while"],
                   philox=philox.counts["kernel"],
                   attention_fma=la.counts["fma"],
                   plain=(qm.counts["plain"] + la.counts["plain"]
                          + philox.counts["plain"]))
        launches[path] = got
        assert got["attention_mma"] > 0 and got["attention_fma"] == 0, \
            (name, path, got)
        assert got["plain"] == 0, (name, path, got)
        # the pool's chain is an IF node of every captured lookahead step;
        # each path is one request graph, its prefill and decode loops on
        # the device: each WHILE condition kernel once before its loop and
        # once an iteration
        assert (got["set_if"] > 0) == (path == "lookahead"), (name, path,
                                                              got)
        assert got["set_while"] == runs[path].steps + 2 + prefill_chunks(
            eng, len(prompt)), (name, path, got)
        # the window's copy_from seeding draws once a request; a greedy
        # step (always_fwd_one) draws nothing
        assert got["philox"] == 1, (name, path, got)
        # bf16 on the tensor cores: the FMA matmul kernels never run
        for kernel in qm.counts:
            if kernel != "plain":
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
    assert r.compression_ratio > 1, f"{name}: no guess was ever accepted"
    assert fidelity > 0.95, f"{name}: synthetic model degenerated ({fidelity})"
    return (launches, r.tokens,
            {"lookahead": r.wall_time_s / r.steps,
             "ar_baseline": rb.wall_time_s / rb.steps})


# the port's kernels, by the name of their __global__ in a profile
FAMILIES = (("attention", "attention_mma_kernel"),
            ("quantized products", "quant_mma_kernel"))


def family_line(by_name, steps):
    """Device ms a step of each of the port's kernel families."""
    return ", ".join(
        f"{label} {sum(ms for k, ms in by_name.items() if key in k) / steps:.4f}"
        for label, key in FAMILIES)


def host_loop_call(eng, prompt, mode, n_new, eos=None):
    """A ``mode`` ("greedy" or "ar") call of ``eng`` decoded by the host loop
    (``LookaheadEngine._run(..., host_loop=True)``: the slot's captured step
    replayed in batches, as sampling calls decode), which the profiler can
    see into: it records no kernel inside a CUDA-graph WHILE body, so not
    the device loop's. Returns the call's result."""
    return eng._run(mode, prompt, n_new, eos, 0, host_loop=True)


def profile_path(name, eng, prompt, card, paths):
    """Where a host-loop call's time goes: one request of PROFILE_NEW tokens
    for each of ``paths`` under torch.profiler, decoded by the host loop
    (``host_loop_call``: the profiler records no kernel inside the device
    loop's WHILE body; phase 13 times that loop with CUDA events), so the
    kernels and the idle share are the host loop's, not those of the device
    loop that greedy calls run. Device busy time is the sum of the kernels'
    durations (one stream, so they do not overlap). The idle share is given
    against the wall time per step of the same host-loop request
    unprofiled, and against the profiled run's own wall time, which the
    profiler lengthens. Prints "not measured" if the profiler records no
    kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for path in paths:
        mode = "greedy" if path == "lookahead" else "ar"
        host_loop_call(eng, prompt, mode, PROFILE_NEW)   # its step graph
        r0 = host_loop_call(eng, prompt, mode, PROFILE_NEW)
        step_ms = 1e3 * r0.wall_time_s / r0.steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            r = host_loop_call(eng, prompt, mode, PROFILE_NEW)
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
        log(f"  [{card}] {name} {path} (host loop): {r.steps} steps, "
            f"{len(kernels)} kernels ({len(kernels) / r.steps:.0f} a "
            f"step); device busy "
            f"{busy_ms / r.steps:.3f} ms a step, idle "
            f"{1 - busy_ms / r.steps / step_ms:.3f} of the unprofiled "
            f"{step_ms:.2f} ms wall a step (idle {1 - busy_ms / wall_ms:.3f} "
            f"of {wall_ms:.1f} ms under the profiler)")
        log(f"    the port's kernels, device ms a step: "
            f"{family_line(by_name, r.steps)}")
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
    la.counts.update(dict.fromkeys(la.counts, 0))
    la.paged_counts.update(dict.fromkeys(la.paged_counts, 0))
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

    got = dict(qm.counts, paged_attention=la.paged_counts["mma"],
               flat_attention=la.counts["mma"],
               attention_fma=la.counts["fma"] + la.paged_counts["fma"],
               plain=(qm.counts["plain"] + la.counts["plain"]
                      + la.paged_counts["plain"]))
    assert got["paged_attention"] > 0 and got["plain"] == 0, (name, got)
    # bf16 on the tensor cores: no FMA kernel of any product runs
    assert got["attention_fma"] == 0, (name, got)
    assert all(n == 0 for key, n in qm.counts.items()
               if key.endswith("_fma")), (name, got)
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
    ttft = np.array([r.ttft_s for r in results.values()])
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
        f"TTFT p50 {1e3 * np.median(ttft):.1f} ms, max "
        f"{1e3 * ttft.max():.1f} ms (from submission, queueing included); "
        f"admission waited {waits} times, fewest free pages {low}; every "
        f"request == flat generate; launches {got}; memory {stats}; peak "
        f"device memory {peak_mb:.0f} MiB")
    return got, dict(step_s=wall / steps_run, engine=eng)


def paged_shared_prefix(name, mcfg, params, flat, nxt, card, n_new):
    """A short run of ``PagedServingEngine``: four requests of ``n_new``
    tokens, two of them on one shared prefix (a partial tail page). Each
    must equal ``flat.generate`` on the same prompt and every page must be
    free at the end. Returns the launches of the paged run and the
    engine."""
    import torch
    import lookaheaddecoding_tpu_torch as lt

    eng = lt.PagedServingEngine(
        mcfg, params,
        lt.LookaheadConfig(level=LEVEL, window_size=WINDOW,
                           guess_set_size=GUESS, pool_from_prompt=True),
        lt.EngineConfig(max_seq_len=MAX_SEQ, prefill_chunk=PREFILL_CHUNK),
        num_lanes=LANES, page_size=PAGE, n_pages=N_PAGES,
        steps_per_sync=STEPS_PER_SYNC)
    assert eng.lcfg.attention_impl == "kernel", eng.lcfg.attention_impl
    eng.generate(make_prompt(nxt, start=1, n=48), WARM_NEW)   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    eng.steps_run = 0
    t0 = time.perf_counter()
    px = eng.precompute_prefix(make_prompt(nxt, start=3, n=200))
    shared = list(px.tokens)
    prompts = {"shared0": shared + make_prompt(nxt, start=shared[-1], n=8),
               "shared1": shared + make_prompt(nxt, start=shared[-1], n=24),
               "plain0": make_prompt(nxt, start=9, n=100),
               "plain1": make_prompt(nxt, start=11, n=64)}
    results = {r.request_id: r for r in eng.run([
        lt.Request(prompt=p, max_new_tokens=n_new, request_id=rid,
                   prefix=px if rid.startswith("shared") else None)
        for rid, p in prompts.items()])}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    assert got["paged_attention"] > 0 and got["attention_fma"] == 0, got
    assert got["plain"] == 0, got
    assert sorted(results) == sorted(prompts), sorted(results)
    assert all(r.error is None and r.num_generated == n_new
               for r in results.values())
    steps_run = eng.steps_run
    eng.release_prefix(px)
    assert eng.pages_free == N_PAGES, eng.memory_stats()
    for rid, r in results.items():
        single = flat.generate(prompts[rid], n_new)
        assert np.array_equal(r.tokens, single.tokens), \
            f"{name}: request {rid} differs from the flat generate"
    tokens = sum(r.num_generated for r in results.values())
    log(f"  [{card}] {name}: {len(results)} requests (two on one shared "
        f"prefix of {len(shared)} tokens), {tokens} tokens in {steps_run} "
        f"batched steps, {tokens / wall:.1f} tok/s summed over {LANES} lanes "
        f"(prefix prefill and admissions included); every request == flat "
        f"generate; every page free; launches {got}")
    return got, eng


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
    log(f"    the port's kernels, device ms a step: "
        f"{family_line(by_name, n_steps)}")
    for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {ms / n_steps:9.4f} ms a step  {kname[:90]}")


# ---------------------------------------------------------------------------
# Phase 8: sampling
# ---------------------------------------------------------------------------

N_SAMPLE = 128        # new tokens of phase 8's b and c, and greedy d, f
N_SAMPLE_SHORT = 64   # ... of its sampling streams and prefix runs, AR
                      # stream, batches and paged requests: compared with
                      # the first 64 of a 128-token run where it has one
                      # (max_new only decides when a run stops)
TOP_K = 50
P_CYCLE = 0.85        # the cycle token's probability T* is chosen for


def teacher_forced_logits(eng, tokens):
    """float32 logits [T, V] of a causal forward over ``tokens`` on a fresh
    cache (the attention kernel's causal mode); on a mesh engine every rank
    of the mesh calls it."""
    import torch
    from lookaheaddecoding_tpu_torch.models import llama

    mcfg, dev = eng.mcfg, eng.device
    m = eng.ecfg.max_seq_len
    k, v = llama.make_kv_cache(mcfg, m, dev, params=eng.params)
    cos, sin = llama.rope_tables(mcfg, m, dev)
    t = torch.tensor(np.asarray(tokens, np.int64), device=dev)
    with torch.inference_mode():
        logits, _, _ = llama.forward(
            eng.params, mcfg, t, torch.arange(len(t), device=dev), k, v, 0,
            cos, sin, dict(level=LEVEL, window=WINDOW, guess_size=LEVEL - 1,
                           sliding_window=0, causal=True,
                           kv_len=torch.zeros(1, dtype=torch.int32,
                                              device=dev)),
            attn_impl="kernel", mesh=eng.mesh)
    return logits.float()


def assert_same_tokens(name, eng, got, want, temperature):
    """Token equality; a mismatch raises with its position, both tokens and
    both tokens' probabilities under the model at ``temperature`` (a
    teacher-forced forward over the common prefix)."""
    import torch
    got, want = np.asarray(got), np.asarray(want)
    if got.shape == want.shape and np.array_equal(got, want):
        return
    n = min(len(got), len(want))
    i = int(np.argmax(got[:n] != want[:n])) if (got[:n] != want[:n]).any() \
        else n
    detail = f"lengths {len(got)} / {len(want)}"
    if i < n:
        probs = torch.softmax(teacher_forced_logits(eng, want[:i])[-1]
                              / temperature, -1)
        detail = (f"position {i}: token {got[i]} (p {float(probs[got[i]]):.6g})"
                  f" against {want[i]} (p {float(probs[want[i]]):.6g}) at "
                  f"temperature {temperature:.4g}")
    raise AssertionError(f"{name}: tokens differ, {detail}")


def check_sampling_function(device, card):
    """Phase 8a: ``rejection_sample_verify`` on the card with
    tests/test_sampling.py's setup (V=8, three candidates) as 20,000 lanes
    of one batched call, each lane with its own stream (key i, its first
    draw: the Philox kernel); and
    ``warp_logits`` on the card against the CPU on the same logits."""
    import torch
    from lookaheaddecoding_tpu_torch.ops import sampling as ts
    from lookaheaddecoding_tpu_torch.ops.philox import seed_key

    V, N = 8, 20_000
    rng = np.random.RandomState(0)

    def rand_dist(peak_ix, peak):
        p = rng.rand(V) * (1 - peak)
        p[peak_ix] = 0
        p = p / p.sum() * (1 - peak)
        p[peak_ix] = peak
        return p
    probs_next = rand_dist(2, 0.35)
    probs_next[3] += probs_next[4] * 0.5
    probs_next[4] *= 0.5
    probs_next /= probs_next.sum()
    q2, q3 = rand_dist(5, 0.4), rand_dist(1, 0.3)
    gp = np.zeros((3, 2, V))
    gp[0, 0] = gp[1, 0] = q2
    gp[2, 0] = q3
    gp[:, 1] = 1.0 / V

    def dev_t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device=device)
    res = ts.rejection_sample_verify(
        dev_t(probs_next).expand(N, V), dev_t(gp).expand(N, 3, 2, V),
        dev_t([[2, 5], [2, 6], [3, 1]], torch.int32).expand(N, 3, 2),
        torch.ones(N, 3, dtype=torch.bool, device=device),
        dev_t([seed_key(i) for i in range(N)], torch.int32),
        torch.zeros(N, dtype=torch.int64, device=device))
    hits, max_hit = res.hits.cpu().numpy(), res.max_hit.cpu().numpy()
    tv0 = 0.5 * np.abs(np.bincount(hits[:, 0], minlength=V) / N
                       - probs_next).sum()
    tvs = {}
    for tau, q in ((2, q2), (3, q3)):
        sel = hits[:, 0] == tau
        assert sel.sum() > 2000 and np.all(max_hit[sel] >= 1), (tau, sel.sum())
        tvs[tau] = 0.5 * np.abs(np.bincount(hits[sel, 1], minlength=V)
                                / sel.sum() - q).sum()
    assert np.all(max_hit[~np.isin(hits[:, 0], [2, 3])] == 0)
    log(f"  [{card}] rejection_sample_verify, {N} lanes of one call: "
        f"first-token TV {tv0:.4f} (< 0.02), conditional TV after 2 "
        f"{tvs[2]:.4f}, after 3 {tvs[3]:.4f} (< 0.08)")
    assert tv0 < 0.02 and max(tvs.values()) < 0.08, (tv0, tvs)

    # warp_logits: the same logits on the card and on the CPU. The two
    # float32 softmax normalizers over the vocabulary differ by a few 1e-6,
    # so a token may fall on either side of top_p where the cumulative
    # probability before it, as each device computes it, straddles top_p
    # (widened by 1e-6); everywhere else the supports must be equal
    logits = torch.from_numpy(
        np.random.RandomState(1).randn(16, ARCH["vocab_size"]).astype(
            np.float32) * 4)

    def cum_before(x, temp, top_k):
        x = ts.warp_logits(x, temp, top_k, None)
        srt, order = torch.sort(x, dim=-1, descending=True, stable=True)
        pr = torch.softmax(srt, -1)
        return torch.empty_like(pr).scatter_(1, order, pr.cumsum(-1) - pr)
    for temp, top_k, top_p in ((0.8, 0, 0.9), (1.0, TOP_K, 0.9),
                               (0.7, TOP_K, 1.0)):
        want = ts.warp_logits(logits, temp, top_k, top_p)
        got = ts.warp_logits(logits.to(device), temp, top_k, top_p).cpu()
        c_cpu = cum_before(logits, temp, top_k)
        c_card = cum_before(logits.to(device), temp, top_k).cpu()
        straddle = ((torch.minimum(c_cpu, c_card) - 1e-6 <= top_p)
                    & (top_p <= torch.maximum(c_cpu, c_card) + 1e-6)
                    & (top_p < 1.0))
        differ = torch.isinf(got) != torch.isinf(want)
        assert bool((~differ | straddle).all()), (temp, top_k, top_p)
        fin = torch.isfinite(want) & torch.isfinite(got)
        torch.testing.assert_close(got[fin], want[fin], rtol=1e-6, atol=1e-6)
        log(f"  [{card}] warp_logits T={temp} top_k={top_k} top_p={top_p} "
            f"on [16, {ARCH['vocab_size']}]: card support == CPU support "
            f"({int(torch.isfinite(want).sum())} tokens kept; "
            f"{int(differ.sum())} differ, each with its two cum_before "
            f"straddling top_p, of {int(straddle.sum())} that do; largest "
            f"cum_before difference {float((c_cpu - c_card).abs().max()):.3g})")


def cycle_temperature(eng, prompt):
    """(T*, the cycle token's mean probability at T*, the median top-2
    logit margin) over the prompt's positions: T* is the temperature at
    which the cycle token has probability P_CYCLE on average."""
    import torch
    lg = teacher_forced_logits(eng, prompt)
    top2 = lg.topk(2, dim=-1).values
    margin = float((top2[:, 0] - top2[:, 1]).median())
    lo, hi = 0.05, 200.0
    for _ in range(60):
        t = (lo * hi) ** 0.5
        p = float(torch.softmax(lg / t, -1).amax(-1).mean())
        lo, hi = (t, hi) if p > P_CYCLE else (lo, t)
    t_star = (lo * hi) ** 0.5
    p_star = float(torch.softmax(lg / t_star, -1).amax(-1).mean())
    return t_star, p_star, margin


def sampling_path(eng, mcfg, params, prompt, nxt, card):
    """Phase 8 b-g on the headline engine. Every path is counted alone: the
    flat (or, for the batch and the paged engine, the paged) attention
    kernel launches, its FMA design and every plain version do not.
    Returns (launches by path, T*, numbers for the report)."""
    import torch
    import lookaheaddecoding_tpu_torch as lt
    from torch.profiler import ProfilerActivity, profile

    launches = {}

    def counted(path, fn, paged=False):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got = read_counts()
        key = "paged_attention" if paged else "attention_mma"
        assert got[key] > 0 and got["attention_fma"] == 0 \
            and got["plain"] == 0, (path, got)
        launches[path] = got
        return out

    t_star, p_star, margin = cycle_temperature(eng, prompt)
    log(f"  [{card}] top-2 logit margin over the prompt (median) {margin:.3f};"
        f" T* = {t_star:.4f} gives the cycle token p = {p_star:.4f}")
    cfg = lt.SamplingConfig(temperature=t_star, top_k=TOP_K)

    eng.generate_sample(prompt, WARM_NEW, cfg)              # warm-up
    greedy = eng.generate(prompt, N_SAMPLE)
    base = eng.generate_baseline(prompt, N_SAMPLE)

    # b: near-zero temperature is greedy
    for seed in (0, 1, 2):
        r = counted(f"b_temperature_0.01_seed{seed}", lambda: eng.generate_sample(
            prompt, N_SAMPLE, lt.SamplingConfig(temperature=0.01), seed=seed))
        assert_same_tokens(f"8b seed {seed}", eng, r.tokens, greedy.tokens,
                           0.01)
    log(f"  [{card}] 8b: generate_sample at T=0.01 == generate for seeds "
        f"0, 1, 2 ({N_SAMPLE} tokens)")

    # c: sampling at T*
    s0 = counted("c_sample_seed0", lambda: eng.generate_sample(
        prompt, N_SAMPLE, cfg, seed=0))
    s0b = eng.generate_sample(prompt, N_SAMPLE, cfg, seed=0)
    s1 = eng.generate_sample(prompt, N_SAMPLE, cfg, seed=1)
    assert_same_tokens("8c seed 0 twice", eng, s0b.tokens, s0.tokens, t_star)
    assert not np.array_equal(s0.tokens, s1.tokens), "seeds 0 and 1 agree"
    lg = teacher_forced_logits(eng, s0.tokens)
    kth = lg.topk(TOP_K, dim=-1).values[:, -1]
    toks = torch.tensor(s0.tokens.astype(np.int64), device=lg.device)
    rows = torch.arange(len(prompt) - 1, len(toks) - 1, device=lg.device)
    assert bool((lg[rows, toks[rows + 1]] >= kth[rows]).all()), \
        "a sampled token lies outside the top-k support"
    on_cycle = float(np.mean([s0.tokens[i + 1] == nxt[s0.tokens[i]] for i in
                              range(len(prompt) - 1, len(s0.tokens) - 1)]))
    accept = (s0.num_generated - s0.steps) / s0.steps
    log(f"  [{card}] 8c: T*={t_star:.4f} top_k={TOP_K}: {s0.num_generated} "
        f"tokens in {s0.steps} steps (compression "
        f"{s0.compression_ratio:.3f}, mean accepted drafts a step "
        f"{accept:.3f}), {s0.tokens_per_sec:.1f} tok/s, wall/steps "
        f"{1e3 * s0.wall_time_s / s0.steps:.2f} ms; seed 1: "
        f"{s1.steps} steps (compression {s1.compression_ratio:.3f}); "
        f"tokens on the cycle {on_cycle:.3f}; every token in the top-{TOP_K} "
        f"support; greedy generate {greedy.tokens_per_sec:.1f} tok/s "
        f"({greedy.steps} steps), generate_baseline "
        f"{base.tokens_per_sec:.1f} tok/s (one timed run each)")

    # the sample step alone (eager) under the profiler: kernels, device
    # busy, and one device-to-host copy a step, graphs.cond's predicate of
    # the pool's chain (an IF node in the captured step), and no other
    out_buf, n, fill = eng._host_args(prompt, N_SAMPLE)
    warp = eng._warp(cfg)
    eos = torch.full((4,), -1, dtype=torch.int32, device=eng.device)
    with torch.inference_mode():
        st = eng._prepare(out_buf, n, 0, fill)
        st = eng._fns.sample_step(eng.params, st, N_SAMPLE, eos, *warp)
        torch.cuda.synchronize()
        n_steps = 8
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_steps):
                st = eng._fns.sample_step(eng.params, st, N_SAMPLE, eos,
                                          *warp)
            torch.cuda.synchronize()
            prof_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    d2h = [e for e in events if "DtoH" in e.name or "Device -> P" in e.name
           or "Device -> H" in e.name]
    assert len(d2h) == n_steps, \
        f"device-to-host copies inside sample_step: {len(d2h)}, {d2h[:3]}"
    step_ms = 1e3 * s0.wall_time_s / s0.steps
    prof_line = "device time not measured (the profiler recorded no kernel)"
    if events:
        busy = sum(e.time_range.elapsed_us() for e in events) / 1e3 / n_steps
        prof_line = (f"{len(events) / n_steps:.0f} kernels a step, device busy "
                     f"{busy:.3f} ms a step, idle {1 - busy / step_ms:.3f} of "
                     f"the unprofiled {step_ms:.2f} ms wall a step (idle "
                     f"{1 - busy / prof_ms:.3f} of {prof_ms:.2f} ms under the "
                     f"profiler); {len(d2h)} device-to-host copies (the "
                     f"chain's predicate, read eagerly) in {n_steps} steps")
    log(f"  [{card}] 8c profile, sample_step alone: {prof_line}")
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {ms / n_steps:9.4f} ms a step  {kname[:90]}")
    # where the host's time goes: the operators with the most CPU time of
    # their own
    ops = sorted((e for e in prof.key_averages() if e.key.startswith("aten")),
                 key=lambda e: -e.self_cpu_time_total)[:8]
    log("    host, ms a step of the operator's own CPU time (calls a step): "
        + ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3 / n_steps:.3f} "
                    f"({e.count / n_steps:.0f})" for e in ops))

    # d: streaming
    head = len(prompt) + N_SAMPLE_SHORT
    for spy in (1, 4):
        chunks = counted(f"d_stream_sample_spy{spy}", lambda: list(
            eng.generate_stream(prompt, N_SAMPLE_SHORT, seed=0, sampling=cfg,
                                steps_per_yield=spy)))
        assert_same_tokens(f"8d sampling stream spy {spy}", eng,
                           np.concatenate([prompt] + chunks),
                           s0.tokens[:head], t_star)
    chunks = counted("d_stream_greedy", lambda: list(
        eng.generate_stream(prompt, N_SAMPLE, steps_per_yield=4)))
    assert_same_tokens("8d greedy stream", eng,
                       np.concatenate([prompt] + chunks), greedy.tokens, 1.0)
    chunks = counted("d_stream_ar", lambda: list(
        eng.generate_stream(prompt, N_SAMPLE_SHORT, lookahead=False)))
    assert_same_tokens("8d AR stream", eng, np.concatenate([prompt] + chunks),
                       base.tokens[:head], 1.0)
    log(f"  [{card}] 8d: sampling stream ({N_SAMPLE_SHORT} tokens, "
        f"steps_per_yield 1 and 4) == generate_sample; greedy stream "
        f"({N_SAMPLE}) == generate; lookahead=False ({N_SAMPLE_SHORT}) == "
        f"generate_baseline")

    # e: batches of 4 prompts
    prompts = [make_prompt(nxt, start=s, n=n)
               for s, n in ((2, 64), (5, 48), (9, 80), (13, 40))]
    temps = [t_star, 0.8 * t_star, 1.25 * t_star, t_star]
    gb = counted("e_batch_greedy", lambda: eng.generate_batch(
        prompts, N_SAMPLE_SHORT), paged=True)
    sb = counted("e_batch_sample", lambda: eng.generate_batch(
        prompts, N_SAMPLE_SHORT, sampling=cfg, seeds=[0, 1, 2, 3],
        temperatures=temps), paged=True)
    for i, p in enumerate(prompts):
        assert_same_tokens(f"8e greedy lane {i}", eng, gb[i].tokens,
                           eng.generate(p, N_SAMPLE_SHORT).tokens, 1.0)
        one = eng.generate_sample(
            p, N_SAMPLE_SHORT, lt.SamplingConfig(temps[i], TOP_K), seed=i)
        assert_same_tokens(f"8e sampling lane {i}", eng, sb[i].tokens,
                           one.tokens, temps[i])
    log(f"  [{card}] 8e: generate_batch of 4 prompts, greedy and sampling "
        f"(temperatures {[round(t, 3) for t in temps]}): every lane == its "
        f"lone call; steps {[r.steps for r in sb]}")

    # f: prefixes
    px = eng.precompute_prefix(prompt[:40])
    kept = [px.k_cache.clone(), px.v_cache.clone()]
    r = counted("f_prefix_greedy", lambda: eng.generate(prompt, N_SAMPLE,
                                                         prefix=px))
    assert_same_tokens("8f greedy prefix", eng, r.tokens, greedy.tokens, 1.0)
    r = counted("f_prefix_sample", lambda: eng.generate_sample(
        prompt, N_SAMPLE_SHORT, cfg, seed=0, prefix=px))
    assert_same_tokens("8f sampling prefix", eng, r.tokens, s0.tokens[:head],
                       t_star)
    chunks = counted("f_prefix_stream", lambda: list(eng.generate_stream(
        prompt, N_SAMPLE_SHORT, seed=0, sampling=cfg, prefix=px,
        steps_per_yield=4)))
    assert_same_tokens("8f stream prefix", eng,
                       np.concatenate([prompt] + chunks), s0.tokens[:head],
                       t_star)
    r1 = counted("f_turn1", lambda: eng.generate(prompt, N_SAMPLE_SHORT,
                                                  return_prefix=True))
    c1 = r1.prefix
    kept += [c1.k_cache.clone(), c1.v_cache.clone(), c1.pool.values.clone()]
    turn2 = list(r1.tokens) + make_prompt(nxt, start=int(r1.tokens[-1]), n=8)
    r2 = counted("f_turn2", lambda: eng.generate(turn2, N_SAMPLE_SHORT,
                                                  prefix=c1))
    assert_same_tokens("8f second turn", eng, r2.tokens,
                       eng.generate(turn2, N_SAMPLE_SHORT).tokens, 1.0)
    for t, k in zip((px.k_cache, px.v_cache, c1.k_cache, c1.v_cache,
                     c1.pool.values), kept):
        assert torch.equal(t, k), "a prefix's tensors changed"
    log(f"  [{card}] 8f: a {px.length}-token prefix: generate, "
        f"generate_sample and generate_stream == the same calls without it; "
        f"a second turn through return_prefix ({c1.length} tokens carried) "
        f"== the full-prompt run; both prefixes' tensors bit-unchanged")

    # g: paged sampling
    paged = lt.PagedServingEngine(
        mcfg, params, eng.lcfg, eng.ecfg, num_lanes=LANES, page_size=PAGE,
        n_pages=N_PAGES, steps_per_sync=STEPS_PER_SYNC, sampling=cfg,
        device=eng.device)
    ppx = paged.precompute_prefix(make_prompt(nxt, start=3, n=160))
    base_p = list(ppx.tokens)
    streamed = []
    reqs = {
        "shared0": dict(prompt=base_p + make_prompt(nxt, start=base_p[-1],
                                                    n=8), prefix=ppx),
        "shared1": dict(prompt=base_p + make_prompt(nxt, start=base_p[-1],
                                                    n=24), prefix=ppx),
        "top_p": dict(prompt=make_prompt(nxt, start=7, n=64), top_p=0.9),
        "stream": dict(prompt=make_prompt(nxt, start=9, n=100),
                       on_tokens=streamed.append, temperature=0.8 * t_star),
        "plain": dict(prompt=make_prompt(nxt, start=11, n=48)),
    }
    seeds = {rid: 20 + i for i, rid in enumerate(reqs)}
    res = counted("g_paged_sample", lambda: {r.request_id: r for r in paged.run(
        [lt.Request(max_new_tokens=N_SAMPLE_SHORT, request_id=rid,
                    seed=seeds[rid], **kw) for rid, kw in reqs.items()])},
        paged=True)
    paged.release_prefix(ppx)
    assert paged.pages_free == N_PAGES, paged.memory_stats()
    assert all(r.error is None for r in res.values())
    for rid, kw in reqs.items():
        one = eng.generate_sample(
            kw["prompt"], N_SAMPLE_SHORT,
            lt.SamplingConfig(kw.get("temperature", t_star), TOP_K,
                              kw.get("top_p", 1.0)), seed=seeds[rid])
        assert_same_tokens(f"8g request {rid}", eng, res[rid].tokens,
                           one.tokens, kw.get("temperature", t_star))
    assert_same_tokens("8g streamed chunks", eng,
                       np.concatenate([reqs["stream"]["prompt"]] + streamed),
                       res["stream"].tokens, 0.8 * t_star)
    log(f"  [{card}] 8g: PagedServingEngine(sampling), {LANES} lanes, pages "
        f"of {PAGE}: 5 requests (two on a {ppx.length}-token shared prefix, "
        f"one with top_p 0.9 on an engine at 1.0, one streaming at "
        f"temperature {0.8 * t_star:.3f}, one plain) each == the flat "
        f"generate_sample with its seed and warpers; every page free; "
        f"steps {[res[rid].steps for rid in reqs]}")
    for path, got in launches.items():
        log(f"    launches {path}: {got}")
    return launches, dict(t_star=t_star, margin=margin)


# ---------------------------------------------------------------------------
# Phase 9: continuous batching
# ---------------------------------------------------------------------------

def cb_requests(nxt, n=10, new_scale=1.0):
    """``n`` requests on the cycle with staggered prompts (32-104 tokens)
    and budgets; neighbours share a budget, so that ``batch_group=2``
    groups them."""
    lens = (32, 48, 64, 80, 96, 40, 56, 72, 88, 104)
    news = (64, 64, 128, 128, 96, 96, 32, 32, 112, 112)
    return [dict(request_id=f"r{i}",
                 prompt=make_prompt(nxt, start=30 + 3 * i, n=lens[i]),
                 max_new_tokens=max(8, int(news[i] * new_scale)))
            for i in range(n)]


def cb_stats(results, wall):
    ok = [r for r in results.values() if r.error is None]
    ttft = np.array([r.ttft_s for r in ok])
    tokens = sum(r.num_generated for r in ok)
    return dict(requests=len(ok), tokens=tokens, wall_s=wall,
                tok_s=tokens / wall, ttft_p50_s=float(np.median(ttft)),
                ttft_max_s=float(ttft.max()))


def serving_path(eng, nxt, card, t_star):
    """Phase 9: ``ContinuousBatchingEngine`` on the headline engine, each
    objective counted alone: ten requests and a bad one (its prompt longer
    than M), one of them streaming, through ``fairness``, ``throughput``
    with ``batch_group=2`` and ``adaptive`` (all eleven queued, one fused
    drain, then an interactive request, which must take a lane). Every
    greedy result equals the flat ``generate``; then a sampling scheduler,
    whose requests each equal the lone ``generate_sample`` with their
    seed, temperature and top_p. Returns (launches by path, stats)."""
    import torch
    import lookaheaddecoding_tpu_torch as lt

    reqs = cb_requests(nxt)
    bad = dict(request_id="bad", prompt=make_prompt(nxt, start=5,
                                                    n=MAX_SEQ + 1),
               max_new_tokens=32)
    chat = dict(request_id="chat", prompt=make_prompt(nxt, start=60, n=72),
                max_new_tokens=64, interactive=True)
    # the flat generate of every request, before any count is reset
    flat = {r["request_id"]: eng.generate(r["prompt"], r["max_new_tokens"])
            for r in reqs + [chat]}
    launches, stats = {}, {}
    for objective, kw in (("fairness", {}),
                          ("throughput", dict(batch_group=2)),
                          ("adaptive", {})):
        srv = lt.ContinuousBatchingEngine(
            eng, num_lanes=CB_LANES, steps_per_sync=CB_SYNC,
            objective=objective, **kw)
        chunks = []
        todo = [dict(r, on_tokens=chunks.append) if r["request_id"] == "r2"
                else r for r in reqs] + [bad]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for r in todo:
            srv.submit(lt.Request(**r))
        chat_chunks = []
        if objective == "adaptive":
            srv.step()               # a deep backlog on idle lanes: fused
            assert not srv._active and len(srv._results) == 1
            srv.submit(lt.Request(**chat, on_tokens=chat_chunks.append))
            srv.step()
            on_lane = [q.request_id for q in srv._active.values()]
            assert on_lane == ["chat"], on_lane
        while srv.step():
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counts()
        results = {r.request_id: r for r in srv._results}
        srv._results = []
        assert got["attention_fma"] == 0 and got["plain"] == 0, (objective,
                                                                 got)
        assert got["attention_mma"] > 0, (objective, got)   # the prefills
        if objective != "throughput":
            assert got["paged_attention"] > 0, (objective, got)  # the lanes
        assert results["bad"].error and "exceeds" in results["bad"].error
        for rid, r in results.items():
            if rid != "bad":
                assert r.error is None, (objective, rid, r.error)
                assert np.array_equal(r.tokens, flat[rid].tokens), \
                    f"phase 9 {objective}: {rid} differs from generate"
        np.testing.assert_array_equal(
            np.concatenate([reqs[2]["prompt"]] + chunks), results["r2"].tokens)
        st = cb_stats(results, wall)
        if objective == "fairness":
            assert len(chunks) > 1, chunks          # r2 streamed from a lane
        if objective == "adaptive":
            # the interactive request streamed from its lane
            assert len(chat_chunks) > 1, chat_chunks
            np.testing.assert_array_equal(
                np.concatenate([chat["prompt"]] + chat_chunks),
                results["chat"].tokens)
        if objective != "throughput":
            st.update(lane_steps=srv.steps_run, host_reads=srv.host_reads,
                      reads_a_step=srv.host_reads / srv.steps_run)
        launches[objective], stats[objective] = got, st
        log(f"  [{card}] 9 {objective}{' batch_group=2' if kw else ''}: "
            f"{st['requests']} requests + 1 failed alone, {st['tokens']} "
            f"tokens in {wall:.2f} s, {st['tok_s']:.1f} tok/s in all; TTFT "
            f"p50 {st['ttft_p50_s']:.3f} s, max {st['ttft_max_s']:.3f} s"
            + (f"; {srv.steps_run} lane steps, {srv.host_reads} host reads "
               f"({st['reads_a_step']:.3f} a step)"
               if objective != "throughput" else "")
            + f"; every result == flat generate; launches {got}")

    # sampling lanes: a temperature a request (None: the engine's T*) and a
    # request top_p on an engine at 1.0
    cfg = lt.SamplingConfig(temperature=t_star, top_k=TOP_K)
    sreqs = [dict(r, seed=i, max_new_tokens=48, temperature=t)
             for i, (r, t) in enumerate(zip(
                 reqs[:5], (None, 0.8 * t_star, 1.2 * t_star, None, None)))]
    sreqs[3]["top_p"] = 0.9
    srv = lt.ContinuousBatchingEngine(eng, num_lanes=CB_LANES,
                                      steps_per_sync=CB_SYNC, sampling=cfg)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results = {r.request_id: r for r in srv.run(
        [lt.Request(**r) for r in sreqs])}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    assert got["paged_attention"] > 0 and got["attention_fma"] == 0 \
        and got["plain"] == 0, got
    for r in sreqs:
        temp = r["temperature"] or t_star
        one = eng.generate_sample(
            r["prompt"], r["max_new_tokens"],
            lt.SamplingConfig(temp, TOP_K, r.get("top_p", 1.0)),
            seed=r["seed"])
        assert_same_tokens(f"9 sampling {r['request_id']}", eng,
                           results[r["request_id"]].tokens, one.tokens, temp)
    launches["sampling"], stats["sampling"] = got, cb_stats(results, wall)
    log(f"  [{card}] 9 sampling lanes at T* = {t_star:.4f} (two requests at "
        f"0.8 and 1.2 T*, one at top_p 0.9 on an engine at 1.0): 5 requests "
        f"each == the lone generate_sample with its seed and warpers; "
        f"{stats['sampling']['tok_s']:.1f} tok/s in all; launches {got}")
    return launches, stats


# ---------------------------------------------------------------------------
# Phase 10: model coverage
# ---------------------------------------------------------------------------

def coverage_lanes(name, eng, nxt, card, n_new):
    """Three requests through ``ContinuousBatchingEngine`` (fairness, two
    lanes) on ``eng``, each equal to its flat ``generate``: the paged
    kernel at the engine's head_dim. Returns the paged launches."""
    import torch
    import lookaheaddecoding_tpu_torch as lt

    reqs = cb_requests(nxt, n=3, new_scale=n_new / 128)
    flat = {r["request_id"]: eng.generate(r["prompt"], r["max_new_tokens"])
            for r in reqs}
    reset_counts()
    res = lt.ContinuousBatchingEngine(eng, num_lanes=2,
                                      steps_per_sync=CB_SYNC).run(
        [lt.Request(**r) for r in reqs])
    torch.cuda.synchronize()
    got = read_counts()
    assert got["paged_attention"] > 0 and got["attention_fma"] == 0 \
        and got["plain"] == 0, (name, got)
    for r in res:
        assert r.error is None and np.array_equal(
            r.tokens, flat[r.request_id].tokens), (name, r.request_id)
    log(f"  [{card}] {name}: 3 requests through ContinuousBatchingEngine "
        f"(2 lanes) each == flat generate; launches {got}")
    return got


def build_on_card(device, mcfg, seed=0):
    """A phase-10 model: ``build_headline``'s recipe (layer weights of
    scale 0.002, unit embeddings scaled by sqrt(H), a head that maps each
    cycle token to the next) drawn on the card by a torch generator seeded
    with ``seed``, where numpy would take most of a minute at
    Llama-3.2-1B's vocab. Returns (params, prompt, nxt)."""
    import torch

    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    h, n, inter = (mcfg.hidden_size, mcfg.num_hidden_layers,
                   mcfg.intermediate_size)
    hq, hkv, d = (mcfg.num_attention_heads, mcfg.num_key_value_heads,
                  mcfg.head_dim)
    vocab = mcfg.vocab_size

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)
    shapes = {"wq": (n, h, hq * d), "wk": (n, h, hkv * d),
              "wv": (n, h, hkv * d), "wo": (n, hq * d, h),
              "w_gate": (n, h, inter), "w_up": (n, h, inter),
              "w_down": (n, inter, h)}
    layers = {name: (0.002 * normal(*shape)).to(mcfg.dtype)
              for name, shape in shapes.items()}
    for name in ("input_norm", "post_norm"):
        layers[name] = torch.ones(n, h, dtype=mcfg.dtype, device=device)
    cycle = np.random.RandomState(seed).choice(vocab, size=64, replace=False)
    nxt = np.full(vocab, cycle[0], np.int64)
    nxt[cycle] = np.roll(cycle, -1)
    embed = normal(vocab, h)
    embed /= embed.norm(dim=1, keepdim=True)
    head = torch.zeros(h, vocab, device=device)
    head[:, torch.from_numpy(nxt[cycle]).to(device)] = \
        embed[torch.from_numpy(cycle).to(device)].T
    params = {"embed": (embed * float(np.sqrt(h))).to(mcfg.dtype),
              "lm_head": head.to(mcfg.dtype), "layers": layers,
              "final_norm": torch.ones(h, dtype=mcfg.dtype, device=device)}
    log(f"  model built on the card in {time.perf_counter() - t0:.1f} s")
    return params, make_prompt(nxt), nxt


def model_coverage(device, card, params, nxt_headline):
    """Phase 10: Llama-3.2-1B from its config fields, the dynamic-NTK run
    and the engines at head_dim 32, 48, 80, 96 and 112. Returns launches by
    configuration (flat and paged)."""
    import dataclasses
    import types
    import torch
    import lookaheaddecoding_tpu_torch as lt

    flat, paged = {}, {}
    # Llama-3.2-1B: its config through from_hf, full width and depth;
    # reduced: synthetic weights, and an untied head (the cycle needs one)
    mcfg = lt.LlamaConfig.from_hf(types.SimpleNamespace(**LLAMA32_1B))
    assert mcfg.rope_scaling == ("llama3", (32.0, 1.0, 4.0, 8192.0)), mcfg
    mcfg = dataclasses.replace(mcfg, tie_word_embeddings=False)
    p32, prompt32, nxt32 = build_on_card(device, mcfg)
    eng = build_engine(mcfg, p32)
    flat["llama3.2-1b_layer"], _, _ = main_path(
        "llama3.2-1b_layer", eng, prompt32, nxt32, card, (), N_NEW_QUANT)
    del eng, p32
    torch.cuda.empty_cache()

    # dynamic-NTK: the headline weights, the rotation rescaled past 512
    dcfg = lt.LlamaConfig(**dict(ARCH, max_position_embeddings=DYN_MAX_POS),
                          rope_scaling=("dynamic", DYN_FACTOR),
                          dtype=torch.bfloat16)
    eng = build_engine(dcfg, params, max_seq=DYN_SEQ)
    prompt = make_prompt(nxt_headline, start=7, n=DYN_PROMPT)
    flat["dynamic_ntk"], _, _ = main_path(
        "dynamic_ntk", eng, prompt, nxt_headline, card, (), DYN_NEW)
    del eng

    for d, arch in ARCH_SMALL_D.items():
        name = f"bf16_head_dim_{d}"
        mc = lt.LlamaConfig(**dict(ARCH, num_hidden_layers=SMALL_D_LAYERS,
                                   **arch), dtype=torch.bfloat16)
        assert mc.head_dim == d, (d, mc.head_dim)
        p, pr, nx = build_on_card(device, mc, seed=d)
        eng = build_engine(mc, p)
        flat[name], _, _ = main_path(name, eng, pr, nx, card, (), SMALL_D_NEW)
        paged[name] = coverage_lanes(name, eng, nx, card, SMALL_D_NEW)
        del eng, p
    torch.cuda.empty_cache()
    return flat, paged


# ---------------------------------------------------------------------------
# Phase 11: the learned model
# ---------------------------------------------------------------------------

def check_train_step(device, card):
    """Three Adam and three SGD steps of ``training.make_train_step`` on the
    card and on the CPU from one seeded float32 parameter set (the learned
    model's config at CHECK_LAYERS layers): the worst relative difference
    of the losses and of the parameters, each within its limit."""
    import dataclasses
    import torch
    import lookaheaddecoding_tpu_torch as lt
    from lookaheaddecoding_tpu_torch.applications import train_synthetic
    from lookaheaddecoding_tpu_torch.training import (init_opt_state,
                                                      make_train_step)

    mcfg = dataclasses.replace(train_synthetic.model_config(torch.float32),
                               num_hidden_layers=CHECK_LAYERS)
    start = lt.init_params(mcfg, seed=0, scale=0.02, device="cpu")
    sampler = train_synthetic.make_markov_sampler(
        mcfg.vocab_size, order=LEARNED_ORDER, active_vocab=LEARNED_ACTIVE)
    rng = np.random.RandomState(1)
    batches = [sampler(CHECK_BATCH, CHECK_SEQ, rng)
               for _ in range(CHECK_STEPS)]

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        return [tree]

    def on(tree, dev):
        if isinstance(tree, dict):
            return {k: on(v, dev) for k, v in tree.items()}
        return tree.to(dev)

    def run(dev, optimizer):
        params = on(start, dev)
        step = make_train_step(mcfg, CHECK_SEQ + 1, learning_rate=LEARNED_LR,
                               optimizer=optimizer)
        opt = init_opt_state(params, optimizer)
        losses = []
        for b in batches:
            params, opt, loss = step(params, opt, b)
            losses.append(float(loss))
        return np.array(losses), [x.cpu() for x in leaves(params)]

    for optimizer in ("adam", "sgd"):
        (lc, pc), (lh, ph) = (run(device, optimizer),
                              run(torch.device("cpu"), optimizer))
        loss_rel = float(np.max(np.abs(lc - lh) / np.abs(lh)))
        diff = torch.cat([(a - b).abs().flatten()
                          for a, b in zip(pc, ph)]).numpy()
        worst, q999 = float(diff.max()), float(np.quantile(diff, 0.999))
        scale = max(float(b.abs().max()) for b in ph)
        if optimizer == "adam":
            limit = 2 * LEARNED_LR * CHECK_STEPS
            q_limit = LEARNED_LR * 1e-3 * CHECK_STEPS
        else:
            limit = q_limit = CHECK_SGD_ATOL
        log(f"  [{card}] train step, {optimizer}, {CHECK_STEPS} steps at "
            f"{CHECK_LAYERS} layers, batch {CHECK_BATCH} x {CHECK_SEQ}: "
            f"losses card {np.round(lc, 6).tolist()}, worst relative "
            f"difference of the loss {loss_rel:.3g} (limit "
            f"{CHECK_LOSS_RTOL:g}); parameters: worst |card - cpu| "
            f"{worst:.3g} (limit {limit:g}; relative to max|p| "
            f"{worst / scale:.3g}), 99.9% within {q999:.3g} (limit "
            f"{q_limit:g}), {int((diff > 1e-6).sum())} of {diff.size} "
            f"above 1e-6")
        assert loss_rel <= CHECK_LOSS_RTOL, (optimizer, loss_rel)
        assert worst <= limit and q999 <= q_limit, (optimizer, worst, q999)


def train_learned(device, card):
    """Train the learned model at full width and depth on the card through
    ``train_synthetic.train``. Returns (float32 config, params)."""
    from lookaheaddecoding_tpu_torch.applications import train_synthetic

    mcfg, params, losses, done, secs = train_synthetic.train(
        LEARNED_STEPS, LEARNED_BATCH, LEARNED_SEQ, LEARNED_LR,
        order=LEARNED_ORDER, active_vocab=LEARNED_ACTIVE, device=device,
        budget_s=LEARNED_BUDGET_S, log_every=LEARNED_LOG_EVERY,
        log=lambda msg: log(f"    {msg}"))
    last = losses[max(losses)]
    tokens = done * LEARNED_BATCH * (LEARNED_SEQ - 1)
    log(f"  [{card}] trained {done} steps in {secs:.1f} s: "
        f"{1e3 * secs / done:.2f} ms a step, {tokens / secs:.0f} training "
        f"tokens/s; loss {losses[0]:.4f} -> {last:.4f} (limit "
        f"{LEARNED_LOSS_MAX}; corpus floor ~0.79)")
    assert last < LEARNED_LOSS_MAX, f"learned model: loss {last}"
    profile_train_step(mcfg, params, device, card)
    return mcfg, params


def roundtrip_checkpoint(mcfg, params, device, card):
    """``save_params`` of the serving tree (bfloat16 matrices) into a
    temporary directory, ``load_params`` back onto the card: the config and
    every leaf equal. Returns the loaded (config, params)."""
    import dataclasses
    import tempfile
    import torch
    from lookaheaddecoding_tpu_torch.applications import train_synthetic
    from lookaheaddecoding_tpu_torch.utils import checkpoint

    cfg = dataclasses.replace(mcfg, dtype=torch.bfloat16)
    tree = train_synthetic.serving_params(params)
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save_params(d + "/learned", cfg, tree)
        nbytes = os.path.getsize(d + "/learned.npz")
        cfg2, tree2 = checkpoint.load_params(d + "/learned", device=device)
    assert cfg2 == cfg, (cfg2, cfg)

    def pairs(a, b, path=""):
        assert isinstance(b, dict) == isinstance(a, dict), path
        if isinstance(a, dict):
            assert set(a) == set(b), path
            return [p for k in a for p in pairs(a[k], b[k], f"{path}/{k}")]
        return [(path, a, b)]
    n = 0
    for path, a, b in pairs(tree, tree2):
        assert a.dtype == b.dtype and a.device == b.device, path
        assert torch.equal(a, b), path
        n += 1
    log(f"  [{card}] checkpoint: {n} leaves, {nbytes / 2**20:.1f} MiB, "
        f"saved and loaded back onto the card, every leaf equal")
    return cfg2, tree2


def divergence(eng, got, want, prompt_len):
    """bench.py's forensics: the first index where lookahead and AR
    differ, and the teacher-forced top-2 margin there (on the AR
    prefix), with the row's largest |logit|."""
    got, want = np.asarray(got), np.asarray(want)
    n = min(len(got), len(want))
    neq = np.nonzero(got[:n] != want[:n])[0]
    if len(neq) == 0:
        return None
    i = int(neq[0])
    row = teacher_forced_logits(eng, want[:i])[-1]
    top = row.topk(2).values
    return dict(index=i, new_token=i - prompt_len, lookahead=int(got[i]),
                ar=int(want[i]), margin=float(top[0] - top[1]),
                scale=float(row.abs().max()))


def serve_learned(name, mcfg, params, card, tmpdir):
    """autotune over LEARNED_CANDIDATES, measure_ar_baseline and
    save_tune_artifact (read back) on the learned model; then each
    candidate's tokens against generate_baseline's, with bench.py's
    forensics at a divergence (float32 must be exact or a near-tie).
    Returns (the kernels' counts of each candidate's autotune run, the AR
    engine, the prompt, the AR result)."""
    import torch
    import lookaheaddecoding_tpu_torch as lt
    from lookaheaddecoding_tpu_torch.applications import train_synthetic
    from lookaheaddecoding_tpu_torch.utils import tuning

    sampler = train_synthetic.make_markov_sampler(
        mcfg.vocab_size, order=LEARNED_ORDER, active_vocab=LEARNED_ACTIVE)
    prompt = sampler(1, LEARNED_PROMPT, np.random.RandomState(7))[0].tolist()
    ecfg = lt.EngineConfig(max_seq_len=MAX_SEQ, prefill_chunk=PREFILL_CHUNK)
    launches = {}

    def progress(cand, res):
        launches[cand] = read_counts()
        reset_counts()
    reset_counts()
    _, report = tuning.autotune(mcfg, params, prompt, LEARNED_NEW,
                                candidates=LEARNED_CANDIDATES,
                                engine_cfg=ecfg, progress=progress)
    assert len(report) == len(LEARNED_CANDIDATES), report
    ar = tuning.measure_ar_baseline(mcfg, params, prompt, LEARNED_NEW, ecfg)
    path = f"{tmpdir}/tune_{name}.json"
    art = tuning.save_tune_artifact(path, report, ar, model=name)
    with open(path) as f:
        assert json.load(f) == art
    by_cand = {(r.config.level, r.config.window_size,
                r.config.guess_set_size): r for r in report}

    ar_eng = build_learned_engine(mcfg, params, LEARNED_CANDIDATES[0])
    rb = ar_eng.generate_baseline(prompt, LEARNED_NEW)
    # the corpus's most likely successor of each context: the first of
    # make_markov_sampler's order-2 table (its seed 0 draws it first)
    succ0 = np.random.RandomState(0).randint(
        0, LEARNED_ACTIVE, size=(LEARNED_ACTIVE,) * 2 + (4,))[..., 0]

    def fidelity(toks, start):
        return float(np.mean([
            max(toks[t - 2], toks[t - 1]) < LEARNED_ACTIVE
            and toks[t] == succ0[toks[t - 2], toks[t - 1]]
            for t in range(start, len(toks))]))
    # the same inside the positions the model was trained on (< 128): a
    # 32-token prompt, 96 new tokens, the largest candidate
    short = prompt[:32]
    rs = ar_eng.generate_baseline(short, LEARNED_SEQ - 1 - len(short))
    big = build_learned_engine(mcfg, params, LEARNED_CANDIDATES[-1])
    ls = big.generate(short, LEARNED_SEQ - 1 - len(short))
    log(f"  [{card}] {name} AR tokens that are the corpus's most likely "
        f"successor of their context: {fidelity(rb.tokens, len(prompt)):.3f}"
        f" of the {LEARNED_NEW} new tokens at positions {len(prompt)}-"
        f"{len(rb.tokens) - 1}, past the {LEARNED_SEQ - 1} positions trained; "
        f"{fidelity(rs.tokens, len(short)):.3f} of {rs.num_generated} from "
        f"a {len(short)}-token prompt, inside them, where "
        f"L{LEARNED_CANDIDATES[-1][0]}/W{LEARNED_CANDIDATES[-1][1]}/"
        f"G{LEARNED_CANDIDATES[-1][2]} compresses {ls.compression_ratio:.3f}"
        f" (token_exact {bool(np.array_equal(ls.tokens, rs.tokens))})")
    design = "attention_mma" if mcfg.dtype == torch.bfloat16 \
        else "attention_fma"
    for cand in LEARNED_CANDIDATES:
        got = launches[cand]
        assert got[design] > 0 and got["plain"] == 0, (name, cand, got)
        eng = build_learned_engine(mcfg, params, cand)
        r = eng.generate(prompt, LEARNED_NEW)
        forensics = divergence(eng, r.tokens, rb.tokens, len(prompt))
        t = by_cand[cand]
        log(f"  [{card}] {name} L{cand[0]}/W{cand[1]}/G{cand[2]}: "
            f"{t.tokens_per_sec:.1f} tok/s (autotune median of 3), "
            f"compression {t.compression_ratio:.3f}, speedup over AR "
            f"{t.tokens_per_sec / ar:.3f}x, token_exact {forensics is None}, "
            f"wall/steps {1e3 * r.wall_time_s / r.steps:.2f} ms; B1 "
            f"launches ({design}) {got[design]}, plain {got['plain']}")
        if forensics is not None:
            f = forensics
            log(f"    first divergence at new token {f['new_token']}: "
                f"lookahead {f['lookahead']}, AR {f['ar']}; teacher-forced "
                f"top-2 margin {f['margin']:.4g} at a logit scale "
                f"{f['scale']:.4g} (float32 limit "
                f"{F32_TIE * f['scale']:.4g})")
            if mcfg.dtype == torch.float32:
                assert f["margin"] <= F32_TIE * f["scale"], (name, cand, f)
    log(f"  [{card}] {name} AR: {ar:.1f} tok/s (median of 3), wall/steps "
        f"{1e3 * rb.wall_time_s / rb.steps:.2f} ms; artifact {art['results']}")
    return launches, ar_eng, prompt, rb


def build_learned_engine(mcfg, params, cand):
    import lookaheaddecoding_tpu_torch as lt

    level, window, guess = cand
    eng = lt.LookaheadEngine(
        mcfg, params,
        lt.LookaheadConfig(level=level, window_size=window,
                           guess_set_size=guess, pool_from_prompt=True),
        lt.EngineConfig(max_seq_len=MAX_SEQ, prefill_chunk=PREFILL_CHUNK))
    assert eng.lcfg.attention_impl == "kernel", eng.lcfg.attention_impl
    return eng


def profile_learned(eng, ar_eng, prompt, card, tmpdir):
    """One lookahead and one AR request of PROFILE_NEW tokens through the
    port's ``utils.profiling.trace``, decoded by the host loop
    (``host_loop_call``: the profiler records no kernel inside the device
    loop's WHILE body): the trace file must exist and name the attention
    kernel; kernels a step, device busy (the sum of the kernels'
    durations) and idle against the wall a step of the same host-loop
    call unprofiled."""
    import glob
    from lookaheaddecoding_tpu_torch.utils import profiling

    for path, e, mode in (("lookahead", eng, "greedy"),
                          ("ar_baseline", ar_eng, "ar")):
        host_loop_call(e, prompt, mode, PROFILE_NEW)      # its step graph
        r0 = host_loop_call(e, prompt, mode, PROFILE_NEW)   # unprofiled
        d = f"{tmpdir}/trace_{path}"
        with profiling.trace(d):
            r = host_loop_call(e, prompt, mode, PROFILE_NEW)
        files = glob.glob(f"{d}/*.pt.trace.json")
        assert len(files) == 1, files
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        names = {e["name"] for e in kernels}
        assert any("attention_mma_kernel" in n for n in names), \
            sorted(names)[:20]
        busy = sum(e["dur"] for e in kernels) / 1e3 / r.steps
        att = sum(e["dur"] for e in kernels
                  if "attention" in e["name"]) / 1e3 / r.steps
        wall = 1e3 * r0.wall_time_s / r0.steps
        log(f"  [{card}] learned bf16 {path} (host loop) under profiling.trace "
            f"({os.path.getsize(files[0]) / 2**20:.1f} MiB trace, names "
            f"attention_mma_kernel): {r.steps} steps, "
            f"{len(kernels) / r.steps:.0f} kernels a step, device busy "
            f"{busy:.3f} ms a step (attention {att:.4f}), idle "
            f"{1 - busy / wall:.3f} of the unprofiled {wall:.2f} ms wall a "
            f"step")


def profile_train_step(mcfg, params, device, card):
    """The train step eager (``graphs.eager()``) and captured (a CUDA graph
    replayed, the arguments copied in and the results cloned out) on one
    batch already on the card: CHECK_STEPS steps each way from the same
    start, whose losses and parameters must be bit-equal (the same kernels
    in the same order) or, naming the kernels that only one way ran,
    within check_train_step's Adam limits; then ms a step (CUDA events, 10
    steps) and 3 steps under torch.profiler: kernels a step, device busy
    and idle, the largest kernels; and the captured step's copies in and
    out timed alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from lookaheaddecoding_tpu_torch.applications import train_synthetic
    from lookaheaddecoding_tpu_torch.core import graphs
    from lookaheaddecoding_tpu_torch.training import (init_opt_state,
                                                      make_train_step)
    from lookaheaddecoding_tpu_torch.training import train_step as ts

    sampler = train_synthetic.make_markov_sampler(
        mcfg.vocab_size, order=LEARNED_ORDER, active_vocab=LEARNED_ACTIVE)
    batch = torch.from_numpy(sampler(LEARNED_BATCH, LEARNED_SEQ,
                                     np.random.RandomState(2))).to(device)
    step = make_train_step(mcfg, LEARNED_SEQ + 1, learning_rate=LEARNED_LR)
    ends, names = {}, {}
    for which in ("eager", "captured"):
        with _mode("eager" if which == "eager" else "graphed"):
            p, opt, losses = params, init_opt_state(params), []
            for _ in range(CHECK_STEPS):
                p, opt, loss = step(p, opt, batch)
                losses.append(loss)
            ends[which] = (p, torch.stack(losses))
            ms = time_ms(lambda: step(p, opt, batch), reps=10, warm=0,
                         rounds=1)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    step(p, opt, batch)
                torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 3e3
        names[which] = set(by_name)
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        extra = ""
        if which == "captured":
            _, static = step.graphs[next(iter(step.graphs))]

            def copies():
                ts._copy_into(static["params"], p)
                ts._copy_into(static["opt"], opt)
                static["batch"].copy_(batch)
                ts._clone(static["params"])
                ts._clone(static["opt"])
            extra = (f"; of which the copies in and out alone "
                     f"{time_ms(copies, reps=10, warm=2, rounds=1):.2f} ms; "
                     f"graph keys {len(step.graphs)}")
        log(f"  [{card}] train step {which} on a batch already on the "
            f"card: {ms:.2f} ms a step (CUDA events, 10 steps); "
            f"{len(kernels) / 3:.0f} kernels a step, device busy "
            f"{busy:.2f} ms a step, idle {1 - busy / ms:.3f}{extra}; "
            f"largest: " + "; ".join(f"{v:.2f} ms {k[:60]}"
                                     for k, v in top))
    (pe, le), (pc, lc) = ends["eager"], ends["captured"]
    diff = torch.cat([(a.float() - b.float()).abs().flatten()
                      for a, b in zip(graphs.state_tensors(pc),
                                      graphs.state_tensors(pe))])
    worst = float(diff.max())
    same = torch.equal(le, lc) and worst == 0.0
    log(f"  [{card}] train step captured vs eager after {CHECK_STEPS} "
        f"steps from one start: losses {le.tolist()} / {lc.tolist()}, "
        f"worst |captured - eager| of the parameters {worst:.3g}: "
        + ("bit-equal" if same else
           f"not bit-equal; kernels only eager "
           f"{sorted(names['eager'] - names['captured'])[:4]}, only "
           f"captured {sorted(names['captured'] - names['eager'])[:4]}"))
    if not same:
        q999 = float(np.quantile(diff.cpu().numpy(), 0.999))
        loss_rel = float(((le - lc).abs() / le.abs()).max())
        assert loss_rel <= CHECK_LOSS_RTOL, loss_rel
        assert worst <= 2 * LEARNED_LR * CHECK_STEPS, worst
        assert q999 <= LEARNED_LR * 1e-3 * CHECK_STEPS, q999


def learned_model(device, card):
    """Phase 11: the train step card against CPU, training the learned
    model, its checkpoint, serving it in bf16 and float32, and a profile.
    Returns the B1 launches by dtype and candidate, and the bf16 model
    (config, params) for phase 13."""
    import tempfile
    import torch

    check_train_step(device, card)
    mcfg32, params32 = train_learned(device, card)
    cfg16, params16 = roundtrip_checkpoint(mcfg32, params32, device, card)
    launches = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        for name, cfg, params in (("learned_bf16", cfg16, params16),
                                  ("learned_float32", mcfg32, params32)):
            got, ar_eng, prompt, _ = serve_learned(name, cfg, params, card,
                                                   tmpdir)
            launches[name] = {f"autotune L{c[0]}/W{c[1]}/G{c[2]}": n
                              for c, n in got.items()}
            if name == "learned_bf16":
                eng = build_learned_engine(cfg, params, LEARNED_CANDIDATES[0])
                profile_learned(eng, ar_eng, prompt, card, tmpdir)
    del params32
    torch.cuda.empty_cache()
    return launches, (cfg16, params16)


# ---------------------------------------------------------------------------
# Phase 12: the parallel slice, two ranks on the one card over gloo
# ---------------------------------------------------------------------------

def parallel_rank(device, one_process, meshes=PAR_MESHES):
    """Phase 12 on one rank (``parallel/launch.py`` runs it on each): the
    headline model built whole from its seed, this rank's shard of it on
    each mesh of ``meshes`` ((name, mesh axes, phase-4 configuration)),
    ``generate`` and ``generate_baseline`` of
    PAR_NEW tokens after a warm-up of PAR_WARM. Each mesh: lookahead equal
    to AR, following the cycle and equal to ``one_process`` (phase 4's
    tokens of the same configuration, cut to PAR_NEW new ones); the
    attention kernel's tensor-core design launched, its FMA design and the
    plain versions never (``int8_weights_tp2``: B3's tensor-core design
    too). A mismatch raises with the teacher-forced top-2 margin there
    (every rank computes it: their tokens are the same). Returns each
    mesh's tokens, steps, ms a step, collectives a step and launches."""
    import torch
    import lookaheaddecoding_tpu_torch as lt
    from lookaheaddecoding_tpu_torch.core import graphs
    from lookaheaddecoding_tpu_torch.ops import quant_matmul as qm
    from lookaheaddecoding_tpu_torch.parallel import (collectives, make_mesh,
                                                      shard_params)

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    mcfg, params, prompt, nxt = synthetic.build_headline(device)
    trees = {"bf16": params}
    out = {"build_s": time.perf_counter() - t0}
    captured = graphs.stats["captured"]
    for name, kw, config in meshes:
        if config not in trees:
            trees[config] = lt.quantize_params(params, bits=8,
                                               quantize_lm_head=True,
                                               lm_head_bits=8)
        mesh = make_mesh(**kw, devices=device)
        eng = lt.LookaheadEngine(
            mcfg, shard_params(trees[config], mesh, mcfg),
            lt.LookaheadConfig(level=LEVEL, window_size=WINDOW,
                               guess_set_size=GUESS, pool_from_prompt=True),
            lt.EngineConfig(max_seq_len=MAX_SEQ, prefill_chunk=PREFILL_CHUNK,
                            **kw), mesh=mesh)
        eng.generate(prompt, PAR_WARM)
        eng.generate_baseline(prompt, PAR_WARM)
        runs, got = {}, {}
        for path, gen in (("lookahead", eng.generate),
                          ("ar_baseline", eng.generate_baseline)):
            reset_counts()
            collectives.counts.update(dict.fromkeys(collectives.counts, 0))
            torch.cuda.synchronize()
            runs[path] = r = gen(prompt, PAR_NEW)
            got[path] = dict(
                read_counts(), **{k: v for k, v in qm.counts.items()
                                  if k != "plain"},
                ms_step=1e3 * r.wall_time_s / r.steps, steps=r.steps,
                collectives_step=sum(collectives.counts.values()) / r.steps,
                collectives=dict(collectives.counts))
            assert got[path]["attention_mma"] > 0, (name, path, got[path])
            assert got[path]["attention_fma"] == got[path]["plain"] == 0, \
                (name, path, got[path])
            assert all(got[path][k] == 0 for k in qm.counts
                       if k.endswith("_fma")), (name, path, got[path])
            if config == "int8_weights":
                assert got[path]["int8_mma"] > 0, (name, path, got[path])
        r, rb = runs["lookahead"], runs["ar_baseline"]
        want = np.asarray(one_process[config][:len(prompt) + PAR_NEW])
        for label, a, b in (("lookahead vs AR", r.tokens, rb.tokens),
                            ("vs the one-process run", r.tokens, want)):
            bad = divergence(eng, a, b, len(prompt))
            if bad is not None or len(a) != len(b):
                raise AssertionError(f"{name} {label}: {bad}")
        fidelity = float(np.mean([r.tokens[i + 1] == nxt[r.tokens[i]]
                                  for i in range(len(prompt) - 1,
                                                 len(r.tokens) - 1)]))
        assert fidelity > 0.95, (name, fidelity)
        # generate_batch on the mesh: the paged step (B6), each lane equal
        # to this engine's lone generate
        prompts = [prompt, make_prompt(nxt, start=5, n=PROMPT_LEN // 2)]
        reset_counts()
        lanes = eng.generate_batch(prompts, PAR_BATCH_NEW)
        batch_launches = read_counts()
        assert batch_launches["paged_attention"] > 0, (name, batch_launches)
        assert batch_launches["plain"] == batch_launches["attention_fma"] \
            == 0, (name, batch_launches)
        for p, lane in zip(prompts, lanes):
            assert np.array_equal(lane.tokens, eng.generate(
                p, PAR_BATCH_NEW).tokens), (name, "generate_batch lane")
        out[name] = dict(tokens=r.tokens.tolist(), steps=r.steps,
                         compression=r.compression_ratio,
                         fidelity=fidelity, coords=mesh.coords,
                         batch_paged_launches=batch_launches[
                             "paged_attention"], **got)
        del eng
        torch.cuda.empty_cache()
    # a mesh with a gloo group steps eagerly: gloo cannot be captured
    out["captured"] = graphs.stats["captured"] - captured
    # phase 2 built every kernel; a rank loads them and builds none
    from lookaheaddecoding_tpu_torch.ops import _build
    out["rebuilt"] = [name for name, info in _build.build_info.items()
                      if info["log"] != "(cached)"]
    return out


def parallel_phase(card, tokens, step_s, meshes=PAR_MESHES):
    """Phase 12: PAR_RANKS ranks on the one card over gloo run
    ``parallel_rank``; every rank's tokens and steps must be equal, and
    every mesh must have stepped eagerly (no graph captured on a rank).
    Prints each mesh's ms a step beside the one-process step's (phase 4)
    and the collectives a step. Returns each mesh's launches by rank."""
    from lookaheaddecoding_tpu_torch.parallel.launch import launch

    backend = "gloo"
    one_process = {c: [int(t) for t in tokens[c]]
                   for c in {config for _, _, config in meshes}}
    ranks = launch(f"{os.path.abspath(__file__)}:parallel_rank", PAR_RANKS,
                   backend, "cuda", dict(one_process=one_process,
                                         meshes=[list(m) for m in meshes]),
                   timeout=PAR_TIMEOUT_S)
    log(f"  model built on each rank in "
        f"{', '.join(f'{r['build_s']:.1f}' for r in ranks)} s; kernels "
        f"rebuilt by a rank: {[r['rebuilt'] for r in ranks]}; graphs "
        f"captured by a rank: {[r['captured'] for r in ranks]} (gloo "
        f"meshes step eagerly)")
    assert not any(r["rebuilt"] for r in ranks), "a rank rebuilt a kernel"
    assert not any(r["captured"] for r in ranks), \
        "a gloo mesh captured a graph"
    launches = {}
    for name, kw, config in meshes:
        per = [r[name] for r in ranks]
        assert all(p["tokens"] == per[0]["tokens"] for p in per), name
        assert all(p[path]["steps"] == per[0][path]["steps"] for p in per
                   for path in ("lookahead", "ar_baseline")), name
        for path in ("lookahead", "ar_baseline"):
            log(f"  [{card}] {name} {path}: {per[0][path]['steps']} steps, "
                f"ms a step by rank "
                f"{', '.join(f'{p[path]['ms_step']:.2f}' for p in per)} "
                f"(one process, {config}: {1e3 * step_s[config][path]:.2f}; "
                f"{len(per)} ranks over {backend}: they share the card and "
                f"gloo crosses the host, not a tensor-parallel speed"
                f"), collectives a step "
                f"{per[0][path]['collectives_step']:.1f} "
                f"{per[0][path]['collectives']}, launches by rank (attention "
                f"mma, int8 mma) "
                f"{[(p[path]['attention_mma'], p[path]['int8_mma']) for p in per]}")
        log(f"  [{card}] {name}: compression {per[0]['compression']:.3f}, "
            f"fidelity {per[0]['fidelity']:.3f}, token-exact against AR and "
            f"the one-process {config} run, the same on every rank "
            f"(coords {[p['coords'] for p in per]}); a two-lane "
            f"generate_batch equal to the lone generate, paged kernel "
            f"launches by rank {[p['batch_paged_launches'] for p in per]}")
        launches[name] = [dict({path: {k: p[path][k] for k in (
            "attention_mma", "attention_fma", "plain", "int8_mma")}
            for path in ("lookahead", "ar_baseline")},
            batch_paged=p["batch_paged_launches"]) for p in per]
    return launches


# ---------------------------------------------------------------------------
# Phase 14: the mesh step captured, a one-rank NCCL world
# ---------------------------------------------------------------------------

def pool_hash(pool) -> str:
    """A hash of the pool's rows [0, R) and clock (its write-only trash row
    apart)."""
    import hashlib
    h = hashlib.sha256()
    for t in (pool.values[:-1], pool.age[:-1], pool.clock):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


# phase 14's WHILE node over collectives of the one-rank world group:
# iterations of a launch (the warm step, a real one, comes before the first)
COLLECTIVE_LOOP_ITERS = 12


def collective_loop(device):
    """One ``graphs.LoopGraph`` whose body calls ``collectives.all_reduce``,
    ``all_gather`` and ``broadcast`` on the world's NCCL group (a group of
    one rank, not None: ProcessGroupNCCL runs each collective inside the
    WHILE body) and adds their results into an accumulator, which sets the
    flag after COLLECTIVE_LOOP_ITERS iterations. Launched twice from a
    fresh state; each launch's iterations, its accumulator's largest
    difference from the plain version (the same loop on the host, where
    each collective of one rank returns its input) and the collectives the
    loop counted."""
    import torch
    import torch.distributed as dist
    from lookaheaddecoding_tpu_torch.core import graphs
    from lookaheaddecoding_tpu_torch.parallel import collectives

    group, n = dist.group.WORLD, COLLECTIVE_LOOP_ITERS
    x = torch.zeros(64, dtype=torch.float32, device=device)
    acc = torch.zeros_like(x)
    count = torch.zeros(1, dtype=torch.int32, device=device)
    finished = torch.zeros(1, dtype=torch.bool, device=device)
    cap = torch.tensor([4 * n], dtype=torch.int32, device=device)

    def body():
        acc.add_(collectives.all_reduce(x, group)
                 + collectives.all_gather(x, group)
                 + 2 * collectives.broadcast(x, 0, group))
        x.add_(1)
        count.add_(1)
        finished.copy_(count >= n)

    def reset():
        x.copy_(torch.arange(64, dtype=torch.float32, device=device))
        acc.zero_()
        count.zero_()
        finished.fill_(False)
    want = torch.zeros(64, dtype=torch.float32)
    for i in range(n):                  # the plain version
        want += 4 * (torch.arange(64, dtype=torch.float32) + i)
    loop = graphs.LoopGraph(body, {"x": x, "acc": acc, "count": count},
                            finished, cap, body_pool=torch.cuda.MemPool())
    out = []
    for _ in range(2):
        reset()
        before = dict(collectives.counts)
        loop.run()
        torch.cuda.synchronize()
        iters = int(loop.iters)
        loop.account(iters)
        # the first launch's warm step ran one iteration's body eagerly
        out.append(dict(iters=iters, steps=int(count),
                        err=float((acc.cpu() - want).abs().max()),
                        collectives={k: collectives.counts[k] - before[k]
                                     for k in before}))
    return out


def nccl_one_rank(device, one_process, t_star=None):
    """Phase 14 on its one rank: the headline engine on ``make_mesh(tp=1)``
    (the world's NCCL group; no axis has a group, so no collective runs)
    and one without a mesh: ``generate``, ``generate_baseline``,
    ``generate_sample`` at ``t_star`` (T*; computed here when None) and a
    two-lane ``generate_batch``, each way on the mesh engine (eager,
    graphed: on the device loop) and graphed on the other, then the
    graphed mesh call once more with its reads counted and no host sync
    allowed before the first (``one_read``); and :func:`collective_loop`.
    Returns each run's tokens, steps, pool hash (greedy) and
    ``graphs.stats`` of the call and its warm-up, and whether the graphed
    greedy tokens are ``one_process``'s (when given)."""
    import torch
    import torch.distributed as dist
    import lookaheaddecoding_tpu_torch as lt
    from lookaheaddecoding_tpu_torch.core import graphs
    from lookaheaddecoding_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mcfg, params, prompt, nxt = synthetic.build_headline(device)
    plain = build_engine(mcfg, params)
    engines = {"mesh": lt.LookaheadEngine(mcfg, params, plain.lcfg,
                                          plain.ecfg,
                                          mesh=make_mesh(tp=1,
                                                         devices=device)),
               "no_mesh": plain}
    if t_star is None:
        t_star = cycle_temperature(plain, prompt)[0]
    sc = lt.SamplingConfig(temperature=t_star, top_k=TOP_K)
    second = make_prompt(nxt, start=5, n=PROMPT_LEN // 2)
    out = {"backend": dist.get_backend(), "graphed_engine": {
        k: e._graphed for k, e in engines.items()}}
    for name, which in (("mesh", "eager"), ("mesh", "graphed"),
                        ("no_mesh", "graphed")):
        eng = engines[name]
        paths = {"lookahead": lambda n: [eng.generate(
                     prompt, n, return_prefix=True)],
                 "ar_baseline": lambda n: [eng.generate_baseline(prompt, n)],
                 "sample": lambda n: [eng.generate_sample(prompt, n, sc,
                                                          seed=0)],
                 "batch": lambda n: eng.generate_batch(
                     [prompt, second], min(n, PAR_BATCH_NEW))}
        for path, gen in paths.items():
            with _mode(which):
                graphs.reset_stats()
                gen(PAR_WARM)
                warm = graphs.read_stats()
                graphs.reset_stats()
                res = gen(PAR_NEW)
                torch.cuda.synchronize()
                got = graphs.read_stats()
            rec = dict(tokens=[r.tokens.tolist() for r in res],
                       steps=[r.steps for r in res],
                       ms_step=1e3 * res[0].wall_time_s / max(
                           r.steps for r in res), warm=warm, call=got)
            if path == "lookahead":
                rec["pool"] = pool_hash(res[0].prefix.pool)
            if (name, which) == ("mesh", "graphed"):
                again, rec["reads"] = one_read(lambda: gen(PAR_NEW))
                rec["again_tokens"] = [r.tokens.tolist() for r in again]
            out[f"{name} {which} {path}"] = rec
    if one_process is not None:
        out["one_process"] = one_process[:len(prompt) + PAR_NEW] == \
            out["mesh graphed lookahead"]["tokens"][0]
    out["collective_loop"] = collective_loop(device)
    out["t_star"] = t_star
    return out


PHASE14_PATHS = ("lookahead", "ar_baseline", "sample", "batch")


def nccl_phase(card, tokens=None, t_star=None):
    """Phase 14: ``nccl_one_rank`` in a one-rank NCCL world. The mesh
    engine captures its steps and runs every decode loop on the device: its
    graphed and eager runs and the no-mesh engine's give the same tokens,
    steps and pool rows, and phase 4's tokens (``tokens``, when given); a
    graphed call launches one loop whose iterations are its steps and
    reads the card once, with no host sync before. The WHILE node over
    the world group's collectives runs its iterations with the plain
    version's result on each launch."""
    from lookaheaddecoding_tpu_torch.parallel.launch import launch

    one = None if tokens is None else [int(t) for t in tokens["bf16"]]
    r, = launch(f"{os.path.abspath(__file__)}:nccl_one_rank", 1, "nccl",
                "cuda", dict(one_process=one, t_star=t_star),
                timeout=PAR_TIMEOUT_S)
    assert r["backend"] == "nccl", r["backend"]
    assert r["graphed_engine"] == {"mesh": True, "no_mesh": True}, r
    for path in PHASE14_PATHS:
        eager, graphed, plain = (r[f"{k} {path}"] for k in (
            "mesh eager", "mesh graphed", "no_mesh graphed"))
        for key in ("tokens", "steps") + (("pool",) if path == "lookahead"
                                          else ()):
            assert graphed[key] == eager[key] == plain[key], (path, key)
        steps = max(graphed["steps"])
        assert eager["warm"]["captured"] == eager["call"]["captured"] == 0
        assert eager["call"]["replays"] == eager["call"]["loops"] == 0, (
            path, eager)
        assert graphed["warm"]["captured"] > 0, (path, graphed)
        assert graphed["call"]["captured"] == 0, (path, graphed)
        # the device loop: one launch, an iteration a step
        assert graphed["call"]["loops"] == plain["call"]["loops"] == 1, (
            path, graphed, plain)
        assert graphed["call"]["replays"] == steps, (path, graphed)
        assert graphed["reads"] == 1, (path, graphed["reads"])
        assert graphed["again_tokens"] == graphed["tokens"], path
        # each prompt's chunks replays of the slot's captured chunk
        lens = (PROMPT_LEN, PROMPT_LEN // 2) if path == "batch" else (
            PROMPT_LEN,)
        assert eager["call"]["prefills"] == 0, (path, eager)
        assert graphed["call"]["prefills"] == sum(
            -(-(n - 1) // PREFILL_CHUNK) for n in lens), (path, graphed)
        assert graphed["call"]["branches"] == eager["call"]["branches"]
        assert graphed["call"]["taken"] == eager["call"]["taken"]
        log(f"  [{card}] mesh engine (tp=1, one NCCL rank) {path}: "
            f"{graphed['steps']} steps; graphs captured at the warm-up "
            f"{graphed['warm']['captured']}; "
            f"{loop_line(graphed['call'], steps, graphed['reads'])}; "
            f"prefill chunks replayed {graphed['call']['prefills']}; "
            f"tokens, steps{', pool rows' if path == 'lookahead' else ''} "
            f"and branches ({graphed['call']['branches']}, chains taken "
            f"{graphed['call']['taken']}) equal to its eager run and the "
            f"no-mesh engine's; the call's wall over its steps, ms: "
            f"graphed {graphed['ms_step']:.3f}, eager "
            f"{eager['ms_step']:.3f}, no mesh {plain['ms_step']:.3f}")
    if one is not None:
        assert r["one_process"], \
            "the mesh engine's tokens differ from phase 4's"
    first, second = r["collective_loop"]
    n = COLLECTIVE_LOOP_ITERS
    # the first launch follows the warm step (a real iteration)
    assert (first["iters"], first["steps"]) == (n - 1, n), first
    assert (second["iters"], second["steps"]) == (n, n), second
    kinds = ("all_reduce", "all_gather", "broadcast")
    for got, warm in ((first, 1), (second, 0)):
        assert got["err"] == 0.0, got
        # a call an iteration, and the warm step's
        assert all(got["collectives"][k] == got["iters"] + warm
                   for k in kinds), got
    log(f"  [{card}] WHILE node over the world group's NCCL collectives "
        f"(all_reduce, all_gather, broadcast on one rank): "
        f"{first['iters']} iterations after the warm step, then "
        f"{second['iters']}, each launch's result == the plain version's "
        f"(max abs err {max(first['err'], second['err'])}); collectives "
        f"counted {second['collectives']}")


# ---------------------------------------------------------------------------
# Phase 13: the captured step
# ---------------------------------------------------------------------------

CAPTURE_STEPS = 24    # decode steps of a timed window of the step alone
BATCH_LANES = 4       # phase 13's greedy generate_batch
EOS_AT = 100          # the new position of phase 13's EOS id
EOS_AT_SAMPLE = 40    # ... of its sampling call's (a step a token at T*)
CAPTURE_PROFILED = 6  # of a profiled one
# steps profiled first in a fresh state: fewer than the headline's N-2 = 5
# steps whose window lanes are not yet harvested, so they take the parallel
# insert unless the prompt's own n-grams share a key
CAPTURE_FIRST = 3
CAPTURE_BUDGET = 100_000   # max_new of those windows: no step ends them
REQUEST_REPS = 3      # timed calls a way of each request-graph case
# phase 13's prefix and batch request graphs: the precomputed prefix's
# length, the new tokens of all but the headline prefix call, and the new
# message of the second conversation turn
PREFIX_LEN, N_PREFIX_NEW, TURN_LEN = 48, 64, 24
PREFILL_REPS = 3      # prefills of each way's timed window of the prefill
PREFILL_PROFILED = ("bf16",)   # configurations whose graphed prefill is
                               # profiled (each profiler run costs seconds)
# phase 13's long prompt: the headline model at M=2048 (B2), 12 chunks
LONG_PROMPT, LONG_SEQ, LONG_NEW = 1536, 2048, 128
# phase 13's paged admissions: their budget, the long prompt (6 chunks
# across 6 pages), the precomputed prefix (it ends inside its second page)
# and the requests live on the other lanes meanwhile
ADMIT_NEW, ADMIT_LONG, ADMIT_PREFIX, ADMIT_LIVE = 64, 700, 200, LANES - 1


def profile_steps(run, n):
    """(kernels a step, device busy ms a step, wall ms a step under the
    profiler) of ``run(n)``, n decode steps; None if the profiler records
    no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return len(kernels) / n, busy_ms / n, wall_ms / n


def timed_steps(run, n):
    """Wall ms a step of ``run(n)``, from a synchronised host clock."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(n)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def _mode(which):
    """``graphs.eager()`` for "eager", a null context for "graphed"."""
    import contextlib
    from lookaheaddecoding_tpu_torch.core import graphs
    return graphs.eager() if which == "eager" else contextlib.nullcontext()


def flat_step_run(eng, prompt, mode, sampling=None):
    """``make_run`` of :func:`step_windows` for the flat step of ``mode``
    ("greedy", "ar" or "sample") on ``eng``: each call prefills ``prompt``
    into a free slot with a budget no window reaches, and gives that live
    state's ``run(n)``, n decode steps."""
    import torch

    def make_run():
        with torch.inference_mode():
            slot = eng._free_slot()
            out_buf, n, fill = eng._host_args(prompt, CAPTURE_BUDGET)
            eng._prepare(out_buf, n, 0, fill, slot=slot)
            steps = eng._flat_runner(slot, mode, CAPTURE_BUDGET, None,
                                     sampling)

        def run(k):
            with torch.inference_mode():
                steps.run(k)
        return run
    return make_run


def step_windows(make_run, n_timed, n_prof, done=lambda: None, n_first=0,
                 profiler=None):
    """The decode step alone, eager and graphed in turns (eager, graphed,
    graphed, eager, then one profiled pass each): ``make_run()`` gives a
    fresh live state's ``run(n)``, whose first use captures when graphed;
    ``done()`` follows each window. A profiled pass profiles the first
    ``n_first`` steps of its state (if any), runs 2, and profiles
    ``n_prof``. Returns {"eager"|"graphed": (ms a step of the two timed
    windows, [(the profiler's numbers, (IF bodies run, branches
    evaluated)) of each profiled window])}; ``profiler(run, n)`` is
    :func:`profile_steps` by default."""
    from lookaheaddecoding_tpu_torch.core import graphs

    def profiled(run, n):
        graphs.reset_stats()
        prof = (profiler or profile_steps)(run, n)
        got = graphs.read_stats()
        return prof, (got["taken"], got["branches"])

    walls, prof = {"eager": [], "graphed": []}, {}
    for which in ("eager", "graphed", "graphed", "eager", "eager",
                  "graphed"):
        with _mode(which):
            run = make_run()
            if len(walls[which]) < 2:
                run(2)
                walls[which].append(timed_steps(run, n_timed))
            else:
                prof[which] = [profiled(run, n_first)] if n_first else []
                run(2)
                prof[which].append(profiled(run, n_prof))
        done()
    return {which: (walls[which], prof[which]) for which in walls}


def share(taken, branches):
    """'t of b (share)' of IF bodies run over branches evaluated."""
    if not branches:
        return "no branch (no pool)"
    return f"{taken} of {branches} ({taken / branches:.3f})"


def capture_line(name, card, windows, per_replay, tok_s, peak, stats):
    """The phase's report of one configuration."""
    parts = []
    for mode in ("eager", "graphed"):
        walls, profs = windows[mode]
        wall = min(walls)
        line = (f"{mode} {walls[0]:.3f}/{walls[1]:.3f} ms a step, "
                f"{tok_s[mode]:.1f} tok/s, peak {peak[mode]:.0f} MiB")
        for i, (prof, branch) in enumerate(profs):
            which = ("the first steps of a state" if i < len(profs) - 1
                     else "later steps")
            if prof is None:
                line += (f"; {which}: device time not measured (no kernel "
                         f"recorded)")
                continue
            kernels, busy, pwall = prof
            line += (f"; {which}: {kernels:.0f} kernels a step, device busy "
                     f"{busy:.3f} ms a step, idle {1 - busy / wall:.3f} "
                     f"(profiled wall {pwall:.3f} ms a step), the chain's "
                     f"IF body in {share(*branch)} steps")
        parts.append(line)
    ratio = min(windows["eager"][0]) / min(windows["graphed"][0])
    log(f"  [{card}] {name}: tokens == eager; graphs captured "
        f"{stats['captured']}, replays {stats['replays']}, launches of the "
        f"port's kernels a replay {per_replay}; the pool's chain (an IF "
        f"node graphed) ran in {share(stats['taken'], stats['branches'])} "
        f"steps of the call, as eagerly; " + " | ".join(parts)
        + f"; eager / graphed wall a step {ratio:.2f}x")
    return windows


def same_branches(name, branch):
    """The eager and the graphed call evaluated the same branches and took
    the same chains (each step's predicate is the same)."""
    e, g = branch["eager"], branch["graphed"]
    assert (e["branches"], e["taken"]) == (g["branches"], g["taken"]), \
        (name, e, g)


def prefill_chunks(eng, prompt_len, start0=0):
    """Chunks of ``eng``'s prefill of a prompt past ``start0``."""
    return -(-max(prompt_len - 1 - start0, 0) // eng.ecfg.prefill_chunk)


def while_launches(stats, lanes=0):
    """The WHILE condition kernel's launches of calls whose every loop is
    on the device and whose every prefill a request or prepare graph's
    (``graphs.stats`` of the calls): one before each loop and one an
    iteration, decode (``loops``, ``replays``) and prefill (``requests``,
    ``prefills``); a batch request graph's lane loop over ``lanes`` lanes
    adds one before it and one a lane, and its prefill node's one before
    it runs once a lane."""
    return (stats["loops"] + stats["replays"] + stats["requests"]
            + stats["prefills"] + 2 * lanes)


def prepared_slot(eng, prompt, n_new):
    """A free slot of ``eng`` after ``_prepare`` of ``prompt``, and clones of
    every tensor of its state (caches, ``kv_len``, window, pool, output
    buffer, counters)."""
    import torch
    from lookaheaddecoding_tpu_torch.core import graphs
    with torch.inference_mode():
        slot = eng._free_slot()
        out_buf, n, fill = eng._host_args(prompt, n_new)
        eng._prepare(out_buf, n, 0, fill, slot=slot)
        return slot, [t.clone() for t in graphs.state_tensors(slot.state)]


def prefills(eng, slot, prompt, n):
    """``n`` prefills of ``prompt`` on ``slot``, prepared for it (each
    rewrites the same rows)."""
    import torch
    with torch.inference_mode():
        for _ in range(n):
            eng._prefill(slot, len(prompt), 0)


def prefill_ms(eng, slot, prompt):
    """ms a chunk of PREFILL_REPS prefills of ``prompt`` on ``slot`` in a
    row."""
    return (timed_steps(lambda n: prefills(eng, slot, prompt, n),
                        PREFILL_REPS) / prefill_chunks(eng, len(prompt)))


def captured_prefill(name, eng, prompt, card, n_new):
    """The request's preparation, eager and graphed on one engine whose
    graphs the calls before captured: the slot after ``_prepare`` bit-equal
    both ways (caches, ``kv_len``, pool, window, output buffer, counters);
    graphed, one launch of the slot's prepare graph whose prefill WHILE
    node ran an iteration a chunk (``stats["prefills"]``, nothing
    captured), the attention launching one a layer and chunk (B1, or B2
    past 1024 slots: causal), no plain version; then ms a chunk of the
    host-counted prefill (``fused=False``'s, a mesh's and eager calls'
    way: the slot's captured chunk replayed, or eager chunks). The request as a whole, graphed against
    today's path, is :func:`request_case`'s. Returns {"chunk_ms",
    "per_replay"}."""
    import torch
    from lookaheaddecoding_tpu_torch.core import graphs

    k = prefill_chunks(eng, len(prompt))
    snaps, stats, got, chunk_ms = {}, {}, {}, {}
    profiled, prof = name in PREFILL_PROFILED, None
    for which in ("eager", "graphed"):
        with _mode(which):
            prepared_slot(eng, prompt, n_new)
            torch.cuda.synchronize()
            reset_counts()
            graphs.reset_stats()
            slot, snaps[which] = prepared_slot(eng, prompt, n_new)
            torch.cuda.synchronize()
            stats[which], got[which] = graphs.read_stats(), read_counts()
            prefills(eng, slot, prompt, 1)      # captures the chunk graph
            chunk_ms[which] = prefill_ms(eng, slot, prompt)
            if which == "graphed" and profiled:
                prof = profile_steps(
                    lambda n: prefills(eng, slot, prompt, n), 1)
    assert all(torch.equal(a, b) for a, b in zip(snaps["eager"],
                                                  snaps["graphed"])), \
        f"{name}: the slot after the graphed prefill differs from eager"
    e, g = stats["eager"], stats["graphed"]
    assert e["prefills"] == e["captured"] == 0, (name, e)
    assert g["prefills"] == k and g["captured"] == 0, (name, k, g)
    assert g["requests"] == 1 and e["requests"] == 0, (name, e, g)
    launches = k * eng.mcfg.num_hidden_layers
    assert got["graphed"]["attention_mma"] == launches \
        == got["eager"]["attention_mma"], (name, launches, got)
    for which in got:
        assert got[which]["plain"] == got[which]["attention_fma"] == 0, \
            (name, which, got)
    per_replay = next(graph for key, graph in eng._free_slot().graphs.items()
                      if key[0] == "prefill").launches_per_replay()
    log(f"  [{card}] {name} prefill ({len(prompt)}-token prompt, {k} "
        f"chunk{'s' if k > 1 else ''} of {eng.ecfg.prefill_chunk}): the "
        f"slot after it bit-equal eager and graphed; graphed one launch of "
        f"the prepare graph, {g['prefills']} prefill iterations; the "
        f"host-counted prefill's chunk graph, launches a replay "
        f"{per_replay}; ms a chunk eager {chunk_ms['eager']:.3f}, graphed "
        f"{chunk_ms['graphed']:.3f} ({chunk_ms['eager'] / chunk_ms['graphed']:.1f}"
        f"x)" + (f"; a graphed chunk under the profiler: "
                 f"{profile_line(prof, chunk_ms, k)}" if profiled else ""))
    return dict(chunk_ms=chunk_ms, per_replay=per_replay, profile=prof)


def profile_line(prof, chunk_ms, k):
    """Kernels, device busy and idle a chunk of the graphed prefill, from
    ``profile_steps`` of one whole prefill of ``k`` chunks."""
    if prof is None:
        return "device time not measured (no kernel recorded)"
    kernels, busy, _ = prof
    return (f"{kernels / k:.0f} kernels, device busy {busy / k:.3f} ms, "
            f"idle {1 - busy / k / chunk_ms['graphed']:.3f}")


def one_read(call):
    """(``call()``, its reads back from the card) with the host's waits for
    the card refused (``torch.cuda.set_sync_debug_mode("error")``) from the
    call's start to its first read back (``graphs.fetch``), which ends the
    check."""
    import torch
    from lookaheaddecoding_tpu_torch.core import graphs
    fetch, reads = graphs.fetch, []

    def read(tensor):
        reads.append(1)
        torch.cuda.set_sync_debug_mode("default")
        return fetch(tensor)
    torch.cuda.synchronize()
    graphs.fetch = read
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        graphs.fetch = fetch
    return out, len(reads)


def loop_iteration(eng, prompt, mode, n_new, sampling=None, eos=None):
    """(device ms an iteration, iterations) of one launch of the slot's
    device loop over ``prompt`` prepared for ``n_new`` tokens (seed 0): CUDA
    events around the launch, the card's time for the whole loop over its
    iterations. A call by today's path first captures the loop's graph
    (a request graph holds its own loop, so the calls before may not
    have)."""
    import torch
    eng._run(mode, prompt, n_new, eos, 0, sampling=sampling, fused=False)
    with torch.inference_mode():
        slot = eng._free_slot()
        out_buf, n, fill = eng._host_args(prompt, n_new)
        eng._prepare(out_buf, n, 0, fill, slot=slot)
        loop = eng._flat_loop(slot, mode, n_new, eos, sampling)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loop.run()
        end.record()
        end.synchronize()
        iters = int(loop.iters)
        loop.account(iters)
    return start.elapsed_time(end) / iters, iters


def pool_mib(pool):
    """MiB the segments of a ``torch.cuda.MemPool`` hold, or None where
    this PyTorch has no snapshot of one pool."""
    try:
        return sum(seg["total_size"] for seg in pool.snapshot()) / 2**20
    except (AttributeError, TypeError, RuntimeError):
        return None


def loop_line(stats, steps, reads):
    """The device loop's account of one graphed call."""
    return (f"the decode loop on the device: {stats['loops']} launch, "
            f"{stats['replays']} iterations for {steps} steps, {reads} read "
            f"back a call and no host sync before it")


def captured_flat(name, eng, prompt, mode, card, n_new, sampling=None,
                  alone=True, return_prefix=True):
    """One flat configuration's captured step against its eager step on the
    same engine: the generate call of ``mode`` ("greedy", "ar" or
    "sample") eager and graphed (tokens and steps equal, greedy's pool
    tables' rows [0, R) and clock bit-equal: those of the prefix the call
    returns with ``return_prefix`` (the graphed copy into it included),
    else of the call's slot; the same branches evaluated and chains
    taken, tok/s, peak memory; the graphed call counted alone:
    replays > 0, a prefill replay a chunk, and the kernels' launches),
    then its preparation (``captured_prefill``), the call's wall over its
    steps, and, with ``alone``, the step alone in windows and under the
    profiler beside it. Returns the graphed call's branch counts and the
    graphed windows' profiles (None without ``alone``)."""
    import torch
    from lookaheaddecoding_tpu_torch.core import graphs

    call = {"greedy": lambda: eng.generate(prompt, n_new,
                                           return_prefix=return_prefix),
            "ar": lambda: eng.generate_baseline(prompt, n_new),
            "sample": lambda: eng.generate_sample(prompt, n_new, sampling,
                                                  seed=0)}[mode]
    runs, peak, tok_s, branch, pools, draws = {}, {}, {}, {}, {}, {}
    for which in ("eager", "graphed"):
        with _mode(which):
            call()                                   # warm (captures)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if which == "graphed":
                reset_counts()
            graphs.reset_stats()
            runs[which] = call()
            torch.cuda.synchronize()
            branch[which] = graphs.read_stats()
            pool = (runs[which].prefix.pool
                    if mode == "greedy" and return_prefix
                    else eng._free_slot().state.pool)    # the call's slot
            pools[which] = [t.clone() for t in (pool.values[:-1],
                                                pool.age[:-1], pool.clock)]
            draws[which] = int(eng._free_slot().state.draws)
        peak[which] = torch.cuda.max_memory_allocated() / 2**20
        tok_s[which] = runs[which].tokens_per_sec
    got, stats = read_counts(), branch["graphed"]
    assert np.array_equal(runs["graphed"].tokens, runs["eager"].tokens), \
        f"{name}: the graphed step's tokens differ from the eager step's"
    assert runs["graphed"].steps == runs["eager"].steps, name
    assert draws["graphed"] == draws["eager"], (name, draws)
    if mode != "ar":
        for field, a, b in zip(("values", "age", "clock"), pools["eager"],
                               pools["graphed"]):
            assert torch.equal(a, b), f"{name}: pool {field} rows differ"
    assert stats["prefills"] == prefill_chunks(eng, len(prompt)), (name,
                                                                   stats)
    same_branches(name, branch)
    assert stats["replays"] > 0 and got["attention_mma"] > 0, (name, stats,
                                                               got)
    assert got["plain"] == 0 and got["attention_fma"] == 0, (name, got)
    # one condition kernel a replay's IF node, one IF node a branch
    assert got["set_if"] == stats["branches"], (name, got, stats)
    # greedy, sampling and AR calls are one request graph: one launch, a
    # decode iteration a step (no step past the one that finished), a
    # prefill iteration a chunk, one read back
    steps = runs["graphed"].steps
    assert stats["loops"] == stats["requests"] == 1 and \
        stats["replays"] == steps, (name, stats)
    assert got["set_while"] == while_launches(stats), (name, got, stats)
    if mode == "sample":     # a draw a step, and the window's seeding
        assert got["philox"] == steps + 1 == draws["graphed"] + 1, (name,
                                                                    got)
    again, reads = one_read(call)
    assert reads == 1 and np.array_equal(again.tokens,
                                         runs["graphed"].tokens), name
    loop_ms, iters = loop_iteration(eng, prompt, mode, n_new, sampling)
    held = pool_mib(eng._loop_pool)
    loop = (f"{loop_line(stats, steps, reads)}; in the loop "
            f"{loop_ms:.3f} ms an iteration (CUDA events, {iters} "
            f"iterations); the loop bodies' MemPool holds "
            + ("not measured" if held is None else f"{held:.1f} MiB"))
    with torch.inference_mode():     # the graph that call replayed
        per_replay = eng._flat_runner(eng._free_slot(), mode, n_new, None,
                                      sampling).launches_per_replay()
    prefill = captured_prefill(name, eng, prompt, card, n_new)
    call_ms = {w: 1e3 * runs[w].wall_time_s / runs[w].steps for w in runs}
    if not alone:
        log(f"  [{card}] {name}: tokens == eager, {runs['graphed'].steps} "
            f"steps; the call's wall over its steps, ms: graphed "
            f"{call_ms['graphed']:.3f}, eager {call_ms['eager']:.3f}; "
            f"{tok_s['graphed']:.1f} / {tok_s['eager']:.1f} tok/s; {loop}; "
            f"peak {peak['graphed']:.0f} MiB graphed, {peak['eager']:.0f} "
            f"eager")
        return (stats["taken"], stats["branches"]), None
    windows = step_windows(flat_step_run(eng, prompt, mode, sampling),
                           CAPTURE_STEPS, CAPTURE_PROFILED,
                           n_first=CAPTURE_FIRST)
    capture_line(name, card, windows, per_replay, tok_s, peak, stats)
    log(f"  [{card}] {name}: the call's wall over its steps, graphed "
        f"{call_ms['graphed']:.3f} ms ({runs['graphed'].steps} steps, its "
        f"prefill {prefill['chunk_ms']['graphed']:.3f} ms a chunk) against "
        f"the step alone {min(windows['graphed'][0]):.3f}; eager "
        f"{call_ms['eager']:.3f} against {min(windows['eager'][0]):.3f}; "
        f"{loop}")
    return (stats["taken"], stats["branches"]), windows["graphed"][1]


def captured_paged(name, srv, nxt, card):
    """``PagedServingEngine``'s captured batched step against its eager
    step on the same engine: four requests eager and graphed (every result
    equal), then the step alone with four lanes live."""
    import torch
    import lookaheaddecoding_tpu_torch as lt
    from lookaheaddecoding_tpu_torch.core import graphs

    def reqs():
        return [lt.Request(prompt=make_prompt(nxt, start=30 + i, n=64),
                           max_new_tokens=PAGED_NEW, request_id=i)
                for i in range(LANES)]
    res, peak, tok_s, branch = {}, {}, {}, {}
    for which in ("eager", "graphed"):
        with _mode(which):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if which == "graphed":
                reset_counts()
            graphs.reset_stats()
            t0 = time.perf_counter()
            out = srv.run(reqs())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            branch[which] = graphs.read_stats()
        res[which] = {r.request_id: r.tokens for r in out}
        peak[which] = torch.cuda.max_memory_allocated() / 2**20
        tok_s[which] = sum(len(t) - 64 for t in res[which].values()) / wall
    got, stats = read_counts(), branch["graphed"]
    for rid, toks in res["eager"].items():
        assert np.array_equal(res["graphed"][rid], toks), \
            f"{name}: request {rid}'s graphed tokens differ from eager"
    same_branches(name, branch)
    assert stats["replays"] > 0 and got["paged_attention"] > 0, (stats, got)
    assert got["set_if"] == stats["branches"] > 0, (name, got, stats)
    assert srv.pages_free == N_PAGES, srv.memory_stats()
    per_replay = srv._runner().launches_per_replay()

    def make_run():
        for r in reqs():
            srv.submit(r)
        srv.step()                 # admission and the first steps
        runner = srv._runner()

        def run(k):
            with torch.inference_mode():
                runner.run(k)
        return run

    def drain():
        while srv.step():
            pass
        srv._results = []
    # four lanes stay live through the windows: 4 + 2 + 8 steps of at most
    # 6 tokens each, below PAGED_NEW
    windows = step_windows(make_run, 8, 4, drain)
    assert srv.pages_free == N_PAGES, srv.memory_stats()
    capture_line(name, card, windows, per_replay, tok_s, peak, stats)
    return (stats["taken"], stats["branches"]), windows["graphed"][1]


def admit_lane(srv, req):
    """``req`` admitted by ``srv._admit`` onto the first free lane, which is
    returned."""
    import torch
    lane = min(set(range(srv.num_lanes)) - set(srv._meta))
    srv.submit(req)
    with torch.inference_mode():
        srv._admit()
    assert lane in srv._meta and srv._meta[lane]["req"] is req, \
        (f"the request was not admitted onto lane {lane}", srv.memory_stats())
    return lane


def evict_lane(srv, lane):
    """Undo lane ``lane``'s admission: its pages back to the allocator in the
    reverse order of their allocation (so the next admission gets the same
    pages) and the lane idle."""
    meta = srv._meta.pop(lane)
    srv.alloc.release(list(reversed(meta["shared"] + meta["priv"])))
    srv._idle(lane)


def admitted_lane(srv, lane):
    """Clones of lane ``lane``'s row (table, capacity, trash slot, kv_len,
    window, output buffer, counters, the pool's rows [0, R) and clock, its
    budget and EOS ids) and of the K/V of every data page in its table."""
    import torch
    from lookaheaddecoding_tpu_torch.core import graphs
    st = srv._states
    out = [t[lane].clone() for t in (
        st.table, st.cap, st.trash, st.kv_len, st.window, st.out_buf,
        st.n_confirmed, st.init_len, st.step_idx, st.finished, st.pool.clock,
        srv._max_new, srv._eos)]
    out += [st.pool.values[lane, :-1].clone(), st.pool.age[lane, :-1].clone()]
    pages = sorted(set(st.table[lane].tolist()) - {lane})
    idx = (torch.tensor(pages)[:, None] * PAGE
           + torch.arange(PAGE)).reshape(-1).to(st.table.device)
    return out + [t.index_select(2, idx) for t in graphs.state_tensors(
        (srv._k_pool, srv._v_pool))]


def admission_to_first_step(srv, req, no_sync):
    """(ms until the host has queued the first batched step, ms until the
    card has run it) from admission: ``_admit`` of ``req`` and one batched
    step of every lane; then the lane is evicted. With ``no_sync`` the host
    must not wait for the card on the way: the calls run under
    ``torch.cuda.set_sync_debug_mode("error")``, so a sync raises."""
    import torch
    torch.cuda.synchronize()
    if no_sync:
        torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            t0 = time.perf_counter()
            lane = admit_lane(srv, req)
            srv._runner().run(1)
            queued = time.perf_counter()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    done = time.perf_counter()
    evict_lane(srv, lane)
    return 1e3 * (queued - t0), 1e3 * (done - t0)


def captured_admission(name, srv, nxt, card):
    """``PagedServingEngine``'s admission (JAX's ``_get_prepare``: lane
    init, pool fill, the prefill fori_loop and the insertion), eager and
    graphed on one warm engine, for a 64-token prompt, an ADMIT_LONG-token
    one (6 chunks across 6 pages), a request on an ADMIT_PREFIX-token
    ``precompute_prefix`` (its tail page copied on write) and a turn on a
    ``return_prefix`` result (its warm pool carried), each admitted while
    ADMIT_LIVE other lanes are live: the lane's row and its data pages
    bit-equal both ways; graphed, a replay of the engine's captured chunk a
    chunk (``stats["prefills"]``, nothing captured), whose paged attention
    launches, one a layer and chunk, and products the kernels' counts take
    from the replays, no plain version; ms a chunk each way; and from
    admission to the first batched step done, ms each way, graphed under
    the sync check (``admission_to_first_step``). Every page is free at the
    end. Returns the captured chunk's launches a replay."""
    import torch
    import lookaheaddecoding_tpu_torch as lt
    from lookaheaddecoding_tpu_torch.core import graphs
    from lookaheaddecoding_tpu_torch.ops import quant_matmul as qm

    layers = srv.mcfg.num_hidden_layers
    px = srv.precompute_prefix(make_prompt(nxt, start=3, n=ADMIT_PREFIX))
    carried = srv.generate(make_prompt(nxt, start=7, n=40), 32,
                           return_prefix=True).prefix
    assert carried.pool is not None

    def more(p, n):                 # p continued along the cycle
        return list(p) + make_prompt(nxt, start=int(p[-1]), n=n)
    cases = {"64": (make_prompt(nxt, start=40, n=64), None),
             str(ADMIT_LONG): (make_prompt(nxt, start=41, n=ADMIT_LONG),
                               None),
             "prefix": (more(px.tokens, 40), px),
             "carried": (more(carried.tokens, 8), carried)}
    for i in range(ADMIT_LIVE):
        srv.submit(lt.Request(prompt=make_prompt(nxt, start=20 + i, n=64),
                              max_new_tokens=PAGED_NEW))
    srv.step()                      # the other lanes live
    assert len(srv._meta) == ADMIT_LIVE, len(srv._meta)
    for case, (prompt, prefix) in cases.items():
        start0 = 0 if prefix is None else prefix.length
        k = prefill_chunks(srv, len(prompt), start0)

        def req():
            return lt.Request(prompt=prompt, max_new_tokens=ADMIT_NEW,
                              prefix=prefix)
        snaps, stats, got, chunk_ms, first_ms = {}, {}, {}, {}, {}
        profiled, prof = case == str(ADMIT_LONG), None
        for which in ("eager", "graphed"):
            with _mode(which):
                torch.cuda.synchronize()
                reset_counts()
                graphs.reset_stats()
                lane = admit_lane(srv, req())
                snaps[which] = admitted_lane(srv, lane)
                torch.cuda.synchronize()
                stats[which] = graphs.read_stats()
                got[which] = dict(read_counts(),
                                  int8_mma=qm.counts["int8_mma"])
                chunk_ms[which] = timed_steps(
                    lambda n: prefills_paged(srv, len(prompt), start0, n),
                    PREFILL_REPS) / k
                if which == "graphed" and profiled:
                    prof = profile_steps(
                        lambda n: prefills_paged(srv, len(prompt), start0, n),
                        1)
                evict_lane(srv, lane)
        differ = [i for i, (a, b) in enumerate(zip(snaps["eager"],
                                                   snaps["graphed"]))
                  if not torch.equal(a, b)]
        assert not differ, (f"{name} {case}: the lane after the graphed "
                            f"admission differs (tensors {differ})")
        # a step writes the lane's pages past its prompt: after the
        # comparison
        for which in ("eager", "graphed"):
            with _mode(which):
                first_ms[which] = admission_to_first_step(
                    srv, req(), which == "graphed")
        e, g = stats["eager"], stats["graphed"]
        assert e["prefills"] == e["captured"] == 0, (name, case, e)
        assert g["prefills"] == k and g["captured"] == 0, (name, case, k, g)
        assert got["graphed"]["paged_attention"] == k * layers \
            == got["eager"]["paged_attention"], (name, case, got)
        assert got["graphed"]["int8_mma"] == got["eager"]["int8_mma"], got
        for which in got:
            assert got[which]["plain"] == got[which]["attention_fma"] == 0, \
                (name, case, which, got)
        per_replay = next(graph for key, graph in srv._graphs.items()
                          if key[0] == "prefill").launches_per_replay()
        log(f"  [{card}] {name} admission, {case} ({len(prompt)}-token "
            f"prompt, {k} chunk{'s' if k > 1 else ''} of "
            f"{srv.ecfg.prefill_chunk} from row {start0}, "
            f"{ADMIT_LIVE} other lanes live): the lane's row and data pages "
            f"bit-equal eager and graphed; graphed {g['prefills']} replays "
            f"of the captured chunk, launches a replay {per_replay}; ms a "
            f"chunk eager {chunk_ms['eager']:.3f}, graphed "
            f"{chunk_ms['graphed']:.3f} "
            f"({chunk_ms['eager'] / chunk_ms['graphed']:.1f}x)"
            + (f"; a graphed chunk under the profiler: "
               f"{profile_line(prof, chunk_ms, k)}" if profiled else "")
            + f"; from admission to the first batched step ({LANES} lanes) "
            f"done, ms queued / run: eager {first_ms['eager'][0]:.3f} / "
            f"{first_ms['eager'][1]:.3f}, graphed "
            f"{first_ms['graphed'][0]:.3f} / {first_ms['graphed'][1]:.3f} "
            f"(no host sync from the lane's choice to the first batched "
            f"replay, set_sync_debug_mode('error'))")
    while srv.step():
        pass
    srv._results = []
    srv.release_prefix(px)
    srv.release_prefix(carried)
    assert srv.pages_free == N_PAGES, srv.memory_stats()
    return per_replay


def prefills_paged(srv, prompt_len, start0, n):
    """``n`` prefills of the admission in ``srv``'s record (each rewrites
    the same rows of the admitted lane's pages)."""
    import torch
    with torch.inference_mode():
        for _ in range(n):
            srv._prefill(prompt_len, start0)


def captured_batch(name, eng, prompts, card, n_new):
    """A greedy ``generate_batch`` of len(prompts) lanes eager and graphed
    on one engine (each way after a warm call): every lane's tokens and
    steps, the lanes' pool rows [0, R) and clocks, the branches evaluated
    and chains taken equal; graphed, one launch of the batch request graph
    (each lane's preparation, then one device loop whose iterations are
    the slowest lane's steps), the kernels' launches counted from them,
    and a call's one read back with no host sync before it. Prints the
    call's wall over its steps and peak memory each way."""
    import torch
    from lookaheaddecoding_tpu_torch.core import graphs

    res, st, pools, peak, got = {}, {}, {}, {}, {}
    for which in ("eager", "graphed"):
        with _mode(which):
            eng.generate_batch(prompts, n_new)          # warm (captures)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            graphs.reset_stats()
            res[which] = eng.generate_batch(prompts, n_new)
            torch.cuda.synchronize()
            st[which], got[which] = graphs.read_stats(), read_counts()
            pool = eng._lane_slots[len(prompts)].states.pool
            pools[which] = [pool.values[:, :-1].clone(),
                            pool.age[:, :-1].clone(), pool.clock.clone()]
        peak[which] = torch.cuda.max_memory_allocated() / 2**20
    e, g = res["eager"], res["graphed"]
    for a, b in zip(e, g):
        assert np.array_equal(a.tokens, b.tokens) and a.steps == b.steps, \
            f"{name}: a graphed lane differs from eager"
    assert all(torch.equal(a, b) for a, b in zip(pools["eager"],
                                                 pools["graphed"])), \
        f"{name}: the lanes' pool rows differ"
    same_branches(name, st)
    steps = max(r.steps for r in g)
    assert st["graphed"]["loops"] == 1 and \
        st["graphed"]["replays"] == steps, (name, st["graphed"])
    assert got["graphed"]["paged_attention"] == \
        got["eager"]["paged_attention"] > 0, (name, got)
    # one batch request graph: its lane loop, each lane's prefill node and
    # the decode loop
    assert got["graphed"]["set_while"] == while_launches(
        st["graphed"], len(prompts)), (name, got)
    assert st["graphed"]["requests"] == 1, (name, st)
    again, reads = one_read(lambda: eng.generate_batch(prompts, n_new))
    assert reads == 1 and all(np.array_equal(a.tokens, b.tokens)
                              for a, b in zip(again, g)), name
    call_ms = {w: 1e3 * res[w][0].wall_time_s / max(r.steps for r in res[w])
               for w in res}
    log(f"  [{card}] {name}: every lane == eager (tokens, steps "
        f"{[r.steps for r in g]}, pool rows, branches "
        f"{share(st['graphed']['taken'], st['graphed']['branches'])}); "
        f"{loop_line(st['graphed'], steps, reads)}; the call's wall over "
        f"its steps, ms: graphed {call_ms['graphed']:.3f}, eager "
        f"{call_ms['eager']:.3f}; peak {peak['graphed']:.0f} MiB graphed, "
        f"{peak['eager']:.0f} eager")


def eos_run(name, eng, prompt, card, n_new):
    """A greedy call that an EOS id ends (the token the run emits at new
    position EOS_AT): the device loop's iterations against the steps the
    run needs, beside the host loop (the slot's captured step replayed
    in batches, ``step.run_loop``) on the same request, whose last batch
    runs on past the EOS; the call's wall over its steps each way."""
    import torch
    from lookaheaddecoding_tpu_torch.core import graphs

    eos = int(eng.generate(prompt, n_new).tokens[len(prompt) + EOS_AT])
    eng.generate(prompt, n_new, eos_token_id=eos)
    torch.cuda.synchronize()
    graphs.reset_stats()
    r = eng.generate(prompt, n_new, eos_token_id=eos)
    loop = graphs.read_stats()
    host_loop_call(eng, prompt, "greedy", n_new, eos)       # warm
    graphs.reset_stats()
    host = host_loop_call(eng, prompt, "greedy", n_new, eos)
    ran = graphs.read_stats()["replays"]
    needed = host.steps
    assert np.array_equal(r.tokens, host.tokens), name
    assert r.steps == needed == loop["replays"], (name, r.steps, needed,
                                                  loop)
    assert ran >= needed, (name, ran, needed)
    log(f"  [{card}] {name} to an EOS id at new position "
        f"{r.num_generated}: {needed} steps needed; the device loop ran "
        f"{loop['replays']} ({loop['loops']} launch), the host loop "
        f"{ran} ({ran - needed} past the EOS); the call's wall "
        f"over the steps needed: device loop {1e3 * r.wall_time_s / needed:.3f}"
        f" ms, host loop {1e3 * host.wall_time_s / needed:.3f}")
    return dict(needed=needed, device=loop["replays"], host=ran)


def three_ways(name, eng, call, card, lanes=0):
    """A call that draws from the state's stream (``call(host_loop)``: a
    flat call of ``eng`` with seed 0, whose ``call.loop`` are
    :func:`loop_iteration`'s arguments after the engine, or, with
    ``lanes``, a
    ``generate_batch`` of that many lanes) on the device loop, by the host
    loop (the slot's captured step replayed from the host, ``_run`` or
    ``_batch`` with ``host_loop=True``) and eagerly (``graphs.eager()``),
    the graphed ones after a warm call: tokens, steps, pool rows [0, R)
    and clocks and
    the final draw counters bit-equal; the device loop one launch whose
    iterations are the steps, the Philox kernel a launch an iteration
    beside one a request for its window, and one read back with no host
    sync before it; the host loop as many replays as the steps or more
    (past an EOS). Prints the call's wall over its steps each way and, for
    a flat call, the device ms an iteration (CUDA events around one
    launch) beside the host loop's wall a step. Returns the device loop's
    kernel launches and the steps, device against host loop."""
    import torch
    from lookaheaddecoding_tpu_torch.core import graphs

    def outcome(res):
        st = (eng._lane_slots[lanes].states if lanes
              else eng._free_slot().state)
        pool = st.pool
        tabs = ([pool.values[:, :-1], pool.age[:, :-1], pool.clock] if lanes
                else [pool.values[:-1], pool.age[:-1], pool.clock])
        return ([r.tokens for r in res], [r.steps for r in res],
                [t.clone() for t in tabs], st.draws.cpu().view(-1).tolist())

    res, out, st, got = {}, {}, {}, {}
    for which in ("eager", "host", "device"):
        with _mode(which):
            if which != "eager":
                call(which == "host")                   # warm (captures)
            torch.cuda.synchronize()
            reset_counts()
            graphs.reset_stats()
            res[which] = call(which == "host")
            torch.cuda.synchronize()
            st[which], got[which] = graphs.read_stats(), read_counts()
            out[which] = outcome(res[which])
    want = out["eager"]
    for which in ("host", "device"):
        tokens, steps, tabs, draws = out[which]
        assert all(np.array_equal(a, b) for a, b in zip(tokens, want[0])), \
            f"{name}: the {which} loop's tokens differ from eager"
        assert steps == want[1] and draws == want[3], (name, which, steps,
                                                       draws, want)
        assert all(torch.equal(a, b) for a, b in zip(tabs, want[2])), \
            f"{name}: the {which} loop's pool rows differ from eager"
        assert got[which]["plain"] == got[which]["attention_fma"] == 0, \
            (name, which, got[which])
    steps = max(want[1])
    assert want[3] == want[1], (name, "a draw a step", want[3], want[1])
    dev, host = st["device"], st["host"]
    assert dev["loops"] == 1 and dev["replays"] == steps, (name, dev)
    assert host["loops"] == 0 and host["replays"] >= steps, (name, host)
    assert got["device"]["philox"] == steps + len(want[1]), (name, got)
    assert got["device"]["set_while"] == while_launches(dev, lanes), \
        (name, got)
    again, reads = one_read(lambda: call(False))
    assert reads == 1 and all(np.array_equal(a.tokens, b) for a, b in
                              zip(again, want[0])), name
    wall = {w: 1e3 * res[w][0].wall_time_s / steps for w in res}
    iteration = ""
    if not lanes:
        loop_ms, iters = loop_iteration(eng, *call.loop)
        iteration = (f"; in the loop {loop_ms:.3f} ms an iteration (CUDA "
                     f"events, {iters} iterations) against the host loop's "
                     f"{wall['host']:.3f} ms wall a step")
    log(f"  [{card}] {name}: device loop == host loop == eager (tokens, "
        f"steps {want[1]}, pool rows, draws {want[3]}); the device loop "
        f"{dev['loops']} launch, {dev['replays']} iterations, {reads} read "
        f"back and no host sync before it, Philox {got['device']['philox']} "
        f"launches; the host loop {host['replays']} replays "
        f"({host['replays'] - steps} past the last needed step); the call's "
        f"wall over its steps, ms: device loop {wall['device']:.3f}, host "
        f"loop {wall['host']:.3f}, eager {wall['eager']:.3f}" + iteration)
    return dict(launches=got["device"], steps=steps,
                host_replays=host["replays"], tokens=want[0])


def sampled_loops(configs, prompt, nxt, card, t_star):
    """The sampling decode loop on the device (JAX's ``sample_loop``,
    whose noise the state's Philox stream gives): the headline bf16
    ``generate_sample`` at T*, int8_weights' at T*, a four-lane sampled
    ``generate_batch`` with per-lane temperatures, a sampling call ended
    by an EOS id (the token its run emits at new position EOS_AT_SAMPLE),
    and a
    greedy ``always_fwd_one=False`` call (the window refill draws), each by
    :func:`three_ways`; the refilling call's tokens also equal the bf16
    engine's greedy ``generate``. Returns {name: the device loop's
    launches}."""
    import dataclasses
    import lookaheaddecoding_tpu_torch as lt

    cfg = lt.SamplingConfig(temperature=t_star, top_k=TOP_K)
    bf16 = configs["bf16"][0]

    def flat(eng, mode, n_new, sampling=None, eos=None):
        def call(host_loop):
            return [eng._run(mode, prompt, n_new, eos, 0, sampling=sampling,
                             host_loop=host_loop)]
        call.loop = (prompt, mode, n_new, sampling, eos)
        return call

    prompts = [make_prompt(nxt, start=60 + i, n=PROMPT_LEN - 8 * i)
               for i in range(BATCH_LANES)]
    temps = [t_star, 0.8 * t_star, 1.25 * t_star, t_star]

    def batch(host_loop):
        return bf16._batch(prompts, N_SAMPLE_SHORT, None, 0,
                           list(range(BATCH_LANES)), None, cfg, temps, None,
                           host_loop=host_loop)
    eos = int(bf16.generate_sample(prompt, N_SAMPLE, cfg).tokens[
        len(prompt) + EOS_AT_SAMPLE])
    refill = lt.LookaheadEngine(
        bf16.mcfg, bf16.params,
        dataclasses.replace(bf16.lcfg, always_fwd_one=False), bf16.ecfg)
    out = {}
    out["bf16 generate_sample"] = three_ways(
        f"bf16 generate_sample at T*={t_star:.4f}", bf16,
        flat(bf16, "sample", N_SAMPLE_SHORT, cfg), card)
    out["int8_weights generate_sample"] = three_ways(
        f"int8_weights generate_sample at T*={t_star:.4f}",
        configs["int8_weights"][0],
        flat(configs["int8_weights"][0], "sample", N_SAMPLE_SHORT, cfg),
        card)
    out["bf16 sampled generate_batch"] = three_ways(
        f"bf16 sampled generate_batch of {BATCH_LANES} lanes (temperatures "
        f"{[round(t, 4) for t in temps]})", bf16, batch, card,
        lanes=BATCH_LANES)
    got = out["bf16 generate_sample to an EOS id"] = three_ways(
        f"bf16 generate_sample to an EOS id (token {eos})", bf16,
        flat(bf16, "sample", N_SAMPLE, cfg, eos), card)
    ended = got["tokens"][0]
    assert ended[-1] == eos and len(ended) < len(prompt) + N_SAMPLE, \
        ("the sampling call did not end at its EOS id", len(ended))
    log(f"  [{card}] the EOS-ended sampling call: {got['steps']} steps "
        f"needed, the device loop ran {got['steps']}, the host loop "
        f"{got['host_replays']}")
    got = out["bf16 always_fwd_one=False"] = three_ways(
        "bf16 generate, always_fwd_one=False", refill,
        flat(refill, "greedy", N_SAMPLE), card)
    assert_same_tokens("always_fwd_one=False", refill, got["tokens"][0],
                       bf16.generate(prompt, N_SAMPLE).tokens, 1.0)
    return {name: got["launches"] for name, got in out.items()}


def timed_request(call, no_sync, count_ops=False):
    """(``call()``, its account) of one request: ms from its start until
    its first read back (``graphs.fetch``) is queued on the host; device
    ms from its start to that read (CUDA events) and, when it launched a
    request graph, of that launch alone; its reads back; with
    ``count_ops``, the ops the host dispatched before the first read (each
    launches one or more kernels or copies; graph launches apart), which
    the counting slows. With ``no_sync`` every wait of the host for the
    card before the first read raises
    (``torch.cuda.set_sync_debug_mode("error")``)."""
    import contextlib
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from lookaheaddecoding_tpu_torch.core import graphs

    fetch, run, marks, ops = graphs.fetch, graphs.RequestGraph.run, {}, [0]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops[0] += "queued" not in marks
            return func(*args, **(kwargs or {}))

    def read(tensor):
        if "queued" not in marks:
            marks["queued"] = time.perf_counter()
            events[1].record()
            torch.cuda.set_sync_debug_mode("default")
        marks["reads"] = marks.get("reads", 0) + 1
        return fetch(tensor)

    def launch(graph):
        events[2].record()
        run(graph)
        events[3].record()
        marks["launched"] = True

    torch.cuda.synchronize()
    graphs.fetch, graphs.RequestGraph.run = read, launch
    if no_sync:
        torch.cuda.set_sync_debug_mode("error")
    try:
        with Ops() if count_ops else contextlib.nullcontext():
            t0 = time.perf_counter()
            events[0].record()
            res = call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        graphs.fetch, graphs.RequestGraph.run = fetch, run
    torch.cuda.synchronize()
    return res, dict(
        queued_ms=1e3 * (marks["queued"] - t0),
        device_ms=events[0].elapsed_time(events[1]),
        launch_ms=(events[2].elapsed_time(events[3])
                   if "launched" in marks else None),
        reads=marks["reads"], ops=ops[0])


def host_stages(eng, prompt, mode, n_new, sampling=None, eos=None):
    """Median host ms of each stage of a request-graph call of ``prompt``
    over REQUEST_REPS calls (a collection of Python's garbage before
    each): the host's arguments (``_host_args``: the output buffer and
    the pool fill), packing the words, pinning them, the copy's launch,
    the graph's lookup and its launch; then the card's run to the read
    (the host waits)."""
    import gc
    import torch

    rows = []
    for _ in range(REQUEST_REPS):
        torch.cuda.synchronize()
        gc.collect()
        with torch.inference_mode(), eng._slot() as slot:
            t = [time.perf_counter()]
            out_buf, n, fill = eng._host_args(prompt, n_new)
            t.append(time.perf_counter())
            words = np.concatenate([
                eng._call_words(mode, n_new, eos, sampling),
                eng._request_words(out_buf, n, 0, fill)])
            t.append(time.perf_counter())
            pinned = torch.from_numpy(words).pin_memory()
            t.append(time.perf_counter())
            slot.args[:len(words)].copy_(pinned, non_blocking=True)
            t.append(time.perf_counter())
            graph = eng._request_graph(slot, fill is not None, mode,
                                       *eng._warpers(mode, sampling))
            t.append(time.perf_counter())
            graph.graph.replay()
            t.append(time.perf_counter())
            torch.cuda.synchronize()
            t.append(time.perf_counter())
        rows.append([1e3 * (b - a) for a, b in zip(t, t[1:])])
    return dict(zip(("host_args", "pack", "pin", "copy", "lookup", "launch",
                     "run"), np.median(np.array(rows), axis=0).tolist()))


def request_case(name, eng, prompt, mode, card, n_new, sampling=None,
                 eos=None, stages=False, prefix=None, lanes=None,
                 temps=None):
    """One flat call (seed 0; past ``prefix`` when given) or, with
    ``lanes`` (prompts), one whole ``generate_batch`` of them (seeds 0..B-1,
    greedy, or ``sampling`` at the lanes' ``temps``; past ``prefix``)
    three ways on one engine: eagerly (``graphs.eager()``, once), and
    after a warm call by today's path (``fused=False``: a flat call's
    preparation op by op, the prefill's chunks replays of the slot's
    captured chunk, the decode loop's own graph; a batch's lanes each by
    its prepare graph, or op by op past a prefix, and copied to its page,
    then the lane loop's graph)
    and as one launch of the request graph (JAX's fused call,
    ``_make_fused_prefix``, or ``bcall`` / ``bcall_px``), those two
    REQUEST_REPS times in turns, a collection of Python's garbage before
    each call (a full one takes ~100 ms in this process, and would land in
    whichever call triggers it). Tokens, steps, the pool's rows [0, R) and
    clocks and the draw counters bit-equal; the request graph one launch
    (a device loop), its prefill iterations the chunks past the prefix
    (each lane's: the batch's ``prefills``), its decode iterations the
    (slowest lane's) steps, the WHILE condition kernel once before each
    loop and once an iteration, no plain version, and one read back with
    no host sync before it, as today's path; a batch's lanes each equal
    to its lone call. Prints, beside today's path, the median and the
    least over the calls of: ms until the read is queued, the call's wall
    over its steps, device ms from the start to the read (CUDA events)
    and of the launch alone; the host's dispatches and graph launches a
    call (from one more call each: counting slows the host); with
    ``stages``, :func:`host_stages`."""
    import dataclasses
    import gc
    import torch
    from lookaheaddecoding_tpu_torch.core import graphs

    prompts = [prompt] if lanes is None else lanes
    B = 0 if lanes is None else len(lanes)
    start0 = 0 if prefix is None else prefix.length

    def call(fused):
        if B:
            return eng._batch(lanes, n_new, eos, 0, None, prefix, sampling,
                              temps, None, fused=fused)
        return [eng._run(mode, prompt, n_new, eos, 0, prefix=prefix,
                         sampling=sampling, fused=fused)]

    def outcome(res):
        st = eng._lane_slots[B].states if B else eng._free_slot().state
        pool = st.pool
        tabs = ([pool.values[:, :-1], pool.age[:, :-1], pool.clock] if B
                else [pool.values[:-1], pool.age[:-1], pool.clock])
        return ([r.tokens for r in res], [r.steps for r in res],
                [t.clone() for t in tabs], st.draws.cpu().view(-1).tolist())

    k = [prefill_chunks(eng, len(p), start0) for p in prompts]
    out, st, got, acc = {}, {}, {}, {"today": [], "request": []}
    with graphs.eager():            # nothing to capture: no warm call
        gc.collect()
        res, _ = timed_request(lambda: call(True), False)
        out["eager"] = outcome(res) + (res[0].wall_time_s,)
    warm = {}
    for which in ("today", "request"):
        torch.cuda.synchronize()
        graphs.reset_stats()
        t0 = time.perf_counter()
        call(which == "request")                       # warm (captures)
        torch.cuda.synchronize()
        warm[which] = (time.perf_counter() - t0,
                       graphs.read_stats()["captured"])
    for rep in range(REQUEST_REPS):
        for which in (("today", "request") if rep % 2 == 0
                      else ("request", "today")):
            gc.collect()
            reset_counts()
            graphs.reset_stats()
            res, a = timed_request(lambda: call(which == "request"), True)
            acc[which].append(dict(a, wall_ms=1e3 * res[0].wall_time_s
                                   / max(r.steps for r in res)))
            st[which], got[which] = graphs.read_stats(), read_counts()
            out[which] = outcome(res) + (res[0].wall_time_s,)
    want = out["eager"]
    for which in ("today", "request"):
        tokens, steps, pools, draws, _ = out[which]
        assert all(np.array_equal(a, b) for a, b in zip(tokens, want[0])) \
            and steps == want[1], \
            f"{name}: {which}'s tokens or steps differ from eager"
        assert draws == want[3], (name, which, draws, want[3])
        assert all(torch.equal(a, b) for a, b in zip(pools, want[2])), \
            f"{name}: {which}'s pool rows differ from eager"
        assert all(a["reads"] == 1 for a in acc[which]), (name, which)
        assert got[which]["plain"] == got[which]["attention_fma"] == 0, \
            (name, which, got[which])
    steps = max(want[1])
    r, t = st["request"], st["today"]
    assert (r["requests"], r["loops"], r["captured"]) == (1, 1, 0), (name, r)
    assert (r["prefills"], r["replays"]) == (sum(k), steps), (name, k, r)
    # today's path: a batch without a prefix prepares each lane by its
    # prepare graph; past a prefix, and a flat call, by replays of the
    # captured chunk
    lane_graphs = B if prefix is None else 0
    assert (t["requests"], t["loops"], t["prefills"]) == \
        (lane_graphs, 1, sum(k)), (name, t)
    assert got["request"]["set_while"] == while_launches(r, B) == \
        steps + sum(k) + 2 + 2 * B, (name, got["request"])
    kernel = "paged_attention" if B else "attention_mma"
    assert got["request"][kernel] == got["today"][kernel] > 0, (name, got)
    if B:
        assert eng._lane_slots[B].prefills.tolist() == k, (name, k)
        for i, (p, tokens, n) in enumerate(zip(lanes, want[0], want[1])):
            lone = (eng.generate(p, n_new, eos, seed=i, prefix=prefix)
                    if sampling is None else eng.generate_sample(
                        p, n_new, dataclasses.replace(
                            sampling, temperature=temps[i]), eos, seed=i,
                        prefix=prefix))
            assert np.array_equal(lone.tokens, tokens) and \
                lone.steps == n, f"{name}: lane {i} differs from its call"
    if eos is not None:
        assert want[0][0][-1] == eos and \
            len(want[0][0]) < len(prompt) + n_new, \
            (name, "not ended by its EOS id")
    # the host's work a call, counted apart
    launches = {}
    for which in ("today", "request"):
        graphs.reset_stats()
        _, counted = timed_request(lambda: call(which == "request"), True,
                                   count_ops=True)
        c = graphs.read_stats()
        launches[which] = (counted["ops"], c["requests"] if which ==
                           "request" else c["loops"] + (
                               c["requests"] if lane_graphs else
                               c["prefills"]))

    def spread(which, key):
        vals = [a[key] for a in acc[which]]
        return float(np.median(vals)), min(vals)

    summary = {w: {key: spread(w, key) for key in ("queued_ms", "wall_ms",
                                                   "device_ms")}
               for w in acc}
    summary["request"]["launch_ms"] = spread("request", "launch_ms")
    staged = host_stages(eng, prompt, mode, n_new, sampling, eos) \
        if stages else None

    def two(pair):
        return f"{pair[0]:.3f} ({pair[1]:.3f})"
    rq, td = summary["request"], summary["today"]
    what = (f"{B} lanes of {[len(p) for p in lanes]} tokens" if B
            else f"{len(prompt)}-token prompt")
    if prefix is not None:
        what += f" past a {prefix.length}-token prefix"
    log(f"  [{card}] request graph, {name} ({what}, chunks {k}, steps "
        f"{want[1]}): == today's path == eager (tokens, steps, pool rows, "
        f"draws {want[3]})" + (", each lane == its lone call" if B else "")
        + f"; one launch, prefill iterations {r['prefills']} of {sum(k)} "
        f"chunks, decode iterations {r['replays']}, 1 read back and no "
        f"host sync before it, no plain version; median (least) of "
        f"{REQUEST_REPS} calls each: ms until the read is queued: request "
        f"graph {two(rq['queued_ms'])}, today's path {two(td['queued_ms'])}"
        f"; the call's wall over its steps, ms: request graph "
        f"{two(rq['wall_ms'])}, today's path {two(td['wall_ms'])}, eager "
        f"{1e3 * want[4] / steps:.3f}; device ms from the start to the read "
        f"(CUDA events): request graph {two(rq['device_ms'])} (the launch "
        f"alone {two(rq['launch_ms'])}), today's path "
        f"{two(td['device_ms'])}; a call's host ops before the read / graph "
        f"launches: request graph {launches['request'][0]} / "
        f"{launches['request'][1]}, today's path {launches['today'][0]} / "
        f"{launches['today'][1]}; the request graph's kernel launches a "
        f"call: " + ", ".join(f"{key} {got['request'][key]}" for key in (
            "attention_mma", "paged_attention", "set_while", "philox"))
        + f"; the first call of each way (its "
        f"captures included): request graph {warm['request'][0]:.3f} s, "
        f"{warm['request'][1]} captured, today's path "
        f"{warm['today'][0]:.3f} s, {warm['today'][1]} captured"
        + ("" if staged is None else
           "; the request graph's host stages, median ms: " + ", ".join(
               f"{key} {v:.3f}" for key, v in staged.items())))
    return dict(steps=steps, chunks=k, summary=summary, launches=launches,
                stages=staged, warm=warm)


def prefix_copy(eng, prefix, reps=5):
    """(the median device ms of ``reps`` copies of ``prefix`` into
    ``eng``'s prefix source, by CUDA events: the copy a prefix call queues
    before its launch; MiB the source holds, its pool included)."""
    import torch
    from lookaheaddecoding_tpu_torch.core import graphs
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with torch.inference_mode():    # the source is an inference tensor
            a.record()
            eng._load_prefix(prefix)
            b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    mib = sum(t.numel() * t.element_size()
              for t in graphs.state_tensors(eng._prefix_src)) / 2**20
    return float(np.median(times)), mib


def request_phase(configs, prompt, nxt, card, t_star, headline):
    """Phase 13's request graphs (JAX's ``_make_fused``: a flat call
    without a prefix one launch and one read), each by
    :func:`request_case`: the headline bf16 ``generate`` of N_NEW tokens,
    its ``generate_baseline`` and ``generate_sample`` at T*, the
    int8_weights, int4_weights and int8_weights_int8_kv ``generate``s, a
    one-token prompt (its prefill runs no iteration), a LONG_PROMPT-token
    prompt at M=LONG_SEQ (12 chunks through B2) and a call that an EOS id
    ends. Returns {name: request_case's account}."""
    import lookaheaddecoding_tpu_torch as lt

    bf16 = configs["bf16"][0]
    mcfg, params = headline
    eos = int(bf16.generate(prompt, N_NEW).tokens[len(prompt) + EOS_AT])
    cases = [
        ("bf16 generate", bf16, prompt, "greedy", N_NEW, None, None, True),
        ("bf16 generate_baseline", bf16, prompt, "ar", N_NEW_QUANT),
        (f"bf16 generate_sample at T*={t_star:.4f}", bf16, prompt, "sample",
         N_SAMPLE, lt.SamplingConfig(temperature=t_star, top_k=TOP_K)),
        *[(f"{name} generate", configs[name][0], prompt, "greedy",
           N_NEW_QUANT) for name in ("int8_weights", "int4_weights",
                                     "int8_weights_int8_kv")],
        ("bf16 one-token prompt", bf16, prompt[:1], "greedy", N_NEW_QUANT),
        (f"bf16 {LONG_PROMPT}-token prompt, M={LONG_SEQ}",
         build_engine(mcfg, params, max_seq=LONG_SEQ),
         make_prompt(nxt, start=11, n=LONG_PROMPT), "greedy", LONG_NEW,
         None, None, True),
        (f"bf16 generate to an EOS id (token {eos})", bf16, prompt,
         "greedy", N_NEW, None, eos),
    ]
    return {case[0]: request_case(case[0], case[1], case[2], case[3], card,
                                  *case[4:]) for case in cases}


def batch_lanes(prompt, nxt):
    """BATCH_LANES prompts that start with the prompt's PREFIX_LEN-token
    prefix and run different prefill chunk counts: 400 tokens (4 chunks, 3
    past the prefix), the prompt (1, 1), the prefix and one token (1, 0),
    200 tokens (2, 2)."""
    def longer(n):
        return prompt + make_prompt(nxt, start=prompt[-1],
                                    n=n - len(prompt))
    return [longer(400), prompt, prompt[:PREFIX_LEN + 1], longer(200)]


def prefix_batch_phase(configs, prompt, nxt, card, t_star):
    """Phase 13's prefix and batch request graphs (JAX's
    ``_make_fused_prefix`` and ``bcall`` / ``bcall_px``: a flat call past a
    prefix, and a whole ``generate_batch``, one launch and one read), each
    by :func:`request_case`: the headline bf16 ``generate`` of
    N_NEW_QUANT tokens past a PREFIX_LEN-token ``precompute_prefix`` of
    the prompt; a second conversation turn on the first turn's
    ``return_prefix`` with its warm pool; ``generate_sample`` at T* past
    the prefix; a prompt of the prefix's length plus one (its prefill runs
    no iteration); int8_weights_int8_kv's ``generate`` past its own
    prefix (an int8 ``{"q", "s"}`` source); greedy and sampled
    ``generate_batch`` of BATCH_LANES lanes (:func:`batch_lanes`: 4, 1,
    1 and 2 chunks, and 3, 1, 0 and 2 past the prefix) without and with
    the prefix; ``generate_baseline`` past the prefix. Also the prefix
    source's copy (device ms) and memory. Returns {name: request_case's
    account}."""
    import lookaheaddecoding_tpu_torch as lt

    bf16 = configs["bf16"][0]
    q8 = configs["int8_weights_int8_kv"][0]
    sampling = lt.SamplingConfig(temperature=t_star, top_k=TOP_K)
    pc = bf16.precompute_prefix(prompt[:PREFIX_LEN])
    pc8 = q8.precompute_prefix(prompt[:PREFIX_LEN])
    first = bf16.generate(prompt, N_PREFIX_NEW, return_prefix=True)
    turn = list(first.tokens) + make_prompt(nxt, start=int(first.tokens[-1]),
                                            n=TURN_LEN)
    lanes = batch_lanes(prompt, nxt)
    temps = [t_star, 0.8 * t_star, 1.25 * t_star, t_star]
    cases = [
        ("bf16 generate past a prefix", bf16, prompt, "greedy",
         N_NEW_QUANT, None, None, False, pc),
        ("bf16 generate, a second turn on return_prefix (warm pool)", bf16,
         turn, "greedy", N_PREFIX_NEW, None, None, False, first.prefix),
        (f"bf16 generate_sample at T*={t_star:.4f} past a prefix", bf16,
         prompt, "sample", N_PREFIX_NEW, sampling, None, False, pc),
        ("bf16 generate, a prompt one token past its prefix", bf16,
         prompt[:PREFIX_LEN + 1], "greedy", N_PREFIX_NEW, None, None, False,
         pc),
        ("int8_weights_int8_kv generate past a prefix", q8, prompt,
         "greedy", N_PREFIX_NEW, None, None, False, pc8),
        ("bf16 generate_baseline past a prefix", bf16, prompt, "ar",
         N_PREFIX_NEW, None, None, False, pc),
        *[(f"bf16 {'sampled' if s else 'greedy'} generate_batch"
           + (" past a prefix" if px else ""), bf16, None,
           "sample" if s else "greedy", N_PREFIX_NEW, sampling if s else None,
           None, False, px, lanes, temps if s else None)
          for s in (False, True) for px in (None, pc)],
    ]
    out = {case[0]: request_case(case[0], case[1], case[2], case[3], card,
                                 *case[4:]) for case in cases}
    for name, eng, prefix in (("bf16", bf16, pc),
                              ("bf16, warm pool", bf16, first.prefix),
                              ("int8_weights_int8_kv", q8, pc8)):
        ms, mib = prefix_copy(eng, prefix)
        log(f"  [{card}] the prefix source, {name}: {mib:.1f} MiB, a "
            f"prefix's copy into it {ms:.4f} device ms (median of 5, CUDA "
            f"events)")
        out[f"prefix copy {name}"] = dict(ms=ms, mib=mib)
    return out


def captured_phase(configs, prompt, paged_engines, nxt, card, t_star,
                   learned, headline):
    """Phase 13 over bf16, int8_weights, int4_weights,
    int8_weights_int8_kv (greedy lookahead), bf16's AR baseline and
    sampling at T*, phase 10's dynamic-NTK engine and a LONG_PROMPT-token
    prompt at M=LONG_SEQ (their calls and prefills; no step alone),
    paged_bf16, the paged admission of each of ``paged_engines`` ({name:
    (engine, its model's cycle)}: paged_bf16, paged_int8_weights_int8_kv
    and paged_bf16_head_dim_256), and phase 11's learned model in bf16 at
    each autotune candidate: 16 active tokens over K = W + GS harvest
    lanes, so its steps chain. Each configuration's IF-body share is
    printed; the learned model must chain, and the headline's first steps
    (no window lane harvested yet) must take the parallel insert. Then
    the sampling loops on the device (:func:`sampled_loops`). Returns
    each paged configuration's captured chunk's launches a replay, and the
    sampling loops' launches."""
    import lookaheaddecoding_tpu_torch as lt
    from lookaheaddecoding_tpu_torch.applications import train_synthetic
    from lookaheaddecoding_tpu_torch.core import graphs

    got = graphs.read_stats()
    log(f"  [{card}] phases 2-12 captured {got['captured']} graphs and "
        f"replayed them {got['replays']} times")
    shares = {}
    for name in ("bf16", "int8_weights", "int4_weights",
                 "int8_weights_int8_kv"):
        shares[name] = captured_flat(
            name, configs[name][0], prompt, "greedy", card,
            N_NEW if name == "bf16" else N_NEW_QUANT)
    bf16 = configs["bf16"][0]
    captured_flat("bf16 AR baseline", bf16, prompt, "ar", card, N_NEW_QUANT)
    captured_batch(f"bf16 generate_batch of {BATCH_LANES} lanes", bf16,
                   [make_prompt(nxt, start=50 + i, n=PROMPT_LEN - 8 * i)
                    for i in range(BATCH_LANES)], card, N_NEW_QUANT)
    eos_run("bf16", bf16, prompt, card, N_NEW)
    shares["sampling"] = captured_flat(
        f"bf16 sampling at T*={t_star:.4f}", bf16, prompt, "sample", card,
        N_SAMPLE, lt.SamplingConfig(temperature=t_star, top_k=TOP_K))
    sampled = sampled_loops(configs, prompt, nxt, card, t_star)
    # the prefill of phase 10's dynamic-NTK engine (its rotation keyed on
    # the prompt's length, on the device) and of a long prompt at M=2048
    # (12 chunks through B2)
    mcfg, params = headline
    dcfg = lt.LlamaConfig(**dict(ARCH, max_position_embeddings=DYN_MAX_POS),
                          rope_scaling=("dynamic", DYN_FACTOR),
                          dtype=mcfg.dtype)
    captured_flat("dynamic_ntk", build_engine(dcfg, params, max_seq=DYN_SEQ),
                  make_prompt(nxt, start=7, n=DYN_PROMPT), "greedy", card,
                  DYN_NEW, alone=False, return_prefix=False)
    captured_flat(f"bf16 {LONG_PROMPT}-token prompt, M={LONG_SEQ}",
                  build_engine(mcfg, params, max_seq=LONG_SEQ),
                  make_prompt(nxt, start=11, n=LONG_PROMPT), "greedy", card,
                  LONG_NEW, alone=False)
    shares["paged_bf16"] = captured_paged(
        "paged_bf16", paged_engines["paged_bf16"][0], nxt, card)
    admissions = {name: captured_admission(name, srv, cycle, card)
                  for name, (srv, cycle) in paged_engines.items()}
    cfg, params = learned
    sampler = train_synthetic.make_markov_sampler(
        cfg.vocab_size, order=LEARNED_ORDER, active_vocab=LEARNED_ACTIVE)
    learned_prompt = sampler(1, LEARNED_PROMPT,
                             np.random.RandomState(7))[0].tolist()
    for cand in LEARNED_CANDIDATES:
        name = f"learned_bf16 L{cand[0]}/W{cand[1]}/G{cand[2]}"
        shares[name] = captured_flat(
            name, build_learned_engine(cfg, params, cand), learned_prompt,
            "greedy", card, LEARNED_NEW)
    for name, ((taken, branches), profs) in shares.items():
        if name.startswith("learned"):
            assert taken > 0, f"{name}: the learned model never chained"
    # the headline's kernels a replay by branch: its first steps take the
    # parallel insert, its later ones mostly the chain
    (first, (t1, _)), (later, (t2, b2)) = shares["bf16"][1]
    assert t1 == 0, ("the headline's first steps chained", t1)
    if first is not None and later is not None:
        log(f"  [{card}] bf16 lookahead, graphed: {first[0]:.0f} kernels a "
            f"replay on steps that took the parallel insert, "
            f"{later[0]:.0f} on later steps (the chain in {share(t2, b2)})"
            f"; device busy {first[1]:.3f} / {later[1]:.3f} ms a step")
    log(f"  [{card}] the pool's chain ran in (IF bodies of steps, whole "
        f"calls): " + "; ".join(f"{k} {share(*v[0])}"
                                for k, v in shares.items()))
    return admissions, sampled


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

    t_lap = [time.perf_counter()]

    def lap(phase):
        """The seconds a phase took (since the previous lap)."""
        now = time.perf_counter()
        log(f"[seconds] {phase}: {now - t_lap[0]:.1f}")
        t_lap[0] = now

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SIGNATURES)) as ex:
        list(ex.map(_build.build, _build.SIGNATURES))
    for name in _build.SIGNATURES:
        _build.load(name)
        info = _build.build_info[name]
        log(f"[build] {name}: {info['seconds']:.1f} s\n{info['log'].strip()}")
    log(f"[build] all kernels in {time.perf_counter() - t0:.1f} s")
    lap("build")

    lay = build_layout(lt.LookaheadConfig(level=LEVEL, window_size=WINDOW,
                                          guess_set_size=GUESS))
    assert (lay.seq_len, 1 + lay.inp_stop - lay.inp_start + lay.seq_len
            - lay.guess_start) == (S_COMP, LOGITS_ROWS), lay
    log(f"[kernels] lookahead_attention vs plain version ({card})")
    att = check_attention(device)
    log(f"[kernels] lookahead_attention at head_dim 256, Gemma-2B's heads "
        f"(8 query, 1 KV), vs plain version ({card})")
    att256 = check_attention(device, HEADS_256, ATT_CASES_256,
                             set(ATT_CASES_256), seed=4)
    log(f"[kernels] lookahead_attention at a first composite row (row0, a "
        f"lookahead-parallel rank's call) vs the whole call's rows ({card})")
    row0_err = check_row0(device)
    log(f"[kernels] lookahead_attention and paged lookahead_attention at a "
        f"tp=2 rank's heads {HEADS_TP2} vs plain version, the paged call "
        f"with generate_batch's two lanes of one page each, vs the flat "
        f"kernel ({card})")
    att_tp2 = check_attention(device, HEADS_TP2, ATT_CASES, set(), seed=7)
    patt_tp2 = check_paged_attention(device, HEADS_TP2,
                                     ((PAGE, 8), (MAX_SEQ, 1)), seed=8,
                                     lanes=2, timed=False)
    log(f"[kernels] quantized matmuls vs plain versions ({card})")
    mm = check_matmuls(device)
    log(f"[kernels] paged lookahead_attention vs plain version and vs the "
        f"flat kernel ({card})")
    patt = check_paged_attention(device)
    log(f"[kernels] paged lookahead_attention at head_dim 256 vs plain "
        f"version and vs the flat kernel ({card})")
    patt256 = check_paged_attention(device, HEADS_256, ((PAGE, 8),), seed=5)
    att_small, patt_small = {}, {}
    for d, heads in HEADS_SMALL.items():
        log(f"[kernels] lookahead_attention at head_dim {d} ({heads[0]} "
            f"query, {heads[1]} KV heads), flat and paged, vs plain version "
            f"and the paged call vs the flat kernel ({card})")
        att_small[d] = check_attention(device, heads, ATT_CASES_256,
                                       ATT_TIMED_SMALL, seed=10 + d)
        patt_small[d] = check_paged_attention(device, heads, ((PAGE, 8),),
                                              seed=11 + d)
    log(f"[kernels] int4 micro-benchmark variants vs plain versions and the "
        f"int4 kernel, then the micro-benchmark ({card}; us a call, "
        f"bfloat16, weight cold in L2)")
    micro = check_int4_micro(device)
    log(f"[kernels] the CUDA-graph IF node (the pool's lax.cond) vs plain "
        f"version ({card})")
    gcond = check_graph_cond(device)
    log(f"[kernels] the CUDA-graph WHILE node (the decode loop's "
        f"lax.while_loop) vs plain version ({card})")
    gwhile = check_graph_while(device)
    log(f"[kernels] the Philox kernel (the state's random stream, JAX's "
        f"jax.random draws) vs plain version ({card})")
    rand = check_philox(device)
    lap("kernels")

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
        "int8_weights": (build_engine(mcfg, q8), ("int8_mma",)),
        "int4_weights": (int4_eng, ("int4_mma", "int8_mma")),
        "int8_weights_int8_kv": (build_engine(mcfg, q8, kv_quant="int8"),
                                 ("int8_mma",)),
        "int4_weights_pipelined": (int4_eng, ("int4_pipe_mma", "int8_mma")),
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
    lap("main path")

    log(f"[profile] ({card})")
    profile_path("bf16", configs["bf16"][0], prompt, card,
                 ("lookahead", "ar_baseline"))
    for name in ("int8_weights", "int4_weights"):
        profile_path(name, configs[name][0], prompt, card, ("lookahead",))
    lap("profile")

    log(f"[paged serving] ({card}); {LANES} lanes, pages of {PAGE}, "
        f"{N_PAGES} data pages, {STEPS_PER_SYNC} steps between host reads")
    paged_launches, paged_stats = {}, {}
    for name, tree, kvq, flat_name, full in (
            ("paged_bf16", params, None, "bf16", True),
            ("paged_int8_weights_int8_kv", q8, "int8",
             "int8_weights_int8_kv", False)):
        paged_launches[name], paged_stats[name] = paged_path(
            name, mcfg, tree, configs[flat_name][0], nxt, card, kvq, full)
    assert paged_launches["paged_int8_weights_int8_kv"]["int8_mma"] > 0
    log(f"[profile, paged] ({card})")
    for name, st in paged_stats.items():
        profile_paged(name, st["engine"], nxt, card, st["step_s"])
    lap("paged serving")

    # head_dim 256: its own model, engines and counts (the entries below
    # keep the headline's launches apart from these)
    log(f"[main path, head_dim 256] ({card}); bf16_head_dim_256: the LLaMA "
        f"layer at Gemma-2B's widths (hidden 2048, intermediate 16384, 18 "
        f"layers, 8 query heads, 1 KV head, head_dim 256), reduced: vocab "
        f"32000 (Gemma's 256000), SwiGLU for GeGLU, no norm offset or "
        f"embedding scale; L7/W20/G20, M={MAX_SEQ}, {PROMPT_LEN}-token "
        f"prompt, {N_NEW_256} new tokens")
    mcfg256, params256, prompt256, nxt256 = build_headline(device, ARCH_256)
    eng256 = build_engine(mcfg256, params256)
    launches256, _, _ = main_path(
        "bf16_head_dim_256", eng256, prompt256, nxt256, card, (), N_NEW_256)
    profile_path("bf16_head_dim_256", eng256, prompt256, card,
                 ("lookahead", "ar_baseline"))
    log(f"[paged serving, head_dim 256] ({card}); {LANES} lanes, pages of "
        f"{PAGE}, {N_PAGES} data pages, {PAGED_NEW_256} new tokens a request")
    paged256, paged256_engine = paged_shared_prefix(
        "paged_bf16_head_dim_256", mcfg256, params256, eng256, nxt256, card,
        PAGED_NEW_256)
    lap("head_dim 256 paths")

    log(f"[sampling] ({card}); the headline bf16 engine (L{LEVEL}/W{WINDOW}/"
        f"G{GUESS}, M={MAX_SEQ}, {PROMPT_LEN}-token prompt)")
    check_sampling_function(device, card)
    samp_launches, samp_info = sampling_path(configs["bf16"][0], mcfg,
                                             params, prompt, nxt, card)
    lap("sampling")

    log(f"[continuous batching] ({card}); ContinuousBatchingEngine on the "
        f"headline bf16 engine, {CB_LANES} lanes, {CB_SYNC} steps between "
        f"host reads")
    cb_launches, _ = serving_path(configs["bf16"][0], nxt, card,
                                  samp_info["t_star"])
    lap("continuous batching")

    log(f"[model coverage] ({card}); Llama-3.2-1B's config through "
        f"LlamaConfig.from_hf at full width and depth (reduced: synthetic "
        f"weights, untied head, vocab kept), L{LEVEL}/W{WINDOW}/G{GUESS}, "
        f"M={MAX_SEQ}, {N_NEW_QUANT} new tokens; dynamic-NTK on the headline "
        f"model (max_position_embeddings {DYN_MAX_POS}, factor {DYN_FACTOR}, "
        f"M={DYN_SEQ}, {DYN_PROMPT}-token prompt, {DYN_NEW} new tokens); "
        f"head_dim {sorted(ARCH_SMALL_D)} at {SMALL_D_LAYERS} layers, "
        f"{SMALL_D_NEW} new tokens")
    cov_flat, cov_paged = model_coverage(device, card, params, nxt)
    lap("model coverage")

    log(f"[learned model] ({card}); train_synthetic's model (vocab 2048, "
        f"hidden 512, intermediate 1280, 6 layers, 8/4 heads, D=64) trained "
        f"in float32 on the order-{LEARNED_ORDER} corpus over "
        f"{LEARNED_ACTIVE} active tokens (Adam, batch {LEARNED_BATCH} x "
        f"{LEARNED_SEQ}, lr {LEARNED_LR}, up to {LEARNED_STEPS} steps or "
        f"{LEARNED_BUDGET_S:.0f} s); served in bf16 and float32 at "
        f"M={MAX_SEQ}, a {LEARNED_PROMPT}-token prompt, {LEARNED_NEW} new "
        f"tokens")
    learned, learned16 = learned_model(device, card)
    lap("learned model")

    log(f"[parallel] ({card}); {PAR_RANKS} ranks on the one card over gloo "
        f"(parallel/launch.py), the headline model at full width and depth "
        f"built on each rank, L{LEVEL}/W{WINDOW}/G{GUESS}, M={MAX_SEQ}, "
        f"{PROMPT_LEN}-token prompt, {PAR_NEW} new tokens; meshes "
        f"{[name for name, _, _ in PAR_MESHES]}")
    torch.cuda.empty_cache()
    par = parallel_phase(card, tokens, step_s)
    lap("parallel")

    log(f"[captured step] ({card}); each decode step replayed as a CUDA "
        f"graph, the pool's chain an IF node, against the same step run "
        f"eagerly (graphs.eager()) on the same engine: bf16, int8_weights, "
        f"int4_weights, int8_weights_int8_kv, bf16's AR baseline and "
        f"sampling at T*, paged_bf16, the learned model in bf16 at "
        f"{LEARNED_CANDIDATES}; ms a step of the step alone in windows of "
        f"{CAPTURE_STEPS} steps (8 paged), eager, graphed, graphed, eager; "
        f"the paged admission of paged_bf16, paged_int8_weights_int8_kv and "
        f"paged_bf16_head_dim_256 ({ADMIT_NEW} new tokens a request)")
    admissions, sampled = captured_phase(
        configs, prompt,
        {"paged_bf16": (paged_stats["paged_bf16"]["engine"], nxt),
         "paged_int8_weights_int8_kv": (
             paged_stats["paged_int8_weights_int8_kv"]["engine"], nxt),
         "paged_bf16_head_dim_256": (paged256_engine, nxt256)},
        nxt, card, samp_info["t_star"], learned16, (mcfg, params))
    lap("captured step")

    log(f"[request graph] ({card}); a flat call without a prefix as one "
        f"CUDA graph (resets, seeding, fill, the prefill's WHILE node, the "
        f"decode loop's WHILE node), launched once and read once, against "
        f"today's path (the preparation op by op, the prefill's chunk "
        f"replayed a chunk, the decode loop's own graph) and eager, on the "
        f"headline engines; {PROMPT_LEN}-token prompts unless named")
    request_phase(configs, prompt, nxt, card, samp_info["t_star"],
                  (mcfg, params))
    lap("request graph")

    log(f"[prefix and batch request graphs] ({card}); a flat call past a "
        f"{PREFIX_LEN}-token prefix and a whole {BATCH_LANES}-lane "
        f"generate_batch as one CUDA graph (the prefix copied from the "
        f"engine's prefix source; the lanes prepared by a WHILE node over "
        f"them, each lane's prefill a WHILE node nested in it), launched "
        f"once and read once, against today's path and eager")
    prefix_batch_phase(configs, prompt, nxt, card, samp_info["t_star"])
    lap("prefix and batch request graphs")

    log(f"[mesh step captured] ({card}); a one-rank NCCL world "
        f"(parallel/launch.py --nproc 1 --backend nccl), the headline "
        f"model on make_mesh(tp=1) and without a mesh, {PAR_NEW} new "
        f"tokens ({PAR_BATCH_NEW} a batch lane), eager and graphed (the "
        f"decode loop on the device); a WHILE node over the world group's "
        f"collectives")
    torch.cuda.empty_cache()
    nccl_phase(card, tokens, samp_info["t_star"])
    lap("mesh step captured")

    # phase 8's paths that step through the paged kernel (generate_batch
    # and the paged engine) and those that run the flat one
    samp_paged = {path: got for path, got in samp_launches.items()
                  if got["paged_attention"]}
    samp_flat = {path: got for path, got in samp_launches.items()
                 if path not in samp_paged}

    def on_paged_path(int8_kv):
        by_path = {name: got["paged_attention"]
                   for name, got in paged_launches.items()
                   if name.endswith("int8_kv") == int8_kv}
        if not int8_kv:
            by_path.update({f"sampling {path}": got["paged_attention"]
                            for path, got in samp_paged.items()})
            by_path.update({f"continuous batching {path}":
                            got["paged_attention"]
                            for path, got in cb_launches.items()})
        total = sum(by_path.values())
        assert total > 0, "the paged path never launched its kernel"
        return dict(launches=total, launches_by_path=by_path)

    def on_main_path(kernel, runs=launches):
        by_path = {name: {path: got[kernel] for path, got in paths.items()}
                   for name, paths in runs.items()}
        total = sum(n for paths in by_path.values() for n in paths.values())
        assert total > 0, f"the main path never launched {kernel}"
        return dict(launches=total, launches_by_path=by_path)

    tpu_mm = "lookaheaddecoding_tpu/ops/quant_matmul.py"
    log(json.dumps({"kernels": [
        dict(name="lookahead_attention", route="cuda",
             source=CSRC + "lookahead_attention.cu", replaces=TPU_KERNELS,
             main_path="generate and generate_baseline, every "
             "configuration; phase 8's sampling, stream and prefix paths; "
             "phase 9's prefills and fused drains; phase 10's "
             "llama3.2-1b_layer and dynamic_ntk; phase 11's autotune of "
             "the learned model in bf16 (its float32 runs launch the FMA "
             "design: launches_float32)",
             **on_main_path("attention_mma", {
                 **launches, "sampling": samp_flat,
                 "continuous batching": cb_launches,
                 **{name: cov_flat[name] for name in (
                     "llama3.2-1b_layer", "dynamic_ntk")},
                 "learned_bf16": learned["learned_bf16"]}),
             launches_float32=sum(got["attention_fma"] for got in
                                  learned["learned_float32"].values()),
             row0_bit_equal=True, row0_max_abs_err=row0_err,
             tp2_heads_max_abs_err=att_tp2["max_abs_err"],
             tp2_heads_int8_kv_max_abs_err=att_tp2["int8_kv"]["max_abs_err"],
             launches_parallel_by_rank={name: [
                 p["lookahead"]["attention_mma"]
                 + p["ar_baseline"]["attention_mma"] for p in per]
                 for name, per in par.items()},
             **att),
        dict(name="int8_matmul", route="cuda", source=CSRC + "quant_matmul.cu",
             replaces=tpu_mm + ":274", main_path="int8_weights, "
             "int8_weights_int8_kv, the int4 configurations' LM head",
             **on_main_path("int8_mma"),
             launches_parallel_by_rank=[
                 p["lookahead"]["int8_mma"] + p["ar_baseline"]["int8_mma"]
                 for p in par["int8_weights_tp2"]],
             **mm["int8"]),
        dict(name="int4_matmul", route="cuda", source=CSRC + "quant_matmul.cu",
             replaces=tpu_mm + ":32", main_path="int4_weights",
             **on_main_path("int4_mma"), **mm["int4"]),
        dict(name="int4_matmul_pipe", route="cuda",
             source=CSRC + "quant_matmul.cu", replaces=tpu_mm + ":69",
             main_path="int4_weights_pipelined",
             **on_main_path("int4_pipe_mma"), **mm["int4_pipe"]),
        dict(name="paged_lookahead_attention", route="cuda",
             source=CSRC + "lookahead_attention.cu",
             replaces=TPU_PAGED_KERNEL, main_path="paged_bf16; phase 8's "
             "generate_batch and paged sampling",
             **on_paged_path(False),
             launches_parallel_by_rank={name: [p["batch_paged"] for p in per]
                                        for name, per in par.items()},
             tp2_heads_max_abs_err=patt_tp2[False]["max_abs_err"],
             tp2_heads_int8_kv_max_abs_err=patt_tp2[True]["max_abs_err"],
             admission_launches_a_chunk=admissions,
             **patt[False]),
        dict(name="paged_lookahead_attention_int8_kv", route="cuda",
             source=CSRC + "lookahead_attention.cu",
             replaces=TPU_PAGED_KERNEL,
             main_path="paged_int8_weights_int8_kv",
             **on_paged_path(True), **patt[True]),
        dict(name="lookahead_attention_head_dim_256", route="cuda",
             source=CSRC + "lookahead_attention.cu", replaces=TPU_KERNELS,
             main_path="bf16_head_dim_256 generate and generate_baseline",
             **on_main_path("attention_mma",
                            {"bf16_head_dim_256": launches256}),
             **att256),
        dict(name="paged_lookahead_attention_head_dim_256", route="cuda",
             source=CSRC + "lookahead_attention.cu",
             replaces=TPU_PAGED_KERNEL, main_path="paged_bf16_head_dim_256",
             launches=paged256["paged_attention"], **patt256[False],
             int8_kv=patt256[True]),
        *[entry for d in HEADS_SMALL for entry in (
            dict(name=f"lookahead_attention_head_dim_{d}", route="cuda",
                 source=CSRC + "lookahead_attention.cu",
                 replaces=TPU_KERNELS,
                 main_path=f"bf16_head_dim_{d} generate, generate_baseline "
                 f"and the prefills of its ContinuousBatchingEngine run",
                 launches=(sum(cov_flat[f"bf16_head_dim_{d}"][path][
                     "attention_mma"] for path in ("lookahead", "ar_baseline"))
                     + cov_paged[f"bf16_head_dim_{d}"]["attention_mma"]),
                 **att_small[d]),
            dict(name=f"paged_lookahead_attention_head_dim_{d}",
                 route="cuda", source=CSRC + "lookahead_attention.cu",
                 replaces=TPU_PAGED_KERNEL,
                 main_path=f"bf16_head_dim_{d}'s ContinuousBatchingEngine "
                 f"lanes",
                 launches=cov_paged[f"bf16_head_dim_{d}"]["paged_attention"],
                 **patt_small[d][False], int8_kv=patt_small[d][True]))],
        dict(name="graph_cond_if_node", route="cuda",
             source=CSRC + "graph_cond.cu",
             replaces="lookaheaddecoding_tpu/core/pool.py:144 (lax.cond; "
             "not a pl.pallas_call)",
             main_path="the pool update's chain, an IF node of every "
             "captured lookahead step (phase 4; phase 13 adds the sampling, "
             "paged and learned-model steps)",
             **on_main_path("set_if"), **gcond),
        dict(name="graph_cond_while_node", route="cuda",
             source=CSRC + "graph_cond.cu",
             replaces="lookaheaddecoding_tpu/core/step.py:520 (lax.while_loop "
             "of decode_loop; :568 baseline_loop; not a pl.pallas_call)",
             main_path="the prefill and the decode loop of every request "
             "graph, two nodes a call: greedy generate and "
             "generate_baseline (phase 4; phase 8's sampling calls; phase "
             "13 adds dynamic_ntk, the learned model, generate_sample, "
             "always_fwd_one=False and the request-graph cases); the decode "
             "loop of greedy and sampled generate_batch, one a call, beside "
             "each lane's prepare graph's prefill node",
             **on_main_path("set_while"), **gwhile),
        dict(name="philox", route="cuda", source=CSRC + "philox.cu",
             replaces="lookaheaddecoding_tpu/core/step.py:104 (jax.random "
             "draws from DecodeState.rng; :207, :217, key :318; not a "
             "pl.pallas_call)",
             main_path="the window's copy_from seeding of every request "
             "(phase 4: one launch a call); every sampling step (phase 8, "
             "phase 13's sampling loops on the device) and every "
             "always_fwd_one=False step; numbers at 1 lane, batch4 at 4",
             **on_main_path("philox", {
                 **launches, "sampling": samp_launches,
                 "captured sampling loops": sampled}),
             batch4=rand[4], **rand[1]),
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
