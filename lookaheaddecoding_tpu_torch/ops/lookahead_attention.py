"""Composite-mask lookahead attention: the mask arithmetic, the plain
PyTorch version and the wrapper of the hand-written CUDA kernel
(``csrc/lookahead_attention.cu``).

Query rows are [lst + window levels + guess n-grams] of the composite step
(core/layout.py). A committed key slot (< kv_len) is visible to every row;
the S speculative slots [kv_len, kv_len + S) follow the within-composite
mask, which ``_spec_visible`` derives from index arithmetic. Causal mode
(prefill and the AR baseline) sees every slot up to its own.

K and V are one layer of the cache: plain ``[Hkv, M, D]`` tensors of q's
dtype, or the int8 cache's ``{"q": int8 [Hkv, M, D], "s": f32 [Hkv, M, 1]}``
dicts, whose per-slot scales are applied to the scores and to the
probabilities, never to a dequantized copy of the cache.

The paged call (:func:`paged_lookahead_attention`) is the same function for
B lanes whose K and V lie in one shared page pool ``[Hkv, P, D]``
(core/paged.py), each lane with its own ``kv_len`` and page table; the
mask is evaluated in logical columns.

On a CUDA tensor :func:`lookahead_attention` and
:func:`paged_lookahead_attention` launch the kernel (one ``__global__`` for
both: the flat call is one lane with no table), or raise on an input it
does not take, with one set of checks and messages
(:func:`_check_kernel_inputs`); on a CPU tensor they run
:func:`lookahead_attention_ref` and :func:`paged_lookahead_attention_ref`.
``counts`` and ``paged_counts`` record which.
"""

from __future__ import annotations

import torch

from ..models.llama import attention_dense

# Launches of the CUDA kernel and calls of the plain version, for showing
# which one a run went through: ``counts`` by the flat wrapper,
# ``paged_counts`` by the paged one. Reset with
# ``counts.update(kernel=0, plain=0)``.
counts = {"kernel": 0, "plain": 0}
paged_counts = {"kernel": 0, "plain": 0}

KERNEL_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _spec_visible(qi, rj, *, level, window, guess_size):
    """Within-composite visibility of key ``rj`` (relative to kv_len) from
    composite row ``qi``; integer tensors of one shape. Equals
    core/layout.py:_build_spec_mask. ``//`` and ``%`` on tensors floor, as
    in the JAX package; the guess-region terms of window ids are negative
    and masked out."""
    n, w, gs = level, window, guess_size
    nw = (n - 1) * w
    q_in_win, k_in_win = qi < nw, rj < nw
    lvl_q, pos_q = qi // w, qi % w
    lvl_k, pos_k = rj // w, rj % w
    win_win = q_in_win & k_in_win & (
        ((lvl_k == 0) & (pos_k <= pos_q))
        | ((lvl_k >= 1) & (lvl_k <= lvl_q) & (pos_k == pos_q)))
    g_q, i_q = (qi - nw) // gs, (qi - nw) % gs
    g_k, i_k = (rj - nw) // gs, (rj - nw) % gs
    guess_q = (~q_in_win) & (
        (rj == 0) | ((~k_in_win) & (g_k == g_q) & (i_k <= i_q)))
    return win_win | guess_q


def _rel_pos(qi, *, level, window, guess_size):
    """Position of composite row ``qi`` relative to the last confirmed
    token (core/layout.py rel_pos)."""
    nw = (level - 1) * window
    return torch.where(qi < nw, qi // window + qi % window,
                       1 + (qi - nw) % guess_size)


def _block_mask(kv_len, m, *, s_len, level, window, guess_size, causal,
                sliding_window, device):
    """[S, M] bool visibility over the whole cache for a device scalar
    ``kv_len`` (no host read)."""
    col = torch.arange(m, device=device)[None, :]
    qi = torch.arange(s_len, device=device)[:, None]
    kv_len = kv_len.reshape(()).long()
    if causal:
        visible = col <= kv_len + qi
        if sliding_window:
            visible = visible & (col > kv_len + qi - sliding_window)
        return visible
    rel = col - kv_len
    committed = col < kv_len
    if sliding_window:
        q_pos = kv_len + _rel_pos(qi, level=level, window=window,
                                  guess_size=guess_size)
        committed = committed & (col > q_pos - sliding_window)
    return committed | ((rel >= 0) & (rel < s_len) & _spec_visible(
        qi, rel, level=level, window=window, guess_size=guess_size))


def lookahead_attention_ref(q, k, v, kv_len, *, level, window, guess_size,
                            causal=False, sliding_window=0):
    """Plain version: the [S, M] visibility of :func:`_block_mask` through
    ``models/llama.py:attention_dense`` (plain or int8 cache). Returns
    [S, Hq*D] in q's dtype."""
    m = (k["q"] if isinstance(k, dict) else k).shape[1]
    vis = _block_mask(kv_len, m, s_len=q.shape[0], level=level,
                      window=window, guess_size=guess_size, causal=causal,
                      sliding_window=sliding_window, device=q.device)
    mask = torch.zeros(vis.shape, dtype=torch.float32, device=q.device)
    mask.masked_fill_(~vis, float("-inf"))
    return attention_dense(q, k, v, mask).to(q.dtype)


def _split_kv(k, v):
    """(k values, v values, k scales, v scales) of one layer of the cache;
    the scales are None for a plain cache."""
    if isinstance(k, dict) != isinstance(v, dict):
        raise ValueError("k and v must both be plain or both be int8 caches")
    if isinstance(k, dict):
        return k["q"], v["q"], k["s"], v["s"]
    return k, v, None, None


def _check_kernel_inputs(q, k, v, lens, tables=None, page_size=0):
    """What the CUDA kernel needs of its inputs, for the flat call (q
    [S, Hq, D], one ``kv_len``) and the paged call (q [B, S, Hq, D],
    ``kv_lens`` [B], ``tables`` [B, NB]) alike: the same fault raises the
    same message in both."""
    paged = tables is not None
    k, v, ks, vs = _split_kv(k, v)
    q_dims = "[B, S, Hq, D]" if paged else "[S, Hq, D]"
    if q.dim() != 3 + paged or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"need q {q_dims} and k, v [Hkv, M, D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    s_len, hq, d = q.shape[-3:]
    lanes = q.shape[0] if paged else 1
    hkv, _, dk = k.shape
    if dk != d or hq % hkv:
        raise ValueError(f"head dims {d}/{dk} or heads {hq}/{hkv} mismatch")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    kv_dtype = q.dtype if ks is None else torch.int8
    if q.dtype not in _DTYPE_CODES or k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise ValueError(f"kernel takes float32 or bfloat16 q with k/v of "
                         f"the same dtype, or int8 k/v with scales; got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    scales = () if ks is None else (ks, vs)
    for s in scales:
        if s.dtype != torch.float32 or tuple(s.shape) != (hkv, k.shape[1], 1):
            raise ValueError(f"int8 cache scales must be float32 "
                             f"[{hkv}, {k.shape[1]}, 1], got {s.dtype} "
                             f"{tuple(s.shape)}")
    if not (isinstance(lens, torch.Tensor) and lens.dtype == torch.int32
            and lens.numel() == lanes):
        raise ValueError(f"kv_len must be an int32 tensor of {lanes} "
                         f"element(s), one a lane")
    index = (lens,)
    if paged:
        if (tables.dtype != torch.int32 or tables.dim() != 2
                or tables.shape[0] != lanes):
            raise ValueError(f"tables must be int32 [{lanes}, NB], got "
                             f"{tables.dtype} {tuple(tables.shape)}")
        if page_size < 1 or k.shape[1] % page_size:
            raise ValueError(f"the pool's {k.shape[1]} slots are not whole "
                             f"pages of {page_size}")
        index = (lens, tables)
    if not all(t.is_contiguous() for t in (q, k, v, *scales, *index)):
        raise ValueError("kernel takes contiguous q, k, v, scales, kv_len "
                         "and tables")
    if len({t.device for t in (q, k, v, *scales, *index)}) != 1:
        raise ValueError("q, k, v, scales, kv_len and tables must be on one "
                         "device")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {q.device}, but the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    if s_len < 1 or lanes < 1:
        raise ValueError("need at least one query row")


def _launch(q, k, v, lens, tables, page_size, geometry):
    """Launch the kernel on checked inputs: q [B, S, Hq, D] (B = 1 and no
    table for the flat call). Returns [B, S, Hq*D]."""
    from ._build import load
    k, v, ks, vs = _split_kv(k, v)
    lanes, s_len, hq, d = q.shape
    hkv, slots, _ = k.shape
    nb = 0 if tables is None else tables.shape[1]
    out = torch.empty((lanes, s_len, hq * d), dtype=q.dtype, device=q.device)
    err = load("lookahead_attention").lookahead_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(), lens.data_ptr(),
        None if tables is None else tables.data_ptr(),
        out.data_ptr(), _DTYPE_CODES[q.dtype], int(ks is not None),
        lanes, s_len, hq, hkv, nb * page_size if nb else slots, slots,
        page_size if nb else 0, nb, d,
        geometry["level"], geometry["window"], geometry["guess_size"],
        int(geometry["causal"]), int(geometry["sliding_window"]),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lookahead_attention kernel launch failed: "
                           f"CUDA error {err}")
    return out


def lookahead_attention(q, k, v, kv_len, *, level, window, guess_size,
                        causal=False, sliding_window=0, spec_mask=None):
    """Composite-mask attention, [S, Hq*D] in q's dtype.

    q [S, Hq, D]; k, v [Hkv, M, D] (one layer of the KV-head-major cache,
    plain or ``{"q", "s"}`` int8 dicts);
    ``kv_len`` a one-element int32 tensor on q's device, read by the kernel
    itself, so launching needs no host read. ``spec_mask`` is accepted for
    the JAX signature; both versions derive that mask from index
    arithmetic."""
    if q.device.type == "cpu":
        counts["plain"] += 1
        return lookahead_attention_ref(
            q, k, v, kv_len, level=level, window=window,
            guess_size=guess_size, causal=causal,
            sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    _check_kernel_inputs(q, k, v, kv_len)
    out = _launch(q[None], k, v, kv_len, None, 0, dict(
        level=level, window=window, guess_size=guess_size, causal=causal,
        sliding_window=sliding_window))[0]
    counts["kernel"] += 1
    return out


def paged_lookahead_attention_ref(q, k, v, kv_lens, tables, *, level, window,
                                  guess_size, page_size, causal=False,
                                  sliding_window=0):
    """Plain version of the paged call: each lane's logical view gathered
    from the pool (``core/paged.py:paged_gather``), then that lane's
    :func:`lookahead_attention_ref`. Returns [B, S, Hq*D] in q's dtype."""
    from ..core.paged import paged_gather
    kg = paged_gather(k, tables, page_size)
    vg = paged_gather(v, tables, page_size)

    def lane(tree, b):
        if isinstance(tree, dict):
            return {name: leaf[b] for name, leaf in tree.items()}
        return tree[b]
    return torch.stack([
        lookahead_attention_ref(
            q[b], lane(kg, b), lane(vg, b), kv_lens[b], level=level,
            window=window, guess_size=guess_size, causal=causal,
            sliding_window=sliding_window)
        for b in range(q.shape[0])])


def paged_lookahead_attention(q, k, v, kv_lens, tables, *, level, window,
                              guess_size, page_size, causal=False,
                              sliding_window=0):
    """Composite-mask attention of B lanes over the shared page pool,
    [B, S, Hq*D] in q's dtype.

    q [B, S, Hq, D]; k, v [Hkv, P, D] (one layer of the pool, plain or
    ``{"q", "s"}`` int8 dicts, P a multiple of ``page_size``); ``kv_lens``
    [B] and ``tables`` [B, NB] int32 on q's device, both read by the kernel
    itself. Logical key column c of lane b lies at pool slot
    ``tables[b, c // page_size] * page_size + c % page_size``; the mask is
    that of :func:`lookahead_attention` in logical columns. The kernel
    translates each key row as it loads it, so any ``page_size`` is taken,
    and it reads nothing past ``kv_len + S`` (nor below the sliding
    window), so table entries of pages a lane does not own are never
    followed for a row that counts."""
    if q.device.type == "cpu":
        paged_counts["plain"] += 1
        return paged_lookahead_attention_ref(
            q, k, v, kv_lens, tables, level=level, window=window,
            guess_size=guess_size, page_size=page_size, causal=causal,
            sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    _check_kernel_inputs(q, k, v, kv_lens, tables, page_size)
    out = _launch(q, k, v, kv_lens, tables, page_size, dict(
        level=level, window=window, guess_size=guess_size, causal=causal,
        sliding_window=sliding_window))
    paged_counts["kernel"] += 1
    return out
