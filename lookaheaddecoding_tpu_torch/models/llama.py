"""LLaMA-family decoder in PyTorch (flat or paged KV cache, no gradients).

The same model and the same data formats as
``lookaheaddecoding_tpu.models.llama``:

- parameters are a dict of tensors with every per-layer weight stacked on a
  leading ``L`` axis, projections in ``[in, out]`` orientation (``x @ W``);
- the KV cache is a preallocated KV-head-major ``[L, Hkv, M, D]`` buffer
  per K and V, written in place at the slots of each call's tokens; the
  int8 cache is a ``{"q": int8 [L, Hkv, M, D], "s": f32 [L, Hkv, M, 1]}``
  dict per K and V, quantized per slot and KV head as it is written;
- a projection may be a quantized dict (``ops/quant.py``) in place of a
  tensor, and q/k/v and gate/up may be fused into ``wqkv`` / ``w_gate_up``
  (``fuse_params``); every projection goes through ``ops/quant.py:qmatmul``;
- RMSNorm statistics, rotary tables, attention logits and softmax are fp32.

Parameter tree (``L`` layers):

    embed [V, H]; final_norm [H]; lm_head [H, V] (absent when tied)
    layers: input_norm, post_norm [L, H]; wq [L, H, Hq*D];
            wk, wv [L, H, Hkv*D]; wo [L, Hq*D, H]; w_gate, w_up [L, H, I];
            w_down [L, I, H]; bq, bk, bv (attention_bias only)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    # None or ("linear", factor); the other scalings are not ported yet
    rope_scaling: Optional[Tuple[str, Any]] = None
    tie_word_embeddings: bool = False
    attention_bias: bool = False      # qkv projection biases
    # a query at position p attends keys in (p - sw, p]; None = full
    sliding_window: Optional[int] = None
    hidden_act: str = "silu"          # "silu" | "gelu_pytorch_tanh" | "gelu"
    rms_norm_offset: float = 0.0      # effective norm weight = offset + w
    scale_embeddings: bool = False    # x *= sqrt(hidden_size) after embed
    head_dim_override: Optional[int] = None
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_attention_heads


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _param_shapes(cfg: LlamaConfig) -> Dict[str, tuple]:
    h, hq, hkv, d = (cfg.hidden_size, cfg.num_attention_heads,
                     cfg.num_key_value_heads, cfg.head_dim)
    n, inter = cfg.num_hidden_layers, cfg.intermediate_size
    return {"wq": (n, h, hq * d), "wk": (n, h, hkv * d),
            "wv": (n, h, hkv * d), "wo": (n, hq * d, h),
            "w_gate": (n, h, inter), "w_up": (n, h, inter),
            "w_down": (n, inter, h)}


def _to_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:            # e.g. arrays from jax.device_get
        a = a.copy()
    if a.dtype.name == "bfloat16":       # ml_dtypes bf16: carry the bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype).contiguous()


def params_from_numpy(tree: Dict, cfg: LlamaConfig, device="cuda") -> Dict:
    """The port's parameters from a tree of numpy arrays with the JAX
    package's names and layouts (what ``jax.device_get(init_params(...))``
    returns, quantized or fused or not). Floating leaves are cast to
    ``cfg.dtype``; inside a quantized dict every leaf keeps its type (int8
    values, float32 scales, the zero-element ``q4_pad`` sentinel)."""
    keep = {"int8": torch.int8, "float32": torch.float32}

    def weight(v):
        if isinstance(v, dict):
            return {k: _to_tensor(a, keep[np.asarray(a).dtype.name], device)
                    for k, a in v.items()}
        return _to_tensor(v, cfg.dtype, device)

    out = {k: weight(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: weight(v) for k, v in tree["layers"].items()}
    return out


def init_params(cfg: LlamaConfig, seed: int = 0, scale: float = 0.02,
                device="cuda") -> Dict:
    """Random-normal parameters made with numpy from ``seed`` (tests and
    synthetic benchmarks), one leaf at a time so host memory holds at most
    one stacked weight."""
    rng = np.random.default_rng(seed)
    h, n = cfg.hidden_size, cfg.num_hidden_layers

    def nrm(shape):
        return _to_tensor(rng.standard_normal(shape, dtype=np.float32) * scale,
                          cfg.dtype, device)

    def ones(shape):
        return torch.full(shape, 1.0 - cfg.rms_norm_offset, dtype=cfg.dtype,
                          device=device)

    params = {"embed": nrm((cfg.vocab_size, h)),
              "layers": {"input_norm": ones((n, h)),
                         "post_norm": ones((n, h))},
              "final_norm": ones((h,))}
    for name, shape in _param_shapes(cfg).items():
        params["layers"][name] = nrm(shape)
    if cfg.attention_bias:
        for name, width in (("bq", cfg.num_attention_heads),
                            ("bk", cfg.num_key_value_heads),
                            ("bv", cfg.num_key_value_heads)):
            params["layers"][name] = torch.zeros(
                (n, width * cfg.head_dim), dtype=cfg.dtype, device=device)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = nrm((h, cfg.vocab_size))
    return params


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             offset: float = 0.0) -> torch.Tensor:
    """fp32-statistics RMSNorm; ``offset`` 1.0 gives effective weight 1 + w."""
    xf = x.float()
    out = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (out * (offset + weight.float())).to(x.dtype)


def act_fn(cfg: LlamaConfig):
    """Gate activation: SwiGLU for LLaMA-family, GeGLU for Gemma."""
    if cfg.hidden_act == "silu":
        return F.silu
    if cfg.hidden_act == "gelu_pytorch_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    if cfg.hidden_act == "gelu":
        return F.gelu
    raise NotImplementedError(f"hidden_act '{cfg.hidden_act}'")


def _rope_kind(cfg: LlamaConfig) -> Optional[str]:
    kind = cfg.rope_scaling[0] if cfg.rope_scaling is not None else None
    if kind not in (None, "linear"):
        raise NotImplementedError(
            f"rope_scaling '{kind}' is not ported yet (supported: linear)")
    return kind


def rope_inv_freq(cfg: LlamaConfig) -> np.ndarray:
    """Inverse rotary frequencies (float32), computed in float64."""
    _rope_kind(cfg)
    d = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, d, 2, dtype=np.float64) / d))
    return inv.astype(np.float32)


def rope_tables(cfg: LlamaConfig, max_len: int,
                device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """[max_len, head_dim] fp32 cos/sin tables, computed in numpy exactly as
    the JAX package computes them."""
    inv = rope_inv_freq(cfg)
    t = np.arange(max_len, dtype=np.float32)
    if _rope_kind(cfg) == "linear":
        t = t / cfg.rope_scaling[1]
    freqs = np.outer(t, inv)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return (torch.from_numpy(np.cos(emb)).to(device),
            torch.from_numpy(np.sin(emb)).to(device))


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [T, n_heads, d]; cos/sin [T, d] for these positions; rotate-half."""
    xf = x.float()
    half = x.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos[:, None, :] + rot * sin[:, None, :]).to(x.dtype)


def attention_dense(q: torch.Tensor, k, v, mask: torch.Tensor) -> torch.Tensor:
    """Dense masked attention over the whole cache. q [T, Hq, D]; k, v
    [Hkv, M, D] tensors or int8 ``{"q", "s"}`` dicts; mask [T, M] additive
    fp32 (0 or -inf). GQA through the reshape q -> [Hkv, rep*T, D]. Logits
    and softmax in fp32; the probabilities are cast to v's dtype (q's for
    an int8 v) before the PV product, whose sum is fp32 (the JAX
    ``attention_xla`` contract). The int8 cache's per-slot scales multiply
    the scores and the probabilities, so no dequantized copy of the cache
    is made. Returns [T, Hq*D] fp32."""
    k, ks = (k["q"], k["s"]) if isinstance(k, dict) else (k, None)
    v, vs = (v["q"], v["s"]) if isinstance(v, dict) else (v, None)
    t, hq, d = q.shape
    hkv, m, _ = k.shape
    rep = hq // hkv
    qh = q.transpose(0, 1).reshape(hkv, rep * t, d)
    scores = torch.matmul(qh.float(), k.float().transpose(1, 2)) / math.sqrt(d)
    if ks is not None:
        scores = scores * ks[:, None, :, 0]                  # [Hkv, 1, M]
    scores = scores.view(hkv, rep, t, m) + mask[None, None]
    probs = torch.softmax(scores, dim=-1)
    if vs is not None:
        probs = probs * vs[:, None, None, :, 0]              # [Hkv, 1, 1, M]
    probs = probs.to(q.dtype if v.dtype == torch.int8 else v.dtype)
    out = torch.matmul(probs.float(), v.float()[:, None])   # [Hkv, rep, T, D]
    return out.permute(2, 0, 1, 3).reshape(t, hq * d)


def write_slots(start, t: int, m: int):
    """Cache slots of ``t`` tokens written from ``start``: the host int
    itself, or a [t] index tensor for a device scalar. The start is clamped
    to [0, m - t], the clamp of ``lax.dynamic_update_slice``; an index past
    the buffer would be a device-side assert on CUDA. The clamp binds only
    on a step taken after ``finished``, whose writes no later read sees."""
    if isinstance(start, int):
        return min(max(start, 0), m - t)
    return start.clamp(0, m - t) + torch.arange(t, device=start.device)


def kv_cache_write(cache, new: torch.Tensor, slots):
    """Write [T, Hkv, D] values into a KV-head-major [Hkv, M, D] buffer in
    place, at ``slots`` from :func:`write_slots`. An int8 cache dict takes
    the values quantized per slot and KV head (symmetric: scale
    ``max(amax * float32(1 / 127), 1e-8)``, as XLA compiles the JAX
    package's ``amax / 127.0`` inside its jitted step; a true division
    ``new / scale``, round half to even, clip to +-127) and their scales.
    Returns the buffer."""
    if isinstance(cache, dict):
        nf = new.float()
        s = (nf.abs().amax(dim=-1, keepdim=True) * (1.0 / 127.0)).clamp_min(1e-8)
        qv = torch.round(nf / s).clamp_(-127, 127).to(torch.int8)
        kv_cache_write(cache["q"], qv, slots)
        kv_cache_write(cache["s"], s, slots)
        return cache
    if isinstance(slots, int):
        cache[:, slots:slots + new.shape[0]] = new.transpose(0, 1)
    else:
        cache.index_copy_(1, slots, new.transpose(0, 1))
    return cache


def make_kv_cache(cfg: LlamaConfig, max_seq: int, device="cuda",
                  quant: Optional[str] = None):
    """Zeroed KV-head-major cache buffers [L, Hkv, M, D] for K and V;
    ``quant="int8"`` gives int8 values with float32 scales [L, Hkv, M, 1]
    (filled with 1e-8) for each."""
    shape = (cfg.num_hidden_layers, cfg.num_key_value_heads, max_seq,
             cfg.head_dim)
    if quant is None:
        return (torch.zeros(shape, dtype=cfg.dtype, device=device),
                torch.zeros(shape, dtype=cfg.dtype, device=device))
    if quant != "int8":
        raise ValueError(f"unsupported kv quantization: {quant}")

    def make():
        return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                "s": torch.full(shape[:-1] + (1,), 1e-8,
                                dtype=torch.float32, device=device)}
    return make(), make()


def fuse_params(params: Dict, qkv: bool = True, gate_up: bool = True) -> Dict:
    """Fuse the per-layer q/k/v and/or gate/up projections into single wide
    products (``wqkv``, ``bqkv``, ``w_gate_up``), for plain tensors and
    for quantized dicts alike: a concatenation of output channels commutes
    with per-output-channel quantization. A mix of plain and quantized
    parts stays unfused."""
    lp = params["layers"]

    def cat(ws):
        if not isinstance(ws[0], dict):
            if any(isinstance(w, dict) for w in ws):
                return None
            return torch.cat(ws, dim=-1)
        qkey = "q" if "q" in ws[0] else "q4"
        if not all(isinstance(w, dict) and qkey in w for w in ws):
            return None
        out = {qkey: torch.cat([w[qkey] for w in ws], dim=-1),
               "scale": torch.cat([w["scale"] for w in ws], dim=-1)}
        if all("q4_pad" in w for w in ws):
            # same K, same pad rows: the concatenation of the zero-element
            # sentinels also checks that their shapes agree
            out["q4_pad"] = torch.cat([w["q4_pad"] for w in ws], dim=-1)
        return out

    new_lp = dict(lp)
    if qkv and "wqkv" not in lp:
        wqkv = cat([lp["wq"], lp["wk"], lp["wv"]])
        if wqkv is not None:
            for k in ("wq", "wk", "wv", "bq", "bk", "bv"):
                new_lp.pop(k, None)
            new_lp["wqkv"] = wqkv
            if "bq" in lp:
                new_lp["bqkv"] = torch.cat([lp["bq"], lp["bk"], lp["bv"]],
                                           dim=-1)
    if gate_up and "w_gate_up" not in lp:
        w_gate_up = cat([lp["w_gate"], lp["w_up"]])
        if w_gate_up is not None:
            for k in ("w_gate", "w_up"):
                new_lp.pop(k, None)
            new_lp["w_gate_up"] = w_gate_up
    return {**params, "layers": new_lp}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def forward(
    params: Dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,        # [T] int composite / prefill chunk
    positions: torch.Tensor,     # [T] int absolute positions
    k_cache,                     # [L, Hkv, M, D] or an int8 {"q", "s"}
    v_cache,                     # dict; written in place
    write_start,                 # host int or device scalar: slot of tokens[0]
    rope_cos: torch.Tensor,      # [M, D] fp32
    rope_sin: torch.Tensor,
    attn_meta: Dict,             # kv_len, level, window, guess_size[, causal,
                                 # sliding_window]: the attention's visibility
    logits_rows: Optional[torch.Tensor] = None,  # rows gathered before lm_head
    attn_impl: str = "dense",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One forward over the layer stack. The tokens' K/V are written at
    slots [write_start, write_start+T) of every layer; attention then reads
    the whole buffer under the composite or causal visibility that
    ``attn_meta`` describes (``ops/lookahead_attention.py``), through the
    plain version (``attn_impl="dense"``) or the attention kernel's wrapper
    (``attn_impl="kernel"``). Returns (fp32 logits, k_cache, v_cache)."""
    from ..ops.lookahead_attention import (lookahead_attention,
                                           lookahead_attention_ref)

    t = tokens.shape[0]
    m = (k_cache["q"] if isinstance(k_cache, dict) else k_cache).shape[2]
    x = params["embed"][tokens]                              # [T, H]
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.hidden_size), dtype=cfg.dtype)
    # a position past the tables occurs only on a step taken after
    # ``finished``; clamp as a JAX gather does instead of asserting
    pos = positions.clamp(0, rope_cos.shape[0] - 1)
    cos, sin = rope_cos[pos], rope_sin[pos]
    slots = write_slots(write_start, t, m)
    attend = lookahead_attention if attn_impl == "kernel" \
        else lookahead_attention_ref
    meta = dict(attn_meta)
    kv_len = meta.pop("kv_len")

    def attention(li, q, k, vv):
        kc = kv_cache_write(_layer(k_cache, li), k, slots)
        vc = kv_cache_write(_layer(v_cache, li), vv, slots)
        return attend(q, kc, vc, kv_len, **meta)

    x = _decoder_layers(params, cfg, x, cos, sin, attention)
    return _logits(params, cfg, x, logits_rows), k_cache, v_cache


def _layer(tree, li):
    """Layer ``li`` of a stacked tensor, or of every leaf of a dict."""
    if isinstance(tree, dict):
        return {name: leaf[li] for name, leaf in tree.items()}
    return tree[li]


def _decoder_layers(params, cfg: LlamaConfig, x, cos, sin, attention):
    """The layer stack on rows x [R, H] with rotary tables cos/sin [R, D].
    ``attention(li, q [R, Hq, D], k [R, Hkv, D], v [R, Hkv, D])`` writes the
    rows' K and V into layer ``li`` of the cache and returns the attention
    output [R, Hq*D]; the flat and the paged forward differ only there."""
    from ..ops.quant import qmatmul

    hq, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    inter = cfg.intermediate_size
    t = x.shape[0]
    lp = params["layers"]
    act = act_fn(cfg)
    for li in range(cfg.num_hidden_layers):
        y = rms_norm(x, lp["input_norm"][li], cfg.rms_norm_eps,
                     cfg.rms_norm_offset)
        if "wqkv" in lp:         # fused projections (fuse_params)
            qkv = qmatmul(y, _layer(lp["wqkv"], li))
            if cfg.attention_bias:
                qkv = qkv + lp["bqkv"][li]
            q, k, vv = qkv.split((hq * d, hkv * d, hkv * d), dim=1)
        else:
            q = qmatmul(y, _layer(lp["wq"], li))
            k = qmatmul(y, _layer(lp["wk"], li))
            vv = qmatmul(y, _layer(lp["wv"], li))
            if cfg.attention_bias:
                q, k, vv = q + lp["bq"][li], k + lp["bk"][li], vv + lp["bv"][li]
        # the fused split hands out column slices; the kernel takes a
        # contiguous q (a no-op for the unfused layout)
        q = apply_rope(q.reshape(t, hq, d), cos, sin).contiguous()
        k = apply_rope(k.reshape(t, hkv, d), cos, sin)
        attn = attention(li, q, k, vv.reshape(t, hkv, d))
        x = x + qmatmul(attn.to(cfg.dtype), _layer(lp["wo"], li))
        y = rms_norm(x, lp["post_norm"][li], cfg.rms_norm_eps,
                     cfg.rms_norm_offset)
        if "w_gate_up" in lp:
            gate_in, up = qmatmul(y, _layer(lp["w_gate_up"], li)).split(
                (inter, inter), dim=1)
        else:
            gate_in = qmatmul(y, _layer(lp["w_gate"], li))
            up = qmatmul(y, _layer(lp["w_up"], li))
        gate = act(gate_in.float()).to(cfg.dtype)
        x = x + qmatmul(gate * up, _layer(lp["w_down"], li))
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps,
                    cfg.rms_norm_offset)


def _logits(params, cfg: LlamaConfig, x, rows):
    """fp32 logits of the normed rows x [R, H] (or [B, T, H]), gathered at
    ``rows`` of the second-to-last axis first when given."""
    from ..ops.quant import qmatmul

    if rows is not None:
        x = x.index_select(x.dim() - 2, rows)
    head = params.get("lm_head")
    if head is None:
        return (x @ params["embed"].T).float()
    lead = x.shape[:-1]
    return qmatmul(x.reshape(-1, x.shape[-1]), head).float().view(
        *lead, cfg.vocab_size)


def forward_paged(
    params: Dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,        # [B, T] int composite / prefill chunk
    positions: torch.Tensor,     # [B, T] int absolute positions per lane
    k_pool,                      # [L, Hkv, P, D] shared pool or an int8
    v_pool,                      # {"q", "s"} dict; written in place
    tables: torch.Tensor,        # [B, NB] int32 logical -> physical page
    write_start: torch.Tensor,   # [B] logical cache slot of tokens[b, 0]
    page_size: int,
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    attn_meta: Dict,             # kv_lens [B], level, window, guess_size
                                 # [, causal, sliding_window]
    logits_rows: Optional[torch.Tensor] = None,
    attn_impl: str = "dense",
    write_limit: Optional[torch.Tensor] = None,  # [B]: rows at logical slots
    trash_slot: Optional[torch.Tensor] = None,   # >= limit, or outside the
                                                 # table, write to the lane's
                                                 # trash page
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lane-batched forward over the shared paged KV pool (core/paged.py).

    B lanes write disjoint physical slots of one pool (scatters through
    each lane's page table) and attention reads each lane's logical view:
    in place through the table in the kernel (``attn_impl="kernel"``,
    ``ops/lookahead_attention.py:paged_lookahead_attention``), gathered in
    the plain version (``"dense"``). Everything else is :func:`forward`'s
    arithmetic on the B*T rows. With ``write_limit`` the rows of a padded
    prefill chunk past the prompt go to the lane's trash page (their
    logical pages may not be allocated); their outputs are discarded and no
    real row sees their columns. Returns (fp32 logits [B, R, V], k_pool,
    v_pool); a call that reads no logits row (prefill) gets [B, 0, V]."""
    from ..core.paged import paged_write, phys_slots
    from ..ops.lookahead_attention import (paged_lookahead_attention,
                                           paged_lookahead_attention_ref)

    hq, d = cfg.num_attention_heads, cfg.head_dim
    b, t = tokens.shape
    x = params["embed"][tokens.reshape(-1)]                  # [B*T, H]
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.hidden_size), dtype=cfg.dtype)
    pos = positions.reshape(-1).clamp(0, rope_cos.shape[0] - 1)
    cos, sin = rope_cos[pos], rope_sin[pos]

    slots = phys_slots(tables, write_start, t, page_size, trash=trash_slot)
    if write_limit is not None:
        m = write_start.long()[:, None] + torch.arange(t, device=x.device)
        slots = torch.where(m >= write_limit[:, None],
                            trash_slot.long()[:, None] + m % page_size, slots)
    slots = slots.reshape(-1)
    attend = paged_lookahead_attention if attn_impl == "kernel" \
        else paged_lookahead_attention_ref
    meta = dict(attn_meta)
    kv_lens = meta.pop("kv_lens")

    def attention(li, q, k, vv):
        kc = paged_write(_layer(k_pool, li), slots, k)
        vc = paged_write(_layer(v_pool, li), slots, vv)
        return attend(q.view(b, t, hq, d), kc, vc, kv_lens, tables,
                      page_size=page_size, **meta).reshape(b * t, hq * d)

    x = _decoder_layers(params, cfg, x, cos, sin, attention)
    x = x.view(b, t, -1)
    if logits_rows is not None and logits_rows.numel() == 0:
        return (torch.zeros((b, 0, cfg.vocab_size), dtype=torch.float32,
                            device=x.device), k_pool, v_pool)
    return _logits(params, cfg, x, logits_rows), k_pool, v_pool
