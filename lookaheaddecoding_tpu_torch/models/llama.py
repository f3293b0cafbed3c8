"""LLaMA-family decoder in PyTorch: the flat and the paged forward on a KV
cache (inference), and ``forward_train``, the batched causal forward
without a cache that the training step differentiates.

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
- RMSNorm statistics, rotary tables, attention logits and softmax are fp32;
- on a mesh (``parallel/sharding.py``) the tree and the caches are the
  rank's shards, and the forward calls the collectives of
  ``parallel/collectives.py``: tp sums the row-parallel products and the
  vocabulary-sharded embedding and gathers the logits; la splits the
  composite step's rows and gathers their K/V and final hidden rows; pp
  runs its stage's layers and hands the hidden state on.

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

from ..parallel import collectives
from ..parallel.sharding import local_dims, split_sizes


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
    # rope_scaling: None, ("linear", factor), ("dynamic", factor), or the
    # static init-time transforms
    #   ("llama3", (factor, low_freq_factor, high_freq_factor,
    #               original_max_position_embeddings))
    #   ("yarn",   (factor, beta_fast, beta_slow,
    #               original_max_position_embeddings,
    #               attention_factor, truncate))
    # as flat float tuples, so the frozen config stays hashable; yarn's
    # attention_factor is resolved to a float by from_hf
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

    @classmethod
    def from_hf(cls, hf_config, dtype=torch.bfloat16) -> "LlamaConfig":
        """Build from a ``transformers`` config (LLaMA, Mistral, Qwen2 or
        Gemma), or any object with its attributes: every field is read with
        ``getattr``, so ``transformers`` is not needed."""
        scaling = None
        rs = getattr(hf_config, "rope_scaling", None)
        if rs:
            kind = rs.get("type", rs.get("rope_type", "linear"))
            # "default" appears in some configs as an explicit no-op
            if kind == "default":
                scaling = None
            elif kind in ("linear", "dynamic"):
                scaling = (kind, float(rs["factor"]))
            elif kind == "llama3":
                scaling = ("llama3", (
                    float(rs["factor"]),
                    float(rs["low_freq_factor"]),
                    float(rs["high_freq_factor"]),
                    float(rs["original_max_position_embeddings"]),
                ))
            elif kind == "yarn":
                factor = float(rs["factor"])
                att = rs.get("attention_factor")
                if att is None:
                    # the paper's mscale; the mscale/mscale_all_dim pair
                    # (DeepSeek-style checkpoints) folds into one float
                    def _mscale(scale, m=1.0):
                        return (1.0 if scale <= 1.0
                                else 0.1 * m * math.log(scale) + 1.0)
                    ms, msad = rs.get("mscale"), rs.get("mscale_all_dim")
                    if ms and msad:
                        att = _mscale(factor, ms) / _mscale(factor, msad)
                    else:
                        att = _mscale(factor)
                scaling = ("yarn", (
                    factor,
                    float(rs.get("beta_fast") or 32.0),
                    float(rs.get("beta_slow") or 1.0),
                    float(rs.get("original_max_position_embeddings")
                          or hf_config.max_position_embeddings),
                    float(att),
                    1.0 if rs.get("truncate", True) else 0.0,
                ))
            else:
                # an ignored scaling would give plausible but wrong tokens
                raise NotImplementedError(
                    f"rope_scaling type '{kind}' is not implemented "
                    "(supported: linear, dynamic, llama3, yarn)")
        model_type = getattr(hf_config, "model_type", "")
        is_gemma = model_type == "gemma"
        hidden_act = "silu"
        if is_gemma:
            # Gemma's activation (HF GemmaMLP: hidden_activation, with a
            # gelu_pytorch_tanh default, else hidden_act)
            hidden_act = (getattr(hf_config, "hidden_activation", None)
                          or getattr(hf_config, "hidden_act", None)
                          or "gelu_pytorch_tanh")
        head_dim = getattr(hf_config, "head_dim", None)
        if (head_dim is not None and head_dim
                == hf_config.hidden_size // hf_config.num_attention_heads):
            head_dim = None               # the usual coupling: no override
        return cls(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            intermediate_size=hf_config.intermediate_size,
            num_hidden_layers=hf_config.num_hidden_layers,
            num_attention_heads=hf_config.num_attention_heads,
            num_key_value_heads=getattr(
                hf_config, "num_key_value_heads",
                hf_config.num_attention_heads),
            rms_norm_eps=hf_config.rms_norm_eps,
            rope_theta=getattr(hf_config, "rope_theta", 10000.0),
            max_position_embeddings=hf_config.max_position_embeddings,
            rope_scaling=scaling,
            tie_word_embeddings=getattr(hf_config, "tie_word_embeddings",
                                        False),
            attention_bias=bool(getattr(hf_config, "attention_bias", False)
                                or model_type == "qwen2"),
            sliding_window=getattr(hf_config, "sliding_window", None),
            hidden_act=hidden_act,
            rms_norm_offset=1.0 if is_gemma else 0.0,
            scale_embeddings=is_gemma,
            head_dim_override=head_dim,
            dtype=dtype,
        )


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
    return cfg.rope_scaling[0] if cfg.rope_scaling is not None else None


def rope_inv_freq(cfg: LlamaConfig, seq_len: Optional[int] = None
                  ) -> np.ndarray:
    """Inverse rotary frequencies (float32), computed in float64: the base
    rescaled for dynamic-NTK once ``seq_len`` passes
    ``max_position_embeddings``, and llama3's and YaRN's static transforms
    (the JAX package's ``rope_inv_freq``, equal bit for bit)."""
    d = cfg.head_dim
    base = cfg.rope_theta
    kind = _rope_kind(cfg)
    if kind == "dynamic":
        factor = cfg.rope_scaling[1]
        max_pos = cfg.max_position_embeddings
        if seq_len is not None and seq_len > max_pos:
            base = base * ((factor * seq_len / max_pos)
                           - (factor - 1)) ** (d / (d - 2))
    inv = 1.0 / (base ** (np.arange(0, d, 2, dtype=np.float64) / d))
    if kind == "llama3":
        # wavelength bands: wavelengths past the pretraining context are
        # interpolated by ``factor``, short ones kept, the band between
        # blended linearly in rotations over the old context
        factor, low_ff, high_ff, old_ctx = cfg.rope_scaling[1]
        wavelen = 2.0 * np.pi / inv
        rotations = old_ctx / wavelen
        blend = (rotations - low_ff) / (high_ff - low_ff)
        inv = np.where(
            wavelen > old_ctx / low_ff, inv / factor,
            np.where(wavelen < old_ctx / high_ff, inv,
                     ((1.0 - blend) / factor + blend) * inv))
    elif kind == "yarn":
        # YaRN (arXiv:2309.00071): a per-dimension blend of interpolated
        # (inv / factor) and extrapolated (inv) frequencies over a ramp
        # bounded by the beta_fast / beta_slow rotation counts
        factor, beta_fast, beta_slow, old_ctx, _att, trunc = \
            cfg.rope_scaling[1]

        def corr_dim(n_rot):
            return (d * np.log(old_ctx / (n_rot * 2.0 * np.pi))
                    ) / (2.0 * np.log(cfg.rope_theta))

        low, high = corr_dim(beta_fast), corr_dim(beta_slow)
        if trunc:
            low, high = np.floor(low), np.ceil(high)
        low, high = max(low, 0.0), min(high, d - 1.0)
        if high == low:
            high += 0.001                      # the ramp's singularity
        ramp = np.clip((np.arange(d // 2, dtype=np.float64) - low)
                       / (high - low), 0.0, 1.0)
        extrap = 1.0 - ramp                    # 1: the original frequency
        inv = inv / factor * (1.0 - extrap) + inv * extrap
    return inv.astype(np.float32)


def rope_attention_factor(cfg: LlamaConfig) -> float:
    """The factor on cos and sin: YaRN's attention temperature, folded into
    the tables as HF multiplies its cached cos/sin; 1.0 for every other
    kind."""
    if _rope_kind(cfg) == "yarn":
        return float(cfg.rope_scaling[1][4])
    return 1.0


def is_dynamic_rope(cfg: LlamaConfig) -> bool:
    return _rope_kind(cfg) == "dynamic"


def rope_rows_dynamic(cfg: LlamaConfig, positions: torch.Tensor,
                      seq_len=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic-NTK cos/sin rows for ``positions`` [T], computed in float32
    from the live context length, in the JAX package's order (``base **
    -exp``): the base is rescaled only once the context outgrows
    ``max_position_embeddings`` (below it the factor is exactly 1).

    ``seq_len`` picks the keying, as HF's call pattern does: None keys on
    ``max(positions) + 1`` (one forward over the whole sequence); a scalar
    is the context length of every row (the prefill keys on the full
    prompt length); a [T] tensor keys each row on its own (``positions +
    1``: HF's incremental decode, which makes the lookahead step
    token-exact against the AR baseline). Returns ([T, D], [T, D])."""
    d = cfg.head_dim
    factor = cfg.rope_scaling[1]
    mp = float(cfg.max_position_embeddings)
    if seq_len is None:
        seq_len = positions.max() + 1
    t = torch.as_tensor(seq_len, device=positions.device).to(
        torch.float32).expand(positions.shape).clamp(min=mp)
    # each power is taken in float64 from its float32 operands and rounded
    # to float32: the correctly rounded float32 power, which is what XLA's
    # pow gives (torch's float32 pow may be an ulp off, and an ulp of the
    # base moves cos/sin at large positions by ~1e-5)
    scale = (factor * t / mp) - (factor - 1.0)                    # [T]
    ex = float(np.float32(d / (d - 2.0)))
    base = cfg.rope_theta * (scale.double() ** ex).float()        # [T]
    exp = torch.arange(0, d, 2, dtype=torch.float32,
                       device=positions.device) / d               # [D/2]
    inv = (base.double()[:, None] ** -exp.double()[None, :]).float()
    freqs = positions.to(torch.float32)[:, None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rope_tables(cfg: LlamaConfig, max_len: int,
                device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """[max_len, head_dim] fp32 cos/sin tables with the attention factor
    folded in, computed in numpy exactly as the JAX package computes them.
    A dynamic-NTK config does not read them: ``forward`` computes its rows
    with :func:`rope_rows_dynamic`."""
    inv = rope_inv_freq(cfg, seq_len=max_len)
    t = np.arange(max_len, dtype=np.float32)
    if _rope_kind(cfg) == "linear":
        t = t / cfg.rope_scaling[1]
    freqs = np.outer(t, inv)
    emb = np.concatenate([freqs, freqs], axis=-1)
    att = rope_attention_factor(cfg)
    return (torch.from_numpy(np.cos(emb) * att).to(device),
            torch.from_numpy(np.sin(emb) * att).to(device))


def _rope_rows(cfg: LlamaConfig, positions, rope_cos, rope_sin,
               rope_seq_len):
    """cos/sin rows [T, D] for ``positions`` [T]: computed for a
    dynamic-NTK config (keyed on ``rope_seq_len``), else gathered from the
    tables. A position past the tables occurs only on a step taken after
    ``finished``; the gather clamps it as a JAX gather does instead of
    asserting."""
    if is_dynamic_rope(cfg):
        return rope_rows_dynamic(cfg, positions, rope_seq_len)
    pos = positions.clamp(0, rope_cos.shape[0] - 1)
    return rope_cos[pos], rope_sin[pos]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [T, n_heads, d], or [B, T, n_heads, d]; cos/sin [T, d] for these
    positions; rotate-half."""
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
                  quant: Optional[str] = None, params: Optional[Dict] = None):
    """Zeroed KV-head-major cache buffers [L, Hkv, M, D] for K and V;
    ``quant="int8"`` gives int8 values with float32 scales [L, Hkv, M, 1]
    (filled with 1e-8) for each. With ``params`` (a rank's shard) L and
    Hkv are those the tree holds: the cache's shard by
    ``parallel.sharding.kv_cache_spec``."""
    layers, hkv = cfg.num_hidden_layers, cfg.num_key_value_heads
    if params is not None:
        layers, _, hkv = local_dims(params, cfg)
    shape = (layers, hkv, max_seq, cfg.head_dim)
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
    rope_seq_len=None,           # dynamic-NTK keying: None, an int or [T]
    mesh=None,                   # parallel.sharding.Mesh: params, caches
                                 # are this rank's shards
    split_rows: bool = False,    # la: this rank runs its share of the rows
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One forward over the layer stack. The tokens' K/V are written at
    slots [write_start, write_start+T) of every layer; attention then reads
    the whole buffer under the composite or causal visibility that
    ``attn_meta`` describes (``ops/lookahead_attention.py``), through the
    plain version (``attn_impl="dense"``) or the attention kernel's wrapper
    (``attn_impl="kernel"``). A dynamic-NTK config computes its rotary
    rows from the positions, keyed on ``rope_seq_len``
    (:func:`rope_rows_dynamic`); every other config gathers them from the
    tables.

    On a ``mesh`` with ``split_rows`` (the composite decode step) la rank
    i runs the i-th ``torch.tensor_split`` share of the T rows through
    every product, gathers the K/V of all T rows over la before the cache
    write (every la rank's cache holds them all) and passes the attention
    its first row as ``row0``; the final hidden rows are gathered over la
    before the logits. Every rank returns the same logits, bit for bit.
    Returns (fp32 logits, k_cache, v_cache)."""
    from ..ops.lookahead_attention import (lookahead_attention,
                                           lookahead_attention_ref)

    t = tokens.shape[0]
    m = (k_cache["q"] if isinstance(k_cache, dict) else k_cache).shape[2]
    x = _stage_input(params, cfg, tokens, mesh)              # [T, H]
    cos, sin = _rope_rows(cfg, positions, rope_cos, rope_sin, rope_seq_len)
    slots = write_slots(write_start, t, m)
    attend = lookahead_attention if attn_impl == "kernel" \
        else lookahead_attention_ref
    meta = dict(attn_meta)
    kv_len = meta.pop("kv_len")
    la = mesh.group("la") if mesh is not None and split_rows else None
    row0 = 0
    if la is not None:
        row0, n = mesh.split("la", t)
        sizes = split_sizes(t, mesh.shape["la"])
        x, cos, sin = (a[row0:row0 + n] for a in (x, cos, sin))

    def attention(li, q, k, vv):
        if la is not None:
            k, vv = (collectives.all_gather(a, la, 0, sizes) for a in (k, vv))
        kc = kv_cache_write(_layer(k_cache, li), k, slots)
        vc = kv_cache_write(_layer(v_cache, li), vv, slots)
        return attend(q, kc, vc, kv_len, row0=row0, **meta)

    x = _decoder_layers(params, cfg, x, cos, sin, attention, mesh)
    if la is not None:
        x = collectives.all_gather(x, la, 0, sizes)
    return _logits(params, cfg, x, logits_rows, mesh), k_cache, v_cache


def _tp_group(mesh):
    return mesh.group("tp") if mesh is not None else None


def _tp_sum(y: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over tp of the row-parallel partial products ``y``, taken
    in float32 and rounded once to y's dtype (Megatron's g: identity
    backward)."""
    group = _tp_group(mesh)
    if group is None:
        return y
    return collectives.reduce_from_region(y.float(), group).to(y.dtype)


def _embed(params, cfg: LlamaConfig, tokens: torch.Tensor, mesh=None):
    """Token embeddings [*tokens.shape, H]. A vocabulary-sharded table (tp)
    looks up the rank's own rows, zeroes the tokens outside them and sums
    over tp: one rank adds its row to zeros, so the sum is exact."""
    emb = params["embed"]
    if _tp_group(mesh) is None:
        x = emb[tokens]
    else:
        v0, n = mesh.split("tp", cfg.vocab_size)
        local = tokens - v0
        inside = ((local >= 0) & (local < n))[..., None]
        x = _tp_sum(torch.where(inside, emb[local.clamp(0, n - 1)],
                                torch.zeros((), dtype=emb.dtype,
                                            device=emb.device)), mesh)
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.hidden_size), dtype=cfg.dtype)
    return x


def _stage_input(params, cfg: LlamaConfig, tokens: torch.Tensor, mesh):
    """The rows the layer stack starts from: the embeddings of ``tokens``,
    or on a pp stage past the first, whose rows come from the stage before
    (:func:`_decoder_layers`), a buffer of their shape, with no lookup
    and no collective."""
    if mesh is not None and mesh.group("pp") is not None \
            and mesh.coords["pp"] > 0:
        emb = params["embed"]
        return torch.empty((*tokens.shape, cfg.hidden_size), dtype=emb.dtype,
                           device=emb.device)
    return _embed(params, cfg, tokens, mesh)


def _layer(tree, li):
    """Layer ``li`` of a stacked tensor, or of every leaf of a dict."""
    if isinstance(tree, dict):
        return {name: leaf[li] for name, leaf in tree.items()}
    return tree[li]


def _decoder_layers(params, cfg: LlamaConfig, x, cos, sin, attention,
                    mesh=None):
    """The layer stack on rows x [R, H] with rotary tables cos/sin [R, D].
    ``attention(li, q [R, Hq, D], k [R, Hkv, D], v [R, Hkv, D])`` writes the
    rows' K and V into layer ``li`` of the cache and returns the attention
    output [R, Hq*D]; the flat and the paged forward differ only there.

    On a ``mesh`` the layers, heads and MLP columns are those the rank's
    shard holds; tp sums the outputs of ``wo`` and ``w_down``; pp stage s
    receives the hidden state from stage s-1, runs its layers and sends to
    s+1, and the last stage hands the result to every stage."""
    from ..ops.quant import qmatmul

    n_layers, hq, hkv = local_dims(params, cfg)
    d = cfg.head_dim
    inter = cfg.intermediate_size
    t = x.shape[0]
    lp = params["layers"]
    act = act_fn(cfg)
    pp = mesh.group("pp") if mesh is not None else None
    if pp is not None:
        stage, stages = mesh.coords["pp"], mesh.shape["pp"]
        if stage > 0:
            x = collectives.recv(x, mesh.peer("pp", stage - 1), pp)
    for li in range(n_layers):
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
        x = x + _tp_sum(qmatmul(attn.to(cfg.dtype), _layer(lp["wo"], li)),
                        mesh)
        y = rms_norm(x, lp["post_norm"][li], cfg.rms_norm_eps,
                     cfg.rms_norm_offset)
        if "w_gate_up" in lp:
            gate_in, up = qmatmul(y, _layer(lp["w_gate_up"], li)).split(
                (inter, inter), dim=1)
        else:
            gate_in = qmatmul(y, _layer(lp["w_gate"], li))
            up = qmatmul(y, _layer(lp["w_up"], li))
        gate = act(gate_in.float()).to(cfg.dtype)
        x = x + _tp_sum(qmatmul(gate * up, _layer(lp["w_down"], li)), mesh)
    if pp is not None:
        if stage < stages - 1:
            collectives.send(x, mesh.peer("pp", stage + 1), pp)
        x = collectives.broadcast(x, mesh.peer("pp", stages - 1), pp)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps,
                    cfg.rms_norm_offset)


def _logits(params, cfg: LlamaConfig, x, rows, mesh=None):
    """fp32 logits of the normed rows x [R, H] (or [B, T, H]), gathered at
    ``rows`` of the second-to-last axis first when given. A head sharded
    over the vocabulary (tp) gives the rank's columns, gathered over tp."""
    from ..ops.quant import qmatmul

    if rows is not None:
        x = x.index_select(x.dim() - 2, rows)
    head = params.get("lm_head")
    if head is None:
        logits = (x @ params["embed"].T).float()
    else:
        y = qmatmul(x.reshape(-1, x.shape[-1]), head)
        logits = y.float().view(*x.shape[:-1], y.shape[-1])
    group = _tp_group(mesh)
    if group is None:
        return logits
    return collectives.gather_from_region(
        logits, group, -1, split_sizes(cfg.vocab_size, mesh.shape["tp"]))


NEG_INF_F32 = -1e30   # forward_train's masked score, as JAX's
_TRAIN_LAYER_KEYS = frozenset({"input_norm", "post_norm", "wq", "wk", "wv",
                               "wo", "w_gate", "w_up", "w_down"})


def forward_train(
    params: Dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,        # [B, T] int
    rope_cos: torch.Tensor,      # [>=T, D] fp32
    rope_sin: torch.Tensor,
    mesh=None,                   # parallel.sharding.Mesh: params are the
                                 # rank's tp shards (whole layer stack)
) -> torch.Tensor:
    """Batched causal forward without a KV cache (training, teacher
    forcing), differentiable by autograd: the JAX package's
    ``forward_train``. Attention is plain float32 ``matmul`` and softmax
    over a ``[B, T, Hkv, rep, D]`` query (JAX computes it with einsums
    outside any Pallas kernel). It takes unfused, unquantized projections
    without biases, as JAX's does, and raises on any other layer key.
    On a ``mesh`` Megatron's f/g pair surrounds the tp-sharded products:
    f (``copy_to_region``) before the column-parallel q/k/v, gate/up and
    LM head, g (``reduce_from_region``) after the row-parallel o/down and
    the vocabulary-sharded embedding; the logits are gathered over tp.
    Returns [B, T, V] fp32 logits."""
    lp = params["layers"]
    other = sorted(set(lp) - _TRAIN_LAYER_KEYS)
    if other or any(isinstance(w, dict) for w in lp.values()):
        raise ValueError(
            "forward_train takes unfused, unquantized projections without "
            f"biases; got layer keys {other or sorted(lp)}")
    n_layers, hq, hkv = local_dims(params, cfg)
    d = cfg.head_dim
    b, t = tokens.shape
    rep = hq // hkv
    tp = _tp_group(mesh)

    x = _embed(params, cfg, tokens, mesh)                    # [B, T, H]
    cos, sin = rope_cos[:t], rope_sin[:t]
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    act = act_fn(cfg)

    def att_rope(y, w, n_heads):
        return apply_rope((y @ w).reshape(b, t, n_heads, d), cos, sin)

    for li in range(n_layers):
        y = collectives.copy_to_region(rms_norm(
            x, lp["input_norm"][li], cfg.rms_norm_eps, cfg.rms_norm_offset),
            tp)
        # [B, Hkv, rep, T, D] queries against [B, Hkv, 1, T, D] keys
        q = att_rope(y, lp["wq"][li], hq).reshape(b, t, hkv, rep, d)
        q = q.float().permute(0, 2, 3, 1, 4)
        k = att_rope(y, lp["wk"][li], hkv).float().permute(0, 2, 1, 3)
        vv = (y @ lp["wv"][li]).reshape(b, t, hkv, d).float().permute(0, 2, 1, 3)
        scores = torch.matmul(q, k[:, :, None].transpose(-1, -2)) / math.sqrt(d)
        scores = scores.masked_fill(~causal, NEG_INF_F32)
        attn = torch.matmul(torch.softmax(scores, dim=-1), vv[:, :, None])
        attn = attn.permute(0, 3, 1, 2, 4).reshape(b, t, hq * d)
        x = x + _tp_sum(attn.to(cfg.dtype) @ lp["wo"][li], mesh)
        y = collectives.copy_to_region(rms_norm(
            x, lp["post_norm"][li], cfg.rms_norm_eps, cfg.rms_norm_offset),
            tp)
        gate = act((y @ lp["w_gate"][li]).float()).to(cfg.dtype)
        x = x + _tp_sum((gate * (y @ lp["w_up"][li])) @ lp["w_down"][li],
                        mesh)
    x = collectives.copy_to_region(rms_norm(
        x, params["final_norm"], cfg.rms_norm_eps, cfg.rms_norm_offset), tp)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    logits = (x @ head).float()
    if tp is None:
        return logits
    return collectives.gather_from_region(
        logits, tp, -1, split_sizes(cfg.vocab_size, mesh.shape["tp"]))


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
    rope_seq_len=None,           # dynamic-NTK keying: an int or [B, T]
    mesh=None,                   # parallel.sharding.Mesh, as in forward
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lane-batched forward over the shared paged KV pool (core/paged.py).

    B lanes write disjoint physical slots of one pool (scatters through
    each lane's page table) and attention reads each lane's logical view:
    in place through the table in the kernel (``attn_impl="kernel"``,
    ``ops/lookahead_attention.py:paged_lookahead_attention``), gathered in
    the plain version (``"dense"``). Everything else is :func:`forward`'s
    arithmetic on the B*T rows (``rope_seq_len`` keys each row's
    dynamic-NTK rotation, a scalar for one lane's prefill). With ``write_limit`` the rows of a padded
    prefill chunk past the prompt go to the lane's trash page (their
    logical pages may not be allocated); their outputs are discarded and no
    real row sees their columns. On a ``mesh`` the pool and the tree are
    the rank's shards and tp and pp run as in :func:`forward` (la does not
    split these rows). Returns (fp32 logits [B, R, V], k_pool, v_pool); a
    call that reads no logits row (prefill) gets [B, 0, V]."""
    from ..core.paged import paged_write, phys_slots
    from ..ops.lookahead_attention import (paged_lookahead_attention,
                                           paged_lookahead_attention_ref)

    hq, d = local_dims(params, cfg)[1], cfg.head_dim
    b, t = tokens.shape
    x = _stage_input(params, cfg, tokens.reshape(-1), mesh)  # [B*T, H]
    if isinstance(rope_seq_len, torch.Tensor):
        rope_seq_len = rope_seq_len.reshape(-1)     # one value a row
    cos, sin = _rope_rows(cfg, positions.reshape(-1), rope_cos, rope_sin,
                          rope_seq_len)

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

    x = _decoder_layers(params, cfg, x, cos, sin, attention, mesh)
    x = x.view(b, t, -1)
    if logits_rows is not None and logits_rows.numel() == 0:
        return (torch.zeros((b, 0, cfg.vocab_size), dtype=torch.float32,
                            device=x.device), k_pool, v_pool)
    return _logits(params, cfg, x, logits_rows, mesh), k_pool, v_pool
