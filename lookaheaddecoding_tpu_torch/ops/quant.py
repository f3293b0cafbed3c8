"""Weight-only quantization (int8 / int4) for the decode path.

The data formats of ``lookaheaddecoding_tpu.ops.quant``, bit for bit: a
quantized linear layer replaces the plain ``[in, out]`` tensor with a dict
of tensors whose key names carry the bit width,

    int8: {"q":  int8[in, out],    "scale": f32[1, out]}
    int4: {"q4": int8[in/2p, out], "scale": f32[1, out],
           "q4_pad": int8[pad, 0]}                  (two nibbles a byte)

with symmetric per-output-channel scales (the reduction runs over axis -2,
so stacked ``[L, in, out]`` weights quantize per layer). int4 packing is
split-half: packed row r holds input row r in its low nibble and input row
r + in/2 in its high nibble. ``pad_packed_rows`` may append zero packed
rows; the zero-element ``q4_pad`` leaf carries their count in its shape.

:func:`qmatmul` is the model's product. On a CUDA tensor a quantized dict
always goes to its hand-written kernel (``ops/quant_matmul.py``); on a CPU
tensor it runs the plain version, ``x @ dequantize_weight(w)``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

# Rows of a packed-weight block above which no padding is considered: part
# of the packed format's definition (it decides how many zero rows
# ``quantize_weight`` appends), not a tile size of the CUDA kernels.
CAP_K = 2816

# The int4 product's pipelined variant (``int4_matmul(pipeline=True)``) is
# off by default, as in the JAX package.
INT4_PIPELINE = False

_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "wqkv", "w_gate_up")


def _pick_block(dim: int) -> int:
    """Largest multiple of 128 that divides ``dim`` and is at most
    ``CAP_K`` (0 when none is at least 256)."""
    for c in range(CAP_K - CAP_K % 128, 255, -128):
        if dim % c == 0:
            return c
    return 0


def pad_packed_rows(k2: int) -> int:
    """Packed-row count stored for an input half-dim ``k2``: ``k2`` itself
    when it splits into blocks of at least 1024 rows (multiples of 128, at
    most ``CAP_K``), else the smallest zero-padded size that splits into at
    most 16 such blocks of at least 256 rows. Llama-2-7B's 11008 packs to
    5504 = 128 * 43 rows and is stored as 5632. Zero packed rows unpack to
    zero weights, so the padding changes no product."""
    cap_aligned = CAP_K - CAP_K % 128
    if k2 < 256:
        return k2
    b0 = _pick_block(k2)
    if b0 >= 1024:
        return k2
    best = 0
    for nb in range(1, 17):
        rows = -(-k2 // nb)                  # ceil rows per block
        b = -(-rows // 128) * 128            # aligned up
        if b > cap_aligned or b < 256:
            continue
        k2p = nb * b
        if best == 0 or k2p < best:
            best = k2p
    if best == 0 or best == k2:
        return k2
    # keep an existing exact split unless the padding is modest
    if b0 and best > k2 * 1.25:
        return k2
    return best


def quantize_weight(w: torch.Tensor, bits: int = 8) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel quantization of an ``[..., in, out]``
    matrix or stack, on the device ``w`` lies on. The values are
    ``clip(round_half_even(w / scale))`` with a true float32 division. The
    scale is ``max(amax * float32(1 / qmax), 1e-8)``: the JAX package
    writes ``amax / qmax``, and XLA compiles a division by a constant into
    this multiplication by its reciprocal, which differs from the division
    in the last bit of some scales."""
    if bits not in (8, 4):
        raise ValueError(f"unsupported bits: {bits}")
    if bits == 4 and w.shape[-2] % 2:
        raise ValueError("input dim must be even for int4 packing")
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    if bits == 8:
        scale = (amax * (1.0 / 127.0)).clamp_min(1e-8)
        q = torch.round(wf / scale).clamp_(-127, 127).to(torch.int8)
        return {"q": q, "scale": scale}
    scale = (amax * (1.0 / 7.0)).clamp_min(1e-8)
    q = torch.round(wf / scale).clamp_(-7, 7).to(torch.int8)
    half = q.shape[-2] // 2
    # nibbles as unsigned bytes, so the shift cannot overflow a signed type
    nib = q.view(torch.uint8) & 0x0F
    packed = (nib[..., :half, :] | (nib[..., half:, :] << 4)).view(torch.int8)
    k2p = pad_packed_rows(half)
    if k2p != half:
        packed = torch.nn.functional.pad(packed, (0, 0, 0, k2p - half))
    sentinel = torch.zeros(packed.shape[:-2] + (k2p - half, 0),
                           dtype=torch.int8, device=w.device)
    return {"q4": packed.contiguous(), "scale": scale, "q4_pad": sentinel}


def logical_packed_rows(wq: Dict[str, torch.Tensor]) -> Optional[int]:
    """Packed-row count before padding of an int4 dict, or None for a dict
    without the ``q4_pad`` sentinel."""
    if "q4_pad" not in wq:
        return None
    return wq["q4"].shape[-2] - wq["q4_pad"].shape[-2]


def unpack_int4(packed: torch.Tensor):
    """(low, high) signed nibble planes of split-half packed bytes, int16."""
    p = packed.to(torch.int16)
    return ((p & 0x0F) ^ 8) - 8, p >> 4


def dequantize_weight(wq: Dict[str, torch.Tensor], dtype=torch.bfloat16,
                      k: int = 0) -> torch.Tensor:
    """The full-width weight: the plain version of what the matmul kernels
    read. int4 pad rows are stripped through the ``q4_pad`` sentinel; ``k``
    (the logical input dim) is cross-checked when given and needed only
    for dicts without the sentinel."""
    if "q" in wq:
        return (wq["q"].float() * wq["scale"]).to(dtype)
    k2 = logical_packed_rows(wq)
    if k:
        if k2 is not None and k != 2 * k2:
            raise ValueError(
                f"int4 weight packed for input dim {2 * k2}, got k={k}")
        k2 = k // 2
    lo, hi = unpack_int4(wq["q4"])
    if k2 is not None and lo.shape[-2] != k2:
        lo, hi = lo[..., :k2, :], hi[..., :k2, :]
    q = torch.cat([lo, hi], dim=-2)                 # split-half layout
    return (q.float() * wq["scale"]).to(dtype)


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a plain tensor or a quantized dict, in x's dtype. A
    CUDA ``x`` with a quantized dict launches the int8 or the int4 kernel
    (or raises on what the kernel does not take); a CPU ``x`` runs the
    plain version."""
    if not isinstance(w, dict):
        return x @ w
    from . import quant_matmul as qm
    if "q" in w:
        return qm.int8_matmul(x, w["q"], w["scale"])
    return qm.int4_matmul(x, w["q4"], w["scale"], pipeline=INT4_PIPELINE,
                          logical_k2=logical_packed_rows(w))


def quantize_params(params: Dict, bits: int = 8,
                    quantize_lm_head: bool = False,
                    lm_head_bits: int = 8) -> Dict:
    """Quantize the per-layer projection stacks ``[L, in, out]`` (per layer
    and output channel), fused layouts included. Embedding and norms keep
    their type; the LM head is quantized on request."""
    out = dict(params)
    layers = dict(params["layers"])
    for key in _QUANT_KEYS:
        if key in layers:
            layers[key] = quantize_weight(layers[key], bits)
    out["layers"] = layers
    if quantize_lm_head and "lm_head" in params:
        out["lm_head"] = quantize_weight(params["lm_head"], lm_head_bits)
    return out


def quantized_bits(w) -> int:
    if not isinstance(w, dict):
        return 0
    return 8 if "q" in w else 4
