"""Quantized-weight matrix products: the wrappers of the hand-written CUDA
kernels in ``csrc/quant_matmul.cu`` and their plain PyTorch versions.

    int8_matmul(x, q, scale)          y = (x @ q) * scale
    int4_matmul(x, q4, scale)         y = (x[:, :K/2] @ lo + x[:, K/2:] @ hi)
                                          * scale
    int4_matmul(..., pipeline=True)   the same product through the kernel
                                      that decodes the next packed tile
                                      into a second buffer while the
                                      current one is multiplied

``x`` is ``[T, K]`` float32 or bfloat16, ``q`` int8 ``[K, N]``, ``q4`` the
split-half packed int8 ``[K2p, N]`` of ``ops/quant.py`` (K2p >= K/2, zero
rows past K/2), ``scale`` float32 ``[1, N]``; the sum is float32, the scale
is applied once after it, and the result is ``[T, N]`` in x's dtype.

On a CUDA tensor a wrapper launches its kernel, or raises on an input the
kernel does not take; on a CPU tensor it runs the plain version.
``counts`` records both. Every product has two designs, chosen by x's
dtype: bfloat16 runs on the tensor cores (``int8_mma``, ``int4_mma``,
``int4_pipe_mma``), float32 on float32 FMAs (``int8_fma``, ``int4_fma``,
``int4_pipe_fma``), which keep every bit of x.
"""

from __future__ import annotations

from typing import Optional

import torch

from .quant import unpack_int4

# Launches of each CUDA kernel and calls of the plain versions. Reset with
# ``counts.update(dict.fromkeys(counts, 0))``.
counts = {"int8_mma": 0, "int4_mma": 0, "int4_pipe_mma": 0, "int8_fma": 0,
          "int4_fma": 0, "int4_pipe_fma": 0, "plain": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"int8": 0, "int4": 1, "int4_pipe": 2}


def int8_matmul_ref(x: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Plain version of the int8 product."""
    return ((x.float() @ q.float()) * scale).to(x.dtype)


def int4_matmul_ref(x: torch.Tensor, q4: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Plain version of the int4 product (and of its pipelined variant):
    the two nibble planes against the two halves of x. Zero-padded packed
    rows are accepted."""
    k2 = x.shape[-1] // 2
    lo, hi = unpack_int4(q4[:k2])
    xf = x.float()
    acc = xf[:, :k2] @ lo.float() + xf[:, k2:] @ hi.float()
    return (acc * scale).to(x.dtype)


def _check_common(x, w, scale, name):
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{name}: need x [T, K] and a 2-D weight, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n = w.shape[1]
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: x must be float32 or bfloat16, "
                         f"got {x.dtype}")
    if w.dtype != torch.int8:
        raise ValueError(f"{name}: the weight must be int8, got {w.dtype}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (1, n):
        raise ValueError(f"{name}: scale must be float32 [1, {n}], got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if w.device != x.device or scale.device != x.device:
        raise ValueError(f"{name}: x, the weight and the scale must be on "
                         f"one device")


def _check_int8(x, q, scale):
    _check_common(x, q, scale, "int8_matmul")
    if q.shape[0] != x.shape[1]:
        raise ValueError(f"int8_matmul: weight packed for K={q.shape[0]}, "
                         f"x has K={x.shape[1]}")


def _check_int4(x, q4, scale, logical_k2: Optional[int]):
    _check_common(x, q4, scale, "int4_matmul")
    k, k2p = x.shape[1], q4.shape[0]
    if k % 2:
        raise ValueError(f"int4_matmul: K={k} must be even")
    if logical_k2 is not None:
        # a q4 packed for another K would pass a bare shape test and be
        # multiplied against the wrong halves of x
        if logical_k2 != k // 2 or k2p < logical_k2:
            raise ValueError(
                f"int4_matmul: weight packed for K={2 * logical_k2} "
                f"({k2p} stored rows), x has K={k}")
    elif k2p != k // 2:
        raise ValueError(
            f"int4_matmul: {k2p} packed rows do not match K={k}; a padded "
            f"weight needs its logical row count (logical_k2)")


def _launch(mode: str, x, w, scale, k2: int):
    """Checks that only the CUDA kernel needs, then the launch."""
    n = w.shape[1]
    if n % 16:
        raise ValueError(f"{mode} kernel reads weight rows in 16-byte "
                         f"pieces: N={n} must be a multiple of 16")
    if not (x.is_contiguous() and w.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError(f"{mode} kernel takes contiguous x, weight (index "
                         f"a stacked weight by layer) and scale")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {x.device}, but the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    t, k = x.shape
    out = torch.empty((t, n), dtype=x.dtype, device=x.device)
    if t == 0:          # no rows (a prefill chunk reads no logits)
        return out
    from ._build import load
    err = load("quant_matmul").quant_matmul_launch(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
        _MODES[mode], _DTYPE_CODES[x.dtype], t, k, n, w.shape[0], k2,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{mode} matmul kernel launch failed: "
                           f"CUDA error {err}")
    counts[count_key(mode, x.dtype)] += 1
    return out


def count_key(mode: str, dtype: torch.dtype) -> str:
    """The ``counts`` key of a launch of kernel ``mode`` ("int8", "int4"
    or "int4_pipe") on an x of ``dtype``."""
    return mode + ("_mma" if dtype == torch.bfloat16 else "_fma")


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``(x @ q) * scale`` with the int8 weights converted inside the
    kernel; [T, N] in x's dtype."""
    _check_int8(x, q, scale)
    if x.device.type == "cpu":
        counts["plain"] += 1
        return int8_matmul_ref(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 matmul kernel for device {x.device}")
    return _launch("int8", x, q, scale, 0)


def int4_matmul(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor,
                pipeline: bool = False,
                logical_k2: Optional[int] = None) -> torch.Tensor:
    """``x @ dequant(q4, scale)`` with the nibbles unpacked inside the
    kernel; [T, N] in x's dtype. ``logical_k2`` is the weight's packed-row
    count before padding (``quant.logical_packed_rows``); without it the
    stored rows must equal K/2. x is never padded: the kernel reads
    nothing past column K/2 of either half."""
    _check_int4(x, q4, scale, logical_k2)
    if x.device.type == "cpu":
        counts["plain"] += 1
        return int4_matmul_ref(x, q4, scale)
    if x.device.type != "cuda":
        raise ValueError(f"no int4 matmul kernel for device {x.device}")
    return _launch("int4_pipe" if pipeline else "int4", x, q4, scale,
                   x.shape[1] // 2)
