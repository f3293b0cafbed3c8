"""Two variants of the int4 unpack-matmul, for the micro-benchmark
``scripts/torch_int4_micro.py``: the wrappers of the hand-written CUDA
kernels in ``csrc/int4_micro.cu`` and their plain PyTorch versions.

    int4_matmul_shift(x, q4, scale)    the product of ``int4_matmul`` with
                                       the nibbles decoded by 32-bit shifts;
                                       bit-equal to ``int4_matmul``
    int4_matmul_kouter(x, q4, scale)   the same product split over K: one
                                       partial sum a slab of KOUTER_SLAB
                                       packed rows, the slabs added in slab
                                       order, then the scale

Inputs and result are those of ``ops/quant_matmul.py:int4_matmul``. Neither
variant is wired into ``qmatmul``: they are measured, not used. On a CUDA
tensor a wrapper launches its kernel, or raises on an input the kernel does
not take; on a CPU tensor it runs the plain version. ``counts`` records
both.
"""

from __future__ import annotations

from typing import Optional

import torch

from .quant_matmul import _DTYPE_CODES, _check_int4

# Launches of each CUDA kernel and calls of the plain versions. Reset with
# ``counts.update(dict.fromkeys(counts, 0))``.
counts = {"shift": 0, "kouter": 0, "plain": 0}

# packed rows a K slab of the K-outer variant; a multiple of the kernel's
# K tiles (64 and 32 rows), and of nothing that depends on T
KOUTER_SLAB = 256
_VARIANTS = {"shift": 0, "kouter": 1}


def unpack_int4_shift(q4: torch.Tensor):
    """(lo, hi) int32 nibble planes of packed bytes, both sign-extended by
    32-bit shifts: ``(p << 28) >> 28`` and ``p >> 4``."""
    p32 = q4.to(torch.int32)
    return (p32 << 28) >> 28, p32 >> 4


def int4_matmul_shift_ref(x: torch.Tensor, q4: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """Plain version of the shift variant: the arithmetic of
    ``int4_matmul_ref`` on the shift-decoded planes."""
    k2 = x.shape[-1] // 2
    lo, hi = unpack_int4_shift(q4[:k2])
    xf = x.float()
    acc = xf[:, :k2] @ lo.float() + xf[:, k2:] @ hi.float()
    return (acc * scale).to(x.dtype)


def int4_matmul_kouter_ref(x: torch.Tensor, q4: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """Plain version of the K-outer variant: one float32 partial product a
    slab of KOUTER_SLAB packed rows, added in slab order, then scaled."""
    k2 = x.shape[-1] // 2
    lo, hi = (plane.float() for plane in unpack_int4_shift(q4[:k2]))
    xf = x.float()
    acc = None
    for r0 in range(0, k2, KOUTER_SLAB):
        r1 = min(r0 + KOUTER_SLAB, k2)
        part = xf[:, r0:r1] @ lo[r0:r1] + xf[:, k2 + r0:k2 + r1] @ hi[r0:r1]
        acc = part if acc is None else acc + part
    return (acc * scale).to(x.dtype)


def _launch(variant: str, x, q4, scale):
    n = q4.shape[1]
    if n % 16:
        raise ValueError(f"int4 {variant} kernel reads weight rows in "
                         f"16-byte pieces: N={n} must be a multiple of 16")
    if not (x.is_contiguous() and q4.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError(f"int4 {variant} kernel takes contiguous x, weight "
                         f"(index a stacked weight by layer) and scale")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {x.device}, but the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    t, k = x.shape
    out = torch.empty((t, n), dtype=x.dtype, device=x.device)
    if t == 0:
        return out
    part = None
    if variant == "kouter":
        slabs = -(-(k // 2) // KOUTER_SLAB)
        part = torch.empty((slabs, t, n), dtype=torch.float32,
                           device=x.device)
    from ._build import load
    err = load("int4_micro").int4_micro_launch(
        x.data_ptr(), q4.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), _VARIANTS[variant],
        _DTYPE_CODES[x.dtype], t, k, n, q4.shape[0], k // 2, KOUTER_SLAB,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int4 {variant} kernel launch failed: "
                           f"CUDA error {err}")
    counts[variant] += 1
    return out


def _run(variant: str, ref, x, q4, scale, logical_k2):
    _check_int4(x, q4, scale, logical_k2)
    if x.device.type == "cpu":
        counts["plain"] += 1
        return ref(x, q4, scale)
    if x.device.type != "cuda":
        raise ValueError(f"no int4 {variant} kernel for device {x.device}")
    return _launch(variant, x, q4, scale)


def int4_matmul_shift(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor,
                      logical_k2: Optional[int] = None) -> torch.Tensor:
    """The int4 product with the shift decode; [T, N] in x's dtype, the
    bits of ``int4_matmul``."""
    return _run("shift", int4_matmul_shift_ref, x, q4, scale, logical_k2)


def int4_matmul_kouter(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor,
                       logical_k2: Optional[int] = None) -> torch.Tensor:
    """The int4 product split over K in one fixed order; [T, N] in x's
    dtype. A row's result does not depend on the rows beside it."""
    return _run("kouter", int4_matmul_kouter_ref, x, q4, scale, logical_k2)
