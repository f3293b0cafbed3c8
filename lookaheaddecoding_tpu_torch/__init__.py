"""lookaheaddecoding_tpu_torch: lookahead decoding in PyTorch and CUDA.

The port of ``lookaheaddecoding_tpu`` (JAX) to one NVIDIA Hopper card,
with the same module tree and data formats. It carries greedy
``LookaheadEngine.generate`` and its AR baseline ``generate_baseline`` on
the flat KV cache, and greedy ``PagedServingEngine`` (lanes batched over a
shared page pool, prefix sharing, conversation carry), with plain, int8 or
int4 weights and a plain or int8 KV cache. The composite attention, flat
and paged, and the quantized-weight products are hand-written CUDA kernels
(``ops/csrc/``). It imports no JAX.
"""

from .config import EngineConfig, LookaheadConfig, SamplingConfig
from .core.engine import GenerationResult, LookaheadEngine
from .core.layout import Layout, build_layout
from .core.paged_serving import PagedPrefix, PagedServingEngine
from .core.serving import Request
from .models.llama import (LlamaConfig, fuse_params, init_params,
                           params_from_numpy)
from .ops.quant import dequantize_weight, quantize_params, quantize_weight

__all__ = [
    "EngineConfig",
    "LookaheadConfig",
    "SamplingConfig",
    "LookaheadEngine",
    "GenerationResult",
    "PagedServingEngine",
    "PagedPrefix",
    "Request",
    "Layout",
    "build_layout",
    "LlamaConfig",
    "init_params",
    "params_from_numpy",
    "fuse_params",
    "quantize_params",
    "quantize_weight",
    "dequantize_weight",
]
