"""lookaheaddecoding_tpu_torch: lookahead decoding in PyTorch and CUDA.

The port of ``lookaheaddecoding_tpu`` (JAX) to one NVIDIA Hopper card,
with the same module tree and data formats. This slice carries greedy
``LookaheadEngine.generate`` and its AR baseline ``generate_baseline`` on
the flat KV cache; the composite attention is a hand-written CUDA kernel
(``ops/csrc/lookahead_attention.cu``). It imports no JAX.
"""

from .config import EngineConfig, LookaheadConfig, SamplingConfig
from .core.engine import GenerationResult, LookaheadEngine
from .core.layout import Layout, build_layout
from .models.llama import LlamaConfig, init_params, params_from_numpy

__all__ = [
    "EngineConfig",
    "LookaheadConfig",
    "SamplingConfig",
    "LookaheadEngine",
    "GenerationResult",
    "Layout",
    "build_layout",
    "LlamaConfig",
    "init_params",
    "params_from_numpy",
]
