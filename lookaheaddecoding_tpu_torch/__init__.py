"""lookaheaddecoding_tpu_torch: lookahead decoding in PyTorch and CUDA.

The port of ``lookaheaddecoding_tpu`` (JAX) to one NVIDIA Hopper card,
with the same module tree and data formats. It carries
``LookaheadEngine`` on the flat KV cache (greedy ``generate``, SpecInfer
sampling ``generate_sample``, ``generate_stream``, ``generate_batch``,
prefix caching with ``PrefixCache``, and the AR baseline
``generate_baseline``), and ``PagedServingEngine`` (lanes batched over a
shared page pool, prefix sharing, conversation carry; greedy or sampling),
and ``ContinuousBatchingEngine`` (a lane scheduler over the flat engine
with fairness, throughput and adaptive objectives), with plain, int8 or
int4 weights and a plain or int8 KV cache, for the LLaMA, Mistral, Qwen2
and Gemma families (``LlamaConfig.from_hf``, ``convert_hf_model``; linear,
dynamic-NTK, llama3 and YaRN rope scaling). ``training`` fits a model on
the card (``forward_train``, Adam or momentum SGD), ``utils`` saves and
loads checkpoints in the JAX package's format, profiles and autotunes,
``compat`` carries the reference's ``config_lade`` knobs,
``applications`` holds the demos, the chatbot, the evaluation harness and
the learned-model benchmark, and ``parallel`` runs tensor, pipeline,
lookahead and data parallelism over ``torch.distributed`` (the engine's
and the train step's ``mesh=``). The composite attention, flat
and paged, and the quantized-weight products are hand-written CUDA kernels
(``ops/csrc/``). It imports no JAX, and ``transformers`` only inside
``load_pretrained``.
"""

from .config import EngineConfig, LookaheadConfig, SamplingConfig
from .core.engine import GenerationResult, LookaheadEngine, PrefixCache
from .core.layout import Layout, build_layout
from .core.paged_serving import PagedPrefix, PagedServingEngine
from .core.serving import ContinuousBatchingEngine, Request
from .models.convert import (convert_hf_model, convert_hf_state_dict,
                             load_pretrained)
from .models.llama import (LlamaConfig, fuse_params, init_params,
                           params_from_numpy)
from .ops.quant import dequantize_weight, quantize_params, quantize_weight
from .ops.sampling import (AcceptResult, rejection_sample_verify,
                           rejection_sample_verify_core, sample_token,
                           warp_logits)
from .utils.checkpoint import load_params, save_params
from .utils.logging import DecodeLog
from .utils.tuning import TuneResult, autotune

__all__ = [
    "EngineConfig",
    "LookaheadConfig",
    "SamplingConfig",
    "LookaheadEngine",
    "GenerationResult",
    "PrefixCache",
    "PagedServingEngine",
    "PagedPrefix",
    "ContinuousBatchingEngine",
    "Request",
    "Layout",
    "build_layout",
    "LlamaConfig",
    "init_params",
    "params_from_numpy",
    "fuse_params",
    "convert_hf_model",
    "convert_hf_state_dict",
    "load_pretrained",
    "DecodeLog",
    "load_params",
    "save_params",
    "TuneResult",
    "autotune",
    "quantize_params",
    "quantize_weight",
    "dequantize_weight",
    "warp_logits",
    "AcceptResult",
    "rejection_sample_verify",
    "rejection_sample_verify_core",
    "sample_token",
]
