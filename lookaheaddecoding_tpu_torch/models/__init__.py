"""LLaMA-family model in PyTorch."""
from .llama import (LlamaConfig, forward, init_params, make_kv_cache,
                    params_from_numpy)
