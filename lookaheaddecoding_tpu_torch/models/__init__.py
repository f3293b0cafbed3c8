"""LLaMA-family model in PyTorch, and the HF checkpoint converter."""
from .llama import (LlamaConfig, forward, forward_train, init_params,
                    make_kv_cache, params_from_numpy)
from .convert import convert_hf_model, convert_hf_state_dict, load_pretrained
