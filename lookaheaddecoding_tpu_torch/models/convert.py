"""HF checkpoint -> the port's parameter tree (models/llama.py).

A one-time weight conversion into the stacked layout, from a state dict of
numpy arrays or from a live ``transformers`` causal LM with the LLaMA layer
naming (LLaMA, Mistral, Qwen2 and Gemma share it). The tree is the JAX
package's ``convert_hf_state_dict`` tree, as torch tensors on a device.
``transformers`` is imported only by :func:`load_pretrained`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .llama import LlamaConfig, _to_tensor


def convert_hf_state_dict(state: Dict[str, np.ndarray], cfg: LlamaConfig,
                          device="cuda") -> Dict:
    """``state`` maps HF parameter names to numpy arrays; the tree's leaves
    are on ``device``, cast to ``cfg.dtype``."""

    def get(name):
        return np.asarray(state[name])

    def tensor(a):
        return _to_tensor(a, cfg.dtype, device)

    def stack(fmt, transpose=False):
        mats = [get(fmt.format(i)) for i in range(cfg.num_hidden_layers)]
        if transpose:
            mats = [m.T for m in mats]
        return tensor(np.stack(mats))

    layer = "model.layers.{}."
    params = {
        "embed": tensor(get("model.embed_tokens.weight")),
        "layers": {
            "input_norm": stack(layer + "input_layernorm.weight"),
            "post_norm": stack(layer + "post_attention_layernorm.weight"),
            # HF linear weights are [out, in]; the tree's are [in, out]
            "wq": stack(layer + "self_attn.q_proj.weight", transpose=True),
            "wk": stack(layer + "self_attn.k_proj.weight", transpose=True),
            "wv": stack(layer + "self_attn.v_proj.weight", transpose=True),
            "wo": stack(layer + "self_attn.o_proj.weight", transpose=True),
            "w_gate": stack(layer + "mlp.gate_proj.weight", transpose=True),
            "w_up": stack(layer + "mlp.up_proj.weight", transpose=True),
            "w_down": stack(layer + "mlp.down_proj.weight", transpose=True),
        },
        "final_norm": tensor(get("model.norm.weight")),
    }
    if cfg.attention_bias:
        # Qwen2's qkv biases (the same HF key naming)
        for name, proj in (("bq", "q_proj"), ("bk", "k_proj"),
                           ("bv", "v_proj")):
            params["layers"][name] = stack(layer + f"self_attn.{proj}.bias")
    if not cfg.tie_word_embeddings:
        params["lm_head"] = tensor(get("lm_head.weight").T)
    return params


def convert_hf_model(hf_model, dtype=torch.bfloat16, device="cuda"):
    """(LlamaConfig, params) of a live ``transformers`` causal LM with the
    LLaMA layer naming."""
    cfg = LlamaConfig.from_hf(hf_model.config, dtype=dtype)
    state = {k: v.detach().to("cpu").float().numpy()
             for k, v in hf_model.state_dict().items()}
    if cfg.tie_word_embeddings:
        state.pop("lm_head.weight", None)
    return cfg, convert_hf_state_dict(state, cfg, device)


def load_pretrained(model_path: str, dtype=torch.bfloat16, device="cuda"):
    """Load an HF hub or local causal-LM checkpoint and convert it: returns
    (LlamaConfig, params, tokenizer). Needs ``transformers`` (and, for a
    hub name, the network)."""
    from transformers import AutoModelForCausalLM, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(model_path)
    hf = AutoModelForCausalLM.from_pretrained(model_path, dtype="float32")
    cfg, params = convert_hf_model(hf, dtype=dtype, device=device)
    del hf
    return cfg, params, tok
