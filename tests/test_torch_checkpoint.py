"""The port's checkpoint format: round trips of plain, int8, int4 and
nested-rope trees, and interchange with the JAX package's
``save_params`` / ``load_params`` in both directions, every leaf equal
(bfloat16 bit for bit) and the config sidecars equal as JSON."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lookaheaddecoding_tpu as jlt
from lookaheaddecoding_tpu.ops.quant import quantize_params as jquantize
from lookaheaddecoding_tpu.utils import checkpoint as jckpt
import lookaheaddecoding_tpu_torch as lt
from lookaheaddecoding_tpu_torch.models import llama as tllama
from lookaheaddecoding_tpu_torch.utils import checkpoint as tckpt

ARCH = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
ROPES = {"linear": ("linear", 2.0),
         "llama3": ("llama3", (8.0, 1.0, 4.0, 64.0)),
         "yarn": ("yarn", (4.0, 32.0, 1.0, 64.0, 1.1386, 1.0))}


def flat(tree, prefix=""):
    """{path: (dtype name, numpy bits)} of a JAX or a torch tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        name = str(tree.dtype).removeprefix("torch.")
        t = tree.cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return {prefix: (name, t.numpy())}
    a = np.asarray(tree)
    name = a.dtype.name
    if name == "bfloat16":
        a = a.view(np.int16)
    return {prefix: (name, a)}


def assert_same_leaves(a, b):
    fa, fb = flat(a), flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k][0] == fb[k][0], (k, fa[k][0], fb[k][0])
        assert fa[k][1].shape == fb[k][1].shape, k
        np.testing.assert_array_equal(fa[k][1], fb[k][1], err_msg=k)


def port_trees(dtype=torch.float32, **extra):
    cfg = tllama.LlamaConfig(**ARCH, dtype=dtype, **extra)
    params = tllama.init_params(cfg, seed=0, scale=0.5, device="cpu")
    return cfg, {
        "plain": params,
        "int8": lt.quantize_params(params, bits=8),
        "int4": lt.quantize_params(params, bits=4, quantize_lm_head=True,
                                   lm_head_bits=8),
    }


@pytest.mark.parametrize("kind", ["plain", "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_roundtrip_keeps_every_leaf_and_dtype(tmp_path, kind, dtype):
    cfg, trees = port_trees(dtype, rope_scaling=("linear", 2.0))
    path = str(tmp_path / "ckpt")             # ".npz" is appended
    tckpt.save_params(path, cfg, trees[kind])
    cfg2, tree2 = tckpt.load_params(path, device="cpu")
    assert cfg2 == cfg
    assert_same_leaves(trees[kind], tree2)
    if kind == "int4":
        assert tree2["layers"]["wq"]["q4_pad"].numel() == 0


@pytest.mark.parametrize("rope", sorted(ROPES))
def test_roundtrip_nested_rope_scaling_stays_hashable(tmp_path, rope):
    cfg, trees = port_trees(rope_scaling=ROPES[rope])
    p = str(tmp_path / "ckpt.npz")
    tckpt.save_params(p, cfg, trees["plain"])
    cfg2, _ = tckpt.load_params(p, device="cpu")
    assert cfg2 == cfg
    hash(cfg2)


def jax_tree(jcfg, kind):
    params = jlt.init_params(jcfg, jax.random.PRNGKey(0))
    if kind == "int8":
        return jquantize(params, bits=8)
    if kind == "int4":
        return jquantize(params, bits=4, quantize_lm_head=True,
                         lm_head_bits=8)
    return params


@pytest.mark.parametrize("kind", ["plain", "int8", "int4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_written_checkpoint_loads_in_the_port(tmp_path, kind, dtype):
    jcfg = jlt.LlamaConfig(**ARCH, dtype=getattr(jnp, dtype),
                           rope_scaling=ROPES["llama3"])
    tree = jax_tree(jcfg, kind)
    p = str(tmp_path / "jax.npz")
    jckpt.save_params(p, jcfg, tree)
    cfg, params = tckpt.load_params(p, device="cpu")
    assert cfg == tllama.LlamaConfig(**ARCH, dtype=getattr(torch, dtype),
                                     rope_scaling=ROPES["llama3"])
    assert_same_leaves(jax.device_get(tree), params)
    # and the port writes the same file back: sidecar and arrays
    q = str(tmp_path / "port.npz")
    tckpt.save_params(q, cfg, params)
    with open(p + ".config.json") as f, open(q + ".config.json") as g:
        assert json.load(f) == json.load(g)
    with np.load(p) as a, np.load(q) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kind", ["plain", "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_port_written_checkpoint_loads_in_jax(tmp_path, kind, dtype):
    cfg, trees = port_trees(dtype, rope_scaling=ROPES["yarn"])
    p = str(tmp_path / "port.npz")
    tckpt.save_params(p, cfg, trees[kind])
    jcfg, jtree = jckpt.load_params(p)
    name = str(dtype).removeprefix("torch.")
    assert jcfg == jlt.LlamaConfig(**ARCH, dtype=getattr(jnp, name),
                                   rope_scaling=ROPES["yarn"])
    assert_same_leaves(trees[kind], jax.device_get(jtree))
    q = str(tmp_path / "jax.npz")
    jckpt.save_params(q, jcfg, jtree)
    with open(p + ".config.json") as f, open(q + ".config.json") as g:
        assert json.load(f) == json.load(g)


def test_sidecar_names_dtypes_bare(tmp_path):
    cfg, trees = port_trees(torch.bfloat16)
    tckpt.save_params(str(tmp_path / "c"), cfg, trees["int4"])
    with open(tmp_path / "c.npz.config.json") as f:
        side = json.load(f)
    assert side["dtype"] == "bfloat16"
    assert side["_array_dtypes"]["embed"] == "bfloat16"
    # quantized leaves are stored natively: int8 values, float32 scales
    assert "layers::wq::q4" not in side["_array_dtypes"]
    assert "layers::wq::scale" not in side["_array_dtypes"]
