"""The port's weight quantization against the JAX package's, on the CPU,
from the same numpy weights: packed bytes, scales and the ``q4_pad``
sentinel must be bit-equal, so a tree quantized by either package serves
both.

The two frameworks agree bit for bit because both compute ``w / scale``
as a true float32 division and both round half to even (``jnp.rint``,
``torch.round``). One operation differs between the JAX source and what
XLA runs: ``amax / 127.0`` (and ``/ 7.0``) inside the jitted
``_quantize_fused`` is compiled into ``amax * float32(1 / 127)``, which
differs from the division in the last bit of about 5% of int8 scales; the
port multiplies by the reciprocal, as the compiled JAX function does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lookaheaddecoding_tpu as jlt
from lookaheaddecoding_tpu.models import llama as jllama
from lookaheaddecoding_tpu.ops import quant as jquant
from lookaheaddecoding_tpu.ops import quant_matmul as jqm
from lookaheaddecoding_tpu_torch.models import llama as tllama
from lookaheaddecoding_tpu_torch.ops import quant as tquant
from lookaheaddecoding_tpu_torch.ops import quant_matmul as tqm

ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512)


def assert_same_quantized(got, want):
    """A port dict against a JAX dict: same keys, dtypes, shapes, bits."""
    assert set(got) == set(want)
    for key, leaf in want.items():
        leaf = np.asarray(leaf)
        assert got[key].numpy().dtype == leaf.dtype, key
        assert tuple(got[key].shape) == leaf.shape, key
        np.testing.assert_array_equal(got[key].numpy(), leaf, err_msg=key)


def weight(seed, shape, scale=0.2):
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    w[..., 0, 0] = 0.5 * np.abs(w).max()       # a value on a rounding tie
    return w


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [
    (64, 48), (512, 256), (2, 64, 32), (3, 5888, 16), (11008, 8)],
    ids=["2d", "2d_wide", "stacked", "stacked_padded", "llama7b_k"])
def test_quantize_weight_bit_equal_to_jax(shape, bits):
    w = weight(len(shape) * 7 + bits, shape)
    want = jquant.quantize_weight(jnp.asarray(w), bits)
    got = tquant.quantize_weight(torch.from_numpy(w), bits)
    assert_same_quantized(got, want)
    if bits == 4 and shape[-2] == 11008:
        assert got["q4"].shape == (5632, 8)          # 5504 rows + 128 of zeros
        assert got["q4_pad"].shape == (128, 0)
        assert tquant.logical_packed_rows(got) == 5504
        assert not got["q4"][5504:].any()


def test_quantize_weight_zero_column_and_bad_input():
    w = weight(0, (64, 16))
    w[:, 3] = 0.0                                   # scale floor 1e-8
    for bits in (8, 4):
        assert_same_quantized(
            tquant.quantize_weight(torch.from_numpy(w), bits),
            jquant.quantize_weight(jnp.asarray(w), bits))
    with pytest.raises(ValueError, match="bits"):
        tquant.quantize_weight(torch.zeros(4, 4), bits=3)
    with pytest.raises(ValueError, match="even"):
        tquant.quantize_weight(torch.zeros(5, 4), bits=4)


@pytest.mark.parametrize("k2", [2048, 2816, 256, 5632, 5504, 9472, 100, 255,
                                2944, 6912, 7168, 14336, 128 * 43, 128 * 67])
def test_pad_packed_rows_equals_jax(k2):
    assert tquant.pad_packed_rows(k2) == jqm.pad_packed_rows(k2)


def test_pad_packed_rows_equals_jax_on_a_grid():
    assert tquant.CAP_K == jqm.CAP_K
    for k2 in list(range(64, 12000, 64)) + list(range(1, 600, 7)):
        assert tquant.pad_packed_rows(k2) == jqm.pad_packed_rows(k2), k2
    for dim in range(128, 6000, 128):
        assert tquant._pick_block(dim) == \
            jqm._pick_block(dim, cap=jqm.CAP_K, floor=256)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,shape", [(8, (64, 48)), (4, (64, 48)),
                                        (4, (2, 5888, 16)), (8, (2, 64, 32))])
def test_dequantize_weight_equals_jax(bits, shape, dtype):
    w = weight(bits + len(shape), shape)
    wq = jquant.quantize_weight(jnp.asarray(w), bits)
    want = jquant.dequantize_weight(wq, dtype=getattr(jnp, dtype))
    tq = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in wq.items()}
    got = tquant.dequantize_weight(tq, dtype=getattr(torch, dtype))
    assert tuple(got.shape) == shape          # pad rows stripped
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    np.testing.assert_allclose(got.float().numpy(), w,
                               atol=np.abs(w).max() / (5 if bits == 4 else 100))


def test_dequantize_checks_k_and_legacy_dicts():
    w = weight(2, (5888, 16))
    wq = tquant.quantize_weight(torch.from_numpy(w), 4)
    assert wq["q4"].shape == (3072, 16)
    assert tquant.dequantize_weight(wq, torch.float32, k=5888).shape == (5888, 16)
    with pytest.raises(ValueError, match="packed for input dim"):
        tquant.dequantize_weight(wq, k=2 * 3072)
    legacy = {"q4": wq["q4"], "scale": wq["scale"]}       # no sentinel
    assert tquant.logical_packed_rows(legacy) is None
    np.testing.assert_array_equal(
        tquant.dequantize_weight(legacy, torch.float32, k=5888).numpy(),
        tquant.dequantize_weight(wq, torch.float32).numpy())
    assert tquant.quantized_bits(wq) == 4
    assert tquant.quantized_bits({"q": None}) == 8
    assert tquant.quantized_bits(torch.zeros(1)) == 0


def tiny_params(seed=0, **extra):
    jcfg = jlt.LlamaConfig(**ARCH, dtype=jnp.float32, **extra)
    params = jlt.init_params(jcfg, jax.random.PRNGKey(seed), scale=0.5)
    tcfg = tllama.LlamaConfig(**ARCH, dtype=torch.float32, **extra)
    return jcfg, params, tcfg, tllama.params_from_numpy(
        jax.device_get(params), tcfg, "cpu")


def assert_same_tree(got, want):
    assert set(got) == set(want)
    for key, leaf in want.items():
        if isinstance(leaf, dict) and key != "layers":
            assert_same_quantized(got[key], leaf)
        elif isinstance(leaf, dict):
            assert_same_tree(got[key], leaf)
        else:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(leaf),
                                          err_msg=key)


@pytest.mark.parametrize("fuse", ["unfused", "fuse_then_quantize",
                                  "quantize_then_fuse"])
@pytest.mark.parametrize("bits,head", [(8, False), (4, True), (8, True)])
def test_quantize_params_and_fuse_params_equal_jax(bits, head, fuse):
    _, jparams, _, tparams = tiny_params(attention_bias=True)
    kw = dict(bits=bits, quantize_lm_head=head, lm_head_bits=8)
    if fuse == "fuse_then_quantize":
        want = jquant.quantize_params(jllama.fuse_params(jparams), **kw)
        got = tquant.quantize_params(tllama.fuse_params(tparams), **kw)
    else:
        want = jquant.quantize_params(jparams, **kw)
        got = tquant.quantize_params(tparams, **kw)
        if fuse == "quantize_then_fuse":
            want, got = jllama.fuse_params(want), tllama.fuse_params(got)
    assert_same_tree(got, jax.device_get(want))
    if fuse != "unfused":
        assert "wqkv" in got["layers"] and "bqkv" in got["layers"]
        assert "wq" not in got["layers"] and "w_gate" not in got["layers"]
    assert isinstance(got["lm_head"], dict) == head


@pytest.mark.parametrize("flags", [dict(qkv=False), dict(gate_up=False)])
def test_fuse_params_flags_and_mixed_trees(flags):
    _, jparams, _, tparams = tiny_params()
    assert_same_tree(tllama.fuse_params(tparams, **flags),
                     jax.device_get(jllama.fuse_params(jparams, **flags)))
    mixed = dict(tparams, layers=dict(tparams["layers"]))
    mixed["layers"]["wk"] = tquant.quantize_weight(tparams["layers"]["wk"])
    fused = tllama.fuse_params(mixed)
    assert "wqkv" not in fused["layers"]      # plain and quantized: unfused
    assert "w_gate_up" in fused["layers"]


@pytest.mark.parametrize("bits", [8, 4])
def test_params_from_numpy_carries_a_quantized_tree_unchanged(bits):
    """int8 stays int8, scales stay float32 (even for a bfloat16 model) and
    the zero-element sentinel keeps its shape."""
    jcfg = jlt.LlamaConfig(**ARCH, dtype=jnp.bfloat16)
    jq = jax.device_get(jquant.quantize_params(
        jllama.fuse_params(jlt.init_params(jcfg, jax.random.PRNGKey(1))),
        bits=bits, quantize_lm_head=True))
    got = tllama.params_from_numpy(
        jq, tllama.LlamaConfig(**ARCH, dtype=torch.bfloat16), "cpu")
    assert_same_quantized(got["lm_head"], jq["lm_head"])
    for name in ("wqkv", "wo", "w_gate_up", "w_down"):
        assert_same_quantized(got["layers"][name], jq["layers"][name])
        assert got["layers"][name]["scale"].dtype == torch.float32
    assert got["embed"].dtype == torch.bfloat16
    assert got["layers"]["input_norm"].dtype == torch.bfloat16


@pytest.mark.parametrize("bits,k", [(8, 512), (4, 512), (4, 5888)])
def test_qmatmul_on_the_cpu_is_the_plain_version(bits, k):
    rng = np.random.RandomState(k + bits)
    x = rng.randn(9, k).astype(np.float32)
    w = rng.randn(k, 64).astype(np.float32) * 0.2
    wq = jquant.quantize_weight(jnp.asarray(w), bits)
    want = jquant.qmatmul(jnp.asarray(x), wq)
    tq = {key: torch.from_numpy(np.asarray(v).copy()) for key, v in wq.items()}
    tqm.counts.update(dict.fromkeys(tqm.counts, 0))
    got = tquant.qmatmul(torch.from_numpy(x), tq)
    assert tqm.counts == dict(dict.fromkeys(tqm.counts, 0), plain=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    plain = torch.from_numpy(x) @ tquant.dequantize_weight(tq, torch.float32)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-4, atol=2e-4)
    dense = torch.from_numpy(w)
    assert tquant.qmatmul(torch.from_numpy(x), dense).shape == (9, 64)
    assert tqm.counts["plain"] == 1             # a plain tensor: no wrapper
