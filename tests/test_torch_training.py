"""The port's training path against the JAX package's, in float32 on the
CPU, from the same numpy weights: ``forward_train`` logits, the loss and
its gradients, and five Adam and five SGD steps of ``make_train_step``.

Tolerances: logits rtol/atol 1e-5 (the same float32 math through two
layers, summed in another order); loss and gradients rtol 1e-4 with atol
1e-6 (a backward pass adds a second reduction order); each loss of the
five steps within rtol 1e-5. After five SGD steps every parameter within
atol 1e-6 of JAX's. Adam normalises each element by its own gradient's
size, so an element whose gradient is near zero, where the two reduction
orders differ in relative terms, moves by a different fraction of a step
(|update| <= ~1, times lr = 1e-3): every parameter within lr / 10, and
99.9% of the elements within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lookaheaddecoding_tpu as jlt
from lookaheaddecoding_tpu.models import llama as jllama
from lookaheaddecoding_tpu.training import train_step as jtrain
from lookaheaddecoding_tpu_torch.models import llama as tllama
from lookaheaddecoding_tpu_torch.training import (init_opt_state,
                                                  make_train_step,
                                                  next_token_loss)

ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
            max_position_embeddings=128)
SEQ = 64


def models(scale=0.1, **extra):
    jcfg = jlt.LlamaConfig(**ARCH, dtype=jnp.float32, **extra)
    tcfg = tllama.LlamaConfig(**ARCH, dtype=torch.float32, **extra)
    tree = jax.device_get(jlt.init_params(jcfg, jax.random.PRNGKey(0),
                                          scale=scale))
    return jcfg, tree, tcfg, tllama.params_from_numpy(tree, tcfg, "cpu")


def batch(seed=1, b=4, t=33):
    return np.random.RandomState(seed).randint(
        0, ARCH["vocab_size"], size=(b, t)).astype(np.int32)


def leaves(tree, prefix=""):
    """{path: numpy array} of a JAX or a torch tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().numpy()}
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("extra", [
    {}, dict(tie_word_embeddings=True),
    dict(hidden_act="gelu_pytorch_tanh", rms_norm_offset=1.0,
         scale_embeddings=True),
], ids=["llama", "tied", "gemma_style"])
def test_forward_train_logits_match_jax(extra):
    jcfg, tree, tcfg, tparams = models(**extra)
    if extra.get("tie_word_embeddings"):
        tree = {k: v for k, v in tree.items() if k != "lm_head"}
        tparams = {k: v for k, v in tparams.items() if k != "lm_head"}
    tokens = batch()[:, :-1]
    jcos, jsin = jllama.rope_tables(jcfg, SEQ)
    want = jllama.forward_train(tree, jcfg, jnp.asarray(tokens), jcos, jsin)
    tcos, tsin = tllama.rope_tables(tcfg, SEQ, "cpu")
    got = tllama.forward_train(tparams, tcfg, torch.from_numpy(tokens),
                               tcos, tsin)
    assert got.dtype == torch.float32 and got.shape == (4, 32, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_loss_and_gradients_match_jax_grad():
    jcfg, tree, tcfg, tparams = models()
    b = batch()
    jcos, jsin = jllama.rope_tables(jcfg, SEQ)
    jloss, jgrads = jax.value_and_grad(jtrain.next_token_loss)(
        jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(b), jcos, jsin)
    tcos, tsin = tllama.rope_tables(tcfg, SEQ, "cpu")
    flat = leaves(tparams)
    live = {k: torch.from_numpy(v.copy()).requires_grad_(True)
            for k, v in flat.items()}
    tree_t = {"layers": {}}
    for k, v in live.items():
        parts = k.strip("/").split("/")
        (tree_t["layers"] if parts[0] == "layers" else tree_t)[parts[-1]] = v
    loss = next_token_loss(tree_t, tcfg, torch.from_numpy(b), tcos, tsin)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    want = leaves(jax.device_get(jgrads))
    assert set(want) == set(live)
    for k, v in live.items():
        np.testing.assert_allclose(v.grad.numpy(), want[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_five_steps_match_jax_train_step(optimizer):
    jcfg, tree, tcfg, tparams = models()
    lr = 1e-3 if optimizer == "adam" else 1e-2
    jstep = jtrain.make_train_step(jcfg, seq_len=SEQ, learning_rate=lr,
                                   optimizer=optimizer)
    jp = jax.tree.map(jnp.asarray, tree)
    jopt = jtrain.init_opt_state(jp, optimizer)
    tstep = make_train_step(tcfg, seq_len=SEQ, learning_rate=lr,
                            optimizer=optimizer)
    tp = tparams
    topt = init_opt_state(tp, optimizer)
    before = leaves(tp)
    for i in range(5):
        b = batch(seed=10 + i)
        jp, jopt, jloss = jstep(jp, jopt, jnp.asarray(b))
        tp, topt, tloss = tstep(tp, topt, b)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    # functional: the first tree was not written
    for k, v in leaves(tparams).items():
        np.testing.assert_array_equal(v, before[k])
    want, got = leaves(jax.device_get(jp)), leaves(tp)
    assert set(want) == set(got)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=0, err_msg=k,
                                   atol=lr / 10 if optimizer == "adam"
                                   else 1e-6)
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert np.quantile(diff, 0.999) <= 1e-6
    if optimizer == "adam":
        assert int(topt["count"]) == int(jopt[0].count) == 5
        # the moments carry the gradients' tolerance: (1 - b1) g summed
        # over the steps, and (1 - b2) g^2, whose relative error doubles
        for name, rtol, atol in (("mu", 1e-4, 1e-7), ("nu", 2e-4, 1e-12)):
            w = leaves(jax.device_get(getattr(jopt[0], name)))
            for k, v in leaves(topt[name]).items():
                np.testing.assert_allclose(v, w[k], rtol=rtol, atol=atol,
                                           err_msg=(name, k))
    else:
        w = leaves(jax.device_get(jopt))
        for k, v in leaves(topt).items():
            np.testing.assert_allclose(v, w[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_training_reduces_loss():
    """The JAX package's ``test_training_reduces_loss`` on the port: twenty
    Adam steps at lr 0.5 on a repeating corpus cut the loss by 30%."""
    tcfg = tllama.LlamaConfig(**ARCH, dtype=torch.float32)
    params = tllama.init_params(tcfg, seed=3, scale=0.2, device="cpu")
    base = np.random.RandomState(0).randint(0, 128, size=32)
    b = torch.from_numpy(np.stack([np.tile(base, 2)[:48]] * 4))
    step = make_train_step(tcfg, seq_len=64, learning_rate=0.5)
    opt = init_opt_state(params)
    loss0 = float(next_token_loss(params, tcfg, b,
                                  *tllama.rope_tables(tcfg, 64, "cpu")))
    for _ in range(20):
        params, opt, loss = step(params, opt, b)
    assert float(loss) < loss0 * 0.7


def test_mesh_unknown_optimizer_and_other_trees_raise():
    _, _, tcfg, tparams = models()
    with pytest.raises(TypeError, match="Mesh"):
        make_train_step(tcfg, seq_len=SEQ, mesh=object())
    with pytest.raises(ValueError, match="optimizer"):
        make_train_step(tcfg, seq_len=SEQ, optimizer="adamw")
    with pytest.raises(ValueError, match="optimizer"):
        init_opt_state(tparams, "lion")
    cos, sin = tllama.rope_tables(tcfg, SEQ, "cpu")
    tokens = torch.from_numpy(batch()[:, :-1])
    for tree in (tllama.fuse_params(tparams),
                 {**tparams, "layers": {**tparams["layers"],
                                        "bq": tparams["layers"]["wq"][:, 0]}}):
        with pytest.raises(ValueError, match="unfused, unquantized"):
            tllama.forward_train(tree, tcfg, tokens, cos, sin)
