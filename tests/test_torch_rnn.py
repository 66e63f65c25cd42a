"""Recurrent bodies (``RNNBlock``) and ``Block`` in the port against the JAX
package (flax's ``nn.RNN`` over ``GRUCell`` / ``OptimizedLSTMCell``) on the
CPU.

- ``RNNBlock`` with GRU and LSTM cells, one and two layers: the flax
  weights through ``convert.params_from_jax`` (every gate in torch's order,
  flax's missing biases at zero) and back through ``params_to_jax``; the
  outputs within 1e-5, the weights' and the input's gradients within 1e-4
  in relative Frobenius norm;
- the biases flax's cells lack stay at zero through an optimizer step;
- the GRU4Rec-style model (input module → ``MLPBlock`` → ``RNNBlock`` → tied
  next-item task, CLM) for both cells: one training step (loss 1e-5
  relative, every gradient 1e-4), evaluation (loss 1e-4, metrics 1e-6) and
  top-k against the JAX model with the same weights;
- a ``SequentialBlock`` refuses packed rows before an ``RNNBlock``, as the
  JAX one does; ``Block`` declares its module's width and passes the
  train/eval flag on;
- the GRU4Rec-style model of both cells exported with
  ``weights_dtype="bfloat16"`` by both packages: the served top-k scores
  within 1e-5 and the ids equal where neighbouring scores are 1e-5 apart.
  Both programs hold the same bf16-rounded weights and compute in f32, as
  ``jnp`` promotes an f32 activation meeting a bf16 weight (the port casts
  the RNN's weights up at the call), so they differ only by the order of
  f32 sums, as the f32 artifacts of ``test_torch_export_program.py`` do.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

import transformers4rec_tpu as jtr
from transformers4rec_tpu.data.synthetic import synthetic_ecommerce_data_schema as jax_schema_fn
from transformers4rec_tpu.serving import export_model as jax_export_model
from transformers4rec_tpu.serving import load_runner as jax_load_runner

from transformers4rec_tpu_torch import (
    Block,
    Head,
    MLPBlock,
    Model,
    NextItemPredictionTask,
    RNNBlock,
    TabularSequenceFeatures,
    convert,
    flagship,
)
from transformers4rec_tpu_torch.data import pack_sessions, synthetic_data
from transformers4rec_tpu_torch.serving import InferenceRunner, export_model

from test_torch_export_program import _assert_same_topk

torch.set_num_threads(1)

V, S, D = 300, 12, 32


def _rel_fro(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _moved(params, seed=1):
    """Every weight off its init (biases off zero), so that each one matters."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + rng.normal(0, 0.1, a.shape).astype(np.float32),
                        params)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("layers", [1, 2])
def test_rnn_block_matches_flax(cell, layers):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7, 5)).astype(np.float32)
    jblock = jtr.RNNBlock(units=6, cell_type=cell, num_layers=layers)
    params = _moved(jblock.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tblock = RNNBlock(units=6, cell_type=cell, num_layers=layers, input_dim=5)
    tblock.load_state_dict(convert.params_from_jax(params))  # strict
    back = convert.params_to_jax(tblock.state_dict(), params)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    w = rng.normal(size=(3, 7, 6)).astype(np.float32)

    def loss(p, xx):
        return (jblock.apply(p, xx) * w).sum()

    want_out = np.asarray(jblock.apply(params, jnp.asarray(x)))
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tblock(xt)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=1e-5, rtol=0)
    want = convert.params_from_jax(jax.tree.map(np.asarray, gp))
    for name, p in tblock.named_parameters():
        assert _rel_fro(p.grad.numpy(), want[name].numpy()) <= 1e-4, name
    assert _rel_fro(xt.grad.numpy(), np.asarray(gx)) <= 1e-4

    # the biases flax's cells lack stay at zero through a step
    opt = torch.optim.AdamW(tblock.parameters(), lr=0.1, weight_decay=0.1)
    opt.step()
    for rnn in tblock.layers():
        if cell == "gru":
            assert not rnn.bias_hh_l0[:12].any() and rnn.bias_hh_l0[12:].any()
        else:
            assert not rnn.bias_ih_l0.any() and rnn.bias_hh_l0.any()


def _gru4rec(cell, device=None):
    """The GRU4Rec-style head of both packages (CLM): input module, one
    MLP layer, a two-layer recurrent body and the tied next-item task."""
    jschema = jax_schema_fn(num_items=V, num_categories=flagship.NUM_CATEGORIES,
                            max_session_length=S)
    jim = jtr.TabularSequenceFeatures.from_schema(jschema, d_output=D, masking="clm",
                                                  aggregation="concat")
    jhead = jtr.Head.from_body(jim, tasks=[jtr.NextItemPredictionTask(weight_tying=True)],
                               extra_blocks=[jtr.MLPBlock(dimensions=(D,)),
                                             jtr.RNNBlock(units=D, cell_type=cell,
                                                          num_layers=2)])
    tim = TabularSequenceFeatures.from_schema(flagship.schema(V, S), d_output=D, masking="clm",
                                              aggregation="concat")
    thead = Head.from_body(tim, tasks=[NextItemPredictionTask(weight_tying=True)],
                           extra_blocks=[MLPBlock((D,)),
                                         RNNBlock(units=D, cell_type=cell, num_layers=2)])
    return jtr.Model(heads=(jhead,)), Model(heads=(thead,), device="cpu")


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_gru4rec_model_matches_jax(cell):
    jmodel, tmodel = _gru4rec(cell)
    batch = synthetic_data(flagship.schema(V, S), num_rows=16, max_session_length=S, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rngs = {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    params = _moved(jax.jit(lambda b: jmodel.init(rngs, b, training=True))(jb), seed=3)
    tmodel.load_state_dict(convert.params_from_jax(params))  # strict
    assert any(".gru_1." in n or ".lstm_1." in n for n in tmodel.state_dict())
    # CLM's labels are the shifted ids: no draw to share
    want_loss, want_grads = jax.jit(jax.value_and_grad(lambda p: jmodel.apply(
        p, jb, targets=jb, training=True, compute_metrics=False,
        rngs={"masking": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)})[0]))(params)
    want = convert.params_from_jax(jax.tree.map(np.asarray, want_grads))
    tb = tmodel._as_dense(batch)
    loss, _ = tmodel(tb, targets=tb, training=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    got = dict(tmodel.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        assert _rel_fro(p.grad.numpy(), want[name].numpy()) <= 1e-4, name
    loader = [synthetic_data(flagship.schema(V, S), num_rows=16, max_session_length=S, seed=7)]
    want_eval, got_eval = jmodel.evaluate(loader, params), tmodel.evaluate(loader)
    assert want_eval.keys() == got_eval.keys()
    np.testing.assert_allclose(got_eval["eval_loss"], want_eval["eval_loss"], rtol=1e-4)
    for k in want_eval:
        if k != "eval_loss":
            np.testing.assert_allclose(got_eval[k], want_eval[k], atol=1e-6, err_msg=k)
    want_s, want_i = jmodel.apply(params, jb, top_k=5)
    with torch.no_grad():
        got_s, got_i = tmodel(tb, top_k=5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_rnn_refuses_packed_rows_and_block_wraps_a_module():
    _, tmodel = _gru4rec("gru")
    data = synthetic_data(flagship.schema(V, S), num_rows=12, max_session_length=S, seed=2,
                          ragged=True)
    packed = tmodel._as_dense(pack_sessions(data, max_len=S, item_id_col="item_id"))
    with pytest.raises(ValueError, match="packed"):
        tmodel(packed, targets=packed, training=True)

    class Noisy(torch.nn.Module):
        def forward(self, x, training=False):
            return x + 1 if training else x

    b = Block(Noisy(), output_dim=4)
    assert b.output_size() == 4
    x = torch.zeros(2, 4)
    assert torch.equal(b(x, training=True), x + 1) and torch.equal(b(x), x)
    lin = Block(torch.nn.Linear(4, 3), output_dim=3)
    assert lin(x).shape == (2, 3) and lin.output_size() == 3
    jb = jtr.Block(module=fnn.Dense(3), output_dim=3)
    assert jb.output_size() == lin.output_size()
    with pytest.raises(ValueError, match="cell_type"):
        RNNBlock(cell_type="rnn")


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_bf16_weights_export_of_an_rnn_body_serves_as_the_jax_artifact(cell, tmp_path):
    jmodel, tmodel = _gru4rec(cell)
    batch = synthetic_data(flagship.schema(V, S), num_rows=6, max_session_length=S, seed=4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rngs = {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    # the JAX tree's shapes without compiling its init; the weights are the
    # port's, moved off their init
    template = jax.eval_shape(lambda b: jmodel.init(rngs, b, training=True), jb)
    tmodel.reset_parameters(3)
    params = _moved(convert.params_to_jax(tmodel.state_dict(), template), seed=5)
    tmodel.load_state_dict(convert.params_from_jax(params))  # strict
    want_path = jax_export_model(jmodel, jax.tree.map(jnp.asarray, params), jb,
                                 str(tmp_path / "jax"), top_k=10, weights_dtype="bfloat16",
                                 batch_polymorphic=False)
    path = export_model(tmodel, batch, str(tmp_path / "port"), top_k=10,
                        weights_dtype="bfloat16", batch_polymorphic=False)
    want_s, want_i = jax_load_runner(want_path).predict(batch, decode_ids=False,
                                                        encode_inputs=False)
    got_s, got_i = InferenceRunner(path, device="cpu").predict(batch, decode_ids=False,
                                                               encode_inputs=False)
    _assert_same_topk(got_s, got_i, want_s, want_i)
    # the model given to the export keeps its f32 weights
    assert {p.dtype for p in tmodel.parameters()} == {torch.float32}
