"""The input options of the paper's command line against the JAX package on
the CPU: the continuous projection, soft embeddings of continuous columns,
pretrained embeddings in both modes (tables looked up in the model, and
precomputed vectors), the ``projection`` MLP of the sequence input module
and an ``MLPBlock`` between the input module and the transformer
(``Head.from_body(extra_blocks=...)``).

The weights go JAX → port through ``convert.params_from_jax``, loaded
strictly. Forward outputs must agree within 1e-5 in relative Frobenius
norm; gradients (of the sum of the outputs times fixed random weights, or
of the model's loss with the same injected mask) within 1e-4. A frozen
pretrained table takes no gradient and sits in no optimizer group. Inputs
come from numpy seeds; the sizes are small.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformers4rec_tpu as jtr
from transformers4rec_tpu.blocks.base import MLPBlock as JaxMLPBlock
from transformers4rec_tpu.data.synthetic import synthetic_ecommerce_data_schema as jax_schema_fn
from transformers4rec_tpu.features.embedding import (
    PretrainedEmbeddingsInitializer as JaxPretrainedInit,
)
from transformers4rec_tpu.masking import MaskedLanguageModeling as JaxMLM
from transformers4rec_tpu.schema import ColumnSchema as JaxColumn
from transformers4rec_tpu.schema import Schema as JaxSchema

import transformers4rec_tpu_torch as ttr
from transformers4rec_tpu_torch import convert, flagship
from transformers4rec_tpu_torch.blocks import MLPBlock
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.features.embedding import PretrainedEmbeddingsInitializer
from transformers4rec_tpu_torch.schema import ColumnSchema, Schema, Tags

torch.set_num_threads(1)

FWD_RTOL = 1e-5   # forward outputs, relative Frobenius norm
GRAD_RTOL = 1e-4  # losses and gradients

V, S, B = 40, 6, 5
# a key bias shifts every logit of a query alike and the softmax ignores it:
# its gradient is rounding noise around zero in both packages
ZERO_GRADIENT = "attn.k.bias"


def _rel_fro(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _schemas(extra_jax=(), extra_port=()):
    jschema = jax_schema_fn(num_items=V, num_categories=flagship.NUM_CATEGORIES,
                            max_session_length=S)
    return (JaxSchema(list(jschema) + list(extra_jax)),
            Schema(list(flagship.schema(V, S)) + list(extra_port)))


def _batch(seed, rows=B, schema=None):
    return synthetic_data(schema or flagship.schema(V, S), num_rows=rows, max_session_length=S,
                          seed=seed)


def _perturbed(params, seed=1, scale=0.1):
    """Move every weight off its initial value (LayerNorm's ones and zeros
    included), so that a swapped pair of weights would show."""
    leaves, tree = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree.unflatten(tree, [x + scale * jax.random.normal(k, x.shape)
                                     for x, k in zip(leaves, keys)])


def _check_module(jm, tm, batch, frozen=()):
    """Forward of the JAX and the port module on ``batch`` and the gradient
    of ``sum(out * R)`` for a fixed random R, every weight (but the frozen
    ones, which take none)."""
    jin = {k: jnp.asarray(v) for k, v in batch.items()}
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jin))
    tm.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, params)), strict=True)

    def first(out):
        return out[0] if isinstance(out, tuple) else out

    want = np.asarray(first(jm.apply(params, jin)))
    R = np.random.default_rng(9).normal(size=want.shape).astype(np.float32)

    def loss_fn(p):
        return jnp.sum(first(jm.apply(p, jin)) * R)

    want_grads = convert.params_from_jax(jax.tree.map(np.asarray, jax.grad(loss_fn)(params)))
    got = first(tm({k: torch.from_numpy(v) for k, v in batch.items()}))
    assert got.shape == want.shape
    assert _rel_fro(got.detach().numpy(), want) <= FWD_RTOL
    (got * torch.from_numpy(R)).sum().backward()
    for name, p in tm.named_parameters():
        if name in frozen:
            assert p.grad is None and not p.requires_grad, name
            assert float(np.abs(want_grads[name].numpy()).max()) == 0.0, name
            continue
        assert _rel_fro(p.grad.numpy(), want_grads[name].numpy()) <= GRAD_RTOL, name
    return tm


@pytest.mark.parametrize("layers", [[8], [8, 6]])
def test_the_continuous_projection_matches_jax(layers):
    jschema, tschema = _schemas()
    kw = dict(aggregation="concat", continuous_projection=layers, embedding_dim_default=4)
    jm = jtr.TabularSequenceFeatures.from_schema(jschema, **kw)
    tm = ttr.TabularSequenceFeatures.from_schema(tschema, **kw)
    assert tm.feature_sizes()["continuous_projection"] == layers[-1]
    assert tm.output_size() == jm.output_size()
    tm = _check_module(jm, tm, _batch(1))
    assert hasattr(tm, f"continuous_projection_{len(layers) - 1}")
    # without continuous columns the projection is left out, as in JAX
    kw["continuous_tags"] = ()
    jm, tm = (pkg.TabularSequenceFeatures.from_schema(schema, **kw)
              for pkg, schema in ((jtr, jschema), (ttr, tschema)))
    assert tm.output_size() == jm.output_size() == 8 and tm.continuous_projection is None


def test_soft_embeddings_match_jax():
    jschema, tschema = _schemas()
    kw = dict(aggregation="concat", continuous_soft_embeddings=True, embedding_dim_default=4,
              soft_embedding_cardinality_default=5, soft_embedding_dim_default=3,
              post="layer-norm")
    jm = jtr.TabularSequenceFeatures.from_schema(jschema, **kw)
    tm = ttr.TabularSequenceFeatures.from_schema(tschema, **kw)
    assert tm.output_size() == jm.output_size() == 4 + 4 + 3 + 3
    _check_module(jm, tm, _batch(2))
    assert tuple(tm.continuous_module.soft_item_recency.embedding_table.shape) == (5, 3)


def test_the_projection_kwarg_matches_jax():
    jschema, tschema = _schemas()
    kw = dict(aggregation="concat", projection=[12], d_output=8, embedding_dim_default=4)
    jm = jtr.TabularSequenceFeatures.from_schema(jschema, **kw)
    tm = ttr.TabularSequenceFeatures.from_schema(tschema, **kw)
    assert tm.projection_dims == (12, 8) and tm.output_size() == 8
    _check_module(jm, tm, _batch(3))


@pytest.mark.parametrize("trainable", [False, True])
def test_pretrained_tables_looked_up_in_the_model_match_jax(trainable):
    jschema, tschema = _schemas()
    matrix = np.random.default_rng(4).normal(size=(flagship.NUM_CATEGORIES + 1, 6))
    matrix = matrix.astype(np.float32)
    kw = dict(aggregation="concat", categorical_tags=[Tags.ITEM_ID], continuous_tags=(),
              embedding_dim_default=4, pretrained_embeddings={"category": matrix},
              pretrained_trainable=trainable, pretrained_projection_dim=5)
    jm = jtr.TabularSequenceFeatures.from_schema(jschema, **kw)
    tm = ttr.TabularSequenceFeatures.from_schema(tschema, **kw)
    assert tm.feature_sizes() == {"item_id": 4, "category": 5}
    frozen = () if trainable else ("pretrained_module.category_pretrained",)
    _check_module(jm, tm, _batch(5), frozen=frozen)
    if not trainable:
        model = ttr.Model([ttr.Head.from_body(
            ttr.TabularSequenceFeatures.from_schema(tschema, masking="mlm", d_output=8, **kw),
            ttr.XLNetConfig.build(8, 2, 1, S))], device="cpu")
        trainer = ttr.Trainer(model, ttr.T4RecTrainingArguments(data_loader_engine="synthetic"),
                              schema=tschema, device="cpu")
        table = model.heads[0].input_module.pretrained_module.category_pretrained
        np.testing.assert_array_equal(table.detach().numpy(), matrix)
        in_groups = [p for opt in trainer.create_optimizer_and_scheduler(4).values()
                     for g in opt.param_groups for p in g["params"]]
        assert all(p is not table for p in in_groups)


def test_precomputed_embedding_columns_match_jax():
    D = 7
    jcol = JaxColumn(name="text_vec", type=3, tags=[Tags.EMBEDDING.value])
    tcol = ColumnSchema(name="text_vec", type=3, tags=[Tags.EMBEDDING.value])
    jschema, tschema = _schemas([jcol], [tcol])
    kw = dict(aggregation="concat", continuous_tags=(), embedding_dim_default=4,
              pretrained_output_dims={"text_vec": D}, pretrained_projection_dim=3,
              pretrained_sequence_combiner="mean")
    jm = jtr.TabularFeatures.from_schema(jschema, **kw)
    tm = ttr.TabularFeatures.from_schema(tschema, **kw)
    batch = {k: v for k, v in _batch(6).items() if k in ("item_id", "category")}
    rng = np.random.default_rng(6)
    vec = rng.normal(size=(B, S, D)).astype(np.float32)
    vec[:, -2:] = 0.0  # padded positions carry zero vectors
    batch["text_vec"] = vec
    assert tm.feature_sizes()["text_vec"] == 3
    _check_module(jm, tm, batch)


def test_a_frozen_pretrained_table_initialiser_takes_no_gradient():
    jschema, tschema = _schemas()
    rows = flagship.NUM_CATEGORIES + 1
    matrix = np.random.default_rng(8).normal(size=(rows, 4)).astype(np.float32)
    jm = jtr.TabularSequenceFeatures.from_schema(
        jschema, aggregation="concat", embedding_dim_default=4, continuous_tags=(),
        embeddings_initializers={"category": JaxPretrainedInit(matrix, trainable=False)})
    tm = ttr.TabularSequenceFeatures.from_schema(
        tschema, aggregation="concat", embedding_dim_default=4, continuous_tags=(),
        embeddings_initializers={"category": PretrainedEmbeddingsInitializer(matrix)})
    table = tm.categorical_module.tables["category"]
    tm.categorical_module._init_weights(torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(table.detach().numpy()[:rows], matrix)
    assert not bool(table.detach()[rows:].any())
    _check_module(jm, tm, _batch(7), frozen=("categorical_module.tables.category",))


def _mlp_models(use_norm):
    jschema, tschema = _schemas()
    D, L, H = 16, 1, 2
    kw = dict(d_output=D, masking="mlm", aggregation="concat",
              masking_kwargs={"mlm_probability": 0.3}, embedding_dim_default=8)
    jim = jtr.TabularSequenceFeatures.from_schema(jschema, **kw)
    jcfg = jtr.XLNetConfig.build(d_model=D, n_head=H, n_layer=L, total_seq_length=S, dropout=0.0)
    jhead = jtr.Head.from_body(jim, jcfg, tasks=[jtr.NextItemPredictionTask(weight_tying=True)],
                               extra_blocks=(JaxMLPBlock(dimensions=(24, D), use_norm=use_norm),))
    jmodel = jtr.Model(heads=(jhead,))
    tim = ttr.TabularSequenceFeatures.from_schema(tschema, **kw)
    tcfg = ttr.XLNetConfig.build(d_model=D, n_head=H, n_layer=L, total_seq_length=S,
                                 dropout=0.0)
    thead = ttr.Head.from_body(tim, tcfg, extra_blocks=[MLPBlock([24, D], use_norm=use_norm)])
    return jmodel, ttr.Model([thead], device="cpu")


@pytest.mark.parametrize("use_norm", [False, True])
def test_an_mlp_block_between_the_input_module_and_the_transformer_matches_jax(use_norm,
                                                                                monkeypatch):
    jmodel, tmodel = _mlp_models(use_norm)
    batch = _batch(10, rows=8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = _perturbed(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb), scale=0.02)
    sd = convert.params_from_jax(jax.tree.map(np.asarray, params))
    assert "heads.0.body.blocks.1.dense_1.weight" in sd
    assert ("heads.0.body.blocks.1.norm_0.weight" in sd) == use_norm
    tmodel.load_state_dict(sd, strict=True)
    # evaluation
    want, got = jmodel.evaluate([batch], params), tmodel.evaluate([batch])
    assert want.keys() == got.keys()
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=GRAD_RTOL)
    # one training step with the reference's mask given to both
    info = JaxMLM.compute_masked_targets(JaxMLM(hidden_size=16, mlm_probability=0.3),
                                         jax.random.PRNGKey(3), jb["item_id"], training=True)
    original = JaxMLM.compute_masked_targets

    def jax_masks(self, rng, item_ids, training=False, testing=False, segment_ids=None):
        if not training:
            return original(self, rng, item_ids, training, testing, segment_ids)
        return info

    monkeypatch.setattr(JaxMLM, "compute_masked_targets", jax_masks)
    rngs = {"masking": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    want_loss, want_grads = jax.value_and_grad(lambda p: jmodel.apply(
        p, jb, targets=jb, training=True, compute_metrics=False, rngs=rngs)[0])(params)
    want_grads = convert.params_from_jax(jax.tree.map(np.asarray, want_grads))
    tb = tmodel._as_dense(batch)
    tinfo = convert.masking_info_from_jax(np.asarray(info.targets), np.asarray(info.mask),
                                          np.asarray(info.pad_mask))
    loss, _ = tmodel(tb, targets=tb, training=True, masking_info=tinfo)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=GRAD_RTOL)
    for name, p in tmodel.named_parameters():
        if name.endswith(ZERO_GRADIENT):
            continue
        assert _rel_fro(p.grad.numpy(), want_grads[name].numpy()) <= GRAD_RTOL, name
