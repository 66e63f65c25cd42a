"""The tied XLNet-MLM model at the paper's item-table width (E = 448)
against the JAX package on the CPU.

The paper's XLNet-MLM command ties a 448-wide item table to the output
through a d_model→448 projection (``examples/paper_repro/README.md``:
``--item_embedding_dim 448 --mf_constrained_embeddings``). A small model of
that shape (about 1,000 items, d_model 32, 2 layers, 2 heads, sessions of
8, dropout 0) is built in both packages with the same weights
(``convert.params_from_jax``); the reference's masks are drawn by its own
function and given to both, as in ``test_torch_trainer.py``.

Tolerances, as the E = 64 tests': one step's loss within 1e-5 relative,
every gradient within 1e-3 in relative Frobenius norm (the CE's residual is
rounded to bf16 in both); evaluation in f32 end to end, the loss within
1e-4 and the metrics, sums of per-row values of the same ranks, within
1e-6; the ranks of the testing pass equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import transformers4rec_tpu as jtr
from transformers4rec_tpu.data.synthetic import synthetic_ecommerce_data_schema as jax_schema_fn
from transformers4rec_tpu.masking import MaskedLanguageModeling as JaxMLM
from transformers4rec_tpu.ops.vocab import fused_ce_and_rank as jax_fused_ce_and_rank

from transformers4rec_tpu_torch import convert, flagship
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.ops import vocab

torch.set_num_threads(1)

V, D, L, H, S, ROWS = 1000, 32, 2, 2, 8, 16
E = flagship.PAPER_ITEM_DIM
# a key bias shifts every logit of a query alike and the softmax ignores it:
# its gradient is rounding noise around zero in both packages
ZERO_GRADIENT = "attn.k.bias"


def _batch(seed, rows=ROWS):
    return synthetic_data(flagship.schema(V, S), num_rows=rows, max_session_length=S, seed=seed)


@pytest.fixture(scope="module")
def pair():
    schema = jax_schema_fn(num_items=V, num_categories=flagship.NUM_CATEGORIES,
                           max_session_length=S)
    im = jtr.TabularSequenceFeatures.from_schema(
        schema, d_output=D, masking="mlm", aggregation="concat",
        masking_kwargs={"mlm_probability": 0.3}, embedding_dims={"item_id": E},
    )
    cfg = jtr.XLNetConfig.build(d_model=D, n_head=H, n_layer=L, total_seq_length=S, dropout=0.0)
    jmodel = cfg.to_model(im, jtr.NextItemPredictionTask(weight_tying=True))
    init_batch = {k: jnp.asarray(v) for k, v in _batch(0, rows=4).items()}
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), init_batch)
    tmodel = flagship.build_model("cpu", num_items=V, d_model=D, n_layer=L, n_head=H, seq=S,
                                  seed=1, dropout=0.0, item_dim=E)
    tmodel.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


def _rel_fro(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_the_model_is_tied_at_the_papers_width(pair):
    _, params, tmodel = pair
    table = tmodel.heads[0].input_module.item_embedding_table()
    assert table.shape == (-(-(V + 1) // 8) * 8, E)
    projection = tmodel.heads[0].tasks[0].tying_projection
    assert (projection.in_features, projection.out_features) == (D, E)


def test_one_training_step_at_e448_matches_jax(pair, monkeypatch):
    jmodel, params, tmodel = pair
    batch = _batch(11)
    ids = np.asarray(batch["item_id"])
    info = JaxMLM.compute_masked_targets(JaxMLM(hidden_size=D, mlm_probability=0.3),
                                         jax.random.PRNGKey(3), jnp.asarray(ids), training=True)
    original = JaxMLM.compute_masked_targets

    def jax_masks(self, rng, item_ids, training=False, testing=False, segment_ids=None):
        if not training:
            return original(self, rng, item_ids, training, testing, segment_ids)
        return info

    monkeypatch.setattr(JaxMLM, "compute_masked_targets", jax_masks)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rngs = {"masking": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}

    def loss_fn(p):
        return jmodel.apply(p, jb, targets=jb, training=True, compute_metrics=False,
                            rngs=rngs)[0]

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    want = convert.params_from_jax(jax.tree.map(np.asarray, want_grads))

    tmodel.zero_grad(set_to_none=True)
    tb = tmodel._as_dense(batch)
    tinfo = convert.masking_info_from_jax(np.asarray(info.targets), np.asarray(info.mask),
                                          np.asarray(info.pad_mask))
    loss, _ = tmodel(tb, targets=tb, training=True, masking_info=tinfo)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(got) == set(want) and all(g is not None for g in got.values())
    assert got["heads.0.body.blocks.0.categorical_module.tables.item_id"].shape[1] == E
    for name in sorted(want):
        if name.endswith(ZERO_GRADIENT):
            scale = float(want[name.replace("attn.k.", "attn.q.")].norm())
            assert float(got[name].norm()) <= 1e-5 * scale >= float(want[name].norm()), name
            continue
        assert _rel_fro(got[name].numpy(), want[name].numpy()) <= 1e-3, name
    tmodel.zero_grad(set_to_none=True)


def test_evaluation_and_ranks_at_e448_match_jax(pair):
    jmodel, params, tmodel = pair
    loader = [_batch(7), _batch(8, rows=9)]
    want = jmodel.evaluate(loader, params)
    got = tmodel.evaluate(loader)
    assert want.keys() == got.keys()
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=1e-4)
    for k in want:
        if k != "eval_loss":
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_fused_ce_and_rank_at_e448_matches_jax(eps):
    """The evaluation's ranks and loss at the paper's width: the port's
    plain K3 against the JAX scan, ranks equal."""
    rng = np.random.default_rng(E)
    n, rows = 53, 1008
    W = rng.normal(0.0, 0.05, (rows, E)).astype(np.float32)
    labels = rng.integers(1, V + 1, n).astype(np.int32)
    x = (rng.uniform(0, 12, (n, 1)) * W[labels] + rng.normal(0, 1, (n, E))).astype(np.float32)
    weights = (rng.random(n) > 0.2).astype(np.float32)
    want_loss, want_rank = jax_fused_ce_and_rank(
        jnp.asarray(x), jnp.asarray(W), jnp.asarray(labels), jnp.asarray(weights),
        use_pallas=False, vocab_size=V + 1, label_smoothing=eps)
    got_loss, got_rank = vocab.fused_ce_and_rank(
        torch.from_numpy(x), torch.from_numpy(W), torch.from_numpy(labels),
        torch.from_numpy(weights), vocab_size=V + 1, label_smoothing=eps)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    np.testing.assert_array_equal(got_rank.numpy(), np.asarray(want_rank))
