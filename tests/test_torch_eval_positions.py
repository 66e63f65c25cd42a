"""Evaluation on every position (``eval_on_last_item_seq_only=False``) and
the non-fused evaluation paths: the port against the JAX package on the CPU.

For MLM, CLM and PLM a small XLNet or GPT-2 model (about 1,000 items,
d_model 32, 2 layers, 2 heads, sessions of 20, dropout 0) is built in both
packages with the same weights (``convert.params_from_jax``) and evaluated
on the same batches through ``Model.evaluate``:

- every position, fused: the CE-and-rank pass over all B·S rows (the port's
  plain K3 against the JAX scan), the positions without a target weighted 0;
- every position, not fused: dense f32 logits, the dense cross-entropy and
  ``compute_batch_metrics`` (top-k ranks);
- the last item, not fused (the single-target dense path).

The loss within 1e-5 relative; each metric within 2 / rows (a label whose
logit ties within rounding with another may rank one place apart).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import transformers4rec_tpu as jtr
from transformers4rec_tpu.data.synthetic import synthetic_ecommerce_data_schema as jax_schema_fn
from transformers4rec_tpu.model.ranking_metric import compute_batch_metrics as jax_metrics

from transformers4rec_tpu_torch import convert, flagship
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.model.ranking_metric import compute_batch_metrics, label_ranks

torch.set_num_threads(1)

V, D, L, H, S = 1000, 32, 2, 2, 20
SCHEMES = {"mlm": ("xlnet", {"mlm_probability": 0.3}),
           "clm": ("gpt2", {}),
           "plm": ("xlnet", {"plm_probability": flagship.PLM_PROBABILITY,
                             "max_span_length": flagship.PLM_MAX_SPAN_LENGTH})}


def _batch(seed, rows):
    return synthetic_data(flagship.schema(V, S), num_rows=rows, max_session_length=S, seed=seed)


def _jax_model(scheme, last_only, fused):
    arch, kw = SCHEMES[scheme]
    schema = jax_schema_fn(num_items=V, num_categories=flagship.NUM_CATEGORIES,
                           max_session_length=S)
    im = jtr.TabularSequenceFeatures.from_schema(
        schema, d_output=D, masking=scheme, aggregation="concat",
        masking_kwargs={**kw, "eval_on_last_item_seq_only": last_only})
    cfg = jtr.transformer_registry.parse(arch).build(d_model=D, n_head=H, n_layer=L,
                                                     total_seq_length=S, dropout=0.0)
    return cfg.to_model(im, jtr.NextItemPredictionTask(weight_tying=True, use_fused_ops=fused))


@pytest.fixture(scope="module", params=sorted(SCHEMES))
def scheme_params(request):
    """``(scheme, params)``: the JAX weights, initialised in training as the
    JAX trainer does (PLM reads its [MASK] embedding only there)."""
    jmodel = _jax_model(request.param, False, True)
    key = jax.random.PRNGKey(0)
    init_batch = {k: jnp.asarray(v) for k, v in _batch(0, 4).items()}
    params = jax.jit(lambda b: jmodel.init({"params": key, "masking": key, "dropout": key}, b,
                                           targets=b, training=True))(init_batch)
    return request.param, jax.tree.map(np.asarray, params)


def _port_model(scheme, params, last_only, fused):
    tmodel = flagship.build_model("cpu", num_items=V, d_model=D, n_layer=L, n_head=H, seq=S,
                                  seed=1, dropout=0.0, scheme=scheme,
                                  eval_on_last_item_seq_only=last_only)
    tmodel.load_state_dict(convert.params_from_jax(params))
    tmodel.heads[0].tasks[0].use_fused_ops = fused
    return tmodel


@pytest.mark.parametrize("last_only,fused", [(False, True), (False, False), (True, False)],
                         ids=["every_position_fused", "every_position_dense",
                              "last_item_dense"])
def test_evaluation_matches_jax(scheme_params, last_only, fused):
    scheme, params = scheme_params
    loader = [_batch(7, 12), _batch(8, 9)]
    want = _jax_model(scheme, last_only, fused).evaluate(loader, params)
    tmodel = _port_model(scheme, params, last_only, fused)
    task = tmodel.heads[0].tasks[0]
    assert task.eval_single_target is last_only and task.use_fused_ops is fused
    got = tmodel.evaluate(loader)
    assert want.keys() == got.keys()
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=1e-5)
    # the rows that carry a target: every position but each session's last
    # (CLM, MLM, PLM all label position i with item i + 1), or one a session
    rows = sum(int(((b["item_id"] != 0).sum(1) - 1).clip(0).sum()) if not last_only
               else len(b["item_id"]) for b in loader)
    for k in want:
        if k != "eval_loss":
            assert abs(got[k] - want[k]) <= 2.0 / rows, (k, got[k], want[k])
    # a batch's output: every position a row, weighted by its target mask
    tb = tmodel._as_dense(loader[0])
    with torch.inference_mode():
        _, outs = tmodel(tb, targets=tb, testing=True)
    out = outs["next-item"]
    if last_only:
        assert out.weights.shape == (12,)
    else:
        assert out.weights.shape == (12 * S,) and out.labels.shape == (12 * S,)
        assert float(out.loss_weight) == float(((tb["item_id"] != 0).sum(1) - 1).sum())
    if not fused:
        assert out.predictions.shape == (out.weights.shape[0], V + 1)


def test_every_position_without_metrics_takes_the_fused_cross_entropy(scheme_params):
    """``compute_metrics=False``: the loss alone, from the training CE (K1),
    equal to the CE-and-rank pass's loss."""
    scheme, params = scheme_params
    tmodel = _port_model(scheme, params, False, True)
    tb = tmodel._as_dense(_batch(9, 6))
    with torch.inference_mode():
        loss, outs = tmodel(tb, targets=tb, testing=True, compute_metrics=False)
        want, _ = tmodel(tb, targets=tb, testing=True)
    assert outs["next-item"].metrics is None
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)


def test_batch_metrics_from_dense_scores_match_jax():
    rng = np.random.default_rng(3)
    scores = rng.normal(size=(40, 300)).astype(np.float32)
    labels = rng.integers(0, 300, 40)
    labels[:10] = scores[:10].argsort(1)[:, -3]  # ranked third
    weights = (rng.random(40) > 0.25).astype(np.float32)
    want = jax_metrics(jnp.asarray(scores), jnp.asarray(labels), weights=jnp.asarray(weights))
    got = compute_batch_metrics(torch.from_numpy(scores), torch.from_numpy(labels),
                                weights=torch.from_numpy(weights))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose([float(v) for v in got[k]], [float(v) for v in want[k]],
                                   rtol=1e-6, err_msg=k)
    ranks = label_ranks(torch.from_numpy(scores), torch.from_numpy(labels), 20)
    assert ranks.dtype == torch.int32 and (ranks[:10] == 2).all()
    assert int(ranks.max()) == 20  # not in the top 20
