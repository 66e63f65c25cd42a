"""The whole ported slice against the JAX package on the CPU.

One small REES46-shaped XLNet-MLM model (V=500, d=32, 2 layers, 2 heads,
sessions of 8) is built in both packages; the flax weights move to the port
through ``convert.params_from_jax`` and the same seeded numpy batches go
through both. Tolerances: f32 end to end, so 1e-4 on scores and losses;
the ranking metrics are sums of per-row values of identical ranks, 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import transformers4rec_tpu as jtr
from transformers4rec_tpu.data.synthetic import synthetic_data as jax_synthetic_data
from transformers4rec_tpu.data.synthetic import synthetic_ecommerce_data_schema as jax_schema_fn
from transformers4rec_tpu.masking import MaskedLanguageModeling as JaxMLM

import transformers4rec_tpu_torch as ttr
from transformers4rec_tpu_torch import convert, flagship
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.masking import MaskedLanguageModeling

torch.set_num_threads(1)

V, D, L, H, S = 500, 32, 2, 2, 8


@pytest.fixture(scope="module")
def pair():
    schema = jax_schema_fn(num_items=V, num_categories=flagship.NUM_CATEGORIES,
                           max_session_length=S)
    im = jtr.TabularSequenceFeatures.from_schema(
        schema, d_output=D, masking="mlm", aggregation="concat",
        masking_kwargs={"mlm_probability": 0.3},
    )
    cfg = jtr.XLNetConfig.build(d_model=D, n_head=H, n_layer=L, total_seq_length=S,
                                dropout=0.1)
    jmodel = cfg.to_model(im, jtr.NextItemPredictionTask(weight_tying=True))
    init_batch = {k: jnp.asarray(v) for k, v in
                  jax_synthetic_data(schema, num_rows=4, max_session_length=S, seed=0).items()}
    # inference-mode init creates the same parameters as a training-mode one;
    # jit keeps the JAX side of these tests to a few seconds on the CPU
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), init_batch)
    tmodel = flagship.build_model("cpu", num_items=V, d_model=D, n_layer=L, n_head=H, seq=S,
                                  seed=1)
    tmodel.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


def _batch(seed, rows=12):
    return synthetic_data(flagship.schema(V, S), num_rows=rows, max_session_length=S, seed=seed)


def test_synthetic_data_draws_match_jax():
    want = jax_synthetic_data(jax_schema_fn(V, flagship.NUM_CATEGORIES, S), num_rows=9,
                              max_session_length=S, seed=3, ragged=True)
    got = synthetic_data(flagship.schema(V, S), num_rows=9, max_session_length=S, seed=3,
                         ragged=True)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(want[k], got[k])


def test_inference_topk_matches_jax(pair):
    jmodel, params, tmodel = pair
    batch = _batch(5)
    want_s, want_i = jax.jit(lambda p, b: jmodel.apply(p, b, top_k=20))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        got_s, got_i = tmodel(tmodel._as_dense(batch), top_k=20)
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=1e-4, rtol=0)
    # ids agree wherever the neighbouring scores are more than 1e-4 apart
    # (torch.topk and lax.top_k may order near-ties differently)
    gaps = np.diff(want_s, axis=1)
    clear = np.ones_like(want_i, dtype=bool)
    clear[:, :-1] &= np.abs(gaps) > 1e-4
    clear[:, 1:] &= np.abs(gaps) > 1e-4
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got_i.numpy()[clear], want_i[clear])


def test_testing_mode_loss_and_metrics_match_jax(pair):
    jmodel, params, tmodel = pair
    batch = _batch(6)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_testing(p, b):
        loss, outs = jmodel.apply(p, b, targets=b, testing=True)
        return loss, outs["next-item"].metrics

    want_loss, want_m = jax.jit(jax_testing)(params, jb)
    with torch.inference_mode():
        tb = tmodel._as_dense(batch)
        got_loss, got_outs = tmodel(tb, targets=tb, testing=True)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-4)
    got_m = got_outs["next-item"].metrics
    assert want_m.keys() == got_m.keys()
    for k in want_m:
        for w, g in zip(want_m[k], got_m[k]):
            np.testing.assert_allclose(float(g), float(w), atol=1e-6, err_msg=k)


def test_evaluate_matches_jax(pair):
    jmodel, params, tmodel = pair
    loader = [_batch(7), _batch(8, rows=9)]
    want = jmodel.evaluate(loader, params)
    got = tmodel.evaluate(loader)
    assert want.keys() == got.keys()
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=1e-4)
    for k in want:
        if k != "eval_loss":
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


def test_mlm_inference_extension_puts_mask_at_len():
    rng = np.random.default_rng(0)
    B = 5
    lengths = np.array([1, 3, 8, 5, 2])
    ids = np.where(np.arange(S)[None, :] < lengths[:, None],
                   rng.integers(1, V, (B, S)), 0).astype(np.int64)
    emb = rng.normal(size=(B, S, D)).astype(np.float32)
    mask_emb = rng.normal(size=(D,)).astype(np.float32)

    jm = JaxMLM(hidden_size=D)
    want_x, want_info = jm.apply({"params": {"masked_item_embedding": jnp.asarray(mask_emb)}},
                                 jnp.asarray(emb), jnp.asarray(ids))
    tm = MaskedLanguageModeling(hidden_size=D)
    with torch.no_grad():
        tm.masked_item_embedding.copy_(torch.from_numpy(mask_emb))
        got_x, got_info = tm(torch.from_numpy(emb), torch.from_numpy(ids))

    assert got_x.shape == (B, S + 1, D)
    rows = np.arange(B)
    np.testing.assert_array_equal(got_x.numpy()[rows, lengths], np.broadcast_to(mask_emb, (B, D)))
    np.testing.assert_array_equal(got_info.targets.numpy()[rows, lengths], ids[rows, lengths - 1])
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=0)
    for f in ("targets", "mask", "input_schema", "pad_mask"):
        np.testing.assert_array_equal(getattr(got_info, f).numpy(),
                                      np.asarray(getattr(want_info, f)), err_msg=f)


def test_port_exports_its_public_names():
    assert ttr.XLNetConfig.build(32, 2, 2, 8).total_seq_length == 10
    assert set(ttr.ranking_metric.finalize_metrics(
        ttr.ranking_metric.init_metric_state())) == {
        f"{m}_at_{k}" for m in ("ndcg", "avg_precision", "recall") for k in (10, 20)}
