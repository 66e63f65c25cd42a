"""The rest of the prediction head of the port against the JAX package on the
CPU: log-uniform sampled softmax, the untied output layer and task blocks,
the sequence summary and the dense tasks' losses.

- ``LogUniformSampler``: the pmf at ids up to 390,001 and 4,000,001 (where
  the plain ``log`` difference goes negative in float32) against the JAX
  sampler's, and the port's draws held to the pmf by a χ² test;
- one sampled-softmax training step of a small XLNet-MLM (vocab 1,000,
  d_model 32, 2 layers) with the JAX draw's mask and negatives given to
  both (``convert.masking_info_from_jax(..., neg_ids=)`` and the JAX
  batch's ``__neg_ids__``), temperature 0.7, label smoothing 0.1 and an
  accidental hit: the loss and every gradient; the same model's
  full-catalogue evaluation and top-k;
- the untied output layer with task blocks in training, evaluation and
  top-k;
- ``summarize``'s four modes, the binary cross-entropy and squared error;
- the paper experiment script with ``--sampled_softmax --sampled_softmax_max_n_samples
  64`` on synthetic windows, and ``Model.fit``/``save``/``load`` of a
  sampled-softmax model.

Tolerances. The pmf: within 2 float32 ulps of JAX's, 2.4e-7 relative
(XLA's and PyTorch's ``log1p`` round a few arguments to neighbouring
values, and the division by log(range + 1) can carry that to 2 ulps).
``expected_probs`` takes ``expm1``, which XLA's CPU backend computes up to
5 ulps (3.3e-7 relative) from the float64 value, where PyTorch's is within
6e-8: against JAX within 5e-7 relative, against float64 within 3e-7 (the
pmf's own rounding carried through). Model steps:
the loss within 1e-5 relative and every gradient within 1e-5 in relative
Frobenius norm (the sampled path has no bf16 rounding: f32 gathers and f32
products on both sides); the full-softmax paths round the CE's residual
to bf16 in both packages and are held to 1e-4, as ``test_torch_archs.py``
holds them; evaluation loss 1e-4, metrics 1e-6, top-k scores 1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import transformers4rec_tpu as jtr
from transformers4rec_tpu.data.synthetic import synthetic_ecommerce_data_schema as jax_schema_fn
from transformers4rec_tpu.masking import MaskedLanguageModeling as JaxMLM
from transformers4rec_tpu.model import losses as jlosses
from transformers4rec_tpu.model.prediction_task import LogUniformSampler as JaxSampler
from transformers4rec_tpu.model.prediction_task import PredictionTask as JaxPredictionTask

from transformers4rec_tpu_torch import (
    NextItemPredictionTask,
    TabularSequenceFeatures,
    XLNetConfig,
    convert,
    flagship,
)
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.model import (
    LogUniformSampler,
    PredictionTask,
    binary_cross_entropy_with_logits,
    mse_loss,
)
from transformers4rec_tpu_torch.paper_repro import transf_exp_main

torch.set_num_threads(1)

D, H, L = 32, 2, 2
V, S = 1000, 10
ROWS = 16
ZERO_GRADIENT = "attn.k.bias"  # the softmax ignores it: rounding noise in both


def _rel_fro(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# -------------------------------------------------------------------- sampler
@pytest.mark.parametrize("vocab,n", [(1000, 64), (390_001, 8192), (4_000_001, 8192)])
def test_sampler_probabilities_match_jax(vocab, n):
    rng = np.random.default_rng(vocab)
    ids = np.concatenate([np.arange(0, 2_000), rng.integers(0, vocab + 5, 50_000),
                          [vocab // 2, vocab - 3, vocab - 2, vocab - 1, vocab]]).astype(np.int64)
    j, t = JaxSampler(n, vocab, 1), LogUniformSampler(n, vocab, 1)
    p_want = np.asarray(j.probs(jnp.asarray(ids, jnp.int32)))
    p_got = t.probs(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_max_ulp(p_got, p_want, maxulp=2)
    np.testing.assert_allclose(p_got, p_want, rtol=2.4e-7, atol=0)
    assert (p_got[ids >= 1] > 0).all() and (p_got[ids < 1] == 0).all()
    e_want = np.asarray(j.expected_probs(jnp.asarray(ids, jnp.int32)))
    e_got = t.expected_probs(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(e_got, e_want, rtol=5e-7, atol=0)
    # against float64: the pmf's rounding carried through expm1
    rel = np.clip(ids - 1, 0, vocab - 2).astype(np.float64)
    p64 = np.where(ids >= 1, np.log1p(1.0 / (rel + 1.0)) / np.log(float(vocab)), 0.0)
    np.testing.assert_allclose(e_got, -np.expm1(n * np.log1p(-p64)), rtol=3e-7, atol=0)
    assert (e_got[ids >= 1] > 0).all() and (e_got <= 1.0).all()
    assert np.isfinite(np.log(e_got[ids >= 1])).all()


@pytest.mark.parametrize("vocab", [1000, 4_000_001])
def test_sampler_draws_follow_the_pmf(vocab):
    """χ² of 200,000 draws (25 calls of 8,192 ids, one generator) against the
    pmf: every id below 64 its own bin, the rest in log-spaced bins, each
    expecting at least 50 draws; the draws stay in [1, vocab)."""
    s = LogUniformSampler(8192, vocab, 1)
    g = torch.Generator().manual_seed(3)
    draws = torch.cat([s.sample(g) for _ in range(25)]).numpy()
    assert draws.min() >= 1 and draws.max() < vocab and draws.dtype == np.int64
    edges = np.unique(np.concatenate([np.arange(1, 64), np.geomspace(64, vocab, 40).astype(int),
                                      [vocab]]))
    cdf = np.concatenate([[0.0], np.cumsum(s.probs(torch.arange(1, vocab)).double().numpy())])
    expected = (cdf[edges[1:] - 1] - cdf[edges[:-1] - 1]) * len(draws)
    observed = np.histogram(draws, bins=edges)[0]
    keep = expected >= 50
    observed, expected = observed[keep], expected[keep] * observed[keep].sum() / expected[keep].sum()
    chi2 = float(((observed - expected) ** 2 / expected).sum())
    assert chi2 < stats.chi2.ppf(0.999, len(expected) - 1), (chi2, len(expected))
    # a fixed number with replacement: popular ids repeat
    assert len(np.unique(draws[:8192])) < 8192


# ----------------------------------------------------------- model parities
def _batch(seed, rows=ROWS):
    return synthetic_data(flagship.schema(V, S), num_rows=rows, max_session_length=S, seed=seed)


def _pair(task_kwargs):
    """The JAX XLNet-MLM model and the port's with the JAX weights (with every
    bias and LayerNorm moved off its initial value, so that each counts)."""
    schema = jax_schema_fn(num_items=V, num_categories=flagship.NUM_CATEGORIES,
                           max_session_length=S)
    masking = {"mlm_probability": 0.3}
    jim = jtr.TabularSequenceFeatures.from_schema(schema, d_output=D, masking="mlm",
                                                  aggregation="concat", masking_kwargs=masking)
    jmodel = jtr.XLNetConfig.build(D, H, L, S, dropout=0.0).to_model(
        jim, jtr.NextItemPredictionTask(**task_kwargs))
    init = {k: jnp.asarray(v) for k, v in _batch(0, rows=4).items()}
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), init)
    rng = np.random.default_rng(9)

    def move(path, leaf):
        name = getattr(path[-1], "key", "")
        leaf = np.asarray(leaf)
        return leaf + rng.normal(0.0, 0.1, leaf.shape).astype(leaf.dtype) \
            if name in ("bias", "scale") else leaf

    params = jax.tree_util.tree_map_with_path(move, params)
    tim = TabularSequenceFeatures.from_schema(flagship.schema(V, S), d_output=D, masking="mlm",
                                              aggregation="concat", masking_kwargs=masking)
    tmodel = XLNetConfig.build(D, H, L, S, dropout=0.0).to_model(
        tim, NextItemPredictionTask(**task_kwargs), device="cpu")
    tmodel.load_state_dict(convert.params_from_jax(params))  # strict
    back = convert.params_to_jax(tmodel.state_dict(), params)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    return jmodel, params, tmodel


def _jax_mask(batch, monkeypatch):
    """The JAX draw's MLM mask, returned by the JAX masking in training."""
    info = JaxMLM.compute_masked_targets(JaxMLM(hidden_size=D, mlm_probability=0.3),
                                         jax.random.PRNGKey(3), jnp.asarray(batch["item_id"]),
                                         training=True)
    original = JaxMLM.compute_masked_targets

    def jax_masks(self, rng, item_ids, training=False, testing=False, segment_ids=None):
        return info if training else original(self, rng, item_ids, training, testing,
                                              segment_ids)

    monkeypatch.setattr(JaxMLM, "compute_masked_targets", jax_masks)
    return info


def _step(jmodel, params, tmodel, batch, info, neg_ids=None):
    """One training step of both packages: (loss, grads) JAX, then the port."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if neg_ids is not None:
        jb["__neg_ids__"] = jnp.asarray(neg_ids, jnp.int32)
    rngs = {"masking": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "sampling": jax.random.PRNGKey(2)}
    want_loss, want_grads = jax.jit(jax.value_and_grad(lambda p: jmodel.apply(
        p, jb, targets=jb, training=True, compute_metrics=False, rngs=rngs)[0]))(params)
    tinfo = convert.masking_info_from_jax(np.asarray(info.targets), np.asarray(info.mask),
                                          np.asarray(info.pad_mask), neg_ids=neg_ids)
    tb = tmodel._as_dense(batch)
    tmodel.zero_grad(set_to_none=True)
    loss, outs = tmodel(tb, targets=tb, training=True, masking_info=tinfo)
    loss.backward()
    return (float(want_loss), convert.params_from_jax(jax.tree.map(np.asarray, want_grads)),
            float(loss.detach()), dict(tmodel.named_parameters()), outs)


def _check_grads(got, want, rtol):
    assert set(got) == set(want)
    for name, p in got.items():
        if not name.endswith(ZERO_GRADIENT):
            assert _rel_fro(p.grad.numpy(), want[name].numpy()) <= rtol, name


def _check_eval_and_topk(jmodel, params, tmodel):
    loader = [_batch(7), _batch(8, rows=9)]
    want, got = jmodel.evaluate(loader, params), tmodel.evaluate(loader)
    assert want.keys() == got.keys()
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=1e-4)
    for k in want:
        if k != "eval_loss":
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    batch = _batch(9, rows=6)
    ws, wi = jax.jit(lambda p, b: jmodel.apply(p, b, top_k=10))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        gs, gi = tmodel(tmodel._as_dense(batch), top_k=10)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_a_sampled_softmax_step_matches_jax_with_its_negatives(monkeypatch):
    task = dict(weight_tying=True, sampled_softmax=True, max_n_samples=64,
                softmax_temperature=0.7, label_smoothing=0.1)
    jmodel, params, tmodel = _pair(task)
    batch = _batch(11)
    info = _jax_mask(batch, monkeypatch)
    neg_ids = np.asarray(JaxSampler(64, V + 1, 1).sample(jax.random.PRNGKey(4))).copy()
    # an accidental hit: a masked target among the negatives
    targets, mask = np.asarray(info.targets), np.asarray(info.mask)
    neg_ids[5] = targets[mask][0]
    want_loss, want, got_loss, got, outs = _step(jmodel, params, tmodel, batch, info, neg_ids)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    _check_grads(got, want, 1e-5)
    # every position a row, weighted by the mask: no loss-row budget
    assert outs["next-item"].weights.shape == (ROWS * S,)
    assert float(outs["next-item"].loss_weight) == mask.sum()
    # sampled softmax changes the training branch only
    _check_eval_and_topk(jmodel, params, tmodel)


def test_the_untied_output_layer_and_task_blocks_match_jax(monkeypatch):
    task = dict(weight_tying=False, task_block_dims=(48,), softmax_temperature=0.9)
    jmodel, params, tmodel = _pair(task)
    nip = tmodel.heads[0].tasks[0]
    assert tuple(nip.output_layer.shape) == (V + 1, D)  # (target_dim, d_model)
    assert nip.task_block_0.out_features == 48 and nip.tying_projection.out_features == D
    batch = _batch(12)
    info = _jax_mask(batch, monkeypatch)
    want_loss, want, got_loss, got, _ = _step(jmodel, params, tmodel, batch, info)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    _check_grads(got, want, 1e-4)
    _check_eval_and_topk(jmodel, params, tmodel)


def test_an_untied_sampled_softmax_step_matches_jax(monkeypatch):
    task = dict(weight_tying=False, sampled_softmax=True, max_n_samples=32,
                task_block_dims=(24, 40))
    jmodel, params, tmodel = _pair(task)
    batch = _batch(13)
    info = _jax_mask(batch, monkeypatch)
    neg_ids = np.asarray(JaxSampler(32, V + 1, 1).sample(jax.random.PRNGKey(5)))
    want_loss, want, got_loss, got, _ = _step(jmodel, params, tmodel, batch, info, neg_ids)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    _check_grads(got, want, 1e-5)


def test_the_untied_output_layer_is_drawn_as_flax_draws_it():
    """variance_scaling(1/3, "fan_in", "uniform") on a (target_dim, d) weight:
    flax's fan-in is the first axis, so the bound is 1/sqrt(target_dim)."""
    model = flagship.build_model("cpu", num_items=V, d_model=D, n_layer=1, n_head=H, seq=S)
    task = NextItemPredictionTask(weight_tying=False, target_dim=5000)
    task.build(D)
    task._init_weights(torch.Generator().manual_seed(0))
    w = task.output_layer.detach().numpy()
    bound = 1.0 / np.sqrt(5000)
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.99 * bound
    np.testing.assert_allclose(w.std(), bound / np.sqrt(3), rtol=0.02)
    assert model.heads[0].tasks[0].output_layer is None  # tied: no output layer


def test_the_negatives_come_from_the_step_generator():
    """Without ``neg_ids`` the task draws from the generator it is given: the
    same seed gives the same loss, another seed another."""
    model = flagship.build_large_vocab_model("cpu", num_items=V, d_model=D, n_layer=1,
                                             n_head=H, dropout=0.0, max_n_samples=16)
    b = model._as_dense(_batch(14))

    def loss(seed):
        return float(model(b, targets=b, training=True,
                           generator=torch.Generator().manual_seed(seed))[0].detach())

    assert loss(1) == loss(1) != loss(2)


def test_sampled_softmax_over_a_group_says_it_is_not_ported():
    with pytest.raises(NotImplementedError, match="sampled softmax over a vocab-parallel"):
        NextItemPredictionTask(weight_tying=True, sampled_softmax=True,
                               vocab_parallel_group=object())
    with pytest.raises(NotImplementedError, match="needs the tied item table"):
        NextItemPredictionTask(weight_tying=False, vocab_parallel_group=object())


# ---------------------------------------------------- summary and dense losses
@pytest.mark.parametrize("summary_type", ["last", "first", "mean", "cls_index"])
def test_summarize_matches_jax(summary_type):
    rng = np.random.default_rng(0)
    hidden = rng.normal(size=(5, 7, 6)).astype(np.float32)
    lengths = np.array([7, 3, 1, 0, 5])
    pad = np.arange(7)[None, :] < lengths[:, None]
    jtask = JaxPredictionTask(summary_type=summary_type)
    ttask = PredictionTask(summary_type=summary_type)
    for p in (pad, None):
        want = np.asarray(jtask.summarize(jnp.asarray(hidden),
                                          None if p is None else jnp.asarray(p)))
        got = ttask.summarize(torch.from_numpy(hidden),
                              None if p is None else torch.from_numpy(p)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # a pad mask one wider (MLM inference's [MASK]) is cut to the hidden length
    wide = np.concatenate([pad, np.ones((5, 1), bool)], axis=1)
    np.testing.assert_allclose(
        ttask.summarize(torch.from_numpy(hidden), torch.from_numpy(wide)).numpy(),
        np.asarray(jtask.summarize(jnp.asarray(hidden), jnp.asarray(wide))), rtol=1e-6,
        atol=1e-7)


def test_bce_and_mse_match_jax():
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=50) * 30).astype(np.float32)  # saturated tails too
    labels = rng.integers(0, 2, 50)
    w = (rng.random(50) > 0.3).astype(np.float32)
    for weights in (w, None):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else torch.from_numpy(weights)
        np.testing.assert_allclose(
            float(binary_cross_entropy_with_logits(torch.from_numpy(logits),
                                                   torch.from_numpy(labels), tw)),
            float(jlosses.binary_cross_entropy_with_logits(jnp.asarray(logits),
                                                           jnp.asarray(labels), jw)),
            rtol=1e-6)
        preds = logits / 30
        np.testing.assert_allclose(
            float(mse_loss(torch.from_numpy(preds), torch.from_numpy(labels), tw)),
            float(jlosses.mse_loss(jnp.asarray(preds), jnp.asarray(labels), jw)), rtol=1e-6)


# ------------------------------------------------------- the entry points
def test_fit_save_and_load_a_sampled_softmax_model(tmp_path):
    model = flagship.build_large_vocab_model("cpu", num_items=V, d_model=D, n_layer=1,
                                             n_head=H, max_n_samples=64)
    data = _batch(15, rows=64)
    loader = [{k: v[i:i + 16] for k, v in data.items()} for i in range(0, 64, 16)]
    losses = model.fit(loader, num_epochs=3)
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    model.save(str(tmp_path))
    other = flagship.build_large_vocab_model("cpu", num_items=V, d_model=D, n_layer=1,
                                             n_head=H, max_n_samples=64, seed=1).load(
                                                 str(tmp_path))
    for (n, a), (_, b) in zip(model.state_dict().items(), other.state_dict().items()):
        assert torch.equal(a, b), n


def test_the_paper_script_trains_with_sampled_softmax(tmp_path, monkeypatch):
    built = []
    original = transf_exp_main.get_model

    def get_model(*args, **kwargs):
        built.append(original(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(transf_exp_main, "get_model", get_model)
    results = transf_exp_main.main([
        "--use_synthetic", "--model_type", "xlnet", "--mlm", "--sampled_softmax",
        "--sampled_softmax_max_n_samples", "64", "--d_model", "16", "--n_layer", "1",
        "--n_head", "2", "--session_seq_length_max", "10", "--synthetic_num_items", "200",
        "--synthetic_rows_per_window", "64", "--per_device_train_batch_size", "16",
        "--per_device_eval_batch_size", "16", "--output_dir", str(tmp_path), "--cpu"])
    task = built[0].heads[0].tasks[0]
    assert task.sampled_softmax and task.max_n_samples == 64
    assert all(len(v) == 2 and all(np.isfinite(v)) for v in results.values())
    with open(os.path.join(tmp_path, "results.json")) as f:
        assert sorted(json.load(f)) == sorted(results)
