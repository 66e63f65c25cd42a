"""Multi-task and multi-head models of the port against the JAX package on
the CPU: next-item with binary classification and regression on the
music-streaming fixture, ``Head.from_schema``, two heads, the streaming
metrics of the dense tasks and ``task_weights`` in evaluation (mirrors of
the JAX package's ``tests/test_multi_task.py``), the loaders' scalar
target columns, the trainer on such a model, and the port's constructors of
the JAX benchmark's configurations 4 and 5 (``benchmarks/run_all.py``).

Weights go from the JAX model to the port's through
``convert.params_from_jax`` (strict). Training steps take the JAX draw's
MLM mask (RTD masks as MLM does), dropout 0.

Tolerances: the total loss and each task's within 1e-5 relative; every
gradient within 1e-4 in relative Frobenius norm (the next-item CE rounds
its residual to bf16 in both packages, as ``test_torch_archs.py`` holds
it); evaluation losses within 1e-4 relative (the fused pass sums in
another order), the dense tasks' metrics within 1e-6 and the ranking
metrics within 1e-6 absolute; dense predictions within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformers4rec_tpu as jtr
from transformers4rec_tpu.data import loader as jloader
from transformers4rec_tpu.data import music_streaming_testing_data as jms
from transformers4rec_tpu.data import testing as jtesting
from transformers4rec_tpu.data.synthetic import synthetic_ecommerce_data_schema as jax_schema_fn
from transformers4rec_tpu.masking import MaskedLanguageModeling as JaxMLM

from transformers4rec_tpu_torch import (
    BertConfig,
    GPT2Config,
    Head,
    Model,
    SequentialBlock,
    Tags,
    convert,
    flagship,
)
from transformers4rec_tpu_torch.data import loader as tloader
from transformers4rec_tpu_torch.data import music_streaming_testing_data as ms
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.data import testing as ttesting
from transformers4rec_tpu_torch.masking import MaskedLanguageModeling
from transformers4rec_tpu_torch.model.base import combine_task_losses
from transformers4rec_tpu_torch.model.ranking_metric import (
    finalize_metrics,
    update_metric_state,
)

torch.set_num_threads(1)

D, H, L, S = 32, 2, 2, 20
RNGS = {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1),
        "dropout": jax.random.PRNGKey(2), "sampling": jax.random.PRNGKey(3)}
APPLY = {k: v for k, v in RNGS.items() if k != "params"}
ZERO_GRADIENT = "attn.k.bias"  # the softmax ignores it: rounding noise in both


def _rel_fro(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _music(rows, seed):
    return synthetic_data(ms.schema, num_rows=rows, max_session_length=S, seed=seed)


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _moved(params, seed=9):
    """The JAX init with every bias and LayerNorm scale moved off its initial
    value, so that each weight counts."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        leaf = np.asarray(leaf)
        if getattr(path[-1], "key", "") in ("bias", "scale"):
            return leaf + rng.normal(0.0, 0.1, leaf.shape).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(move, params)


def _three_tasks(mod, weights=(1.0, 0.5, 0.5), masking="mlm", arch="bert", d=D):
    """The three-task head of ``mod`` (the JAX package or the port) as the
    JAX test builds it: next-item, ``click``, ``play_percentage``."""
    schema = (jms if mod is jtr else ms).schema
    im = mod.TabularSequenceFeatures.from_schema(
        schema.remove_by_tag(mod.Tags.TARGET), d_output=d, masking=masking,
        aggregation="concat")
    cfg = mod.transformer_registry.parse(arch).build(d, H, L, S, dropout=0.0)
    tasks = [mod.NextItemPredictionTask(weight_tying=True),
             mod.BinaryClassificationTask(task_name="click", target_name="click"),
             mod.RegressionTask(task_name="play_percentage", target_name="play_percentage")]
    head = mod.Head.from_body(input_module=im, transformer=cfg, tasks=tasks,
                              task_weights=list(weights))
    return head


def _pair(jhead, thead, batch, head_weights=None):
    jmodel = jtr.Model(heads=(jhead,) if not isinstance(jhead, tuple) else jhead,
                       head_weights=head_weights)
    params = _moved(jax.jit(lambda b: jmodel.init(RNGS, b, targets=b, training=True))(
        _jnp(batch)))
    theads = (thead,) if not isinstance(thead, tuple) else thead
    tmodel = Model(heads=theads, head_weights=head_weights, device="cpu")
    tmodel.load_state_dict(convert.params_from_jax(params))  # strict
    return jmodel, params, tmodel


def _inject_jax_mask(batch, monkeypatch, port=False):
    """The JAX draw's MLM mask, returned by the JAX masking (and, with
    ``port``, by the port's) in training; the port's ``MaskingInfo``."""
    info = JaxMLM.compute_masked_targets(JaxMLM(hidden_size=D, mlm_probability=0.15),
                                         jax.random.PRNGKey(3), jnp.asarray(batch["item_id"]),
                                         training=True)
    original = JaxMLM.compute_masked_targets

    def jax_masks(self, rng, item_ids, training=False, testing=False, segment_ids=None):
        return info if training else original(self, rng, item_ids, training, testing,
                                              segment_ids)

    monkeypatch.setattr(JaxMLM, "compute_masked_targets", jax_masks)
    tinfo = convert.masking_info_from_jax(np.asarray(info.targets), np.asarray(info.mask),
                                          np.asarray(info.pad_mask))
    if port:
        port_original = MaskedLanguageModeling.compute_masked_targets

        def port_masks(self, item_ids, training=False, testing=False, generator=None):
            return tinfo if training else port_original(self, item_ids, training, testing,
                                                        generator)

        monkeypatch.setattr(MaskedLanguageModeling, "compute_masked_targets", port_masks)
    return tinfo


def _check_step(jmodel, params, tmodel, batch, masking_info=None, rtol=1e-4):
    jb = _jnp(batch)

    def loss_fn(p):
        loss, outs = jmodel.apply(p, jb, targets=jb, training=True, compute_metrics=False,
                                  rngs=APPLY)
        return loss, {name: o.loss for name, o in outs.items()}

    (want_loss, want_losses), want_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    tb = tmodel._as_dense(batch)
    loss, outs = tmodel(tb, targets=tb, training=True, masking_info=masking_info)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    assert outs.keys() == want_losses.keys()
    for name in outs:
        np.testing.assert_allclose(float(outs[name].loss.detach()), float(want_losses[name]),
                                   rtol=1e-5, err_msg=name)
    want = convert.params_from_jax(jax.tree.map(np.asarray, want_grads))
    got = dict(tmodel.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        if not name.endswith(ZERO_GRADIENT):
            assert _rel_fro(p.grad.numpy(), want[name].numpy()) <= rtol, name


def _jax_testing(jmodel, params, batch):
    """The JAX model's testing outputs, jitted: {task: (loss, metrics,
    predictions)}."""
    def run(p, b):
        _, outs = jmodel.apply(p, b, targets=b, testing=True)
        return {n: (o.loss, o.metrics, o.predictions) for n, o in outs.items()}

    return jax.jit(run)(params, _jnp(batch))


def _check_evaluate(got, want):
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=1e-4)
    for k in want:
        if k != "eval_loss":
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


# --------------------------------------------------------------- the models
def test_the_three_task_model_trains_evaluates_and_predicts_as_jax(monkeypatch):
    batch = _music(16, 5)
    jmodel, params, tmodel = _pair(_three_tasks(jtr), _three_tasks(
        __import__("transformers4rec_tpu_torch")), batch)
    tinfo = _inject_jax_mask(batch, monkeypatch)
    _check_step(jmodel, params, tmodel, batch, masking_info=tinfo)

    # testing: each task's loss and metrics
    tb = tmodel._as_dense(batch)
    want_outs = _jax_testing(jmodel, params, batch)
    with torch.inference_mode():
        _, outs = tmodel(tb, targets=tb, testing=True)
    for name, (loss, metrics, preds) in want_outs.items():
        np.testing.assert_allclose(float(outs[name].loss), float(loss), rtol=1e-4)
        for k, (s, c) in metrics.items():
            np.testing.assert_allclose([float(outs[name].metrics[k][0]),
                                        float(outs[name].metrics[k][1])],
                                       [float(s), float(c)], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name}/{k}")
        if name != "next-item":
            np.testing.assert_allclose(outs[name].predictions.numpy(), np.asarray(preds),
                                       atol=1e-5)
    # over several batches, with a tail of 7 sessions
    loader = [_music(16, 6), _music(7, 7)]
    _check_evaluate(tmodel.evaluate(loader), jmodel.evaluate(loader, params))
    # inference: the next-item task's top-k
    ws, wi = jax.jit(lambda p, b: jmodel.apply(p, b, top_k=10))(params, _jnp(batch))
    with torch.inference_mode():
        gs, gi = tmodel(tb, top_k=10)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-5)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert tmodel.output_schema_for(10).column_names == ["item_id_scores", "item_ids"]

    # trains end to end (the JAX test's 10 steps on one batch, Adam 5e-3)
    monkeypatch.undo()
    tmodel.train()
    losses = tmodel.fit([batch] * 10, optimizer=torch.optim.Adam(tmodel.parameters(), lr=5e-3))
    assert losses[-1] < losses[0], losses


def test_head_from_schema_builds_the_target_tasks_as_jax():
    def build(mod):
        schema = (jms if mod is jtr else ms).schema
        im = mod.TabularSequenceFeatures.from_schema(
            schema.remove_by_tag(mod.Tags.TARGET), d_output=16, aggregation="concat")
        body = mod.SequentialBlock(blocks=(im,)) if mod is jtr else SequentialBlock([im])
        return mod.Head.from_schema(schema, body=body)

    jhead, thead = build(jtr), build(__import__("transformers4rec_tpu_torch"))
    assert [(type(t).__name__, t.task_name, t.target_name) for t in thead.tasks] == \
        [(type(t).__name__, t.task_name, t.target_name) for t in jhead.tasks] == \
        [("BinaryClassificationTask", "click", "click"),
         ("RegressionTask", "play_percentage", "play_percentage")]
    batch = _music(8, 3)
    jmodel, params, tmodel = _pair(jhead, thead, batch)
    # inference without a next-item task: {task: predictions}; the batch
    # carries the targets, so each task also scores them
    want = jax.jit(jmodel.apply)(params, _jnp(batch))
    with torch.inference_mode():
        got = tmodel(tmodel._as_dense(batch))
    assert got.keys() == want.keys() == {"click", "play_percentage"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5)
    assert tmodel.output_schema_for(None).column_names == ["click"]
    with pytest.raises(ValueError, match="No target columns"):
        Head.from_schema(ms.schema.remove_by_tag(Tags.TARGET), body=thead.body)


def test_two_heads_match_jax(monkeypatch):
    schema = flagship.schema(300, S)
    jschema = jax_schema_fn(num_items=300, num_categories=flagship.NUM_CATEGORIES,
                            max_session_length=S)
    batch = synthetic_data(schema, num_rows=8, max_session_length=S, seed=2)

    def heads(mod, sch):
        im1 = mod.TabularSequenceFeatures.from_schema(sch, d_output=24, masking="clm",
                                                      aggregation="concat")
        im2 = mod.TabularSequenceFeatures.from_schema(sch, d_output=24, masking="mlm",
                                                      aggregation="concat")
        gpt2 = (jtr.GPT2Config if mod is jtr else GPT2Config).build(24, 2, 1, S, dropout=0.0)
        bert = (jtr.BertConfig if mod is jtr else BertConfig).build(24, 2, 1, S, dropout=0.0)
        return (mod.Head.from_body(input_module=im1, transformer=gpt2,
                                   tasks=[mod.NextItemPredictionTask(weight_tying=True)]),
                mod.Head.from_body(input_module=im2, transformer=bert,
                                   tasks=[mod.NextItemPredictionTask(
                                       weight_tying=True, task_name="next-item-2")]))

    jmodel, params, tmodel = _pair(heads(jtr, jschema),
                                   heads(__import__("transformers4rec_tpu_torch"), schema),
                                   batch, head_weights=(0.7, 0.3))
    _inject_jax_mask(batch, monkeypatch, port=True)
    _check_step(jmodel, params, tmodel, batch)
    want = jax.jit(jmodel.apply)(params, _jnp(batch))
    with torch.inference_mode():
        got = tmodel(tmodel._as_dense(batch))
    assert isinstance(got, list) and len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    with pytest.raises(ValueError, match="head_weights must match"):
        Model(heads=tuple(tmodel.heads), head_weights=(1.0,), device="cpu")


def test_binary_regression_streaming_metrics_exact_on_unequal_batches():
    """Merged (sum, count) states over batches of 16 and 7 equal the
    whole-dataset values from the model's own predictions, and the JAX
    model's streamed values."""
    def head(mod):
        im = mod.TabularSequenceFeatures.from_schema(
            (jms if mod is jtr else ms).schema.remove_by_tag(mod.Tags.TARGET), d_output=16,
            aggregation="concat")
        cfg = (jtr.BertConfig if mod is jtr else BertConfig).build(16, 2, 1, S, dropout=0.0)
        return mod.Head.from_body(input_module=im, transformer=cfg, tasks=[
            mod.BinaryClassificationTask(task_name="click", target_name="click"),
            mod.RegressionTask(task_name="play_percentage", target_name="play_percentage")])

    full = _music(23, 7)
    jmodel, params, tmodel = _pair(head(jtr), head(__import__("transformers4rec_tpu_torch")),
                                   full)
    state, jstate, preds = {}, {}, {}
    for lo, hi in ((0, 16), (16, 23)):
        chunk = {k: v[lo:hi] for k, v in full.items()}
        with torch.inference_mode():
            _, outs = tmodel(tmodel._as_dense(chunk), targets=tmodel._as_dense(chunk),
                             testing=True)
        jouts = _jax_testing(jmodel, params, chunk)
        new = {f"{n}/{k}": v for n, o in outs.items() for k, v in o.metrics.items()}
        jnew = {f"{n}/{k}": v for n, o in jouts.items() for k, v in o[1].items()}
        state = update_metric_state(state, new) if state else new
        jstate = update_metric_state(jstate, jnew) if jstate else jnew
        for n, o in outs.items():
            preds.setdefault(n, []).append(o.predictions.numpy())
    streamed = {k: float(v) for k, v in finalize_metrics(state).items()}
    for k, v in jtr.model.ranking_metric.finalize_metrics(jstate).items():
        np.testing.assert_allclose(streamed[k], float(v), rtol=1e-6, err_msg=k)
    click = full["click"].astype(np.float64)
    hard = (np.concatenate(preds["click"]).astype(np.float64) > 0.5).astype(np.float64)
    tp = float((hard * click).sum())
    np.testing.assert_allclose(streamed["click/accuracy"], float((hard == click).mean()),
                               rtol=1e-6)
    np.testing.assert_allclose(streamed["click/precision"], tp / max(hard.sum(), 1.0), rtol=1e-6)
    np.testing.assert_allclose(streamed["click/recall"], tp / max(click.sum(), 1.0), rtol=1e-6)
    rpred = np.concatenate(preds["play_percentage"]).astype(np.float64)
    np.testing.assert_allclose(streamed["play_percentage/mse"],
                               float(np.mean((rpred - full["play_percentage"]) ** 2)),
                               rtol=1e-5)


def test_model_evaluate_honours_task_weights_as_jax():
    batch = _music(16, 5)
    port = __import__("transformers4rec_tpu_torch")

    def models(weights):
        return _pair(_three_tasks(jtr, weights), _three_tasks(port, weights), batch)

    (jeq, params, teq), (jw, _, tw) = models([1.0, 1.0, 1.0]), models([3.0, 1.0, 0.5])
    tw.load_state_dict(teq.state_dict())
    with torch.inference_mode():
        _, outs = teq(teq._as_dense(batch), targets=teq._as_dense(batch), testing=True)
    means = {name: float(o.loss) for name, o in outs.items()}
    for jmodel, tmodel in ((jeq, teq), (jw, tw)):
        got = tmodel.evaluate([batch])
        np.testing.assert_allclose(got["eval_loss"], combine_task_losses(tmodel, means),
                                   rtol=1e-5)
        _check_evaluate(got, jmodel.evaluate([batch], params))
    assert abs(tw.evaluate([batch])["eval_loss"] - teq.evaluate([batch])["eval_loss"]) > 1e-6


# ----------------------------------------------- data, trainer, configurations
def test_the_loaders_yield_the_scalar_targets_as_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jtesting, "_CACHE", tmp_path / "jax")
    monkeypatch.setattr(ttesting, "_CACHE", tmp_path / "torch")
    jds = jtesting.TestingDataset("music_streaming", jms.schema, num_rows=40, seed=5)
    tds = ttesting.TestingDataset("music_streaming", ms.schema, num_rows=40, seed=5)
    for name in ("ParquetDataLoader", "StreamingParquetDataLoader"):
        want = list(getattr(jloader, name).from_schema(jms.schema, jds.path, batch_size=16,
                                                       max_sequence_length=S, shuffle=False))
        got = list(getattr(tloader, name).from_schema(ms.schema, tds.path, batch_size=16,
                                                      max_sequence_length=S, shuffle=False))
        assert len(got) == len(want) >= 2
        for g, w in zip(got, want):
            assert g.keys() == w.keys() and {"click", "play_percentage"} <= set(g)
            assert g["click"].shape == (16,) and g["play_percentage"].shape == (16,)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    synth = next(iter(tloader.SyntheticDataLoader.from_schema(ms.schema, batch_size=8,
                                                              max_sequence_length=S)))
    assert synth["click"].shape == (8,) and synth["play_percentage"].dtype == np.float32


def test_the_trainer_trains_evaluates_and_predicts_a_multi_task_model(tmp_path, monkeypatch):
    monkeypatch.setattr(ttesting, "_CACHE", tmp_path / "data")
    ds = ttesting.TestingDataset("music_streaming", ms.schema, num_rows=48, seed=5)
    trainer = flagship.build_multitask_trainer(
        "cpu", train_dataset=ds, eval_dataset=ds, output_dir=str(tmp_path / "out"), batch=16,
        d_model=D, n_head=H, n_layer=1)
    a = trainer.args
    a.max_steps, a.logging_steps, a.eval_steps, a.save_steps = 6, 3, 3, 3
    a.load_best_model_at_end, a.metric_for_best_model = True, "click/accuracy"
    metrics = trainer.train()
    assert metrics["train_steps"] == 6 and np.isfinite(metrics["train_loss"])
    assert trainer._best_checkpoint is not None
    ev = trainer.evaluate()
    keys = {"eval_/next-item/ndcg_at_10", "eval_/click/accuracy", "eval_/click/precision",
            "eval_/click/recall", "eval_/play_percentage/mse"}
    assert keys <= set(ev)
    direct = trainer.model.evaluate(trainer.get_eval_dataloader(), max_sequence_length=S)
    for k in keys | {"eval_loss"}:
        np.testing.assert_allclose(ev[k], direct[k], rtol=1e-6, err_msg=k)
    scores, ids = trainer.predict(ds, top_k=5)
    assert scores.shape == ids.shape == (48, 5)


@pytest.mark.parametrize("config", ["large_vocab", "multitask"])
def test_the_benchmark_configurations_mirror_the_jax_benchmark(config, monkeypatch):
    """The JAX ``run_all.py`` construction at small widths loads into the
    port's constructor strictly, and a training step agrees (for the large
    vocabulary with the JAX draw's negatives)."""
    port = __import__("transformers4rec_tpu_torch")
    if config == "multitask":
        jmodel = jtr.Model(heads=(_three_tasks(jtr, (1.0, 1.0, 1.0), masking="rtd",
                                               arch="electra"),))
        tmodel = flagship.build_multitask_model("cpu", d_model=D, n_head=H, n_layer=L,
                                                dropout=0.0)
        assert isinstance(tmodel.heads[0].input_module.masking,
                          port.masking.ReplacementLanguageModeling)
        batch = _music(16, 8)
    else:
        num_items = 1000
        jschema = jax_schema_fn(num_items=num_items, num_categories=150)
        im = jtr.TabularSequenceFeatures.from_schema(
            jschema, d_output=D, masking="mlm", aggregation="concat",
            masking_kwargs={"mlm_probability": 0.3},
            embedding_dims={jschema.item_id_column_name: 64})
        jmodel = jtr.XLNetConfig.build(D, H, L, S, dropout=0.0).to_model(
            im, jtr.NextItemPredictionTask(weight_tying=True, sampled_softmax=True,
                                           max_n_samples=128))
        tmodel = flagship.build_large_vocab_model("cpu", num_items=num_items, d_model=D,
                                                  n_head=H, n_layer=L, dropout=0.0,
                                                  max_n_samples=128)
        assert tmodel.heads[0].input_module.item_embedding_table().shape == (1008, 64)
        batch = synthetic_data(flagship.schema(num_items), num_rows=16, max_session_length=S,
                               seed=8)
    params = _moved(jax.jit(lambda b: jmodel.init(RNGS, b, targets=b, training=True))(
        _jnp(batch)))
    tmodel.load_state_dict(convert.params_from_jax(params))  # strict
    tinfo = _inject_jax_mask(batch, monkeypatch)
    if config == "large_vocab":
        neg = np.array(jtr.model.LogUniformSampler(128, 1001, 1).sample(
            jax.random.PRNGKey(6)))
        batch = dict(batch, __neg_ids__=neg)
        tinfo = tinfo.replace(neg_ids=torch.from_numpy(neg.astype(np.int64)))
    _check_step(jmodel, params, tmodel, {k: v for k, v in batch.items()}, masking_info=tinfo,
                rtol=1e-4 if config == "multitask" else 1e-5)
