"""Training with the port against the JAX package on the CPU.

One small REES46-shaped XLNet-MLM model (V=500, d=32, 2 layers, 2 heads,
sessions of 8, dropout 0) is built in both packages with the same weights
(``convert.params_from_jax``). The two packages draw masks from different
generators, so the masks are drawn once by the reference's own function and
given to both: to the port through ``masking_info=``, to the JAX model by
patching its masking's ``compute_masked_targets`` for the test.

Tolerances: one step's loss within 1e-5 relative; every gradient within 1e-3
in relative Frobenius norm (the CE's residual is rounded to bf16 in both).
Over three optimizer steps the differences pass through Adafactor's
g / sqrt(v) (which maps a gradient near zero to an update of either sign),
so the parameters' movements agree within 2e-2 in relative Frobenius norm
and the losses within 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import transformers4rec_tpu as jtr
from transformers4rec_tpu.data.loader import SyntheticDataLoader as JaxSyntheticDataLoader
from transformers4rec_tpu.data.synthetic import synthetic_ecommerce_data_schema as jax_schema_fn
from transformers4rec_tpu.masking import MaskedLanguageModeling as JaxMLM
from transformers4rec_tpu.ops.fused_adafactor import fused_adafactor
from transformers4rec_tpu.ops.sparse_update import label_embedding_params as jax_labels

import transformers4rec_tpu_torch as ttr
from transformers4rec_tpu_torch import convert, flagship
from transformers4rec_tpu_torch.data import SyntheticDataLoader, synthetic_data
from transformers4rec_tpu_torch.masking import MaskedLanguageModeling
from transformers4rec_tpu_torch.model.prediction_task import NextItemPredictionTask

torch.set_num_threads(1)

V, D, L, H, S, ROWS = 500, 32, 2, 2, 8, 16
SMALL = dict(num_items=V, d_model=D, n_layer=L, n_head=H, seq=S)
LR, WD = 6.7e-4, 1e-4
# a key bias shifts every logit of a query alike and the softmax ignores it:
# its gradient is rounding noise around zero in both packages
ZERO_GRADIENT = "attn.k.bias"


def _batch(seed, rows=ROWS):
    return synthetic_data(flagship.schema(V, S), num_rows=rows, max_session_length=S, seed=seed)


def _jax_model(use_fused_ops=True):
    schema = jax_schema_fn(num_items=V, num_categories=flagship.NUM_CATEGORIES,
                           max_session_length=S)
    im = jtr.TabularSequenceFeatures.from_schema(
        schema, d_output=D, masking="mlm", aggregation="concat",
        masking_kwargs={"mlm_probability": 0.3},
    )
    cfg = jtr.XLNetConfig.build(d_model=D, n_head=H, n_layer=L, total_seq_length=S, dropout=0.0)
    return cfg.to_model(im, jtr.NextItemPredictionTask(weight_tying=True,
                                                       use_fused_ops=use_fused_ops))


@pytest.fixture(scope="module")
def pair():
    jmodel = _jax_model()
    init_batch = {k: jnp.asarray(v) for k, v in _batch(0, rows=4).items()}
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), init_batch)
    return jmodel, params


def _torch_model(params, **kwargs):
    model = flagship.build_model("cpu", seed=1, dropout=0.0, **SMALL, **kwargs)
    model.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, params)))
    return model


@pytest.fixture
def masks(monkeypatch):
    """Masks drawn by the reference's own function, one per batch, looked up
    by the batch's item ids in both packages."""
    drawn = {}
    original = JaxMLM.compute_masked_targets

    def key(ids):
        return np.asarray(ids).astype(np.int64).tobytes()

    def draw(batch, seed):
        ids = np.asarray(batch["item_id"])
        info = original(JaxMLM(hidden_size=D, mlm_probability=0.3), jax.random.PRNGKey(seed),
                        jnp.asarray(ids), training=True)
        drawn[key(ids)] = info
        return info

    def jax_lookup(self, rng, item_ids, training=False, testing=False, segment_ids=None):
        if not training:
            return original(self, rng, item_ids, training, testing, segment_ids)
        return drawn[key(item_ids)]

    def torch_lookup(self, item_ids, training=False, testing=False, generator=None):
        info = drawn[key(item_ids.numpy())]
        return convert.masking_info_from_jax(np.asarray(info.targets), np.asarray(info.mask),
                                             np.asarray(info.pad_mask))

    monkeypatch.setattr(JaxMLM, "compute_masked_targets", jax_lookup)
    draw.patch_torch = lambda: monkeypatch.setattr(
        MaskedLanguageModeling, "compute_masked_targets", torch_lookup)
    return draw


def _jax_loss_fn(jmodel, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rngs = {"masking": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}

    def loss_fn(p):
        return jmodel.apply(p, jb, targets=jb, training=True, compute_metrics=False,
                            rngs=rngs)[0]

    return loss_fn


def _rel_fro(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_one_training_step_loss_and_every_gradient_match_jax(pair, masks):
    jmodel, params = pair
    batch = _batch(11)
    info = masks(batch, seed=3)
    want_loss, want_grads = jax.value_and_grad(_jax_loss_fn(jmodel, batch))(params)
    want = convert.params_from_jax(jax.tree.map(np.asarray, want_grads))

    tmodel = _torch_model(params)
    tb = tmodel._as_dense(batch)
    tinfo = convert.masking_info_from_jax(np.asarray(info.targets), np.asarray(info.mask),
                                          np.asarray(info.pad_mask))
    loss, outs = tmodel(tb, targets=tb, training=True, masking_info=tinfo)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    # the loss-row budget: int(128·0.3 + 6·sqrt(128·0.3·0.7)) + 8 = 77 of 128 positions
    assert outs["next-item"].labels.shape == (77,)
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(got) == set(want) and all(g is not None for g in got.values())
    for name in sorted(want):
        if name.endswith(ZERO_GRADIENT):
            scale = float(want[name.replace("attn.k.", "attn.q.")].norm())
            assert float(got[name].norm()) <= 1e-5 * scale >= float(want[name].norm()), name
            continue
        assert _rel_fro(got[name].numpy(), want[name].numpy()) <= 1e-3, name


def test_non_fused_training_loss_matches_jax(pair, masks):
    _, params = pair
    batch = _batch(12)
    info = masks(batch, seed=4)
    want = _jax_loss_fn(_jax_model(use_fused_ops=False), batch)(params)
    tmodel = _torch_model(params)
    tmodel.heads[0].tasks[0].use_fused_ops = False
    tb = tmodel._as_dense(batch)
    tinfo = convert.masking_info_from_jax(np.asarray(info.targets), np.asarray(info.mask),
                                          np.asarray(info.pad_mask))
    loss, _ = tmodel(tb, targets=tb, training=True, masking_info=tinfo)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert all(p.grad is not None for p in tmodel.parameters())


def test_three_trainer_steps_follow_the_optax_chain(pair, masks):
    jmodel, params = pair
    batches = [_batch(20 + i) for i in range(3)]
    for i, b in enumerate(batches):
        masks(b, seed=10 + i)
    tx = optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.multi_transform(
            {"dense": optax.adamw(LR, weight_decay=WD),
             "table": fused_adafactor(learning_rate=LR, moment_dtype=jnp.bfloat16)},
            jax_labels),
    )
    p, opt_state, want_losses = params, tx.init(params), []
    for b in batches:
        loss, grads = jax.value_and_grad(_jax_loss_fn(jmodel, b))(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
        want_losses.append(float(loss))
    want = convert.params_from_jax(jax.tree.map(np.asarray, p))
    start = convert.params_from_jax(jax.tree.map(np.asarray, params))

    masks.patch_torch()
    args = ttr.T4RecTrainingArguments(
        learning_rate=LR, lr_scheduler_type="constant", weight_decay=WD, max_grad_norm=1.0,
        embedding_optimizer="adafactor", embedding_moment_dtype="bf16", max_steps=3,
        steps_per_execution=2, logging_steps=1, per_device_train_batch_size=ROWS)
    trainer = ttr.Trainer(_torch_model(params), args, train_dataloader=batches, device="cpu")
    metrics = trainer.train()
    got_losses = [h["loss"] for h in trainer.state.log_history if "loss" in h]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    np.testing.assert_allclose(metrics["train_loss"], np.mean(want_losses), rtol=1e-4)
    assert metrics["train_steps"] == metrics["global_step"] == 3
    assert trainer.optimizers["table"].state_dict()["state"][0]["v"].dtype == torch.bfloat16
    got = trainer.model.state_dict()
    moved = 0
    for name in sorted(want):
        if name.endswith(ZERO_GRADIENT):
            continue  # Adam turns the rounding noise into steps of either sign
        delta = (want[name] - start[name]).numpy()
        assert np.abs(delta).max() > 0, name
        moved += 1
        assert _rel_fro((got[name] - start[name]).numpy(), delta) <= 2e-2, name
    assert moved == len(want) - L


def _trainer(tmp_path, data, max_steps, K, dropout=0.1, seed=0):
    trainer = flagship.build_trainer("cpu", seed=seed, train_dataset=data,
                                     output_dir=str(tmp_path), dropout=dropout, **SMALL)
    trainer.args.per_device_train_batch_size = ROWS
    trainer.args.steps_per_execution = K
    trainer.args.max_steps = max_steps
    trainer.args.logging_steps = 1
    return trainer


def _same_weights(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return all(torch.equal(sa[k], sb[k]) for k in sa)


def test_k1_and_k4_trajectories_are_bit_identical(tmp_path):
    """Dropout is on: the mask and every dropout draw come from the one
    generator, in the same order whatever the group size."""
    data = _batch(30, rows=4 * ROWS)
    one = _trainer(tmp_path, data, 6, 1)
    four = _trainer(tmp_path, data, 6, 4)
    m1, m4 = one.train(), four.train()
    assert m1["train_loss"] == m4["train_loss"]
    assert [h["loss"] for h in one.state.log_history[:-1]] == \
           [h["loss"] for h in four.state.log_history[:-1]]
    assert len(one.state.log_history) == 7 and _same_weights(one, four)
    # another seed gives another trajectory
    assert not _same_weights(one, _trainer(tmp_path, data, 6, 4, seed=1))


def test_save_load_continue_equals_an_unbroken_run(tmp_path):
    data = _batch(31, rows=4 * ROWS)
    whole = _trainer(tmp_path / "whole", data, 6, 2)
    whole.train()
    first = _trainer(tmp_path / "parts", data, 3, 2)
    first.args.save_steps = 3
    first.train()
    second = _trainer(tmp_path / "parts", data, 6, 2)
    with torch.no_grad():
        for p in second.model.parameters():
            p.add_(1.0)  # other weights until the checkpoint is loaded
    second._generator.manual_seed(123)
    second.train(resume_from_checkpoint=True)
    assert second.state.global_step == 6
    assert second.state.loader_epoch == 1 and second.state.batches_in_epoch == 2
    assert _same_weights(whole, second)
    for k, opt in whole.optimizers.items():
        for a, b in zip(opt.state_dict()["state"].values(),
                        second.optimizers[k].state_dict()["state"].values()):
            assert all(torch.equal(torch.as_tensor(a[f]), torch.as_tensor(b[f])) for f in a)


def test_trainer_evaluates_through_the_model_and_resets_its_schedule(tmp_path):
    data = _batch(32, rows=2 * ROWS)
    trainer = _trainer(tmp_path, data, 2, 2)
    trainer.eval_dataset = data
    trainer.args.lr_scheduler_type, trainer.args.warmup_steps = "linear", 1
    trainer.train()
    got = trainer.evaluate()
    # the trainer adds the evaluation's runtime to the model's metrics
    assert got.pop("eval_runtime") >= 0 and got.pop("eval_samples_per_second") > 0
    assert got == trainer.model.evaluate(trainer.get_eval_dataloader())
    assert trainer.state.log_history[-1]["step"] == 2 and "eval_/next-item/ndcg_at_10" in got
    assert trainer._opt_step == 2
    trainer.reset_lr_scheduler()
    assert trainer._opt_step == 0 and not trainer.optimizers["table"].state
    scores, ids = trainer.predict(data, top_k=5)
    assert scores.shape == ids.shape == (2 * ROWS, 5)
    with pytest.raises(NotImplementedError):
        ttr.Trainer(trainer.model, trainer.args, device="cpu", mesh=object())
    # a path goes to the Parquet loader, which reads the file
    with pytest.raises(FileNotFoundError):
        ttr.Trainer(trainer.model, trainer.args, schema=trainer.schema,
                    train_dataset="sessions.parquet", device="cpu").get_train_dataloader()


def test_head_from_body_configures_copies_and_sets_the_budget():
    task = NextItemPredictionTask(weight_tying=True)
    heads = []
    for num_items in (50, 80):
        im = ttr.TabularSequenceFeatures.from_schema(
            flagship.schema(num_items, 4), d_output=16, masking="mlm", aggregation="concat",
            masking_kwargs={"mlm_probability": 0.3})
        cfg = ttr.XLNetConfig.build(d_model=16, n_head=2, n_layer=1, total_seq_length=4)
        heads.append(ttr.Head.from_body(im, cfg, tasks=[task]))
    # the task object given stays as it was; each head has its own copy
    assert task.target_dim is None and task.tying_projection is None
    assert task.budget_target_prob is None
    a, b = heads[0].tasks[0], heads[1].tasks[0]
    assert a is not b and a is not task
    assert (a.target_dim, b.target_dim) == (51, 81)
    assert a.tying_projection is not b.tying_projection
    assert a.budget_target_prob == b.budget_target_prob == 0.3
    # the flagship head: 2560 positions are cut to 915 loss rows
    flag = flagship.build_model("cpu", **SMALL).heads[0].tasks[0]
    assert flag.budget_target_prob == 0.3 and flag._budget_rows(128 * 20) == 915
    # an explicit budget wins, and a budget of 1 keeps every row
    assert NextItemPredictionTask(weight_tying=True, loss_budget=0.5)._budget_rows(100) == 50
    assert NextItemPredictionTask(weight_tying=True, loss_budget=1.0)._budget_rows(100) is None
    # sampled softmax builds; over a vocab-parallel group it is not ported
    assert NextItemPredictionTask(weight_tying=True, sampled_softmax=True).sampled_softmax
    with pytest.raises(NotImplementedError):
        NextItemPredictionTask(weight_tying=True, sampled_softmax=True,
                               vocab_parallel_group=object())


def test_budgeted_rows_keep_every_target_first():
    """With the budget on (N = 320 > 187), the loss over the M gathered rows
    equals the loss over all N rows: no target is dropped."""
    model = flagship.build_model("cpu", dropout=0.0, **SMALL)
    task = model.heads[0].tasks[0]
    tb = model._as_dense(_batch(40, rows=40))
    g = torch.Generator().manual_seed(0)
    loss, outs = model(tb, training=True, generator=g)
    M = task._budget_rows(40 * S)
    assert M is not None and outs["next-item"].labels.shape == (M,)
    task.budget_target_prob = None
    g = torch.Generator().manual_seed(0)
    full, outs_full = model(tb, training=True, generator=g)
    assert outs_full["next-item"].labels.shape == (40 * S,)
    assert float(outs["next-item"].loss_weight) == float(outs_full["next-item"].loss_weight)
    np.testing.assert_allclose(float(loss.detach()), float(full.detach()), rtol=1e-6)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_synthetic_loader_batches_match_jax(shuffle, drop_last):
    kw = dict(batch_size=12, num_rows=40, shuffle=shuffle, drop_last=drop_last, seed=5)
    want = JaxSyntheticDataLoader.from_schema(
        jax_schema_fn(V, flagship.NUM_CATEGORIES, S), prefetch=0, **kw)
    got = SyntheticDataLoader.from_schema(flagship.schema(V, S), **kw)
    assert len(got) == len(want) == (3 if drop_last else 4)
    for _ in range(2):  # two epochs: the order changes with the epoch
        batches = list(zip(got, want))
        assert len(batches) == len(want)
        for g, w in batches:
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
    got.set_state(0, 2)
    resumed = list(got)
    first_epoch = list(SyntheticDataLoader.from_schema(flagship.schema(V, S), **kw))
    assert len(resumed) == len(first_epoch) - 2
    np.testing.assert_array_equal(resumed[0]["item_id"], first_epoch[2]["item_id"])


def _trainer_pair(params, tmp_path, engine, **datasets):
    jschema = jax_schema_fn(num_items=V, num_categories=flagship.NUM_CATEGORIES,
                            max_session_length=S)
    kw = dict(data_loader_engine=engine, max_sequence_length=S, max_steps=2, eval_steps=1,
              logging_steps=1)
    # the JAX batch sizes are per device of its mesh, the port's global
    per_device = ROWS // jax.device_count()
    jt = jtr.Trainer(model=_jax_model(), schema=jschema, **datasets,
                     args=jtr.T4RecTrainingArguments(
                         output_dir=str(tmp_path / "jax"), per_device_train_batch_size=per_device,
                         per_device_eval_batch_size=per_device, **kw))
    tt = ttr.Trainer(_torch_model(params), schema=flagship.schema(V, S), device="cpu", **datasets,
                     args=ttr.T4RecTrainingArguments(
                         output_dir=str(tmp_path / "port"), per_device_train_batch_size=ROWS,
                         per_device_eval_batch_size=ROWS, **kw))
    return jt, tt


@pytest.mark.parametrize("entry", ["train", "evaluate", "predict"])
def test_without_data_both_trainers_raise_the_same_error_under_parquet(entry, pair, tmp_path):
    """No silent synthetic sessions: under a file engine, training,
    evaluation and prediction without their dataset raise the JAX
    ``Trainer``'s errors, from the entry point and from the loader getter."""
    jt, tt = _trainer_pair(pair[1], tmp_path, "parquet")
    getter = {"train": "get_train_dataloader", "evaluate": "get_eval_dataloader",
              "predict": "get_test_dataloader"}[entry]
    messages = []
    for t in (jt, tt):
        for call in (getattr(t, entry), getattr(t, getter)):
            with pytest.raises(ValueError) as err:
                call()
            messages.append(str(err.value))
    assert len(set(messages)) == 1 and entry.replace("evaluate", "evaluation") \
        .replace("train", "training").replace("predict", "prediction") in messages[0]


def test_periodic_evaluation_needs_evaluation_data_as_in_jax(pair, tmp_path):
    """With training data and no evaluation data, ``eval_steps`` runs no
    evaluation under a file engine; under ``"synthetic"`` both trainers
    evaluate on sessions of the schema, and their loaders agree batch for
    batch."""
    data = _batch(40, rows=2 * ROWS)
    jt, tt = _trainer_pair(pair[1], tmp_path, "parquet", train_dataset=data)
    assert jt._has_eval_data() is tt._has_eval_data() is False
    tt.train()
    assert tt.state.global_step == 2
    assert not any("eval_loss" in h for h in tt.state.log_history)

    jt, tt = _trainer_pair(pair[1], tmp_path, "synthetic")
    assert jt._has_eval_data() is tt._has_eval_data() is True
    for getter in ("get_train_dataloader", "get_eval_dataloader", "get_test_dataloader"):
        want, got = next(iter(getattr(jt, getter)())), next(iter(getattr(tt, getter)()))
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    tt.train()
    assert sum("eval_loss" in h for h in tt.state.log_history) == 2


def test_build_trainer_without_data_trains_on_synthetic_sessions(tmp_path):
    trainer = flagship.build_trainer("cpu", output_dir=str(tmp_path), **SMALL)
    assert trainer.args.data_loader_engine == "synthetic"
    trainer.args.max_steps, trainer.args.per_device_train_batch_size = 2, ROWS
    assert trainer.train()["train_steps"] == 2
    assert "eval_/next-item/recall_at_10" in trainer.evaluate(max_steps=1)
    # with a training set and no evaluation set, evaluation raises
    given = flagship.build_trainer("cpu", output_dir=str(tmp_path), train_dataset=_batch(41),
                                   **SMALL)
    assert given.args.data_loader_engine == "parquet"
    with pytest.raises(ValueError, match="evaluation requires an eval_dataset"):
        given.evaluate()
