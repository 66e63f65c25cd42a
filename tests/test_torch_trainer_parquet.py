"""The port's ``Trainer`` on Parquet files against the JAX ``Trainer`` on the
CPU.

Raw interactions of three days go through the port's ETL into
``{1,2,3}/train.parquet`` and ``valid.parquet`` windows. One small XLNet-MLM
(50 items, d_model 16, one layer, two heads, sessions of 8, dropout 0) is
built in both packages with the same weights (``convert.params_from_jax``
of the JAX trainer's initial parameters). The JAX trainer runs on the
8-device CPU mesh of ``tests/conftest.py``, where a per-device batch of 4 is
a global 32; the port is given the global 32, so both read the same
batches. Tolerance 1e-5 absolute for every metric, loss and score: the two
packages sum in other orders, nothing else differs. The learning rate is 0
where the JAX trainer trains, so ``fit_and_evaluate``'s windows see the
initial weights in both packages. Mid-epoch resume, ``reset_model``,
``Model.fit``/``save``/``load`` and the README's quick start run on the
port alone.
"""

import json
import os
import re
import sys
import types
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import transformers4rec_tpu as jtr
from transformers4rec_tpu.data.synthetic import synthetic_ecommerce_data_schema as jax_schema_fn
from transformers4rec_tpu.parallel.mesh import param_shardings
from transformers4rec_tpu.utils import examples_utils as jexamples

import transformers4rec_tpu_torch as ttr
from transformers4rec_tpu_torch import convert, flagship
from transformers4rec_tpu_torch.trainer import T4RecTrainingArguments
from transformers4rec_tpu_torch.utils import data_utils, examples_utils

torch.set_num_threads(1)

V, D, S = 50, 16, 8
SMALL = dict(num_items=V, d_model=D, n_layer=1, n_head=2, seq=S)
GLOBAL_BATCH = 32
ATOL = 1e-5
REPO = Path(__file__).resolve().parent.parent


def _raw_interactions(seed=0, sessions_per_day=200):
    """Sessions of 2-8 interactions over three days, item ids below V."""
    rng = np.random.default_rng(seed)
    n_sessions = 3 * sessions_per_day
    lengths = rng.integers(2, S + 1, n_sessions)
    sid = np.repeat(np.arange(1, n_sessions + 1), lengths)
    day = np.repeat(np.arange(n_sessions) // sessions_per_day + 1, lengths)
    n = len(sid)
    item = rng.integers(1, V, n)
    return pd.DataFrame({
        "session_id": sid, "item_id": item, "category": item % 17 + 1,
        "item_recency": rng.random(n).astype(np.float32), "weekday_sin": rng.random(n),
        "timestamp": day * 86_400 + rng.integers(0, 86_000, n), "day": day,
    })


@pytest.fixture(scope="module")
def windows(tmp_path_factory):
    root = tmp_path_factory.mktemp("windows")
    data_utils.etl_interactions_to_time_splits(
        _raw_interactions(), flagship.schema(V, S), str(root), day_col="day",
        maximum_length=S, val_size=0.25, test_size=0.05)
    return root


def _jax_args(output_dir, **kw):
    return jtr.T4RecTrainingArguments(
        output_dir=str(output_dir), per_device_train_batch_size=GLOBAL_BATCH // 8,
        per_device_eval_batch_size=GLOBAL_BATCH // 8, max_sequence_length=S,
        steps_per_execution=1, learning_rate=0.0, max_steps=2, logging_steps=1,
        log_json=True, **kw)


def _port_args(output_dir, **kw):
    return T4RecTrainingArguments(**{
        "output_dir": str(output_dir), "per_device_train_batch_size": GLOBAL_BATCH,
        "per_device_eval_batch_size": GLOBAL_BATCH, "max_sequence_length": S,
        "learning_rate": 0.0, "max_steps": 2, "logging_steps": 1, "log_json": True, **kw})


def _jax_model():
    schema = jax_schema_fn(num_items=V, num_categories=flagship.NUM_CATEGORIES,
                           max_session_length=S)
    im = jtr.TabularSequenceFeatures.from_schema(
        schema, d_output=D, masking="mlm", aggregation="concat",
        masking_kwargs={"mlm_probability": 0.3})
    cfg = jtr.XLNetConfig.build(d_model=D, n_head=2, n_layer=1, total_seq_length=S, dropout=0.0)
    return schema, cfg.to_model(im, jtr.NextItemPredictionTask(weight_tying=True))


@pytest.fixture(scope="module")
def pair(windows, tmp_path_factory):
    """A JAX trainer whose parameters are initialised, and a factory of
    port trainers that start from the same weights. The JAX trainer's own
    ``_init_params`` runs ``model.init`` eagerly (about 12 s on the CPU);
    it is handed the parameters of a jitted ``model.init`` instead, placed
    with the trainer's shardings."""
    schema, jmodel = _jax_model()
    jt = jtr.Trainer(model=jmodel, args=_jax_args(tmp_path_factory.mktemp("jax")),
                     schema=schema, eval_dataset=str(windows / "2" / "valid.parquet"))
    first = next(iter(jt.get_eval_dataloader()))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  {k: jnp.asarray(v) for k, v in first.items()})
    jt._init_params = lambda batch: jax.device_put(params, param_shardings(params, jt.mesh))
    jt._ensure_state(first, 1)
    state = convert.params_from_jax(jax.tree.map(np.asarray, jt.params))

    def port_trainer(output_dir, **kw):
        model = flagship.build_model("cpu", seed=1, dropout=0.0, **SMALL)
        model.load_state_dict(state)
        return ttr.Trainer(model, _port_args(output_dir, **kw), schema=flagship.schema(V, S),
                           eval_dataset=str(windows / "2" / "valid.parquet"), device="cpu")

    return jt, port_trainer


def _metrics(results):
    return {k: v for k, v in results.items() if "_runtime" not in k and "_per_second" not in k}


def _close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= ATOL, (k, got[k], want[k])


@pytest.mark.parametrize("engine,every", [("parquet", 1), ("parquet_streaming", 1),
                                          ("merlin", 2)])
def test_evaluate_matches_the_jax_trainer(pair, windows, tmp_path, engine, every):
    jt, port_trainer = pair
    jt.args.data_loader_engine, jt.args.compute_metrics_each_n_steps = engine, every
    try:
        want = jt.evaluate()
    finally:
        jt.args.data_loader_engine, jt.args.compute_metrics_each_n_steps = "parquet", 1
    tt = port_trainer(tmp_path, data_loader_engine=engine, compute_metrics_each_n_steps=every)
    got = tt.evaluate()
    _close(_metrics(got), _metrics(want))
    assert "eval_runtime" in got and "eval_samples_per_second" in got
    # every session counts once: the tail batch is zero-filled, not dropped
    n = len(pd.read_parquet(windows / "2" / "valid.parquet"))
    loader = tt.get_eval_dataloader()
    assert loader.num_rows == n and n % GLOBAL_BATCH and len(loader) == -(-n // GLOBAL_BATCH)
    assert tt.get_eval_dataloader() is loader  # cached


@pytest.mark.parametrize("engine", ["parquet", "parquet_streaming"])
def test_predict_and_log_predictions_match_the_jax_trainer(pair, windows, tmp_path, engine):
    jt, port_trainer = pair
    path = str(windows / "3" / "valid.parquet")
    want_s, want_i = jt.predict(path, top_k=5)
    tt = port_trainer(tmp_path, data_loader_engine=engine)
    got_s, got_i = tt.predict(path, top_k=5)
    n = len(pd.read_parquet(path))
    assert got_s.shape == got_i.shape == want_i.shape == (n, 5)
    np.testing.assert_allclose(got_s, want_s, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got_i, want_i)
    # k from predict_top_k when no top_k is given
    tt.args.predict_top_k = 3
    assert tt.predict(path)[1].shape == (n, 3)
    if engine == "parquet":
        jt.args.predict_top_k = tt.args.predict_top_k = 5
        try:
            want = pd.read_parquet(jt.log_predictions(path))
        finally:
            jt.args.predict_top_k = 100
        got_path = tt.log_predictions(path)
        assert os.path.basename(got_path) == "pred_logs_eval_0.parquet"
        got = pd.read_parquet(got_path)
        assert list(got.columns) == ["pred_item_ids", "pred_item_scores"] and len(got) == n
        np.testing.assert_array_equal(np.stack(got["pred_item_ids"]),
                                      np.stack(want["pred_item_ids"]))
        np.testing.assert_allclose(np.stack(got["pred_item_scores"]),
                                   np.stack(want["pred_item_scores"]), atol=ATOL, rtol=0)


def _jsonl(output_dir):
    with open(os.path.join(output_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_fit_and_evaluate_at_learning_rate_zero_matches_jax(pair, windows, tmp_path):
    jt, port_trainer = pair
    jt.args.output_dir = str(tmp_path / "jax")
    want = jexamples.fit_and_evaluate(jt, 1, 2, str(windows))
    tt = port_trainer(tmp_path / "torch")
    got = examples_utils.fit_and_evaluate(tt, 1, 2, str(windows))
    assert got.keys() == want.keys() and "indexed_by_time_eval_/next-item/recall@20" in got
    for k in want:
        assert len(got[k]) == 2
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0, err_msg=k)
    assert tt.state.global_step == 4
    # the metrics.jsonl records carry the JAX trainer's keys, record by record
    got_records, want_records = _jsonl(tt.args.output_dir), _jsonl(jt.args.output_dir)
    assert [sorted(r) for r in got_records] == [sorted(r) for r in want_records]
    assert [r["global_step"] for r in got_records] == [2, 2, 4, 4]


def test_reset_model_and_the_sliding_window_protocol(pair, windows, tmp_path, monkeypatch):
    _, port_trainer = pair
    tt = port_trainer(tmp_path, learning_rate=1e-2)
    start = {k: v.clone() for k, v in tt.model.state_dict().items()}
    seen = []
    train = tt.train
    monkeypatch.setattr(tt, "train", lambda: (seen.append(list(tt.train_dataset)), train())[1])
    out = examples_utils.fit_and_evaluate(tt, 1, 2, str(windows), no_incremental_training=True,
                                          training_time_window_size=2)
    assert [[Path(p).parent.name for p in paths] for paths in seen] == [["1"], ["1", "2"]]
    assert all(len(v) == 2 for v in out.values())
    assert not all(torch.equal(start[k], v) for k, v in tt.model.state_dict().items())
    tt.reset_model()
    assert not tt.optimizers
    assert all(torch.equal(start[k], v) for k, v in tt.model.state_dict().items())


@pytest.mark.parametrize("metric,greater,values,limit", [
    ("recall_at_10", None, [0.2, 0.5, 0.3, 0.4], 1),
    ("eval_loss", None, [3.0, 2.5, 2.7, 2.4], 2),
    ("/next-item/ndcg_at_10", False, [0.3, 0.1, 0.2, 0.4], 1),
])
def test_best_checkpoint_and_rotation_keep_the_jax_directories(pair, tmp_path, metric, greater,
                                                               values, limit):
    """One scripted sequence of evaluations, a save at each (and one save
    between evaluations, which claims no metric)."""
    jt, port_trainer = pair
    kw = dict(save_steps=2, eval_steps=2, save_total_limit=limit, load_best_model_at_end=True,
              metric_for_best_model=metric, greater_is_better=greater)
    j2 = jtr.Trainer(model=jt.model, args=_jax_args(tmp_path / "jax", **kw), schema=jt.schema)
    j2._train_state = jt._train_state
    t2 = port_trainer(tmp_path / "torch", **kw)
    for trainer in (j2, t2):
        for i, v in enumerate(values):
            step = 2 * (i + 1)
            trainer.state.global_step = step
            trainer._last_eval_metrics = {"eval_loss": v, "eval_/next-item/recall_at_10": v,
                                          "eval_/next-item/ndcg_at_10": v}
            trainer._last_eval_step = step
            trainer._save_checkpoint()
        trainer.state.global_step = 9
        trainer._save_checkpoint()
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    assert os.path.basename(t2._best_checkpoint) == os.path.basename(j2._best_checkpoint)
    assert t2._best_metric == pytest.approx(j2._best_metric)


def test_load_best_model_at_end_restores_the_best_weights(pair, tmp_path):
    _, port_trainer = pair
    with pytest.raises(ValueError, match="save_steps AND eval_steps"):
        port_trainer(tmp_path, load_best_model_at_end=True)
    tt = port_trainer(tmp_path, learning_rate=1e-2, max_steps=4, save_steps=2, eval_steps=2,
                      load_best_model_at_end=True, metric_for_best_model="eval_loss",
                      greater_is_better=False)
    tt.train_dataset = tt.eval_dataset
    losses = []
    evaluate = tt.evaluate
    tt.evaluate = lambda: losses.append(evaluate()["eval_loss"]) or {}
    tt.train()
    best = f"checkpoint-{2 * (int(np.argmin(losses)) + 1)}"
    assert os.path.basename(tt._best_checkpoint) == best
    want = torch.load(tmp_path / best / "trainer.pt", weights_only=False)["model"]
    assert all(torch.equal(v, want[k]) for k, v in tt.model.state_dict().items())


@pytest.mark.parametrize("engine", ["parquet", "parquet_streaming"])
def test_a_mid_epoch_resume_equals_the_unbroken_run(windows, tmp_path, engine):
    """Dropout on, batches of 16 from window 1 (about 9 a epoch), a
    checkpoint after 3 steps."""
    path = str(windows / "1" / "train.parquet")

    def trainer(out, max_steps):
        t = flagship.build_trainer("cpu", seed=3, train_dataset=path, output_dir=str(out),
                                   batch=16, **SMALL)
        t.args.data_loader_engine, t.args.shuffle_buffer_size = engine, 48
        t.args.max_steps, t.args.logging_steps, t.args.steps_per_execution = max_steps, 1, 2
        return t

    whole = trainer(tmp_path / "whole", 6)
    whole.train()
    first = trainer(tmp_path / "parts", 3)
    first.args.save_steps = 3
    first.train()
    second = trainer(tmp_path / "parts", 6)
    second.train(resume_from_checkpoint=str(tmp_path / "parts" / "checkpoint-3"))
    assert second.state.loader_epoch == 0 and second.state.batches_in_epoch == 6

    def losses(t):
        return [h["loss"] for h in t.state.log_history if "loss" in h]

    assert losses(second)[-3:] == losses(whole)[-3:]
    assert all(torch.equal(v, whole.model.state_dict()[k])
               for k, v in second.model.state_dict().items())


def test_evaluate_on_the_train_set_reads_at_most_its_batches(pair, windows, tmp_path):
    _, port_trainer = pair
    tt = port_trainer(tmp_path, eval_steps_on_train_set=2)
    tt.train_dataset = str(windows / "1" / "train.parquet")
    got = tt.evaluate(on_train_set=True)
    assert "eval_train_/next-item/recall_at_20" in got
    assert got["eval_train_samples_per_second"] * got["eval_train_runtime"] == \
        pytest.approx(2 * GLOBAL_BATCH)


def test_metrics_go_to_tensorboard_when_asked(pair, tmp_path, monkeypatch):
    _, port_trainer = pair
    written = []

    class Writer:
        def __init__(self, log_dir):
            written.append(log_dir)

        def add_scalar(self, key, value, step):
            written.append((key, step))

        def flush(self):
            pass

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=Writer))
    tt = port_trainer(tmp_path, report_to="tensorboard")
    tt.evaluate()
    assert written[0] == str(tmp_path / "runs") and ("eval_loss", 0) in written


def test_model_fit_lowers_the_loss_and_save_load_round_trip(windows, tmp_path):
    from transformers4rec_tpu_torch.data import ParquetDataLoader

    model = flagship.build_model("cpu", seed=4, dropout=0.0, **SMALL)
    loader = ParquetDataLoader.from_schema(flagship.schema(V, S),
                                           str(windows / "1" / "train.parquet"), batch_size=32)
    batch = next(iter(loader))
    losses = model.fit([batch] * 30, optimizer=torch.optim.Adam(model.parameters(), lr=1e-2))
    assert len(losses) == 30 and np.mean(losses[-5:]) < losses[0]
    assert len(model.fit(loader, num_epochs=3, max_steps=5)) == 5
    model.save(str(tmp_path / "m"))
    assert sorted(os.listdir(tmp_path / "m")) == ["input_schema.json", "model.pt"]
    other = flagship.build_model("cpu", seed=5, dropout=0.0, **SMALL).load(str(tmp_path / "m"))
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in other.state_dict().items())
    assert ttr.Schema.load(str(tmp_path / "m" / "input_schema.json")) == model.input_schema


def test_arguments_keep_the_jax_defaults_and_refuse_what_is_not_ported():
    got, want = T4RecTrainingArguments(), jtr.T4RecTrainingArguments()
    for f in ("data_loader_engine", "eval_steps_on_train_set", "predict_top_k",
              "log_predictions", "compute_metrics_each_n_steps", "eval_on_test_set",
              "shuffle_buffer_size", "experiments_group", "save_total_limit",
              "load_best_model_at_end", "metric_for_best_model", "greater_is_better",
              "report_to", "disable_tqdm", "log_json", "save_async", "pack_sessions",
              "pack_eval_sessions", "mesh_model_axis", "auto_vocab_parallel",
              "gradient_checkpointing", "profile_steps", "profile_dir"):
        assert getattr(got, f) == getattr(want, f), f
    # the JAX checkpoint formats raise, naming the port's counterpart
    for jax_name, port_name in (("msgpack", "torch"), ("orbax", "sharded")):
        with pytest.raises(ValueError, match=f"counterpart is '{port_name}'"):
            T4RecTrainingArguments(checkpoint_format=jax_name)
        assert T4RecTrainingArguments(checkpoint_format=port_name).checkpoint_format == port_name
    assert T4RecTrainingArguments().checkpoint_format == "torch"
    # asynchronous saves and the profiler window are ported
    for field, value in (("save_async", True), ("profile_steps", "1,2"), ("profile_dir", "p")):
        assert getattr(T4RecTrainingArguments(**{field: value}), field) == value
    # the mesh's fields are ported (parallel.mesh, the trainer's layout)
    assert T4RecTrainingArguments(mesh_model_axis=2).mesh_model_axis == 2
    assert not T4RecTrainingArguments(auto_vocab_parallel=False).auto_vocab_parallel
    # read by no module in either package: rematerialisation is the encoder's
    assert T4RecTrainingArguments(gradient_checkpointing=True).gradient_checkpointing
    with pytest.raises(ValueError, match="data_loader_engine"):
        T4RecTrainingArguments(data_loader_engine="csv")


def test_readme_port_quick_start_runs_on_the_cpu(windows, tmp_path, monkeypatch):
    readme = (REPO / "README.md").read_text()
    blocks = [b for b in re.findall(r"```python\n(.*?)```", readme, re.DOTALL)
              if "transformers4rec_tpu_torch" in b and "train.parquet" in b]
    assert len(blocks) == 1
    code = blocks[0]
    for old, new in (('device = "cuda"', 'device = "cpu"'),
                     ("flagship.schema()", f"flagship.schema({V}, {S})"),
                     ("flagship.build_model(device)",
                      f"flagship.build_model(device, num_items={V}, d_model={D}, n_layer=1, "
                      f"n_head=2, seq={S})"),
                     ("=128", f"={GLOBAL_BATCH}"), ("max_sequence_length=20",
                                                    f"max_sequence_length={S}"),
                     ("max_steps=100", "max_steps=2"), ('"windows"', repr(str(windows)))):
        assert old in code, old
        code = code.replace(old, new)
    for name in ("train", "valid"):
        os.symlink(windows / "1" / f"{name}.parquet", tmp_path / f"{name}.parquet")
    monkeypatch.chdir(tmp_path)
    ns: dict = {}
    exec(compile(code, "README-port-quickstart", "exec"), ns)
    n = len(pd.read_parquet(tmp_path / "valid.parquet"))
    assert "eval_/next-item/ndcg_at_10" in ns["metrics"] and ns["ids"].shape == (n, 20)
    assert all(len(v) == 2 for v in ns["by_time"].values())
