"""Training, evaluation, prediction and checkpoints of the port over
('data', 'model') layouts of Gloo ranks on the CPU, against the port on one
rank and against the JAX ``Trainer`` on a (data 2, model 2) mesh.

A small XLNet-MLM model (32,768 items, so that its 32,776-row tied table
crosses ``MIN_ROWS_TO_SHARD`` and splits into 2 or 4 shards; d_model 16, 2
layers, 2 heads, sessions of 8, dropout 0) starts from the JAX package's
initial weights (``convert.params_from_jax``). Ranks run as subprocesses of
``tests/torch_mesh_worker.py`` (two worlds: 2 ranks for the layouts
(2, 1) and (1, 2), 4 ranks for (2, 2)), each with a hard timeout and a
collective timeout; the one-rank runs and the JAX trainer run meanwhile in
this process. The runs are made once and shared between pytest-xdist
workers (a file lock under the session's base temporary directory).

Every arm takes the same three global batches of 16 sessions (each data
row its half), with masks that are a function of the batch's content (the
same rows masked alike however a batch is split) and a fixed set of 64
negatives: the adafactor chain, the streamed table update (K7a/K7b's plain
versions over the shard), sampled softmax (its rows through the sharded
row gather) and ``sparse_adam``; the arm ``draws`` keeps the trainer's own
masks, which over (1, 2) are those of one rank.

Tolerances, from the sums' order (all-reduces, the sharded CE's merge,
deduplicated row gradients): losses within 1e-5 relative; the parameters'
movements within 1e-3 in relative Frobenius norm (Adam and Adafactor map a
gradient near zero to an update of either sign); evaluation metrics within
1e-5; top-k ids equal and scores within 1e-4 (after three steps the weights
differ by those roundings). A resumed run equals the
unbroken one within 1e-6. Against the JAX trainer: losses 1e-4, movements
2e-2, metrics 1e-4, as ``test_torch_trainer.py`` holds one rank.
"""

import fcntl
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import transformers4rec_tpu as jtr
from transformers4rec_tpu.data.synthetic import synthetic_ecommerce_data_schema as jax_schema_fn
from transformers4rec_tpu.masking import MaskedLanguageModeling as JaxMLM
from transformers4rec_tpu.masking import MaskingInfo as JaxMaskingInfo
from transformers4rec_tpu.model.prediction_task import LogUniformSampler as JaxLogUniformSampler
from transformers4rec_tpu.parallel.mesh import make_mesh as jax_make_mesh
from transformers4rec_tpu.parallel.mesh import param_shardings

from transformers4rec_tpu_torch import convert, flagship
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.masking import MaskedLanguageModeling
from transformers4rec_tpu_torch.model.prediction_task import LogUniformSampler
from transformers4rec_tpu_torch.trainer.trainer import CHECKPOINT_FILE

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_worker as worker  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
V, S, D, L, H = worker.V, worker.S, worker.D, worker.L, worker.H
EVAL_ROWS = 13  # an odd count: the stripes differ in length and end in fill rows
RANK_TIMEOUT = 150
# a key bias shifts every logit of a query alike: its gradient is rounding noise
ZERO_GRADIENT = "attn.k.bias"
CASES = [(layout, arm) for layout, arms in worker.ARMS.items() for arm in arms]


def _jax_model(sampled=False):
    schema = jax_schema_fn(num_items=V, num_categories=flagship.NUM_CATEGORIES,
                           max_session_length=S)
    im = jtr.TabularSequenceFeatures.from_schema(
        schema, d_output=D, masking="mlm", aggregation="concat",
        masking_kwargs={"mlm_probability": 0.3})
    cfg = jtr.XLNetConfig.build(d_model=D, n_head=H, n_layer=L, total_seq_length=S, dropout=0.0)
    task = jtr.NextItemPredictionTask(weight_tying=True, sampled_softmax=sampled,
                                      max_n_samples=worker.NEG)
    return schema, cfg.to_model(im, task)


def _jax_content_mask(self, rng, item_ids, training=False, testing=False, segment_ids=None):
    """``torch_mesh_worker.content_mask`` in JAX (training only)."""
    if not training:
        return _jax_original(self, rng, item_ids, training, testing, segment_ids)
    pos = jnp.arange(item_ids.shape[1])[None, :]
    non_pad = item_ids != self.padding_idx
    mask = ((item_ids * 7 + pos * 3) % 10 < 3) & non_pad
    targets = jnp.where(mask, item_ids, jnp.full_like(item_ids, self.padding_idx))
    return JaxMaskingInfo(targets=targets, mask=mask, input_schema=mask, pad_mask=non_pad)


_jax_original = JaxMLM.compute_masked_targets
JAX_ARMS = ("adafactor", "sampled", "sparse_adam")


def _run_jax(arm, params, data, out_dir):
    """The JAX trainer on a (data 2, model 2) mesh of four of the CPU
    devices, two steps of the arm on the global batches with the content
    masks and the fixed negatives, then its evaluation."""
    schema, jmodel = _jax_model(sampled=arm != "adafactor")
    mesh = jax_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    args = jtr.T4RecTrainingArguments(
        output_dir=str(out_dir), learning_rate=worker.LR, lr_scheduler_type="constant",
        max_grad_norm=worker.CLIP, per_device_train_batch_size=2,
        per_device_eval_batch_size=2, steps_per_execution=2, max_sequence_length=S,
        max_steps=2, logging_steps=1,
        embedding_optimizer="sparse_adam" if arm == "sparse_adam" else "adafactor")
    jt = jtr.Trainer(model=jmodel, args=args, schema=schema, mesh=mesh,
                     train_dataloader=data["train"][:2], eval_dataloader=[_padded(data["eval"])])
    # numpy leaves: each trainer donates the arrays it is given
    jt._init_params = lambda batch: jax.device_put(params, param_shardings(params, mesh))
    negatives = jnp.asarray(worker.negatives().numpy(), jnp.int32)
    sample = JaxLogUniformSampler.sample
    JaxMLM.compute_masked_targets = _jax_content_mask
    JaxLogUniformSampler.sample = lambda self, rng: negatives
    try:
        jt.train()
    finally:
        JaxMLM.compute_masked_targets, JaxLogUniformSampler.sample = _jax_original, sample
    metrics = {k: float(v) for k, v in jt.evaluate().items()
               if "runtime" not in k and "per_second" not in k}
    return {"losses": [h["loss"] for h in jt.state.log_history if "loss" in h],
            "eval": metrics,
            "state": convert.params_from_jax(jax.tree.map(np.asarray, jt.params)),
            "table_sharded": "model" in str(jt.params["params"]["heads_0"]["body"]
                                                ["blocks_0"]["categorical_module"]
                                                ["item_id_table"].sharding.spec)}


def _padded(batch, rows=worker.GLOBAL_BATCH):
    """``batch`` zero-filled to ``rows`` rows, as the loaders fill a tail."""
    return {k: np.concatenate([v, np.zeros((rows - len(v),) + v.shape[1:], v.dtype)])
            for k, v in batch.items()}


def _one_rank(arm, weights, data, out_dir):
    """The arm on one rank: the global batches whole."""
    patched = (MaskedLanguageModeling.compute_masked_targets, LogUniformSampler.sample)
    if arm != "draws":
        worker.patch_draws()
    try:
        trainer = worker.build_trainer(arm, weights, str(out_dir), world=1)
        record = worker.run_arm(trainer, data, 0, 1, str(out_dir))
        record["seed"] = trainer._generator.initial_seed()
    finally:
        MaskedLanguageModeling.compute_masked_targets, LogUniformSampler.sample = patched
    return record


def _start_world(world, in_dir, out_dir, tmp):
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_mesh_worker.py"), str(rank), str(world),
         str(tmp / f"store{world}"), str(in_dir), str(out_dir)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]


def _compute(root: Path) -> dict:
    in_dir, out_dir = root / "in", root / "out"
    in_dir.mkdir()
    out_dir.mkdir()
    _, jmodel = _jax_model()
    data = {"train": [synthetic_data(flagship.schema(V, S), num_rows=worker.GLOBAL_BATCH,
                                     max_session_length=S, seed=40 + t) for t in range(3)],
            "eval": synthetic_data(flagship.schema(V, S), num_rows=EVAL_ROWS,
                                   max_session_length=S, seed=50)}
    first = {k: jnp.asarray(v) for k, v in data["train"][0].items()}
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), first)
    params = jax.tree.map(np.asarray, params)
    weights = convert.params_from_jax(params)
    torch.save(weights, in_dir / "weights.pt")
    torch.save(data, in_dir / "data.pt")
    procs = _start_world(2, in_dir, out_dir, root) + _start_world(4, in_dir, out_dir, root)
    try:
        ref = {arm: _one_rank(arm, weights, data, root / f"one_{arm}")
               for arm in ("adafactor", "streamed", "sampled", "sparse_adam", "draws")}
        jax_run = {arm: _run_jax(arm, params, data, root / f"jax_{arm}") for arm in JAX_ARMS}
        logs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0] * 6, "\n".join(logs)
    ranks = {}
    for (rows, cols), arms in worker.ARMS.items():
        for arm in arms:
            d = out_dir / f"{rows}x{cols}_{arm}"
            ranks[(rows, cols), arm] = [json.loads((d / f"rank{r}.json").read_text())
                                        for r in range(rows * cols)]
    return dict(root=root, data=data, weights=weights, ref=ref, jax=jax_run, ranks=ranks)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The multi-rank, one-rank and JAX runs, made once for every xdist
    worker of the session."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent  # the session's, shared by its workers
    done = base / "torch_mesh_runs.pkl"
    with open(base / "torch_mesh_runs.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not done.exists():
                root = base / "torch_mesh_runs"
                root.mkdir(exist_ok=True)
                with open(done, "wb") as f:
                    pickle.dump(_compute(root), f)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    with open(done, "rb") as f:
        return pickle.load(f)


def _ckpt(path):
    return torch.load(Path(path) / CHECKPOINT_FILE, map_location="cpu", weights_only=False)


def _moved(state, weights, ref_state, tol, what):
    """The parameters' movements from ``weights`` agree with the
    reference's within ``tol`` in relative Frobenius norm."""
    for name, w0 in weights.items():
        if ZERO_GRADIENT in name:
            continue
        got = state[name].float() - w0.float()
        want = ref_state[name].float() - w0.float()
        denom = float(torch.linalg.norm(want))
        err = float(torch.linalg.norm(got - want)) / max(denom, 1e-12)
        assert err <= tol or denom == 0.0 and float(torch.linalg.norm(got)) == 0.0, \
            (what, name, err)


def _close_metrics(got, want, tol):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=tol, abs=tol), k


@pytest.mark.parametrize("layout,arm", CASES, ids=[f"{r}x{c}-{a}" for (r, c), a in CASES])
def test_layout_equals_one_rank_on_the_global_batch(runs, layout, arm):
    """Each layout's run equals the one-rank run: losses, weights after the
    second and third steps, evaluation, top-k; a resumed run equals the
    unbroken one; the ranks of a model group agree, and every table state
    is the shard's V/M rows."""
    ranks, ref = runs["ranks"][layout, arm], runs["ref"][arm]
    name = f"{layout[0]}x{layout[1]}_{arm}"
    d = runs["root"] / "out" / name
    weights = runs["weights"]
    for rec in ranks:
        np.testing.assert_allclose(rec["losses"], ref["losses"], rtol=1e-5)
        _close_metrics(rec["eval"], ref["eval"], 1e-5)
        np.testing.assert_array_equal(rec["ids"], ref["ids"])
        np.testing.assert_allclose(rec["scores"], ref["scores"], rtol=1e-4, atol=1e-6)
    for step in (2, 3):
        _moved(_ckpt(d / f"checkpoint-{step}")["model"], weights,
               _ckpt(runs["root"] / f"one_{arm}" / f"checkpoint-{step}")["model"], 1e-3,
               (name, step))
    unbroken, resumed = _ckpt(d / "checkpoint-3"), _ckpt(d / "resumed")
    for k, v in unbroken["model"].items():
        torch.testing.assert_close(resumed["model"][k], v, rtol=1e-6, atol=1e-7)
    # the shards: V/M rows of the table and of every table state on each rank
    rows = 32776
    M = layout[1]
    for rec in ranks:
        assert rec["table_rows"] == [rows // M, 64]
        assert rec["state_rows"] and all(shape[0] == rows // M
                                         for shape in rec["state_rows"].values()), rec
        # each data row's loader takes its stripe of the dataset
        assert rec["loader"][0] == worker.GLOBAL_BATCH // layout[0]
        stripe = runs["data"]["eval"]["item_id"][rec["data_index"]::layout[0], 0]
        assert rec["loader"][1][:len(stripe)] == stripe.tolist()
    # the checkpoint holds whole tables, states included
    doc = _ckpt(d / "checkpoint-2")
    table = [k for k in doc["model"] if k.endswith("tables.item_id")][0]
    assert doc["model"][table].shape[0] == rows
    assert len(doc["generators"]) == layout[0]


def test_draws_follow_the_data_row(runs):
    """The ranks of a data row draw alike and the rows apart: the seeds,
    and over (1, 2) the trainer's own masks give the one-rank run."""
    for (layout, arm), ranks in runs["ranks"].items():
        seeds = {}
        for rec in ranks:
            seeds.setdefault(rec["data_index"], set()).add(rec["seed"])
        assert all(len(s) == 1 for s in seeds.values()), (layout, arm)
        assert len(set().union(*seeds.values())) == layout[0], (layout, arm)
        assert seeds[0] == {runs["ref"][arm]["seed"]}
    # already held to the one-rank run in test_layout_equals_one_rank_...
    assert ((1, 2), "draws") in runs["ranks"]


@pytest.mark.parametrize("arm", JAX_ARMS)
def test_jax_trainer_on_a_2x2_mesh_matches_four_ranks(runs, arm):
    """The JAX ``Trainer`` with a (data 2, model 2) mesh (its item table
    row-sharded; its CE vocab-parallel, or its sampled softmax, or its
    sparse step on the sharded table) against the port's four ranks."""
    j, ranks = runs["jax"][arm], runs["ranks"][(2, 2), arm]
    assert j["table_sharded"]
    weights = runs["weights"]
    d = runs["root"] / "out" / f"2x2_{arm}"
    for rec in ranks:
        np.testing.assert_allclose(rec["losses"][:2], j["losses"], rtol=1e-4)
    _moved(_ckpt(d / "checkpoint-2")["model"], weights, j["state"], 2e-2, "jax")
    assert _ckpt(d / "checkpoint-3")["trainer_state"]["global_step"] == 3
    # the JAX evaluation after two steps against the one-rank port's on the
    # four ranks' checkpoint of the same step
    one = worker.build_trainer(arm, weights, str(runs["root"] / f"eval_{arm}"), world=1)
    one.load(str(d / "checkpoint-2"))
    want = {k: v for k, v in one.evaluate(eval_dataset=runs["data"]["eval"]).items()
            if "runtime" not in k and "per_second" not in k}
    _close_metrics(want, j["eval"], 1e-4)


@pytest.mark.parametrize("layout", [(1, 2), (2, 2)])
def test_one_rank_loads_a_multi_rank_checkpoint(runs, layout, tmp_path):
    """The checkpoint four (or two) ranks wrote after step 2, loaded by a
    one-rank trainer, takes the third step as the one-rank run did; its
    optimizer state is the whole table's."""
    patched = (MaskedLanguageModeling.compute_masked_targets, LogUniformSampler.sample)
    worker.patch_draws()
    try:
        for arm in ("adafactor", "sparse_adam"):
            name = f"{layout[0]}x{layout[1]}_{arm}"
            one = worker.build_trainer(arm, runs["weights"], str(tmp_path / arm), world=1)
            one.load(str(runs["root"] / "out" / name / "checkpoint-2"))
            _, state_rows = worker.state_rows(one)
            assert state_rows and all(s[0] == 32776 for s in state_rows.values())
            one._train_dataloader = [runs["data"]["train"][2]]
            one.args.max_steps = 1
            one.train()
            _moved(one.model.state_dict(), runs["weights"],
                   _ckpt(runs["root"] / f"one_{arm}" / "checkpoint-3")["model"], 1e-3, name)
    finally:
        MaskedLanguageModeling.compute_masked_targets, LogUniformSampler.sample = patched
