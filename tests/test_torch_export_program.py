"""The port's serving artifact as a ``torch.export`` program, served without
the model's code, against the JAX package's StableHLO artifact on the CPU.

One small XLNet-MLM (500 items, d_model 32, 2 layers, sessions of 8,
dropout 0) is initialised by the JAX package and given to the port through
``convert.params_from_jax``; both packages export it with the same
Categorify mapping of the item column, in f32 and with
``weights_dtype="bfloat16"``, and both runners answer the same raw
sessions (known ids, unseen ids, padding).

Tolerances, each with its reason:

- f32 artifacts: scores within 1e-5 (the same f32 arithmetic in another
  order of sums), ids equal wherever neighbouring scores are more than
  1e-5 apart (a closer pair may swap).
- bf16 weights: both programs hold the same bf16-rounded weights and
  compute as ``jnp`` promotes (the encoder in f32, every bf16 weight cast
  up where it meets an f32 activation; scores f32), so they agree as the
  f32 artifacts do: 1e-5 on the scores, ids where neighbours are 1e-5
  apart.
- a program against its own eager model on the same device: bit for bit
  (the same operations traced).

The program's graph takes about 0.9 MB at any width, so the size check of
the bf16 artifact uses a 20,000-item table, whose weights outweigh it.
"""

import json
import os
import shutil
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformers4rec_tpu as jtr
from transformers4rec_tpu.data.synthetic import synthetic_ecommerce_data_schema as jax_schema_fn
from transformers4rec_tpu.serving import export_model as jax_export_model
from transformers4rec_tpu.serving import load_runner as jax_load_runner

import transformers4rec_tpu_torch as ttr
from transformers4rec_tpu_torch import convert, flagship
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.serving import (
    InferenceRunner,
    ServingServer,
    ShardedInferenceRunner,
    export_model,
)
from transformers4rec_tpu_torch.serving.export import PROGRAM_FILE

torch.set_num_threads(1)

V, D, H, L, S = 500, 32, 2, 2, 8
TOP_K = 10
RAW = np.random.default_rng(11).permutation(np.arange(10_000, 60_000))[: V - 3]


def _mlm_pair():
    """The JAX model and its init, and the port's model with those weights."""
    jschema = jax_schema_fn(num_items=V, num_categories=flagship.NUM_CATEGORIES,
                            max_session_length=S)
    jim = jtr.TabularSequenceFeatures.from_schema(jschema, d_output=D, masking="mlm",
                                                 aggregation="concat")
    jmodel = jtr.XLNetConfig.build(d_model=D, n_head=H, n_layer=L, total_seq_length=S,
                                   dropout=0.0).to_model(
        jim, jtr.NextItemPredictionTask(weight_tying=True))
    init = {k: jnp.asarray(v) for k, v in _batch(0, 4).items()}
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "masking", "dropout"))}
    params = jax.tree.map(np.asarray, jax.jit(lambda b: jmodel.init(rngs, b, training=True))(init))
    tmodel = build_mlm("cpu")
    tmodel.load_state_dict(convert.params_from_jax(params))
    return jmodel, params, tmodel


def build_mlm(device):
    tim = ttr.TabularSequenceFeatures.from_schema(flagship.schema(V, S), d_output=D,
                                                 masking="mlm", aggregation="concat")
    return ttr.XLNetConfig.build(d_model=D, n_head=H, n_layer=L, total_seq_length=S,
                                 dropout=0.0).to_model(
        tim, ttr.NextItemPredictionTask(weight_tying=True), device=device)


def _batch(seed, rows):
    return synthetic_data(flagship.schema(V, S), num_rows=rows, max_session_length=S, seed=seed)


def _raw_sessions(seed, rows):
    """Ragged sessions of raw item ids: mapped values, unseen values and
    sessions shorter and longer than the artifact's length; the other
    columns as the synthetic data has them."""
    data = synthetic_data(flagship.schema(V, S), num_rows=rows, max_session_length=S,
                          ragged=True, seed=seed)
    rng = np.random.default_rng(seed)
    out = {}
    for col in [k[: -len("__values")] for k in data if k.endswith("__values")]:
        off = data[f"{col}__offsets"]
        out[col] = [data[f"{col}__values"][off[i]:off[i + 1]].tolist() for i in range(rows)]
    out["item_id"] = [[int(RAW[i]) if rng.random() > 0.15 else int(rng.integers(70_000, 80_000))
                       for i in rng.integers(0, len(RAW), len(r))] for r in out["item_id"]]
    return out


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The JAX and the port's artifacts of one model, f32 and bf16 weights,
    each with the item column's Categorify mapping."""
    jmodel, params, tmodel = _mlm_pair()
    root = tmp_path_factory.mktemp("programs")
    cats = {"item_id": RAW}
    example = _batch(0, 4)
    jex = {k: jnp.asarray(v) for k, v in example.items()}
    arts = {}
    for name, wd in (("f32", None), ("bf16", "bfloat16")):
        arts[f"jax_{name}"] = jax_export_model(
            jmodel, jax.tree.map(jnp.asarray, params), jex, str(root / f"jax_{name}"),
            top_k=TOP_K, weights_dtype=wd, categories=cats)
        arts[name] = export_model(tmodel, example, str(root / name), top_k=TOP_K,
                                  weights_dtype=wd, categories=cats)
    return arts, tmodel


def _assert_same_topk(got_s, got_i, want_s, want_i, tol=1e-5):
    got_s, want_s = np.asarray(got_s, np.float64), np.asarray(want_s, np.float64)
    np.testing.assert_allclose(got_s, want_s, atol=tol, rtol=tol)
    gaps = np.abs(np.diff(want_s, axis=1)) > tol
    clear = np.ones(want_s.shape, dtype=bool)
    clear[:, :-1] &= gaps
    clear[:, 1:] &= gaps
    np.testing.assert_array_equal(np.asarray(got_i)[clear], np.asarray(want_i)[clear])


@pytest.mark.parametrize("weights", ["f32", "bf16"])
def test_the_program_answers_raw_sessions_as_the_jax_artifact(artifacts, weights):
    arts, _ = artifacts
    runner = InferenceRunner(arts[weights], device="cpu")
    assert runner.model is None  # no builder, no model code: the program alone
    jrunner = jax_load_runner(arts[f"jax_{weights}"])
    raw = _raw_sessions(7, 6)
    got_s, got_i = runner.predict(raw)
    want_s, want_i = jrunner.predict(raw)
    assert got_s.dtype == np.float32 and got_i.shape == (6, TOP_K)
    _assert_same_topk(got_s, got_i, want_s, want_i)
    # raw ids come out: every id is a mapped raw value or the undecodable -1
    assert np.isin(got_i, np.append(RAW, -1)).all()
    # and the encoded form answers the same
    enc = {k: runner.encode(k, v) for k, v in raw.items()}
    np.testing.assert_array_equal(runner.predict(enc, decode_ids=False,
                                                 encode_inputs=False)[1] >= 0, True)


def test_encode_and_decode_follow_the_jax_runner(artifacts):
    arts, _ = artifacts
    runner = InferenceRunner(arts["f32"], device="cpu")
    jrunner = jax_load_runner(arts["jax_f32"])
    raw = [[int(RAW[0]), 0, 123, int(RAW[5])], [int(RAW[1])]]
    got = runner.encode("item_id", raw)
    want = jrunner.encode("item_id", raw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].tolist() == [3, 0, 2, 8]
    ids = np.array([[0, 1, 2, 3, 4, V - 1]])
    np.testing.assert_array_equal(runner.decode_item_ids(ids), jrunner.decode_item_ids(ids))


def test_one_program_serves_every_batch_size(artifacts):
    arts, tmodel = artifacts
    runner = InferenceRunner(arts["f32"], device="cpu")
    meta = runner.metadata
    assert meta["batch_polymorphic"] and meta["device_type"] == "cpu"
    for rows in (1, 3, 7):
        batch = _batch(20 + rows, rows)
        # already ids: not encoded through the bundled mapping
        got_s, got_i = runner.predict(batch, decode_ids=False, encode_inputs=False)
        with torch.inference_mode():
            want_s, want_i = tmodel({k: torch.as_tensor(v) for k, v in batch.items()},
                                    top_k=TOP_K)
        np.testing.assert_array_equal(got_i, want_i.numpy())
        np.testing.assert_array_equal(got_s, want_s.numpy())


def test_bf16_weights_halve_the_program(tmp_path):
    model = flagship.build_model("cpu", num_items=20_000, d_model=D, n_layer=1, n_head=H,
                                 seq=S, dropout=0.0)
    example = synthetic_data(flagship.schema(20_000, S), num_rows=2, max_session_length=S,
                             seed=0)
    sizes = {}
    for name, wd in (("f32", None), ("bf16", "bfloat16")):
        path = export_model(model, example, str(tmp_path / name), top_k=TOP_K, weights_dtype=wd)
        sizes[name] = os.path.getsize(os.path.join(path, PROGRAM_FILE))
        assert json.load(open(os.path.join(path, "metadata.json")))["weights_dtype"] == wd
    assert sizes["bf16"] < 0.65 * sizes["f32"], sizes
    # the model given to the export is not changed
    assert {p.dtype for p in model.parameters()} == {torch.float32}


def test_the_clm_program_holds_the_flash_node_and_equals_the_eager_model(tmp_path):
    seq = 128
    model = flagship.build_model("cpu", scheme="clm", num_items=V, d_model=D, n_layer=L,
                                 n_head=H, seq=seq, dropout=0.0, seed=5)
    example = synthetic_data(flagship.schema(V, seq), num_rows=2, max_session_length=seq, seed=1)
    path = export_model(model, example, str(tmp_path / "clm"), top_k=TOP_K)
    program = torch.export.load(os.path.join(path, PROGRAM_FILE))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("t4r.flash_fwd.default") == L
    batch = synthetic_data(flagship.schema(V, seq), num_rows=3, max_session_length=seq, seed=2)
    got_s, got_i = InferenceRunner(path, device="cpu").predict(batch)
    with torch.inference_mode():
        want_s, want_i = model({k: torch.as_tensor(v) for k, v in batch.items()}, top_k=TOP_K)
    np.testing.assert_array_equal(got_i, want_i.numpy())
    np.testing.assert_array_equal(got_s, want_s.numpy())


def test_the_server_serves_the_program_without_a_builder(artifacts):
    arts, _ = artifacts
    runner = InferenceRunner(arts["f32"], device="cpu")
    server = ServingServer(arts["f32"], port=0, max_batch_size=16, max_delay_ms=20.0,
                           device="cpu").start()
    try:
        for seed, rows in ((3, 1), (4, 3)):
            raw = _raw_sessions(seed, rows)
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/v2/predict",
                data=json.dumps({"inputs": raw}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                ans = json.loads(r.read())
            want_s, want_i = runner.predict(raw)
            np.testing.assert_array_equal(np.asarray(ans["item_ids"]), want_i)
            np.testing.assert_allclose(np.asarray(ans["item_id_scores"]), want_s, rtol=1e-6)
    finally:
        server.stop()


def test_the_runners_refuse_what_they_cannot_serve(artifacts, tmp_path):
    arts, _ = artifacts
    with pytest.raises(ValueError, match="bundle_params=True"):
        ShardedInferenceRunner(arts["f32"], build_mlm, model_axis=2, device="cpu")
    # a program traced for the card is refused on the CPU, never re-traced
    cuda_art = str(tmp_path / "cuda")
    shutil.copytree(arts["f32"], cuda_art)
    meta_path = os.path.join(cuda_art, "metadata.json")
    meta = json.load(open(meta_path))
    meta["device_type"] = "cuda"
    json.dump(meta, open(meta_path, "w"))
    with pytest.raises(ValueError, match="traced for 'cuda'"):
        InferenceRunner(cuda_art, device="cpu")
    # with a builder the weights load into the rebuilt model instead
    raw = _raw_sessions(5, 3)
    got = InferenceRunner(cuda_art, build_mlm, device="cpu").predict(raw)
    want = InferenceRunner(arts["f32"], device="cpu").predict(raw)
    np.testing.assert_array_equal(got[1], want[1])


def test_a_split_or_grouped_table_exports_as_its_single_device_model(tmp_path):
    """A model whose item table is split in this process, or row-sharded
    over a (one-rank) process group, exports the one-device model: the
    program holds the whole table, takes no collective, and answers as the
    unsplit model does."""
    import torch.distributed as dist

    items = 16_384  # 16,392 rows: enough for the sharding rule's two shards
    example = synthetic_data(flagship.schema(items, S), num_rows=3, max_session_length=S,
                             seed=6)
    batch = {k: torch.as_tensor(v) for k, v in example.items()}
    plain = flagship.build_model("cpu", seed=8, dropout=0.0, num_items=items, d_model=16,
                                 n_layer=1, n_head=H, seq=S)
    with torch.inference_mode():
        want_s, want_i = plain(batch, top_k=TOP_K)
    split = flagship.build_model("cpu", seed=8, dropout=0.0, num_items=items, d_model=16,
                                 n_layer=1, n_head=H, seq=S)
    split.heads[0].input_module.categorical_module.split_table("item_id", ["cpu", "cpu"])
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        grouped = flagship.build_model("cpu", seed=8, dropout=0.0, num_items=items,
                                       d_model=16, n_layer=1, n_head=H, seq=S,
                                       vocab_parallel_group=dist.group.WORLD)
        for name, model in (("split", split), ("grouped", grouped)):
            path = export_model(model, example, str(tmp_path / name), top_k=TOP_K)
            program = torch.export.load(os.path.join(path, PROGRAM_FILE))
            table = [v for k, v in program.state_dict.items() if k.endswith("tables.item_id")]
            assert [tuple(t.shape) for t in table] == [(items + 8, 64)], name
            assert not any("c10d" in str(n.target) for n in program.graph.nodes), name
            got_s, got_i = InferenceRunner(path, device="cpu").predict(example)
            np.testing.assert_array_equal(got_i, want_i.numpy())
            np.testing.assert_allclose(got_s, want_s.numpy(), rtol=1e-6, atol=1e-6)
        # the models given to the export keep their layout
        assert grouped.heads[0].tasks[0].vocab_parallel_group is dist.group.WORLD
        assert "item_id" in split.heads[0].input_module.categorical_module.table_shards
    finally:
        dist.destroy_process_group()


def test_the_server_cli_needs_a_builder_for_a_model_axis(artifacts, capsys):
    from transformers4rec_tpu_torch.serving.server import main

    arts, _ = artifacts
    with pytest.raises(SystemExit):
        main(["--artifact", arts["f32"], "--model-axis", "2", "--device", "cpu"])
    assert "--model-axis needs --model-builder" in capsys.readouterr().err
