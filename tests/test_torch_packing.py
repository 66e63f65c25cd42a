"""Session packing in the port against the JAX package on the CPU.

- ``pack_sessions`` and ``packing_stats`` give the JAX functions' output bit
  for bit (ragged and dense inputs, a row count cut and padded, the dropped
  short sessions), and the first fit is exact against a scan of the rows;
- the Parquet, streaming and synthetic loaders with ``pack=True`` yield the
  JAX loaders' batches exactly, with the same ``len``; the streaming loader
  refuses more than one process, as the JAX one does;
- masking: the deterministic branches (CLM's labels, every scheme's
  evaluation on the last item and on every position) equal the JAX
  package's on packed rows bit for bit; the port's own draws keep the
  per-segment invariants (≥1 masked and ≥1 unmasked position in every
  segment under MLM, RTD and PLM; PLM's spans only lose positions to the
  segment clip; no CLM label across a boundary);
- one training step of small packed models with the JAX draw's mask
  (CLM under GPT-2 and TransfoXL, MLM, PLM and RTD under XLNet): the loss
  within 1e-5 relative, every gradient within 1e-4 in relative Frobenius
  norm (the CE's residual is rounded to bf16 in both);
- packed evaluation (the JAX ``test_packed_eval_matches_unpacked`` cases and
  GPT-2's restarted positions) equals unpacked evaluation of the same
  sessions (loss 2e-5 relative, metric sums 2e-5, counts exact) and the JAX
  package's packed evaluation (loss 1e-5, metrics 1e-6); the worst case of
  sessions of two, where the B·(S//2) rows are all targets, drops none;
- GPT-2's packed encoder on the flash path (S = 128: a (B, 1, S, S)
  block-diagonal bias) against the JAX encoder's kernels in interpret mode
  (fixture ``jax_flash``), at the flash tolerances of ``test_torch_archs.py``;
- the ``Trainer``'s flags: packed training batches, packed evaluation equal
  to unpacked, the evaluation loader rebuilt when the flag flips, unpacked
  prediction; a packed batch at inference raises.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import transformers4rec_tpu as jtr
from transformers4rec_tpu.data import loader as jloader
from transformers4rec_tpu.data import packing as jpacking
from transformers4rec_tpu.data.synthetic import synthetic_ecommerce_data_schema as jax_schema_fn
from transformers4rec_tpu.masking import masking_registry as jax_masking_registry

from test_torch_clm import jax_flash  # noqa: F401  (a fixture)
from transformers4rec_tpu_torch import (
    NextItemPredictionTask,
    T4RecTrainingArguments,
    TabularSequenceFeatures,
    Trainer,
    convert,
    flagship,
    transformer_registry,
)
from transformers4rec_tpu_torch.blocks.transformer import TransformerEncoder
from transformers4rec_tpu_torch.data import loader as tloader
from transformers4rec_tpu_torch.data import pack_sessions, packing_stats, synthetic_data
from transformers4rec_tpu_torch.data.padding import pad_ragged
from transformers4rec_tpu_torch.masking import masking_registry

torch.set_num_threads(1)

V, S, D, H, L = 300, 12, 32, 2, 2
FEATURES = ("item_id", "category", "item_recency", "weekday_sin")
# a key bias shifts every logit of a query alike and the softmax ignores it:
# its gradient is rounding noise around zero in both packages
ZERO_GRADIENT = "attn.k.bias"


def _rel_fro(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _ragged(rows, seed, seq=S):
    return synthetic_data(flagship.schema(V, seq), num_rows=rows, max_session_length=seq,
                          ragged=True, seed=seed)


def _unpacked(data, seq=S, min_len=2):
    """One session a row, the sessions ``pack_sessions`` keeps."""
    off = data["item_id__offsets"]
    keep = [i for i in range(len(off) - 1) if off[i + 1] - off[i] >= min_len]
    return {name: pad_ragged(data[f"{name}__values"], data[f"{name}__offsets"], seq)[keep]
            for name in FEATURES}


def _same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


# ----------------------------------------------------------------- packing
@pytest.mark.parametrize("form", ["ragged", "dense", "cut", "padded", "min_len_4"])
def test_pack_sessions_and_stats_equal_jax(form):
    data = _ragged(57, 1)
    kw = {}
    if form == "dense":
        data = {name: pad_ragged(data[f"{name}__values"], data[f"{name}__offsets"], S)
                for name in FEATURES}
    elif form == "cut":
        kw["num_rows"] = 5
    elif form == "padded":
        kw["num_rows"] = 60
    elif form == "min_len_4":
        kw["min_session_len"] = 4
    got = pack_sessions(data, max_len=S, item_id_col="item_id", **kw)
    want = jpacking.pack_sessions(data, max_len=S, item_id_col="item_id", **kw)
    _same(got, want)
    assert packing_stats(got, "item_id") == jpacking.packing_stats(want, "item_id")
    with pytest.raises(ValueError, match="scalar per-session"):
        pack_sessions({**data, "user": np.arange(57)}, max_len=S, item_id_col="item_id")


def test_first_fit_is_exact():
    """Every session in the lowest-index row with room for it, the longest
    first: the JAX test's scan of the rows."""
    rng = np.random.RandomState(0)
    for _ in range(5):
        n, ml = rng.randint(2, 300), rng.randint(3, 25)
        lens = rng.randint(2, ml + 1, n)
        off = np.concatenate([[0], np.cumsum(lens)])
        packed = pack_sessions({"item_id__values": np.arange(off[-1]) % 97 + 1,
                                "item_id__offsets": off}, max_len=ml, item_id_col="item_id")
        rows, space = [], []
        for idx in np.argsort(-lens, kind="stable"):
            r = next((r for r in range(len(rows)) if space[r] >= lens[idx]), None)
            if r is None:
                rows.append([]), space.append(ml)
                r = len(rows) - 1
            rows[r].append(idx)
            space[r] -= lens[idx]
        np.testing.assert_array_equal((packed["item_id"] != 0).sum(1), [ml - s for s in space])
        np.testing.assert_array_equal(packed["segment_ids"].max(1), [len(r) for r in rows])


# ----------------------------------------------------------------- loaders
@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two Parquet files of ragged sessions, row groups of 23 and 17."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    d = tmp_path_factory.mktemp("packed")
    data = _ragged(110, 3)
    table = pa.table({name: pa.ListArray.from_arrays(
        pa.array(data[f"{name}__offsets"], pa.int32()), pa.array(data[f"{name}__values"]))
        for name in FEATURES})
    paths = [str(d / "a.parquet"), str(d / "b.parquet")]
    pq.write_table(table.slice(0, 60), paths[0], row_group_size=23)
    pq.write_table(table.slice(60), paths[1], row_group_size=17)
    return paths


@pytest.mark.parametrize("cls_name,kw", [
    ("ParquetDataLoader", {}),
    ("ParquetDataLoader", {"shuffle": False, "drop_last": False}),
    ("StreamingParquetDataLoader", {"buffer_rows": 40}),
    ("StreamingParquetDataLoader", {"buffer_rows": 40, "drop_last": False, "shuffle": False}),
])
def test_packed_loaders_yield_the_jax_batches(files, cls_name, kw):
    jschema = jax_schema_fn(V, flagship.NUM_CATEGORIES, S)
    got_len, want_len, got, want = [], [], [], []
    for mod, schema, lens, out in ((jloader, jschema, want_len, want),
                                   (tloader, flagship.schema(V, S), got_len, got)):
        loader = getattr(mod, cls_name).from_schema(schema, files, batch_size=8,
                                                    max_sequence_length=S, pack=True,
                                                    prefetch=0, **kw)
        lens.append(len(loader))  # the streaming loader's estimate
        for _ in range(2):
            out += list(loader)
            lens.append(len(loader))  # exact once an epoch has run
    assert got_len == want_len
    assert len(got) == len(want) and len(got) > 2
    for g, w in zip(got, want):
        _same(g, w)
    assert max(int(b["segment_ids"].max()) for b in got) > 1


def test_synthetic_loader_packs_and_streaming_refuses_processes(files):
    jschema = jax_schema_fn(V, flagship.NUM_CATEGORIES, S)
    want = list(jloader.SyntheticDataLoader.from_schema(jschema, batch_size=8,
                                                        max_sequence_length=S, pack=True,
                                                        prefetch=0))
    got = list(tloader.SyntheticDataLoader.from_schema(flagship.schema(V, S), batch_size=8,
                                                       max_sequence_length=S, pack=True,
                                                       prefetch=0))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)
    with pytest.raises(ValueError, match="does not support multi-process"):
        tloader.StreamingParquetDataLoader.from_schema(flagship.schema(V, S), files,
                                                       batch_size=8, pack=True, global_size=2)


# ----------------------------------------------------------------- masking
def _packed_ids(seed, rows=12):
    return pack_sessions(_ragged(rows * 3, seed), max_len=S, item_id_col="item_id")


@pytest.mark.parametrize("scheme,kw", [
    ("clm", {"training": True}), ("clm", {"testing": True}),
    ("clm", {"testing": True, "last": False}), ("mlm", {"testing": True}),
    ("mlm", {"testing": True, "last": False}), ("plm", {"testing": True}),
    ("plm", {"testing": True, "last": False}),
])
def test_packed_deterministic_masking_equals_jax(scheme, kw):
    kw = dict(kw)
    last = kw.pop("last", True)
    b = _packed_ids(5)
    ids, seg = b["item_id"], b["segment_ids"]
    jm = jax_masking_registry.parse(scheme)(hidden_size=4, eval_on_last_item_seq_only=last)
    want = jm.compute_masked_targets(jax.random.PRNGKey(0), jnp.asarray(ids),
                                     segment_ids=jnp.asarray(seg), **kw)
    tm = masking_registry.parse(scheme)(hidden_size=4, eval_on_last_item_seq_only=last)
    got = tm.compute_masked_targets(torch.from_numpy(ids), segment_ids=torch.from_numpy(seg),
                                    **kw)
    for f in ("targets", "mask", "input_schema", "pad_mask", "perm_mask"):
        w = getattr(want, f)
        if w is None:
            assert getattr(got, f) is None, f
            continue
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(w), err_msg=f)
    assert got.targets_per_segment_bounded == want.targets_per_segment_bounded


@pytest.mark.parametrize("scheme", ["mlm", "rtd", "plm"])
def test_per_segment_masking_invariants(scheme):
    b = _packed_ids(7, rows=16)
    ids, seg = torch.from_numpy(b["item_id"]), torch.from_numpy(b["segment_ids"])
    kw = {"mlm_probability": 0.15} if scheme != "plm" else {"plm_probability": 0.5,
                                                           "max_span_length": 3}
    tm = masking_registry.parse(scheme)(hidden_size=4, **kw)
    for trial in range(4):
        info = tm.compute_masked_targets(ids, training=True, segment_ids=seg,
                                         generator=torch.Generator().manual_seed(trial))
        m = info.mask
        assert not (m & (ids == 0)).any()
        for r in range(seg.shape[0]):
            for s in seg[r].unique().tolist():
                if s == 0:
                    continue
                pos = seg[r] == s
                assert 1 <= int(m[r][pos].sum()) < int(pos.sum()), (trial, r, s)
        if scheme == "plm":
            # the clip only removes positions from the draw without segments
            clipped = tm._sample_spans(ids != 0, torch.Generator().manual_seed(trial), seg)
            free = tm._sample_spans(ids != 0, torch.Generator().manual_seed(trial))
            assert (clipped <= free).all()
            starts = torch.nonzero(clipped[:, 1:] & ~clipped[:, :-1])
            assert clipped.any() and len(starts)
    clm = masking_registry.parse("clm")(hidden_size=4).compute_masked_targets(
        ids, training=True, segment_ids=seg)
    for r, i in torch.nonzero(clm.mask).tolist():
        assert i + 1 < S and seg[r, i + 1] == seg[r, i] != 0


def test_packed_inference_raises_and_last_item_training_is_refused():
    b = _packed_ids(9)
    ids, seg = torch.from_numpy(b["item_id"]), torch.from_numpy(b["segment_ids"])
    for scheme in ("clm", "mlm", "plm"):
        tm = masking_registry.parse(scheme)(hidden_size=4)
        with pytest.raises(NotImplementedError, match="unpacked"):
            tm(torch.zeros(*ids.shape, 4), ids, segment_ids=seg)
    clm = masking_registry.parse("clm")(hidden_size=4, train_on_last_item_seq_only=True)
    with pytest.raises(NotImplementedError, match="train_on_last_item_seq_only"):
        clm.compute_masked_targets(ids, training=True, segment_ids=seg)


# ------------------------------------------------------------------ models
def _model_pair(arch, scheme, masking_kwargs=None, seq=S, tasks_kw=None):
    masking_kwargs = masking_kwargs or {}
    tasks_kw = tasks_kw or {}
    schema = jax_schema_fn(num_items=V, num_categories=flagship.NUM_CATEGORIES,
                           max_session_length=seq)
    jim = jtr.TabularSequenceFeatures.from_schema(
        schema, d_output=D, masking=scheme, aggregation="concat", masking_kwargs=masking_kwargs)
    jmodel = jtr.transformer_registry.parse(arch).build(
        d_model=D, n_head=H, n_layer=L, total_seq_length=seq, dropout=0.0).to_model(
        jim, jtr.NextItemPredictionTask(weight_tying=True, **tasks_kw))
    init = {k: jnp.asarray(v) for k, v in _unpacked(_ragged(4, 0, seq), seq).items()}
    rngs = {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    params = jax.jit(lambda b: jmodel.init(rngs, b, training=True))(init)
    params = jax.tree.map(np.asarray, params)
    tim = TabularSequenceFeatures.from_schema(
        flagship.schema(V, seq), d_output=D, masking=scheme, aggregation="concat",
        masking_kwargs=masking_kwargs)
    tmodel = transformer_registry.parse(arch).build(
        d_model=D, n_head=H, n_layer=L, total_seq_length=seq, dropout=0.0).to_model(
        tim, NextItemPredictionTask(weight_tying=True, **tasks_kw), device="cpu")
    tmodel.load_state_dict(convert.params_from_jax(params))  # strict
    return jmodel, params, tmodel


@pytest.mark.parametrize("arch,scheme", [("gpt2", "clm"), ("transfoxl", "clm"),
                                         ("xlnet", "mlm"), ("xlnet", "plm"),
                                         ("electra", "rtd")])
def test_a_packed_training_step_matches_jax(arch, scheme, monkeypatch):
    kwargs = {"mlm": {"mlm_probability": 0.3}, "rtd": {"mlm_probability": 0.3},
              "plm": {"plm_probability": 0.5, "max_span_length": 3}}.get(scheme, {})
    jmodel, params, tmodel = _model_pair(arch, scheme, kwargs)
    batch = _packed_ids(11, rows=10)
    assert int(batch["segment_ids"].max()) > 1
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jcls = jax_masking_registry.parse(scheme)
    # the JAX draw on the packed rows, given to both
    info = jcls.compute_masked_targets(jcls(hidden_size=D, **kwargs), jax.random.PRNGKey(3),
                                       jnp.asarray(batch["item_id"]), training=True,
                                       segment_ids=jnp.asarray(batch["segment_ids"]))
    original = jcls.compute_masked_targets

    def jax_masks(self, rng, item_ids, training=False, testing=False, segment_ids=None):
        if not training:
            return original(self, rng, item_ids, training, testing, segment_ids)
        return info

    monkeypatch.setattr(jcls, "compute_masked_targets", jax_masks)
    tinfo = convert.masking_info_from_jax(
        np.asarray(info.targets), np.asarray(info.mask), np.asarray(info.pad_mask),
        input_schema=np.asarray(info.input_schema),
        perm_mask=None if info.perm_mask is None else np.asarray(info.perm_mask))
    rngs = {"masking": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    want_loss, want_grads = jax.jit(jax.value_and_grad(lambda p: jmodel.apply(
        p, jb, targets=jb, training=True, compute_metrics=False, rngs=rngs)[0]))(params)
    want = convert.params_from_jax(jax.tree.map(np.asarray, want_grads))
    tb = tmodel._as_dense(batch)
    loss, _ = tmodel(tb, targets=tb, training=True, masking_info=tinfo)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    got = dict(tmodel.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        if not name.endswith(ZERO_GRADIENT):
            assert _rel_fro(p.grad.numpy(), want[name].numpy()) <= 1e-4, name


def _eval_case(data, arch, scheme, unpacked):
    jmodel, params, tmodel = _model_pair(arch, scheme)
    packed = pack_sessions(data, max_len=S, item_id_col="item_id")
    half = len(packed["item_id"]) // 2
    packed_loader = [{k: v[:half] for k, v in packed.items()},
                     {k: v[half:] for k, v in packed.items()}]
    got_packed = tmodel.evaluate(packed_loader)
    got_unpacked = tmodel.evaluate([unpacked])
    want_packed = jmodel.evaluate(packed_loader, params)
    assert got_packed.keys() == got_unpacked.keys() == want_packed.keys()
    np.testing.assert_allclose(got_packed["eval_loss"], got_unpacked["eval_loss"], rtol=2e-5)
    np.testing.assert_allclose(got_packed["eval_loss"], want_packed["eval_loss"], rtol=1e-5)
    for k in want_packed:
        if k != "eval_loss":
            np.testing.assert_allclose(got_packed[k], got_unpacked[k], rtol=2e-5, atol=1e-7,
                                       err_msg=k)
            np.testing.assert_allclose(got_packed[k], want_packed[k], atol=1e-6, err_msg=k)
    return tmodel, packed, unpacked


@pytest.mark.parametrize("scheme,arch", [("clm", "transfoxl"), ("mlm", "xlnet"),
                                         ("plm", "xlnet"), ("clm", "gpt2")])
def test_packed_eval_matches_unpacked_and_jax(scheme, arch):
    data = _ragged(24, 5)
    tmodel, packed, unpacked = _eval_case(data, arch, scheme, _unpacked(data))
    # one target a segment, so every target is within the B·(S//2) rows
    b = tmodel._as_dense(packed)
    _, outs = tmodel(b, targets=b, testing=True)
    counts = {k: float(v[1]) for k, v in outs["next-item"].metrics.items()}
    assert set(counts.values()) == {float(len(unpacked["item_id"]))}


@pytest.mark.parametrize("scheme", ["clm", "mlm"])
def test_packed_eval_budget_worst_case(scheme):
    """Sessions of two: every packed row holds S // 2 segments, so the
    B·(S//2) rows the packed evaluation ranks are all targets."""
    rng = np.random.default_rng(9)
    n = S // 2 * 6
    off = np.arange(n + 1) * 2
    data = {f"{name}__offsets": off for name in FEATURES}
    data.update({"item_id__values": rng.integers(1, V, 2 * n),
                 "category__values": rng.integers(1, 10, 2 * n),
                 "item_recency__values": rng.random(2 * n).astype(np.float32),
                 "weekday_sin__values": rng.random(2 * n).astype(np.float32)})
    assert int(pack_sessions(data, S, "item_id")["segment_ids"].max()) == S // 2
    _eval_case(data, "transfoxl" if scheme == "clm" else "xlnet", scheme, _unpacked(data))


def test_packed_gpt2_encoder_on_the_flash_path_matches_jax(jax_flash):  # noqa: F811
    """S = 128: the port's flash path with the (B, 1, S, S) block-diagonal
    bias and restarted positions against the JAX kernels in interpret mode."""
    seq = 128
    rng = np.random.default_rng(4)
    lens = rng.integers(2, 21, 40)
    off = np.concatenate([[0], np.cumsum(lens)])
    packed = pack_sessions({"item_id__values": rng.integers(1, V, off[-1]),
                            "item_id__offsets": off}, max_len=seq, item_id_col="item_id",
                           num_rows=2)
    seg = packed["segment_ids"]
    pad = seg > 0
    x = rng.normal(size=(2, seq, D)).astype(np.float32)
    kw = dict(d_model=D, n_head=H, n_layer=L, total_seq_length=seq, dropout=0.0)
    jenc = jtr.transformer_registry.parse("gpt2").build(**kw).to_encoder()
    params = jax.tree.map(np.asarray, jenc.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                jnp.asarray(pad)))
    tenc = transformer_registry.parse("gpt2").build(**kw).to_encoder()
    assert isinstance(tenc, TransformerEncoder)
    tenc.load_state_dict(convert.params_from_jax(params))
    w = rng.normal(size=x.shape).astype(np.float32)

    def loss(p, xx):
        out = jenc.apply(p, xx, jnp.asarray(pad), segment_ids=jnp.asarray(seg))
        return (out * w * pad[..., None]).sum(), out

    (_, want_out), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    assert jax_flash  # the JAX side took its kernels
    xt = torch.from_numpy(x).requires_grad_()
    out = tenc(xt, pad_mask=torch.from_numpy(pad), segment_ids=torch.from_numpy(seg))
    (out * torch.from_numpy(w) * torch.from_numpy(pad)[..., None]).sum().backward()
    real = pad[..., None] & np.ones(D, bool)
    got_out, want_out = out.detach().numpy()[real], np.asarray(want_out)[real]
    assert _rel_fro(got_out, want_out) <= 1e-3
    np.testing.assert_allclose(got_out, want_out, atol=1e-2)
    want = convert.params_from_jax(jax.tree.map(np.asarray, gp))
    for name, p in tenc.named_parameters():
        if not name.endswith(ZERO_GRADIENT):
            assert _rel_fro(p.grad.numpy(), want[name].numpy()) <= 5e-3, name
    assert _rel_fro(xt.grad.numpy(), np.asarray(gx)) <= 5e-3


# ----------------------------------------------------------------- trainer
def test_trainer_pack_flags(tmp_path):
    """Packed training batches; evaluation of sessions of S // 2 (two to a
    row) packed equals unpacked; the evaluation loader follows the flag;
    prediction stays one row per session."""
    rng = np.random.default_rng(3)
    n = 32
    df = pd.DataFrame({
        "item_id": [rng.integers(1, V, S // 2) for _ in range(n)],
        "category": [rng.integers(1, 10, S // 2) for _ in range(n)],
        "item_recency": [rng.random(S // 2).astype(np.float32) for _ in range(n)],
        "weekday_sin": [rng.random(S // 2).astype(np.float32) for _ in range(n)]})
    df.to_parquet(tmp_path / "sessions.parquet")
    _, _, model = _model_pair("transfoxl", "clm")
    args = T4RecTrainingArguments(output_dir=str(tmp_path / "out"), max_sequence_length=S,
                                  per_device_train_batch_size=8, per_device_eval_batch_size=8,
                                  max_steps=2, pack_sessions=True, steps_per_execution=1)
    trainer = Trainer(model, args, schema=flagship.schema(V, S),
                      train_dataset=str(tmp_path / "sessions.parquet"),
                      eval_dataset=str(tmp_path / "sessions.parquet"), device="cpu")
    first = next(iter(trainer.get_train_dataloader()))
    assert first["segment_ids"].shape == (8, S) and int(first["segment_ids"].max()) == 2
    unpacked = trainer.evaluate()
    assert "segment_ids" not in next(iter(trainer.get_eval_dataloader()))
    trainer.args.pack_eval_sessions = True
    loader = trainer.get_eval_dataloader()
    assert len(loader) == 2 and int(next(iter(loader))["segment_ids"].max()) == 2
    packed = trainer.evaluate()
    for k in unpacked:
        if k.startswith("eval_/") or k == "eval_loss":
            np.testing.assert_allclose(packed[k], unpacked[k], rtol=2e-5, err_msg=k)
    scores, ids = trainer.predict(str(tmp_path / "sessions.parquet"), top_k=5)
    assert ids.shape == (n, 5)
    trainer.train()
    assert trainer.state.global_step == 2
    with pytest.raises(NotImplementedError, match="unpacked"):
        model(model._as_dense(first))
