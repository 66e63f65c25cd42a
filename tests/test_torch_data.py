"""The port's host data path against the JAX package on the CPU.

Both packages read the same Parquet files (written once from a seed): the
port's ``ParquetDataLoader`` and ``StreamingParquetDataLoader`` must yield
the JAX loaders' batches exactly (same keys, dtypes and values) under every
shuffling, tail, buffer, striping and resume setting; the bundled testing
datasets and the ETL (``categorify``, ``session_aggregator``,
``save_time_based_splits`` and the whole ``etl_interactions_to_time_splits``)
must give equal tables. The prefetch thread must stop when its iterator is
abandoned, and raise its producer's error in the consumer.
"""

import os
import threading
import time

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import transformers4rec_tpu.data as jdata
from transformers4rec_tpu.data import loader as jloader
from transformers4rec_tpu.data import testing as jtesting
from transformers4rec_tpu.data.synthetic import synthetic_ecommerce_data_schema as jax_schema_fn
from transformers4rec_tpu.utils import data_utils as jetl

import transformers4rec_tpu_torch.data as tdata
from transformers4rec_tpu_torch import flagship
from transformers4rec_tpu_torch.data import loader as tloader
from transformers4rec_tpu_torch.data import testing as ttesting
from transformers4rec_tpu_torch.utils import data_utils as tetl

V, S, ROWS = 50, 8, 230  # 230 sessions: no batch size below divides them


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two Parquet files of ragged sessions (row groups of 37 and 29 rows)
    and the same rows as one table."""
    d = tmp_path_factory.mktemp("sessions")
    data = jdata.synthetic_data(jax_schema_fn(V, flagship.NUM_CATEGORIES, S), num_rows=ROWS,
                                max_session_length=S, ragged=True, seed=3)
    cols = {}
    for name in ("item_id", "category", "item_recency", "weekday_sin"):
        vals, off = data[f"{name}__values"], data[f"{name}__offsets"]
        cols[name] = pa.ListArray.from_arrays(pa.array(off, pa.int32()), pa.array(vals))
    table = pa.table(cols)
    paths = [str(d / "a.parquet"), str(d / "b.parquet")]
    pq.write_table(table.slice(0, 140), paths[0], row_group_size=37)
    pq.write_table(table.slice(140), paths[1], row_group_size=29)
    return paths, table


def _schemas():
    return jax_schema_fn(V, flagship.NUM_CATEGORIES, S), flagship.schema(V, S)


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _both(cls_name, files, epochs=2, state=None, **kw):
    """Batches of ``epochs`` epochs from the JAX and the port loader."""
    jschema, tschema = _schemas()
    out = []
    for mod, schema in ((jloader, jschema), (tloader, tschema)):
        loader = getattr(mod, cls_name).from_schema(schema, files, batch_size=16,
                                                    max_sequence_length=6, **kw)
        batches = []
        for e in range(epochs):
            if state is not None and e == 0:
                loader.set_state(*state)
            batches += list(loader)
        out.append((loader, batches))
    (jl, want), (tl, got) = out
    assert len(tl) == len(jl) and tl.num_rows == jl.num_rows
    return got, want


@pytest.mark.parametrize("shuffle,drop_last,rank,size,state", [
    (True, True, 0, 1, None),
    (False, False, 0, 1, None),
    (True, False, 1, 3, None),
    (True, False, 0, 1, (1, 5)),
    (False, True, 2, 3, (0, 2)),
])
def test_parquet_loader_batches_equal_jax(files, shuffle, drop_last, rank, size, state):
    got, want = _both("ParquetDataLoader", files[0], shuffle=shuffle, drop_last=drop_last,
                      global_rank=rank, global_size=size, seed=7, state=state, prefetch=0)
    _assert_same_batches(got, want)


@pytest.mark.parametrize("shuffle,drop_last,buffer_rows,rank,size,state", [
    (True, True, 50, 0, 1, None),
    (False, False, 16, 0, 1, None),
    (True, False, 100, 1, 2, None),  # 7 row groups striped over 2 processes
    (True, False, 40, 3, 8, None),  # fewer groups than processes: rows stripe
    (True, True, 64, 0, 1, (1, 3)),
    (True, False, 30, 0, 1, (0, 9)),
])
def test_streaming_loader_batches_equal_jax(files, shuffle, drop_last, buffer_rows, rank,
                                            size, state):
    got, want = _both("StreamingParquetDataLoader", files[0], shuffle=shuffle,
                      drop_last=drop_last, buffer_rows=buffer_rows, global_rank=rank,
                      global_size=size, seed=11, state=state, prefetch=0)
    _assert_same_batches(got, want)


def test_prefetched_batches_equal_the_unprefetched(files):
    paths = files[0]
    for cls_name in ("ParquetDataLoader", "StreamingParquetDataLoader"):
        _, tschema = _schemas()
        make = getattr(tloader, cls_name).from_schema
        ahead = list(make(tschema, paths, batch_size=16, prefetch=2, drop_last=False))
        _assert_same_batches(ahead, list(make(tschema, paths, batch_size=16, prefetch=0,
                                              drop_last=False)))


@pytest.mark.parametrize("start,length", [(0, 230), (17, 101), (200, 30)])
def test_sliced_tables_decode_as_in_jax(files, start, length):
    """A slice of a record batch keeps a nonzero first offset in its list
    arrays; both packages rebase it."""
    table = files[1].combine_chunks().to_batches()[0].slice(start, length)
    if start:
        assert table.column("item_id").offsets[0].as_py() != 0
    jschema, tschema = _schemas()
    want = jloader._table_to_columns(table, jschema, 6)
    got = tloader._table_to_columns(table, tschema, 6)
    _assert_same_batches([got], [want])
    assert all(v.flags.writeable for v in got.values())


def test_a_directory_and_a_parquet_dataset_resolve_as_in_jax(files, tmp_path):
    directory = os.path.dirname(files[0][0])
    assert tloader._resolve_paths(directory) == jloader._resolve_paths(directory)
    jschema, tschema = _schemas()
    tschema.to_json_file(str(tmp_path / "schema.json"))
    ds = tdata.ParquetDataset(parquet_path=files[0][0], schema_path=tmp_path / "schema.json")
    assert tloader._resolve_paths(ds) == [files[0][0]]
    assert ds.schema == tschema and len(ds.to_pandas()) == 140


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == tloader.PREFETCH_THREAD_NAME]


def _wait_for_no_prefetch_thread():
    deadline = time.monotonic() + 10.0
    while _prefetch_threads() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert _prefetch_threads() == []


@pytest.mark.parametrize("cls_name", ["ParquetDataLoader", "StreamingParquetDataLoader"])
def test_an_abandoned_iterator_stops_its_prefetch_thread(files, cls_name):
    _wait_for_no_prefetch_thread()
    _, tschema = _schemas()
    loader = getattr(tloader, cls_name).from_schema(tschema, files[0], batch_size=8,
                                                    prefetch=1)
    it = iter(loader)
    next(it)
    assert len(_prefetch_threads()) == 1  # blocked on the full queue
    it.close()
    _wait_for_no_prefetch_thread()
    # a for loop left by break does the same
    for _ in loader:
        break
    _wait_for_no_prefetch_thread()


def test_a_producer_error_reaches_the_consumer():
    def failing():
        yield {"x": np.zeros(2)}
        raise OSError("disk gone")

    it = tloader._prefetched(failing, 2)
    assert next(it)["x"].shape == (2,)
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    _wait_for_no_prefetch_thread()


def test_packing_is_refused(files):
    """Packing is ported (tests/test_torch_packing.py); the streaming loader
    refuses it over more than one process, as the JAX one does."""
    jschema, tschema = _schemas()
    for mod, schema in ((jloader, jschema), (tloader, tschema)):
        with pytest.raises(ValueError, match="pack=True"):
            mod.StreamingParquetDataLoader.from_schema(schema, files[0], batch_size=8, pack=True,
                                                       global_rank=1, global_size=2)


def test_registry_and_exports_match_jax():
    for name in ("parquet", "merlin", "parquet_streaming", "synthetic"):
        assert tdata.dataloader_registry.parse(name).__name__ == \
            jdata.dataloader_registry.parse(name).__name__
    assert set(jdata.__all__) <= set(tdata.__all__)
    assert tdata.InMemoryDataLoader is tdata.ParquetDataLoader


@pytest.mark.parametrize("name", ["tabular_sequence_testing_data", "tabular_testing_data",
                                  "music_streaming_testing_data"])
def test_testing_datasets_equal_jax(name, tmp_path, monkeypatch):
    monkeypatch.setattr(jtesting, "_CACHE", tmp_path / "jax")
    monkeypatch.setattr(ttesting, "_CACHE", tmp_path / "torch")
    want, got = getattr(jtesting, name), getattr(ttesting, name)
    want = jtesting.TestingDataset(want._name, want.schema, num_rows=60, seed=5)
    got = ttesting.TestingDataset(got._name, got.schema, num_rows=60, seed=5)
    pd.testing.assert_frame_equal(pd.read_parquet(got.path), pd.read_parquet(want.path))
    with open(got.schema_path) as g, open(want.schema_path) as w:
        assert g.read() == w.read()


def test_padding_and_interaction_helpers_equal_jax():
    dense = np.arange(24).reshape(4, 6)
    lengths = np.array([6, 0, 3, 9])
    for g, w in zip(tdata.dense_to_ragged(dense, lengths), jdata.dense_to_ragged(dense, lengths)):
        np.testing.assert_array_equal(g, w)
    jschema, tschema = _schemas()
    want = jdata.generate_item_interactions(400, jschema, seed=2)
    got = tdata.generate_item_interactions(400, tschema, seed=2)
    pd.testing.assert_frame_equal(got, want)
    pd.testing.assert_frame_equal(tdata.interactions_to_sessions(got, tschema, 5),
                                  jdata.interactions_to_sessions(want, jschema, 5))


# ----------------------------------------------------------------------- ETL
@pytest.fixture(scope="module")
def raw():
    """Interactions with raw string categories, nulls, consecutive repeats
    and three days."""
    rng = np.random.default_rng(0)
    n = 900
    items = rng.choice(["a", "b", "c", "d", "e", "f", "g", None], n,
                       p=[.3, .2, .15, .1, .1, .08, .05, .02])
    return pd.DataFrame({
        "session_id": rng.integers(1, 120, n),
        "item_id": items,
        "category": rng.choice(["x", "y", "z"], n),
        "item_recency": rng.random(n).astype(np.float32),
        "weekday_sin": rng.random(n),
        "timestamp": rng.integers(0, 3 * 86_400, n),
        "day": 0,
    }).assign(day=lambda f: f["timestamp"] // 86_400 + 1)


@pytest.mark.parametrize("kw", [{}, {"freq_threshold": 60}, {"max_size": 3, "start_index": 5}])
def test_categorify_equals_jax(raw, kw):
    want, wmap = jetl.categorify(raw, ["item_id", "category"], **kw)
    got, gmap = tetl.categorify(raw, ["item_id", "category"], **kw)
    pd.testing.assert_frame_equal(got, want)
    assert gmap.keys() == wmap.keys()
    for k in wmap:
        np.testing.assert_array_equal(gmap[k], wmap[k])
    values = np.array([["a", None, "zz"], ["", "c", "b"]], dtype=object)
    np.testing.assert_array_equal(
        tetl.encode_with_categories(values, gmap["item_id"]),
        jetl.encode_with_categories(values, wmap["item_id"]))


@pytest.mark.parametrize("keep,lengths", [("first", (20, 2)), ("last", (4, 3))])
def test_session_aggregator_equals_jax(raw, keep, lengths):
    coded, _ = jetl.categorify(raw, ["item_id", "category"])
    jschema, tschema = _schemas()
    want = jetl.session_aggregator(jschema, coded, *lengths, keep=keep)
    got = tetl.session_aggregator(tschema, coded, *lengths, keep=keep)
    pd.testing.assert_frame_equal(got, want)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_same_tree(got_dir, want_dir):
    assert _tree(got_dir) == _tree(want_dir)
    for rel in _tree(want_dir):
        if rel.endswith(".parquet"):
            pd.testing.assert_frame_equal(pd.read_parquet(os.path.join(got_dir, rel)),
                                          pd.read_parquet(os.path.join(want_dir, rel)))
        else:
            with open(os.path.join(got_dir, rel)) as g, open(os.path.join(want_dir, rel)) as w:
                assert g.read() == w.read(), rel


def test_time_based_splits_equal_jax(raw, tmp_path):
    coded, _ = jetl.categorify(raw, ["item_id", "category"])
    sessions = jetl.session_aggregator(_schemas()[0], coded).merge(
        coded.groupby("session_id")["timestamp"].min().rename("ts/first"), on="session_id"
    ).merge(coded.groupby("session_id")["day"].min().rename("day_idx"), on="session_id")
    kw = dict(test_size=0.2, val_size=0.25, seed=4, pad_digits=3)
    jetl.save_time_based_splits(sessions, str(tmp_path / "jax"), **kw)
    sessions.to_parquet(tmp_path / "sessions.parquet")
    tetl.save_time_based_splits(str(tmp_path / "sessions.parquet"), str(tmp_path / "torch"), **kw)
    assert sorted(os.listdir(tmp_path / "torch")) == ["001", "002", "003"]
    _assert_same_tree(tmp_path / "torch", tmp_path / "jax")


@pytest.mark.parametrize("kw", [{"day_col": "day", "categorify_columns": True},
                                {"num_windows": 2, "categorify_columns": ["item_id"],
                                 "keep": "last", "maximum_length": 5}])
def test_etl_to_time_splits_equals_jax(raw, tmp_path, kw):
    jschema, tschema = _schemas()
    jetl.etl_interactions_to_time_splits(raw, jschema, str(tmp_path / "jax"), **kw)
    tetl.etl_interactions_to_time_splits(raw, tschema, str(tmp_path / "torch"), **kw)
    _assert_same_tree(tmp_path / "torch", tmp_path / "jax")
    if "day_col" in kw:
        assert tetl.load_categories(str(tmp_path / "torch" / "categories")).keys() == \
            {"item_id", "category"}
