"""The trainer's checkpoints on the CPU: asynchronous saves, the completion
marker, waiting for pending writes, the profiler window, the checkpoint
formats, and the sharded format over two Gloo ranks.

One rank: a small flagship trainer (2,000 items, d_model 16, 1 layer,
sessions of 8) takes two steps, then saves. The asynchronous write is held
back by a gate on ``torch.save`` (the test's own) until the test lets it
go, so that what happens between ``save()`` returning and the file being
whole is seen: the live state moving on, a load, a rotation.

Two ranks: ``tests/torch_mesh_worker.py``'s shared run
(``test_torch_data_parallel.runs``, made once a session) saves on (1, 2)
in both formats and loads each on (2, 1) and (1, 2), and saves part-way
through an accumulation over (2, 1). A checkpoint's state loads bit for
bit whatever the format; a resumed accumulation sums its gradients in
another order (the saved sum of the data rows' first micro-steps, then the
second's), so its weights equal the unbroken run's within 1e-6 relative.
"""

import json
import os
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from transformers4rec_tpu_torch import flagship
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.trainer import T4RecTrainingArguments
from transformers4rec_tpu_torch.trainer.checkpoint import (
    CHECKPOINT_FILE,
    RowShard,
    checkpoint_complete,
    wait_all_pending,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_worker as worker  # noqa: E402
from test_torch_data_parallel import runs  # noqa: E402,F401  (the shared two-rank run)

torch.set_num_threads(1)

V, S, ROWS = 2000, 8, 8
SMALL = dict(num_items=V, d_model=16, n_layer=1, n_head=2, seq=S)


def _trainer(out, steps=2, **args):
    data = synthetic_data(flagship.schema(V, S), num_rows=4 * ROWS, max_session_length=S,
                          seed=31)
    trainer = flagship.build_trainer("cpu", seed=0, train_dataset=data, output_dir=str(out),
                                     dropout=0.0, **SMALL)
    trainer.args.per_device_train_batch_size = ROWS
    trainer.args.max_steps = steps
    trainer.args.logging_steps = 1
    for k, v in args.items():
        setattr(trainer.args, k, v)
    return trainer


def _doc(path):
    return torch.load(os.path.join(path, CHECKPOINT_FILE), map_location="cpu",
                      weights_only=False)


def _equal(a, b):
    """Two checkpoint documents hold the same values."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a.cpu(), b.cpu())
    return a == b


class Gate:
    """Holds every ``torch.save`` of a checkpoint file back until opened;
    records the order in which the files were written."""

    def __init__(self, monkeypatch):
        self.open = threading.Event()
        self.written = []
        save = torch.save

        def gated(doc, f, *a, **k):
            if isinstance(f, str) and f.endswith(".tmp"):
                assert self.open.wait(60), "the gate was never opened"
                self.written.append(os.path.basename(f))
            return save(doc, f, *a, **k)

        monkeypatch.setattr(torch, "save", gated)


@pytest.fixture
def trained(tmp_path):
    trainer = _trainer(tmp_path / "run")
    trainer.train()
    return trainer


def test_an_async_save_holds_what_a_sync_save_holds(trained, tmp_path, monkeypatch):
    trained.save(str(tmp_path / "sync"))
    want = _doc(tmp_path / "sync")
    gate = Gate(monkeypatch)
    trained.args.save_async = True
    trained.save(str(tmp_path / "async"))
    # save() returned with the write held back: the live state moves on
    assert not checkpoint_complete(str(tmp_path / "async"))
    with torch.no_grad():
        for p in trained.model.parameters():
            p.add_(1.0)
    for opt in trained.optimizers.values():
        for st in opt.state.values():
            for v in st.values():
                if torch.is_tensor(v) and v.is_floating_point():
                    v.add_(1.0)
    trained.state.global_step += 5
    trained._generator.manual_seed(99)
    gate.open.set()
    trained.wait_for_checkpoints()
    assert checkpoint_complete(str(tmp_path / "async"))
    assert _equal(_doc(tmp_path / "async"), want)


@pytest.mark.parametrize("fmt", ["torch", "sharded"])
def test_the_completion_marker_is_written_last(trained, tmp_path, monkeypatch, fmt):
    gate = Gate(monkeypatch)
    trained.args.save_async = True
    trained.args.checkpoint_format = fmt
    path = tmp_path / "checkpoint-2"
    trained.save(str(path))
    # while the write is held back the checkpoint is not complete, and the
    # trainer's search for the latest checkpoint passes it by
    trained.args.output_dir = str(tmp_path)
    assert not checkpoint_complete(str(path)) and trained._latest_checkpoint() is None
    gate.open.set()
    wait_all_pending()
    assert checkpoint_complete(str(path))
    assert trained._latest_checkpoint() == str(path)
    names = sorted(os.listdir(path))
    assert not any(n.endswith(".tmp") for n in names)
    want = [CHECKPOINT_FILE] if fmt == "torch" else ["replicated-of-0.pt"]
    assert names == want and gate.written == [n + ".tmp" for n in want]


def test_load_and_rotation_wait_for_a_pending_write(trained, tmp_path, monkeypatch):
    trained.args.output_dir = str(tmp_path)
    trained.args.save_total_limit = 1
    trained.save(str(tmp_path / "checkpoint-1"))
    gate = Gate(monkeypatch)
    trained.args.save_async = True
    trained.save(str(tmp_path / "checkpoint-2"))
    opened = []

    def open_later():
        time.sleep(0.5)
        opened.append(time.monotonic())
        gate.open.set()

    threading.Thread(target=open_later).start()
    # the rotation removes checkpoint-1 only once checkpoint-2 is whole
    trained._rotate_checkpoints()
    assert opened and time.monotonic() >= opened[0]
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("checkpoint-")) == \
        ["checkpoint-2"]
    # a load waits for the write it reads
    gate.open.clear()
    trained.save(str(tmp_path / "checkpoint-3"))
    opened.clear()
    threading.Thread(target=open_later).start()
    fresh = _trainer(tmp_path / "fresh")
    fresh.load(str(tmp_path / "checkpoint-3"))
    assert opened and fresh.state.global_step == trained.state.global_step == 2
    assert all(torch.equal(a, b) for a, b in zip(fresh.model.state_dict().values(),
                                                  trained.model.state_dict().values()))


def test_train_ends_with_its_writes_on_disk(tmp_path, monkeypatch):
    trainer = _trainer(tmp_path, steps=4, save_steps=2, save_async=True)
    gate = Gate(monkeypatch)
    threading.Timer(0.5, gate.open.set).start()
    trainer.train()
    assert checkpoint_complete(str(tmp_path / "checkpoint-2"))
    assert checkpoint_complete(str(tmp_path / "checkpoint-4"))


def test_the_profile_window_writes_a_trace(tmp_path):
    trainer = _trainer(tmp_path, steps=4, profile_steps="1,3", steps_per_execution=4)
    trainer.train()
    traces = sorted((tmp_path / "profile").iterdir())
    assert [t.name for t in traces] == ["trace-steps-1-3-rank0.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    # the window's steps ran one a group, and their operators were recorded
    assert any(n.startswith("aten::") for n in names)
    assert trainer.state.global_step == 4
    # profile_dir moves the trace
    other = _trainer(tmp_path / "b", steps=2, profile_steps="0,1",
                     profile_dir=str(tmp_path / "elsewhere"))
    other.train()
    assert [t.name for t in (tmp_path / "elsewhere").iterdir()] == ["trace-steps-0-1-rank0.json"]


@pytest.mark.parametrize("jax_name,port_name", [("msgpack", "torch"), ("orbax", "sharded")])
def test_the_jax_formats_raise_naming_the_counterpart(jax_name, port_name):
    with pytest.raises(ValueError, match=f"counterpart is '{port_name}'"):
        T4RecTrainingArguments(checkpoint_format=jax_name)


def test_a_one_rank_sharded_checkpoint_resumes_as_the_torch_one(trained, tmp_path):
    trained.args.checkpoint_format = "sharded"
    trained.save(str(tmp_path / "sharded"))
    trained.args.checkpoint_format = "torch"
    trained.save(str(tmp_path / "torch"))
    a, b = _trainer(tmp_path / "a", steps=4), _trainer(tmp_path / "b", steps=4)
    a.load(str(tmp_path / "torch"))
    b.load(str(tmp_path / "sharded"))
    assert worker.differences(a, b) == []


# ------------------------------------------------------------- two ranks
def _formats(runs):
    root = runs["root"] / "out" / "formats"
    return root, [json.loads((root / f"rank{r}.json").read_text()) for r in range(2)]


@pytest.mark.parametrize("arm", ["adafactor", "sparse_adam"])
def test_a_sharded_checkpoint_restores_onto_other_layouts(runs, arm):
    """Saved on (1, 2), loaded on (2, 1) and (1, 2): the same state as the
    torch checkpoint of the same step gives."""
    _, recs = _formats(runs)
    rows = 32776
    for rec in recs:
        assert rec[arm]["2x1"] == [] and rec[arm]["1x2"] == [], rec[arm]
        assert rec[arm]["2x1_table_rows"] == rows and rec[arm]["1x2_table_rows"] == rows // 2


@pytest.mark.parametrize("arm", ["adafactor", "sparse_adam"])
def test_each_rank_writes_its_rows_and_one_rank_loads_them(runs, arm, tmp_path):
    root, _ = _formats(runs)
    d = root / arm / "sharded-2"
    assert sorted(os.listdir(d)) == ["replicated-of-2.pt", "rows-0-of-2.pt", "rows-1-of-2.pt"]
    half = 32776 // 2
    for i in range(2):
        shard = torch.load(d / f"rows-{i}-of-2.pt", weights_only=True)
        assert shard and all(t.shape[0] == half for t in shard.values())
    replicated = torch.load(d / "replicated-of-2.pt", weights_only=False)
    refs = []

    def walk(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)
        elif isinstance(tree, RowShard):
            refs.append(tree)
        elif torch.is_tensor(tree):
            assert tree.dim() == 0 or tree.shape[0] < half, tuple(tree.shape)

    walk(replicated)
    # the table and every state of its rows stand as references
    assert refs and all(r.rows == 32776 and r.shards == 2 for r in refs)
    # a one-rank trainer reads the whole table from the two files
    a = worker.build_trainer(arm, runs["weights"], str(tmp_path / "a"), world=1)
    b = worker.build_trainer(arm, runs["weights"], str(tmp_path / "b"), world=1)
    a.load(str(root / arm / "torch-2"))
    b.load(str(d))
    assert worker.differences(a, b) == []


@pytest.mark.parametrize("arm", ["adafactor", "sparse_adam"])
def test_a_save_mid_accumulation_resumes_to_the_unbroken_update(runs, arm):
    _, recs = _formats(runs)
    for rec in recs:
        for fmt in ("torch", "sharded"):
            assert rec[arm][f"mid_{fmt}_mini_step"] == 1
            assert rec[arm][f"mid_{fmt}_opt_steps"] == [2, 2]
            assert rec[arm][f"mid_{fmt}_rel_diff"] <= 1e-6, rec[arm]
