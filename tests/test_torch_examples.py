"""The port's four examples (``transformers4rec_tpu_torch.examples``), each
``main(argv)`` run in-process on the CPU at a few steps and small sizes,
and ``large_vocab_stress``' Adagrad held to ``optax.adagrad`` on a few
numbers.

- ``getting_started``: the loss falls (the script asserts it), the
  evaluation's ranking metrics and a top-10 for every session;
- ``serving_export``: the artifact's files, batches of 1, 7 and 32 served
  by the program alone;
- ``end_to_end``: two windows of training from the ETL's Parquet files,
  the daemon's raw ids on loopback, equal to the in-process runner's (the
  script asserts it);
- ``large_vocab_stress``: two ranks started by the script (Gloo) give the
  eval losses and the step losses of one rank holding the whole table bit
  for bit (sparse Adam: the same rows move, only their home differs); the
  full softmax through the vocab-parallel CE with Adagrad; the eval loss
  falls in each run (the script asserts it).
"""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from transformers4rec_tpu_torch.examples import (
    end_to_end,
    getting_started,
    large_vocab_stress,
    serving_export,
)

torch.set_num_threads(1)

SMALL_VOCAB = ["--cpu", "--vocab", "4000", "--dim", "16", "--batch-size", "8", "--seq-len",
               "6", "--n-samples", "256", "--steps", "4"]


def test_getting_started_trains_evaluates_and_predicts(tmp_path):
    out = getting_started.main(["--cpu", "--steps", "20", "--d-model", "32", "--n-layer", "1",
                                "--n-head", "2", "--num-items", "300", "--batch-size", "16",
                                "--seq-len", "10", "--output-dir", str(tmp_path)])
    assert out["losses"][-1] < out["losses"][0] and out["train"]["train_steps"] == 20
    assert "eval_/next-item/ndcg_at_10" in out["eval"]
    assert out["top_k_shape"][1] == 10


def test_serving_export_serves_from_the_artifact_alone(tmp_path):
    out = serving_export.main(["--cpu", "--steps", "3", "--artifact-dir", str(tmp_path / "a")])
    assert "model.pt2" in out["files"] and "metadata.json" in out["files"]
    assert {b: ids.shape for b, ids in out["served"].items()} == {
        1: (1, 10), 7: (7, 10), 32: (32, 10)}


def test_end_to_end_serves_raw_ids(tmp_path, monkeypatch):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    out = end_to_end.main(["--cpu", "--steps-per-day", "3", "--top-k", "5"])
    assert len(out["windows"]) == 2 and len(out["item_ids"]) == 5
    assert all(i >= 1_000_000 or i == -1 for i in out["item_ids"])  # raw, not encoded


def test_large_vocab_stress_on_two_ranks_equals_one():
    two = large_vocab_stress.main(SMALL_VOCAB + ["--model-axis", "2"])
    one = large_vocab_stress.main(SMALL_VOCAB + ["--model-axis", "1"])
    assert two["world"] == 2 and two["backend"] == "gloo" and one["world"] == 1
    assert two["losses"] == one["losses"]
    assert (two["initial"], two["final"]) == (one["initial"], one["final"])
    assert two["final"] < two["initial"]


def test_large_vocab_stress_full_softmax_with_adagrad():
    out = large_vocab_stress.main(SMALL_VOCAB + ["--model-axis", "1", "--optimizer", "adagrad",
                                                 "--objective", "full"])
    assert out["final"] < out["initial"] and np.isfinite(out["losses"]).all()
    with pytest.raises(SystemExit):
        large_vocab_stress.main(SMALL_VOCAB + ["--model-axis", "1", "--objective", "full"])


def test_adagrad_takes_optax_steps():
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) for _ in range(3)]
    grads[1][0] = 0.0  # a row without a gradient in one step
    tx = optax.adagrad(0.5)
    jp, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.from_numpy(p0.copy())
    opt = large_vocab_stress.Adagrad(tp, 0.5)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step(torch.from_numpy(g))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(opt.sum_of_squares.numpy(),
                               np.asarray(state[0].sum_of_squares), rtol=1e-6)
