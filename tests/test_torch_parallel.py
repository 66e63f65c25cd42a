"""The port's label ranks, streamed top-k and vocab-parallel functions against
the JAX package on the CPU.

Inputs are made with numpy from a seed and go through the JAX function and
its counterpart in the port. The JAX side runs its scan paths
(``use_pallas=False``), the plain references of its Pallas kernels; the
sharded functions run on a ``(data=1, model=2)`` mesh of two CPU devices.
The port runs two shards in one process (``group=None``, the shards given as
a list), and once across two Gloo ranks started as subprocesses.

Tolerances: f32 sums of the same bf16-rounded products in another order:
losses 1e-6 relative, gradients 1e-5 in relative Frobenius norm, scores 1e-5
relative; ranks and top-k ids exact.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import transformers4rec_tpu as jtr
from transformers4rec_tpu.data.synthetic import synthetic_ecommerce_data_schema as jax_schema_fn
from transformers4rec_tpu.masking import MaskedLanguageModeling as JaxMLM
from transformers4rec_tpu.ops import vocab as jvocab
from transformers4rec_tpu.parallel import sharded_embedding as jsharded

from transformers4rec_tpu_torch import convert, flagship
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.features.embedding import SequenceEmbeddingFeatures
from transformers4rec_tpu_torch.ops import vocab
from transformers4rec_tpu_torch.parallel import (
    shard_table,
    sharded_ce_and_rank,
    sharded_embedding_lookup,
    sharded_softmax_ce,
    sharded_topk,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N, E, ROWS = 32, 16, 1024
CHUNK = 256  # the JAX scan's block: several chunks, the last one padded past the vocab


def _inputs(seed, vocab_size, n=N, rows=ROWS):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, E)).astype(np.float32)
    W = (rng.normal(size=(rows, E)) * 0.1).astype(np.float32)
    labels = rng.integers(0, vocab_size, size=(n,)).astype(np.int32)
    weights = (rng.random(n) > 0.2).astype(np.float32)
    return x, W, labels, weights


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _rel_fro(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))


# ---------------------------------------------------------------- single device
@pytest.mark.parametrize("vocab_size", [1000, 1024, 700])
def test_rank_counts_and_label_rank_match_the_jax_scan(vocab_size):
    x, W, labels, _ = _inputs(1, vocab_size)
    _, ll, _ = jvocab._ce_fwd_scan(jnp.asarray(x), jnp.asarray(W), jnp.asarray(labels), CHUNK,
                                   vocab_size=vocab_size)
    want = jvocab.rank_counts(jnp.asarray(x), jnp.asarray(W), ll, jnp.asarray(labels),
                              block_v=CHUNK, use_pallas=False, vocab_size=vocab_size)
    tx, tW, tl, tll = _t(x, W, labels, ll)
    got = vocab.rank_counts(tx, tW, tll, tl, vocab_size)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(vocab.rank_counts_plain(tx, tW, tll, tl, vocab_size).numpy(),
                                  np.asarray(want))
    want_rank = jvocab.fused_label_rank(jnp.asarray(x), jnp.asarray(W), jnp.asarray(labels),
                                        block_v=CHUNK, use_pallas=False, vocab_size=vocab_size)
    got_rank = vocab.fused_label_rank(tx, tW, tl, vocab_size=vocab_size)
    np.testing.assert_array_equal(got_rank.numpy(), np.asarray(want_rank))
    # K1 + K4 give the ranks of the one-pass K3
    _, k3 = vocab.fused_ce_and_rank(tx, tW, tl, torch.ones(N), vocab_size=vocab_size)
    np.testing.assert_array_equal(got_rank.numpy(), k3.numpy())


def test_rank_counts_with_labels_of_minus_one_and_an_empty_vocab():
    """A label of -1 leaves no column out (its ``ll`` is another shard's
    logit), and a vocab bound of 0 counts nothing."""
    x, W, labels, _ = _inputs(2, 1000)
    ll = np.random.default_rng(3).normal(size=N).astype(np.float32) * 0.3
    want = jvocab.rank_counts(jnp.asarray(x), jnp.asarray(W), jnp.asarray(ll),
                              jnp.asarray(labels), block_v=CHUNK, use_pallas=False,
                              vocab_size=1000)
    tx, tW, tll = _t(x, W, ll)
    got = vocab.rank_counts(tx, tW, tll, torch.full((N,), -1, dtype=torch.int32), 1000)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.max()) > 0
    empty = vocab.rank_counts(tx, tW, tll, torch.full((N,), -1, dtype=torch.int32), 0)
    np.testing.assert_array_equal(empty.numpy(), np.zeros(N, np.int32))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("vocab_size,chunk", [(1000, 256), (1024, 300), (130, 64)])
def test_fused_topk_matches_jax(dtype, vocab_size, chunk):
    x, W, _, _ = _inputs(4, vocab_size)
    k = 20
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32,
                                                                        torch.float32)
    want_s, want_i = jvocab.fused_topk(jnp.asarray(x), jnp.asarray(W), k, chunk=chunk,
                                       vocab_size=vocab_size, compute_dtype=jdt)
    tx, tW = _t(x, W)
    got_s, got_i = vocab.fused_topk(tx, tW, k, chunk=chunk, vocab_size=vocab_size,
                                    compute_dtype=tdt)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert int(got_i.max()) < vocab_size
    # the streamed merge is the dense top-k of the same scores
    dense = (tx.to(tdt).float() @ tW[:vocab_size].to(tdt).float().T).topk(k, dim=-1)
    np.testing.assert_array_equal(got_i.numpy(), dense.indices.numpy())


def test_task_streams_top_k_above_the_threshold(monkeypatch):
    """Without a group the task takes ``fused_topk`` above N·V = 1e9 (the
    threshold is lowered here) and the dense product below; both give the
    same ids."""
    from transformers4rec_tpu_torch.model import prediction_task

    model = flagship.build_model("cpu", num_items=300, d_model=16, n_layer=1, n_head=2, seq=4)
    batch = model._as_dense(synthetic_data(flagship.schema(300, 4), num_rows=6,
                                           max_session_length=4, seed=2))
    with torch.inference_mode():
        dense_s, dense_i = model(batch, top_k=5)
        calls = []
        monkeypatch.setattr(prediction_task, "_STREAMED_TOPK_MIN", 100)
        monkeypatch.setattr(prediction_task, "fused_topk",
                            lambda *a, **kw: (calls.append(kw), vocab.fused_topk(*a, **kw))[1])
        s, i = model(batch, top_k=5)
    assert calls == [{"vocab_size": 301}]
    # bf16 scores against f32 ones
    np.testing.assert_allclose(s.numpy(), dense_s.numpy(), atol=2e-2)
    assert (i == dense_i).float().mean() > 0.7 and int(i.max()) <= 300


# ------------------------------------------------- labels on padding rows
@pytest.mark.parametrize("eps", [0.0, 0.2])
def test_a_label_on_a_padding_row_gives_the_reference_loss_and_gradients(eps):
    """``vocab_size <= label < rows``: the label logit is the masked -1e30, so
    the loss is about 1e30 and the fault is loud, and the backward still
    subtracts the label's one-hot, from dx and from that row of dW."""
    vocab_size = 1000
    x, W, labels, weights = _inputs(5, vocab_size)
    labels[[3, 17]] = [1003, 1023]  # weights: row 3 counts, row 17 as drawn
    weights[3] = 1.0
    labels[5] = 2000  # beyond the table: matches no column in either package
    jx, jW, jl = jnp.asarray(x), jnp.asarray(W), jnp.asarray(labels)
    want_lse, want_ll, want_zs = jvocab._ce_fwd_scan(jx, jW, jl, CHUNK, vocab_size=vocab_size,
                                                    smooth=eps > 0)
    tx, tW, tl, tw = _t(x, W, labels, weights)
    lse, ll, zs = vocab.ce_fwd(tx, tW, tl, vocab_size, smooth=eps > 0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-6)
    np.testing.assert_allclose(ll.numpy(), np.asarray(want_ll), rtol=1e-5, atol=1e-6)
    assert ll[3] == ll[17] == -1e30 and ll[5] == 0
    if eps:
        np.testing.assert_allclose(zs.numpy(), np.asarray(want_zs), rtol=1e-4, atol=1e-4)

    coef = weights / weights.sum()
    want_dx, want_dW = jvocab._ce_bwd_scan(jx, jW, jl, want_lse, jnp.asarray(coef), CHUNK,
                                           vocab_size=vocab_size, eps=eps)
    dx, dW = vocab.ce_bwd(tx, tW, tl, lse, torch.from_numpy(coef), vocab_size, eps)
    assert _rel_fro(dx.numpy(), np.asarray(want_dx)) <= 1e-5
    assert _rel_fro(dW.numpy(), np.asarray(want_dW)) <= 1e-5
    # the one-hot stands on the padding rows, and nothing else does
    assert float(dW[1003].abs().max()) > 0 and float(dW[1023].abs().max()) > 0
    others = np.setdiff1d(np.arange(vocab_size, ROWS), [1003, 1023])
    assert not dW[others].any()
    np.testing.assert_allclose(dW[1003].numpy(), np.asarray(want_dW)[1003], rtol=1e-6)

    # the whole op, and the evaluation's one pass
    want_loss = jvocab.fused_softmax_ce(jx, jW, jl, jnp.asarray(weights), 256, CHUNK, False,
                                        vocab_size, eps)
    got_loss = vocab.fused_softmax_ce(tx, tW, tl, tw, vocab_size=vocab_size,
                                      label_smoothing=eps)
    assert float(got_loss) > 1e28
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)
    # (its label logit is a gather from the table: no label beyond the rows)
    labels[5] = 7
    jl, tl = jnp.asarray(labels), torch.from_numpy(labels.copy())
    want_eval, want_rank = jvocab.fused_ce_and_rank(jx, jW, jl, jnp.asarray(weights), 256,
                                                    CHUNK, False, vocab_size, eps)
    got_eval, got_rank = vocab.fused_ce_and_rank(tx, tW, tl, tw, vocab_size=vocab_size,
                                                 label_smoothing=eps)
    np.testing.assert_allclose(float(got_eval), float(want_eval), rtol=1e-6)
    np.testing.assert_array_equal(got_rank.numpy(), np.asarray(want_rank))


def test_an_empty_vocab_gives_a_finite_lse():
    x, W, labels, _ = _inputs(6, 1000)
    want_lse, want_ll, _ = jvocab._ce_fwd_scan(jnp.asarray(x), jnp.asarray(W),
                                               jnp.full((N,), -1, jnp.int32), CHUNK,
                                               vocab_size=0)
    tx, tW = _t(x, W)
    minus_one = torch.full((N,), -1, dtype=torch.int32)
    lse, ll, _ = vocab.ce_fwd(tx, tW, minus_one, 0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-6)
    assert torch.isfinite(lse).all() and float(lse.max()) < -1e29 and not ll.any()
    np.testing.assert_array_equal(ll.numpy(), np.asarray(want_ll))
    lse3, rank, _ = vocab.ce_rank(tx, tW, minus_one, torch.zeros(N), 0)
    assert torch.equal(lse3, lse) and not rank.any()
    dx, dW = vocab.ce_bwd(tx, tW, minus_one, torch.zeros(N), torch.ones(N) / N, 0)
    assert not dx.any() and not dW.any()


# ------------------------------------------------------- two shards, one process
SHARDED_CASES = [
    # (seed, vocab_size, eps): the last shard partly empty, full, wholly empty
    (7, 1000, 0.0), (8, 1000, 0.2), (9, 1024, 0.2), (10, 500, 0.0), (11, 400, 0.2),
]


def _jax_sharded(mesh, x, W, labels, weights, vocab_size, eps):
    jx, jl, jw = jnp.asarray(x), jnp.asarray(labels), jnp.asarray(weights)
    Ws = jsharded.shard_table(jnp.asarray(W), mesh)

    def loss_fn(x_, W_):
        return jsharded.sharded_softmax_ce(x_, W_, jl, jw, mesh, vocab_size=vocab_size,
                                           block_v=CHUNK, use_pallas=False,
                                           label_smoothing=eps)

    loss, (dx, dW) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(jx, Ws)
    eval_loss, ranks = jax.jit(lambda x_, W_: jsharded.sharded_ce_and_rank(
        x_, W_, jl, jw, mesh, vocab_size=vocab_size, block_v=CHUNK, use_pallas=False,
        label_smoothing=eps))(jx, Ws)
    return (float(loss), np.asarray(dx), np.asarray(dW), float(eval_loss), np.asarray(ranks))


@pytest.mark.parametrize("seed,vocab_size,eps", SHARDED_CASES)
def test_two_shards_in_one_process_match_jax_and_the_unsharded_ops(mesh, seed, vocab_size, eps):
    x, W, labels, weights = _inputs(seed, vocab_size)
    want = _jax_sharded(mesh, x, W, labels, weights, vocab_size, eps)
    tx, tW, tl, tw = _t(x, W, labels, weights)

    xs = tx.clone().requires_grad_()
    shards = [shard_table(tW, i, 2).clone().requires_grad_() for i in range(2)]
    loss = sharded_softmax_ce(xs, shards, tl, tw, None, vocab_size=vocab_size,
                              label_smoothing=eps)
    loss.backward()
    dW = torch.cat([s.grad for s in shards]).numpy()
    eval_loss, ranks = sharded_ce_and_rank(tx, [s.detach() for s in shards], tl, tw, None,
                                           vocab_size=vocab_size, label_smoothing=eps)

    xu, Wu = tx.clone().requires_grad_(), tW.clone().requires_grad_()
    ref = vocab.fused_softmax_ce(xu, Wu, tl, tw, vocab_size=vocab_size, label_smoothing=eps)
    ref.backward()
    ref_eval, ref_ranks = vocab.fused_ce_and_rank(tx, tW, tl, tw, vocab_size=vocab_size,
                                                  label_smoothing=eps)
    for what, (w_loss, w_dx, w_dW, w_eval, w_ranks) in {
        "jax": want,
        "unsharded": (float(ref.detach()), xu.grad.numpy(), Wu.grad.numpy(), float(ref_eval),
                      ref_ranks.numpy()),
    }.items():
        np.testing.assert_allclose(float(loss.detach()), w_loss, rtol=1e-6, err_msg=what)
        assert _rel_fro(xs.grad.numpy(), w_dx) <= 1e-5, what
        assert _rel_fro(dW, w_dW) <= 1e-5, what
        np.testing.assert_allclose(float(eval_loss), w_eval, rtol=1e-6, err_msg=what)
        np.testing.assert_array_equal(ranks.numpy(), w_ranks, err_msg=what)
    assert not dW[vocab_size:].any()


def test_sharded_label_on_a_padding_row_matches_no_column(mesh):
    """Over shards a label at or beyond the true vocab becomes -1 on every
    shard, in both packages: no label logit and no one-hot (unsharded it
    would pick up the masked logit of its padding row)."""
    vocab_size = 1000
    x, W, labels, weights = _inputs(12, vocab_size)
    labels[4], weights[4] = 1010, 1.0
    want = _jax_sharded(mesh, x, W, labels, weights, vocab_size, 0.0)
    tx, tW, tl, tw = _t(x, W, labels, weights)
    xs = tx.clone().requires_grad_()
    shards = [shard_table(tW, i, 2).clone().requires_grad_() for i in range(2)]
    loss = sharded_softmax_ce(xs, shards, tl, tw, None, vocab_size=vocab_size)
    loss.backward()
    assert float(loss.detach()) < 1e3
    np.testing.assert_allclose(float(loss.detach()), want[0], rtol=1e-6)
    assert _rel_fro(xs.grad.numpy(), want[1]) <= 1e-5
    assert _rel_fro(torch.cat([s.grad for s in shards]).numpy(), want[2]) <= 1e-5
    eval_loss, ranks = sharded_ce_and_rank(tx, [s.detach() for s in shards], tl, tw, None,
                                           vocab_size=vocab_size)
    np.testing.assert_allclose(float(eval_loss), want[3], rtol=1e-6)
    np.testing.assert_array_equal(ranks.numpy(), want[4])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("vocab_size", [1000, 500])
def test_sharded_topk_matches_jax_and_the_unsharded_topk(world, vocab_size):
    x, W, _, _ = _inputs(13, vocab_size)
    k = 20
    jmesh = Mesh(np.array(jax.devices()[:world]).reshape(1, world), ("data", "model"))
    want_s, want_i = jax.jit(lambda x_, W_: jsharded.sharded_topk(
        x_, W_, k, jmesh, vocab_size=vocab_size, chunk=100))(
            jnp.asarray(x), jsharded.shard_table(jnp.asarray(W), jmesh))
    tx, tW = _t(x, W)
    shards = [shard_table(tW, i, world) for i in range(world)]
    got_s, got_i = sharded_topk(tx, shards, k, None, vocab_size=vocab_size, chunk=100)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    ref_s, ref_i = vocab.fused_topk(tx, tW, k, vocab_size=vocab_size)
    np.testing.assert_array_equal(got_i.numpy(), ref_i.numpy())
    np.testing.assert_allclose(got_s.numpy(), ref_s.numpy(), rtol=1e-6)
    assert int(got_i.max()) < vocab_size


def test_sharded_lookup_matches_jax_and_the_dense_gather(mesh):
    rng = np.random.default_rng(14)
    table = rng.normal(size=(64, 8)).astype(np.float32)
    ids = rng.integers(0, 64, size=(5, 7))
    jt = jsharded.shard_table(jnp.asarray(table), mesh)

    def f(t):
        return (jsharded.sharded_embedding_lookup(t, jnp.asarray(ids), mesh) ** 2).sum()

    want = jsharded.sharded_embedding_lookup(jt, jnp.asarray(ids), mesh)
    want_grad = jax.grad(f)(jt)
    shards = [shard_table(torch.from_numpy(table), i, 2).clone().requires_grad_()
              for i in range(2)]
    got = sharded_embedding_lookup(shards, torch.from_numpy(ids), None)
    (got ** 2).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), table[ids])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(torch.cat([s.grad for s in shards]).numpy(),
                               np.asarray(want_grad), rtol=1e-6)


def test_rows_that_do_not_divide_by_the_group_raise(mesh):
    table = torch.zeros(10, 4)
    with pytest.raises(ValueError, match="must divide"):
        shard_table(table, 0, 3)
    with pytest.raises(ValueError, match="must divide"):
        jsharded.sharded_embedding_lookup(jnp.zeros((9, 4)), jnp.zeros((2,), jnp.int32), mesh)
    with pytest.raises(ValueError, match="equal shapes"):
        sharded_topk(torch.zeros(2, 4), [table[:6], table[6:]], 2, None)
    with pytest.raises(ValueError, match="sequence of all shards"):
        sharded_topk(torch.zeros(2, 4), table, 2, None)
    with pytest.raises(ValueError, match="do not divide"):
        convert.params_from_jax({"categorical_module": {"item_id_table": np.zeros((9, 4))}},
                                shard=(0, 2), sharded_tables=("item_id",))


# ------------------------------------------------------ the slice as a whole
V, D, L, H, S = 500, 32, 2, 2, 8
SMALL = dict(num_items=V, d_model=D, n_layer=L, n_head=H, seq=S)
MODEL_ROWS, TOP_K = 12, 10


def _jax_vocab_parallel_model(mesh):
    schema = jax_schema_fn(num_items=V, num_categories=flagship.NUM_CATEGORIES,
                           max_session_length=S)
    im = jtr.TabularSequenceFeatures.from_schema(
        schema, d_output=D, masking="mlm", aggregation="concat",
        masking_kwargs={"mlm_probability": 0.3},
    )
    cfg = jtr.XLNetConfig.build(d_model=D, n_head=H, n_layer=L, total_seq_length=S, dropout=0.0)
    return cfg.to_model(im, jtr.NextItemPredictionTask(weight_tying=True,
                                                       vocab_parallel_mesh=mesh))


def _flat(tree, prefix):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


@pytest.fixture(scope="module")
def gloo_run(mesh, tmp_path_factory):
    """Everything the two-rank run needs, computed once: the inputs, what the
    JAX vocab-parallel model gives on them, and the two ranks' outputs."""
    tmp = tmp_path_factory.mktemp("gloo")
    # ---- the functions: a padded table, label smoothing
    vocab_size, eps, k = 1000, 0.2, 20
    x, W, labels, weights = _inputs(15, vocab_size)
    ids = np.random.default_rng(16).integers(0, ROWS, size=(4, 6))
    # ---- the model: the JAX package with a (data=1, model=2) mesh
    jmodel = _jax_vocab_parallel_model(mesh)
    batch = synthetic_data(flagship.schema(V, S), num_rows=MODEL_ROWS, max_session_length=S,
                           seed=21)
    jb = {key: jnp.asarray(val) for key, val in batch.items()}
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb)
    info = JaxMLM(hidden_size=D, mlm_probability=0.3).compute_masked_targets(
        jax.random.PRNGKey(3), jb["item_id"], training=True)
    np.savez(tmp / "in.npz", x=x, W=W, labels=labels, weights=weights, ids=ids,
             vocab_size=vocab_size, eps=eps, k=k, model_k=TOP_K, rows=MODEL_ROWS, batch_seed=21,
             mask_targets=np.asarray(info.targets), mask_mask=np.asarray(info.mask),
             mask_pad_mask=np.asarray(info.pad_mask),
             **{f"small_{key}": val for key, val in SMALL.items()},
             **_flat(jax.tree.map(np.asarray, params)["params"], "model/"))
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_gloo_worker.py"), str(rank), "2",
         str(tmp / "store"), str(tmp / "in.npz"), str(tmp / f"out{rank}.npz")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    outs = [dict(np.load(tmp / f"out{rank}.npz")) for rank in range(2)]
    return dict(x=x, W=W, labels=labels, weights=weights, ids=ids, vocab_size=vocab_size,
                eps=eps, k=k, jmodel=jmodel, params=params, jb=jb, info=info, outs=outs)


def test_two_gloo_ranks_match_the_unsharded_ops(gloo_run):
    r = gloo_run
    tx, tW, tl, tw = _t(r["x"], r["W"], r["labels"], r["weights"])
    xu, Wu = tx.clone().requires_grad_(), tW.clone().requires_grad_()
    loss = vocab.fused_softmax_ce(xu, Wu, tl, tw, vocab_size=r["vocab_size"],
                                  label_smoothing=r["eps"])
    loss.backward()
    eval_loss, ranks = vocab.fused_ce_and_rank(tx, tW, tl, tw, vocab_size=r["vocab_size"],
                                               label_smoothing=r["eps"])
    top_s, top_i = vocab.fused_topk(tx, tW, r["k"], vocab_size=r["vocab_size"])
    for rank, out in enumerate(r["outs"]):
        rows = slice(rank * ROWS // 2, (rank + 1) * ROWS // 2)
        np.testing.assert_allclose(out["ce_loss"], float(loss.detach()), rtol=1e-6)
        assert _rel_fro(out["ce_dx"], xu.grad.numpy()) <= 1e-5
        assert _rel_fro(out["ce_dW"], Wu.grad.numpy()[rows]) <= 1e-5
        np.testing.assert_allclose(out["rank_loss"], float(eval_loss), rtol=1e-6)
        np.testing.assert_array_equal(out["ranks"], ranks.numpy())
        np.testing.assert_array_equal(out["topk_ids"], top_i.numpy())
        np.testing.assert_allclose(out["topk_scores"], top_s.numpy(), rtol=1e-6)
        np.testing.assert_array_equal(out["lookup"], r["W"][r["ids"]])
        want_grad = np.zeros_like(r["W"])
        np.add.at(want_grad, r["ids"].reshape(-1), 2 * r["W"][r["ids"]].reshape(-1, E))
        np.testing.assert_allclose(out["lookup_grad"], want_grad[rows], rtol=1e-6)
    # what is the same on every rank is the same bits
    for key in ("ce_loss", "ce_dx", "ranks", "topk_ids", "topk_scores", "lookup"):
        np.testing.assert_array_equal(r["outs"][0][key], r["outs"][1][key], err_msg=key)


def test_vocab_parallel_model_matches_the_jax_model_with_a_mesh(gloo_run, monkeypatch):
    """A small model with ``vocab_parallel_group`` over two Gloo ranks, its
    weights through ``params_from_jax(shard=...)``, against the JAX model with
    ``vocab_parallel_mesh``: evaluation, one training step with the same
    mask, and the top-k. f32 end to end but for the CE's bf16 products."""
    r = gloo_run
    jmodel, params, jb = r["jmodel"], r["params"], r["jb"]
    want_eval = jmodel.evaluate([{k: np.asarray(v) for k, v in jb.items()}], params)
    monkeypatch.setattr(JaxMLM, "compute_masked_targets", lambda self, *a, **kw: r["info"])
    rngs = {"masking": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    want_loss, want_grads = jax.value_and_grad(lambda p: jmodel.apply(
        p, jb, targets=jb, training=True, compute_metrics=False, rngs=rngs)[0])(params)
    want_grads = convert.params_from_jax(jax.tree.map(np.asarray, want_grads))
    monkeypatch.undo()
    want_s, want_i = jax.jit(lambda p, b: jmodel.apply(p, b, top_k=TOP_K))(params, jb)
    table_rows = want_grads["heads.0.body.blocks.0.categorical_module.tables.item_id"].shape[0]
    assert table_rows == 504  # 501 ids padded to a multiple of 8: 252 rows a rank
    for rank, out in enumerate(r["outs"]):
        assert {k[len("eval/"):] for k in out if k.startswith("eval/")} == set(want_eval)
        for k, v in want_eval.items():
            np.testing.assert_allclose(out["eval/" + k], v, rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(out["train_loss"], float(want_loss), rtol=1e-5)
        rows = slice(rank * table_rows // 2, (rank + 1) * table_rows // 2)
        table_grad = want_grads["heads.0.body.blocks.0.categorical_module.tables.item_id"]
        assert out["table_grad"].shape == (table_rows // 2, 64)
        assert _rel_fro(out["table_grad"], table_grad.numpy()[rows]) <= 1e-3
        assert _rel_fro(out["projection_grad"],
                        want_grads["heads.0.tasks.0.tying_projection.weight"].numpy()) <= 1e-3
        np.testing.assert_allclose(out["model_topk_scores"], np.asarray(want_s), atol=1e-4)
        gaps = np.abs(np.diff(np.asarray(want_s), axis=1)) > 1e-4
        clear = np.ones_like(np.asarray(want_i), dtype=bool)
        clear[:, :-1] &= gaps
        clear[:, 1:] &= gaps
        assert clear.mean() > 0.5
        np.testing.assert_array_equal(out["model_topk_ids"][clear], np.asarray(want_i)[clear])
    for key in ("train_loss", "projection_grad", "model_topk_ids"):
        np.testing.assert_array_equal(r["outs"][0][key], r["outs"][1][key], err_msg=key)


def test_a_group_of_one_rank_in_this_process_shards_nothing_away(tmp_path):
    """``vocab_parallel_group`` with a single rank: the same weights from the
    same seed as the unsharded model, and the same evaluation, loss and
    top-k; the lookup and the head go through the group all the same."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        plain = flagship.build_model("cpu", seed=4, dropout=0.0, **SMALL)
        sharded = flagship.build_model("cpu", seed=4, dropout=0.0, vocab_parallel_group=group,
                                       **SMALL)
        cat = sharded.heads[0].input_module.categorical_module
        assert isinstance(cat, SequenceEmbeddingFeatures) and list(cat.table_groups) == ["item_id"]
        assert sharded.heads[0].tasks[0].vocab_parallel_group is group
        for (n, a), (_, b) in zip(plain.state_dict().items(), sharded.state_dict().items()):
            assert torch.equal(a, b), n
        batch = synthetic_data(flagship.schema(V, S), num_rows=MODEL_ROWS,
                               max_session_length=S, seed=22)
        assert sharded.evaluate([batch]) == pytest.approx(plain.evaluate([batch]), rel=1e-6)
        tb = plain._as_dense(batch)
        info = plain.heads[0].input_module.masking.compute_masked_targets(
            tb["item_id"].long(), training=True, generator=torch.Generator().manual_seed(1))
        losses = []
        for m in (plain, sharded):
            loss, _ = m(tb, targets=tb, training=True, masking_info=info)
            loss.backward()
            losses.append(float(loss.detach()))
        assert losses[1] == pytest.approx(losses[0], rel=1e-6)
        for (n, a), (_, b) in zip(plain.named_parameters(), sharded.named_parameters()):
            assert _rel_fro(b.grad.numpy(), a.grad.numpy()) <= 1e-5, n
        with torch.inference_mode():
            want_s, want_i = plain(tb, top_k=TOP_K)
            got_s, got_i = sharded(tb, top_k=TOP_K)
            with pytest.raises(NotImplementedError, match="top-k only"):
                sharded(tb)
        np.testing.assert_allclose(got_s.numpy(), want_s.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got_i.numpy(), want_i.numpy())
    finally:
        dist.destroy_process_group()
