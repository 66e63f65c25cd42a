"""The vocab-parallel CE and the sparse row update over two ranks, on CUDA
tensors on the card, against one rank.

Marked ``cuda``: on a machine without CUDA they skip. This file imports no
JAX, so it runs on the card without the JAX package's test setup:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mesh_cuda.py

Two ranks (subprocesses, ``torch.multiprocessing`` spawn) join a Gloo group
over TCP on ``localhost`` (Gloo takes CUDA tensors, and two ranks may share
one card), each on ``cuda:<rank mod cards>``. Each holds one half of the
table: the sharded CE's loss, dx and its rows' dW (K1, K2), the
CE-and-rank (K1, K4) and the top-k against the whole table's ``fused_*``
functions (K1, K2, K3) on one rank; ``sharded_rows_adam_update`` and
``sharded_rows_adafactor_update`` (the clip's sum over the group) against
the whole table's update. Tolerances: the loss 1e-6 relative, dx and dW
1e-5 in relative Frobenius norm (another order of the same sums), ranks
exact but for near ties (within 1), top-k ids equal; the updated rows 1e-6
relative.
"""

import os
import socket
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

pytestmark = pytest.mark.cuda

N, E, ROWS, VOCAB, EPS, K = 915, 64, 2 * 8192, 2 * 8192 - 5, 0.1, 20
UPDATE_IDS = 3000


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _inputs(dev):
    g = torch.Generator().manual_seed(3)
    W = torch.randn(ROWS, E, generator=g) * 0.05
    labels = torch.randint(1, VOCAB, (N,), generator=g, dtype=torch.int32)
    x = 6.0 * W[labels.long()] + torch.randn(N, E, generator=g)
    weights = (torch.rand(N, generator=g) > 0.3).float()
    ids = torch.randint(0, ROWS, (UPDATE_IDS,), generator=g)
    row_grads = torch.randn(UPDATE_IDS, E, generator=g) * 0.1
    return [t.to(dev) for t in (x, W, labels, weights, ids, row_grads)]


def _rank(rank, port, out_dir):
    from transformers4rec_tpu_torch.ops import sparse_update as su
    from transformers4rec_tpu_torch.parallel import (
        shard_table,
        sharded_ce_and_rank,
        sharded_softmax_ce,
        sharded_topk,
    )

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2, timeout=timedelta(seconds=60))
    try:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        group = dist.group.WORLD
        x, W, labels, weights, ids, row_grads = _inputs(dev)
        W_l = shard_table(W, rank, 2).clone().requires_grad_()
        xs = x.clone().requires_grad_()
        loss = sharded_softmax_ce(xs, W_l, labels, weights, group, vocab_size=VOCAB,
                                  label_smoothing=EPS)
        loss.backward()
        ev_loss, ranks = sharded_ce_and_rank(x, W_l.detach(), labels, weights, group,
                                             vocab_size=VOCAB, label_smoothing=EPS)
        s, i = sharded_topk(x, W_l.detach(), K, group, vocab_size=VOCAB,
                            compute_dtype=torch.float32)
        out = {"loss": loss.detach(), "dx": xs.grad, "dW": W_l.grad, "eval_loss": ev_loss,
               "ranks": ranks, "topk_s": s, "topk_i": i}
        lo, rows = rank * (ROWS // 2), ROWS // 2
        uids, g = su.dedupe_row_grads(ids, row_grads, ROWS)
        for rule, init, update in (
                ("adam", su.sparse_rows_adam_init, su.sharded_rows_adam_update),
                ("adafactor", su.sparse_rows_adafactor_init, su.sharded_rows_adafactor_update)):
            table = shard_table(W, rank, 2).clone()
            state = init(table)
            kwargs = {"group": group, "total_rows": ROWS} if rule == "adafactor" else {}
            update(table, state, uids, g, 0.05, lo, rows, deduped=True, **kwargs)
            out[f"{rule}_table"] = table
        torch.save({k: v.cpu() for k, v in out.items()}, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    out = tmp_path_factory.mktemp("mesh_cuda")
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, str(out))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and [p.exitcode for p in procs] == [0, 0]
    return [torch.load(out / f"{r}.pt") for r in range(2)]


def _rel(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm())


def test_two_rank_sharded_ce_on_the_card_matches_one_rank(two_ranks):
    from transformers4rec_tpu_torch.ops import vocab

    dev = torch.device("cuda")
    x, W, labels, weights, _, _ = _inputs(dev)
    xu, Wu = x.clone().requires_grad_(), W.clone().requires_grad_()
    loss = vocab.fused_softmax_ce(xu, Wu, labels, weights, vocab_size=VOCAB,
                                  label_smoothing=EPS)
    loss.backward()
    ev_loss, ranks = vocab.fused_ce_and_rank(x, W, labels, weights, vocab_size=VOCAB,
                                             label_smoothing=EPS)
    top_s, top_i = vocab.fused_topk(x, W, K, vocab_size=VOCAB, compute_dtype=torch.float32)
    for rank, out in enumerate(two_ranks):
        rows = slice(rank * ROWS // 2, (rank + 1) * ROWS // 2)
        assert float(out["loss"]) == pytest.approx(float(loss.detach()), rel=1e-6)
        assert _rel(out["dx"], xu.grad.cpu()) <= 1e-5
        assert _rel(out["dW"], Wu.grad.cpu()[rows]) <= 1e-5
        assert float(out["eval_loss"]) == pytest.approx(float(ev_loss), rel=1e-6)
        assert (out["ranks"] - ranks.cpu()).abs().max() <= 1
        assert (out["ranks"] == ranks.cpu()).float().mean() >= 0.99
        np.testing.assert_array_equal(out["topk_i"].numpy(), top_i.cpu().numpy())
        np.testing.assert_allclose(out["topk_s"].numpy(), top_s.cpu().numpy(), rtol=1e-6)


def test_two_rank_sparse_row_updates_on_the_card_match_one_rank(two_ranks):
    from transformers4rec_tpu_torch.ops import sparse_update as su

    dev = torch.device("cuda")
    _, W, _, _, ids, row_grads = _inputs(dev)
    for rule, init, update in (("adam", su.sparse_rows_adam_init, su.sparse_rows_adam_update),
                               ("adafactor", su.sparse_rows_adafactor_init,
                                su.sparse_rows_adafactor_update)):
        table = W.clone()
        update(table, init(table), ids, row_grads, 0.05)
        whole = torch.cat([out[f"{rule}_table"] for out in two_ranks])
        assert torch.equal(whole != W.cpu(), table.cpu() != W.cpu()), rule
        torch.testing.assert_close(whole, table.cpu(), rtol=1e-6, atol=1e-7)
