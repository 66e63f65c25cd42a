"""One rank of the port's vocab-parallel tests (``test_torch_parallel.py``).

    python torch_gloo_worker.py RANK WORLD STORE_FILE INPUT.npz OUTPUT.npz

Joins a Gloo process group of WORLD ranks on the CPU through a file store,
takes its rows of the table in INPUT.npz and runs the sharded CE with its
gradients, the CE-and-rank, the top-k and the lookup over the group; then
builds the small vocab-parallel model from the weights in INPUT.npz
(``model/...`` keys) and evaluates, takes one training step's loss and
gradients and serves a top-k. Everything goes to OUTPUT.npz. Imports no JAX.
"""

import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from transformers4rec_tpu_torch import convert, flagship
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.parallel import (
    shard_table,
    sharded_ce_and_rank,
    sharded_embedding_lookup,
    sharded_softmax_ce,
    sharded_topk,
)


def run_ops(inp, group, rank, world, out):
    x, W, labels, weights, ids = (torch.from_numpy(inp[k]) for k in
                                  ("x", "W", "labels", "weights", "ids"))
    vsz, eps, k = int(inp["vocab_size"]), float(inp["eps"]), int(inp["k"])
    xs = x.clone().requires_grad_()
    W_l = shard_table(W, rank, world).clone().requires_grad_()
    loss = sharded_softmax_ce(xs, W_l, labels, weights, group, vocab_size=vsz,
                              label_smoothing=eps)
    loss.backward()
    out.update(ce_loss=loss.detach().numpy(), ce_dx=xs.grad.numpy(), ce_dW=W_l.grad.numpy())
    eval_loss, ranks = sharded_ce_and_rank(x, W_l.detach(), labels, weights, group,
                                           vocab_size=vsz, label_smoothing=eps)
    out.update(rank_loss=eval_loss.numpy(), ranks=ranks.numpy())
    s, i = sharded_topk(x, W_l.detach(), k, group, vocab_size=vsz)
    out.update(topk_scores=s.numpy(), topk_ids=i.numpy())
    table = shard_table(W, rank, world).clone().requires_grad_()
    emb = sharded_embedding_lookup(table, ids, group)
    (emb ** 2).sum().backward()
    out.update(lookup=emb.detach().numpy(), lookup_grad=table.grad.numpy())


def nested(inp, prefix):
    tree = {}
    for key in inp.files:
        if key.startswith(prefix):
            node = tree
            *path, leaf = key[len(prefix):].split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = inp[key]
    return tree


def run_model(inp, group, rank, world, out):
    small = {k: int(inp[f"small_{k}"]) for k in ("num_items", "d_model", "n_layer", "n_head",
                                                  "seq")}
    model = flagship.build_model("cpu", seed=1, dropout=0.0, vocab_parallel_group=group,
                                 **small)
    model.load_state_dict(convert.params_from_jax(
        nested(inp, "model/"), shard=(rank, world), sharded_tables=("item_id",)))
    batch = synthetic_data(flagship.schema(small["num_items"], small["seq"]),
                           num_rows=int(inp["rows"]), max_session_length=small["seq"],
                           seed=int(inp["batch_seed"]))
    res = model.evaluate([batch])
    out.update({"eval/" + k: np.float64(v) for k, v in res.items()})
    tb = model._as_dense(batch)
    info = convert.masking_info_from_jax(inp["mask_targets"], inp["mask_mask"],
                                         inp["mask_pad_mask"])
    loss, _ = model(tb, targets=tb, training=True, masking_info=info)
    loss.backward()
    task = model.heads[0].tasks[0]
    out.update(train_loss=loss.detach().numpy(),
               table_grad=model.heads[0].input_module.item_embedding_table().grad.numpy(),
               projection_grad=task.tying_projection.weight.grad.numpy())
    with torch.inference_mode():
        s, i = model(tb, top_k=int(inp["model_k"]))
    out.update(model_topk_scores=s.numpy(), model_topk_ids=i.numpy())


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store_file, in_file, out_file = sys.argv[3:6]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    try:
        group = dist.group.WORLD
        inp = np.load(in_file)
        out = {}
        run_ops(inp, group, rank, world, out)
        run_model(inp, group, rank, world, out)
        np.savez(out_file, **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
