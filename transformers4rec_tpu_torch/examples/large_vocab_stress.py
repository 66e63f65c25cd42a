"""Large-vocab stress config: a row-sharded item table + sampled softmax.

Counterpart of the JAX package's ``examples/large_vocab_stress.py``: a huge
item table (100M rows at full scale) row-sharded over the 'model' axis of
ranks (``parallel.make_mesh(1, M)``: rank r holds rows [r·V/M, (r+1)·V/M)),
looked up through the sharded row gather (``sharded_embedding_lookup``: each
rank writes its own rows, one sum over the group fills in the rest) and
trained with log-uniform sampled softmax; ``--objective full`` trains the
full softmax through the vocab-parallel CE (``sharded_softmax_ce``: the CE
kernels on each shard, O(N) numbers merged). At full scale the table must
shard over several cards; this script runs the same sharded path at a size
the machine holds (scale with ``--vocab``).

With ``--model-axis M`` above 1 the script starts M ranks, each a process
of this module (``--rank``), joined by ``torch.distributed`` on loopback:
Gloo on the CPU (``--cpu``) and where the ranks share a card, NCCL when
there is a card a rank. The ranks draw the same table, batch and negatives
from the same seeds, so each holds its rows of one table and sees the same
batch.

  python -m transformers4rec_tpu_torch.examples.large_vocab_stress --vocab 1000000
  python -m transformers4rec_tpu_torch.examples.large_vocab_stress --cpu --vocab 100000
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import time
from typing import Optional, Sequence

import torch

MODULE = "transformers4rec_tpu_torch.examples.large_vocab_stress"
RESULT = "result: "  # rank 0's line of numbers, read back by the launcher


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vocab", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--seq-len", type=int, default=20)
    ap.add_argument("--model-axis", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--n-samples", type=int, default=8192)
    ap.add_argument(
        "--optimizer", choices=["adagrad", "sparse_adam"], default="sparse_adam",
        help="adagrad = dense update over the whole table each step; "
        "sparse_adam = gather rows outside autograd + O(N*E) scatter update "
        "(ops/sparse_update.py) — the only viable mode at 100M rows",
    )
    ap.add_argument(
        "--objective", choices=["sampled", "full"], default="sampled",
        help="sampled = log-uniform sampled softmax; full = vocab-parallel "
        "FULL softmax through the sharded CE (sharded_softmax_ce) — requires "
        "--optimizer adagrad (dense table gradient)",
    )
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    # one rank of the launched group (set by the launcher, not by hand)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dist-port", type=int, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


class Adagrad:
    """``optax.adagrad(learning_rate)``'s rule, in place on ``param``: the
    accumulator starts at ``initial_accumulator_value`` (0.1), takes the
    squared gradient, and the step is ``lr · g / sqrt(acc + eps)`` with
    ``eps`` (1e-7) inside the root (0 where the accumulator is 0).
    ``torch.optim.Adagrad`` starts its accumulator at 0 and adds eps
    outside the root, so it is not used."""

    def __init__(self, param: torch.Tensor, learning_rate: float,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        self.param, self.lr, self.eps = param, learning_rate, eps
        self.sum_of_squares = torch.full_like(param, initial_accumulator_value)

    @torch.no_grad()
    def step(self, grad: torch.Tensor) -> None:
        self.sum_of_squares += grad * grad
        t = self.sum_of_squares
        scale = torch.where(t > 0, torch.rsqrt(t + self.eps), torch.zeros_like(t))
        self.param -= self.lr * (scale * grad)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(argv: Sequence[str], world: int) -> dict:
    """Start ``world`` ranks of this module and wait for them: rank 0's
    output is printed, every rank must end with 0. Returns rank 0's
    numbers."""
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    env = {**os.environ, "PYTHONPATH": root + (os.pathsep + path if path else "")}
    procs = [subprocess.Popen(
        [sys.executable, "-m", MODULE, *argv, "--rank", str(r), "--dist-port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    outs = [p.communicate()[0] for p in procs]
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"rank(s) {failed} failed:\n" + "\n".join(outs[r] for r in failed))
    result = None
    for line in outs[0].splitlines():
        if line.startswith(RESULT):
            result = json.loads(line[len(RESULT):])
        else:
            print(line)
    return result


def _rank(args: argparse.Namespace, world: int) -> dict:
    """One rank's run (the only one when ``world`` is 1): rows
    [index·V_l, (index+1)·V_l) of the table on this rank's device."""
    import torch.distributed as dist

    from transformers4rec_tpu_torch.model.prediction_task import LogUniformSampler
    from transformers4rec_tpu_torch.ops.sparse_update import (
        sharded_rows_adam_update,
        sparse_rows_adam_init,
    )
    from transformers4rec_tpu_torch.parallel import (
        make_mesh,
        shard_table,
        sharded_embedding_lookup,
        sharded_softmax_ce,
    )

    rank = args.rank or 0
    if args.cpu:
        device, backend = torch.device("cpu"), "gloo"
    else:
        cards = torch.cuda.device_count()
        device = torch.device("cuda", rank % cards)
        backend = "nccl" if cards >= world else "gloo"  # ranks sharing a card: Gloo
        torch.cuda.set_device(device)
    if world > 1:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{args.dist_port}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(1, world)
        group = mesh.model_group
        V = (args.vocab // world) * world
        V_l = V // world
        lo = mesh.model_index * V_l
        print(f"mesh: {mesh.shape} ({backend} on {device.type}); table {V}x{args.dim} "
              f"({V * args.dim * 4 / 1e9:.2f} GB f32), "
              f"{V_l * args.dim * 4 / 1e9:.2f} GB per model shard")
        # the whole table from one seed on every rank, each keeping its rows
        draw = torch.Generator().manual_seed(0)
        table = (shard_table(torch.randn(V, args.dim, generator=draw), mesh.model_index, world)
                 * 0.05).to(device).requires_grad_(args.optimizer == "adagrad")
        shards = table if group is not None else [table]
        B, S = args.batch_size, args.seq_len
        ids = torch.randint(1, V, (B, S), generator=torch.Generator().manual_seed(1)).to(device)
        # learnable toy objective: predict the session's last item from the
        # pooled session embedding (a real signal, unlike uniform labels)
        labels = ids[:, -1]
        sampler = LogUniformSampler(args.n_samples, V, min_id=1)

        def scores_loss(emb, pos_w, neg_w, neg):
            hidden = emb.mean(dim=1)  # stand-in tower: mean-pool session
            pos = (hidden * pos_w).sum(-1, keepdim=True)
            negs = hidden @ neg_w.T
            eps = 1e-16
            pos = pos - torch.log(sampler.expected_probs(labels) + eps)[:, None]
            negs = negs - torch.log(sampler.expected_probs(neg) + eps)[None, :]
            negs = torch.where(labels[:, None] == neg[None, :], -1e4, negs)
            logits = torch.cat([pos, negs], dim=1)
            return -torch.log_softmax(logits, dim=1)[:, 0].mean()

        if args.objective == "full":
            ones = torch.ones(B, device=device)

            def loss_fn(gen):
                hidden = sharded_embedding_lookup(shards, ids, group).mean(dim=1)  # (B, E)
                return sharded_softmax_ce(hidden, shards, labels, ones, group, vocab_size=V)
        else:
            def loss_fn(gen):
                emb = sharded_embedding_lookup(shards, ids, group)  # (B, S, E) by one sum
                neg = sampler.sample(gen)
                pos_w = sharded_embedding_lookup(shards, labels, group)
                neg_w = sharded_embedding_lookup(shards, neg, group)
                return scores_loss(emb, pos_w, neg_w, neg)

        if args.objective == "full" and args.optimizer != "adagrad":
            raise SystemExit("--objective full produces a dense (V, E) gradient; "
                             "use --optimizer adagrad")
        if args.optimizer == "adagrad":
            opt = Adagrad(table, 0.5)

            def step(gen):
                loss = loss_fn(gen)
                (g,) = torch.autograd.grad(loss, [table])  # this rank's rows
                opt.step(g)
                return loss.detach()
        else:  # sparse_adam: rows gathered OUTSIDE autograd; no dense (V, E) grad
            state = sparse_rows_adam_init(table.detach())
            n_in, n_lab = B * S, B

            def step(gen):
                neg = sampler.sample(gen)
                all_ids = torch.cat([ids.reshape(-1), labels, neg])
                with torch.no_grad():
                    rows = sharded_embedding_lookup(shards, all_ids, group)
                rows.requires_grad_()
                loss = scores_loss(rows[:n_in].reshape(B, S, args.dim), rows[n_in:n_in + n_lab],
                                   rows[n_in + n_lab:], neg)
                (g_rows,) = torch.autograd.grad(loss, [rows])
                with torch.no_grad():
                    sharded_rows_adam_update(table, state, all_ids, g_rows, 0.05, lo, V_l)
                return loss.detach()

        def eval_loss() -> float:
            # fixed negatives: comparable eval losses
            with torch.no_grad():
                return float(loss_fn(torch.Generator(device=device).manual_seed(99)))

        gen = torch.Generator(device=device).manual_seed(7)
        initial = eval_loss()
        losses = []
        t0 = time.time()
        for _ in range(args.steps):
            losses.append(float(step(gen)))
        dt = time.time() - t0
        final = eval_loss()
        print(f"train losses: {[round(v, 4) for v in losses[:5]]}...")
        print(f"fixed-rng eval loss: {initial:.4f} -> {final:.4f}")
        print(f"{args.steps} steps in {dt:.1f}s; table sharding: rows over 'model', "
              f"{world} shard(s) of {V_l} rows")
        assert final < initial, "eval loss must decrease"
        print("OK")
        return {"initial": initial, "final": final, "losses": losses, "seconds": dt,
                "world": world, "backend": backend}
    finally:
        if world > 1:
            dist.destroy_process_group()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns rank 0's eval losses before and after, its step losses and
    the group's size."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.rank is None and args.model_axis > 1:
        return _launch(argv, args.model_axis)
    result = _rank(args, args.model_axis)
    if args.rank is not None:
        print(RESULT + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
