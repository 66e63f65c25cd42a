"""One rank of the port's data- and model-parallel tests
(``test_torch_data_parallel.py``).

    python torch_mesh_worker.py RANK WORLD STORE_FILE INPUT_DIR OUTPUT_DIR

Joins a Gloo group of WORLD ranks on the CPU through a file store, then,
for each layout of that world (WORLD 2: (data 2, model 1) and (1, 2);
WORLD 4: (2, 2)) and each arm, trains a small XLNet-MLM trainer from the
weights in INPUT_DIR/weights.pt on the global batches of INPUT_DIR/data.pt
(this data row's rows of each), three steps in two ``train()`` calls with a
save after the second step, then loads that checkpoint into a fresh trainer
and takes the third step again; evaluates and predicts. Rank 0 writes the
checkpoints and every rank a JSON record of what the parent test compares
under OUTPUT_DIR. Imports no JAX.

WORLD 2 also runs the checkpoint formats (``checkpoint_formats``): two
steps on (1, 2) saved in both formats, each loaded on (2, 1) and on (1, 2)
and compared; and on (2, 1) with two micro-steps an update, a save part-way
through the second update, resumed in fresh trainers from both formats.

The training masks are a function of the batch's content
(``patch_draws``), so that a data row's half of a batch is masked as the
whole batch is; the negatives are a fixed set. The arm ``draws`` keeps the
trainer's own draws: over (1, 2) they must be those of one rank.
"""

import json
import os
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from transformers4rec_tpu_torch import flagship
from transformers4rec_tpu_torch.masking import MaskedLanguageModeling, MaskingInfo
from transformers4rec_tpu_torch.model.prediction_task import LogUniformSampler
from transformers4rec_tpu_torch.ops.fused_adafactor import FusedAdafactor
from transformers4rec_tpu_torch.parallel import make_mesh
from transformers4rec_tpu_torch.trainer import T4RecTrainingArguments, Trainer

V, S, D, L, H = 32768, 8, 16, 2, 2
SMALL = dict(num_items=V, d_model=D, n_layer=L, n_head=H, seq=S)
GLOBAL_BATCH, NEG, TOP_K = 16, 64, 10
LR, CLIP = 1e-3, 0.1
# arms run on each layout; "draws" keeps the generator's masks
ARMS = {(2, 1): ("adafactor", "sampled", "sparse_adam"),
        (1, 2): ("adafactor", "streamed", "sampled", "sparse_adam", "draws"),
        (2, 2): ("adafactor", "streamed", "sampled", "sparse_adam")}
LAYOUTS = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
TIMEOUT = timedelta(seconds=90)

_original_mlm = MaskedLanguageModeling.compute_masked_targets


def content_mask(item_ids: torch.Tensor, padding_idx: int = 0):
    """The training mask of a batch as a function of each row's ids and
    positions: the same rows are masked alike in any batch."""
    pos = torch.arange(item_ids.shape[1], device=item_ids.device)[None, :]
    non_pad = item_ids != padding_idx
    mask = ((item_ids * 7 + pos * 3) % 10 < 3) & non_pad
    return torch.where(mask, item_ids, torch.full_like(item_ids, padding_idx)), mask, non_pad


def negatives(device=None) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(5).integers(1, V, NEG)).to(device)


def patch_draws():
    """Content masks in training, the fixed negatives for every draw."""
    def mlm(self, item_ids, training=False, testing=False, generator=None, segment_ids=None):
        if not training:
            return _original_mlm(self, item_ids, training, testing, generator, segment_ids)
        targets, mask, non_pad = content_mask(item_ids, self.padding_idx)
        return MaskingInfo(targets=targets, mask=mask, input_schema=mask, pad_mask=non_pad)

    MaskedLanguageModeling.compute_masked_targets = mlm
    LogUniformSampler.sample = lambda self, generator=None, device=None: negatives(
        generator.device if generator is not None else device)


def build_trainer(arm, weights, output_dir, world, mesh=None, model_axis=1):
    """The arm's trainer; per device batches of ``GLOBAL_BATCH / world``."""
    model = flagship.build_model("cpu", seed=1, dropout=0.0, **SMALL)
    model.load_state_dict(weights)
    task = model.heads[0].tasks[0]
    if arm in ("sampled", "sparse_adam"):
        task.sampled_softmax, task.max_n_samples = True, NEG
    args = T4RecTrainingArguments(
        output_dir=output_dir, learning_rate=LR, lr_scheduler_type="constant",
        max_grad_norm=CLIP, embedding_optimizer="sparse_adam" if arm == "sparse_adam"
        else "adafactor", embedding_moment_dtype="f32" if arm == "streamed" else "bf16",
        per_device_train_batch_size=GLOBAL_BATCH // world,
        per_device_eval_batch_size=GLOBAL_BATCH // world, steps_per_execution=2,
        max_sequence_length=S, seed=3, logging_steps=1, mesh_model_axis=model_axis,
        data_loader_engine="parquet")
    table_optimizer = None
    if arm == "streamed":
        def table_optimizer(tables, schedule):
            return FusedAdafactor(tables, lr=schedule, use_pallas=True, moment_dtype=None)
    return Trainer(model, args, schema=flagship.schema(V, S), device="cpu", mesh=mesh,
                   table_optimizer=table_optimizer)


def data_rows(batch, index, parts):
    """Rows ``[index·n/parts, (index+1)·n/parts)`` of a batch of n rows."""
    n = len(next(iter(batch.values())))
    return {k: v[index * n // parts:(index + 1) * n // parts] for k, v in batch.items()}


def run_arm(trainer, data, index, parts, out_dir):
    """Two steps (one group), a save, a third step; evaluation and top-k.
    Returns the record the parent compares."""
    batches = [data_rows(b, index, parts) for b in data["train"]]
    trainer._train_dataloader = batches[:2]
    trainer.args.max_steps = 2
    trainer.train()
    trainer.save(os.path.join(out_dir, "checkpoint-2"))
    trainer._train_dataloader = batches[2:]
    trainer.args.max_steps = 1
    trainer.train()
    trainer.save(os.path.join(out_dir, "checkpoint-3"))
    results = trainer.evaluate(eval_dataset=data["eval"])
    scores, ids = trainer.predict(data["eval"], top_k=TOP_K)
    return {"losses": [h["loss"] for h in trainer.state.log_history if "loss" in h],
            "eval": {k: v for k, v in results.items() if "runtime" not in k
                     and "per_second" not in k},
            "scores": scores.tolist(), "ids": ids.tolist()}


def state_rows(trainer):
    """(table rows, rows of each table optimizer state tensor) on this rank."""
    im = trainer.model.heads[0].input_module
    table = im.item_embedding_table()
    rows = {}
    if trainer._sparse is not None:
        rows.update({f"sparse.{k}": list(v.shape) for k, v in vars(trainer._sparse.state).items()
                     if torch.is_tensor(v) and v.dim()})
    opt = trainer.optimizers.get("table")
    if opt is not None and table in opt.state:
        rows.update({f"table.{k}": list(v.shape) for k, v in opt.state[table].items()
                     if torch.is_tensor(v) and v.dim()})
    return list(table.shape), rows


def differences(a, b) -> list:
    """The names of what two trainers hold differently: weights, optimizer
    and sparse-row state, pending gradients, generator, counters."""
    out = []
    sa, sb = a.model.state_dict(), b.model.state_dict()
    out += [k for k in sa if not torch.equal(sa[k], sb[k])]
    for k, opt in a.optimizers.items():
        for i, (x, y) in enumerate(zip(opt.state_dict()["state"].values(),
                                       b.optimizers[k].state_dict()["state"].values())):
            out += [f"{k}.{i}.{f}" for f in x
                    if not torch.equal(torch.as_tensor(x[f]), torch.as_tensor(y[f]))]
    if a._sparse is not None:
        out += [f"sparse.{k}" for k, v in vars(a._sparse.state).items()
                if torch.is_tensor(v) and not torch.equal(v, getattr(b._sparse.state, k))]
    ga = {n: p.grad for n, p in a.model.named_parameters() if p.grad is not None}
    gb = {n: p.grad for n, p in b.model.named_parameters() if p.grad is not None}
    out += [f"grad.{n}" for n in ga if n not in gb or not torch.equal(ga[n], gb[n])]
    if not torch.equal(a._generator.get_state(), b._generator.get_state()):
        out.append("generator")
    if (a._opt_step, a._mini_step, a.state.global_step) != \
            (b._opt_step, b._mini_step, b.state.global_step):
        out.append("counters")
    return out


def max_rel_diff(a, b) -> float:
    """The largest relative Frobenius difference of two trainers' weights."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return max(float(torch.linalg.norm(sa[k].float() - sb[k].float()))
               / max(float(torch.linalg.norm(sb[k].float())), 1e-30) for k in sa)


def checkpoint_formats(weights, data, out_dir, rank, world):
    """The sharded format against the torch format over two ranks, and a
    save part-way through an accumulation over the data axis."""
    patch_draws()
    record = {}
    root = os.path.join(out_dir, "formats")
    for arm in ("adafactor", "sparse_adam"):
        d = os.path.join(root, arm)
        trainer = build_trainer(arm, weights, d, world, make_mesh(1, 2))
        trainer._train_dataloader = data["train"][:2]
        trainer.args.max_steps = 2
        trainer.train()
        trainer.save(os.path.join(d, "torch-2"))
        trainer.args.checkpoint_format = "sharded"
        trainer.save(os.path.join(d, "sharded-2"))
        rec = record[arm] = {}
        for layout in ((2, 1), (1, 2)):
            mesh = make_mesh(*layout)
            loaded = {}
            for fmt in ("torch", "sharded"):
                loaded[fmt] = build_trainer(arm, weights, d, world, mesh)
                loaded[fmt].load(os.path.join(d, f"{fmt}-2"))
            rec[f"{layout[0]}x{layout[1]}"] = differences(loaded["torch"], loaded["sharded"])
            rec[f"{layout[0]}x{layout[1]}_table_rows"] = \
                loaded["sharded"].model.heads[0].input_module.item_embedding_table().shape[0]
        # part-way through the second update of two micro-steps each
        mesh = make_mesh(2, 1)
        batches = [data_rows(b, mesh.data_index, mesh.data)
                   for b in data["train"] + data["train"][:1]]
        unbroken = build_trainer(arm, weights, os.path.join(d, "mid"), world, mesh)
        unbroken.args.gradient_accumulation_steps = 2
        unbroken._train_dataloader = batches[:3]
        unbroken.args.max_steps = 3
        unbroken.train()
        for fmt in ("torch", "sharded"):
            unbroken.args.checkpoint_format = fmt
            unbroken.save(os.path.join(d, f"mid-{fmt}"))
        unbroken._train_dataloader = batches[3:]
        unbroken.args.max_steps = 1
        unbroken.train()
        for fmt in ("torch", "sharded"):
            resumed = build_trainer(arm, weights, os.path.join(d, "mid"), world, mesh)
            resumed.args.gradient_accumulation_steps = 2
            resumed.load(os.path.join(d, f"mid-{fmt}"))
            rec[f"mid_{fmt}_mini_step"] = resumed._mini_step
            resumed._train_dataloader = batches[3:]
            resumed.args.max_steps = 1
            resumed.train()
            rec[f"mid_{fmt}_rel_diff"] = max_rel_diff(resumed, unbroken)
            rec[f"mid_{fmt}_opt_steps"] = [resumed._opt_step, unbroken._opt_step]
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store_file, in_dir, out_dir = sys.argv[3:6]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world), rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        weights = torch.load(os.path.join(in_dir, "weights.pt"), weights_only=True)
        data = torch.load(os.path.join(in_dir, "data.pt"), weights_only=False)
        for layout in LAYOUTS[world]:
            mesh = make_mesh(*layout)
            for arm in ARMS[layout]:
                if arm == "draws":
                    MaskedLanguageModeling.compute_masked_targets = _original_mlm
                else:
                    patch_draws()
                name = f"{layout[0]}x{layout[1]}_{arm}"
                arm_dir = os.path.join(out_dir, name)
                trainer = build_trainer(arm, weights, arm_dir, world, mesh)
                record = run_arm(trainer, data, mesh.data_index, mesh.data, arm_dir)
                record["table_rows"], record["state_rows"] = state_rows(trainer)
                record["seed"] = trainer._generator.initial_seed()
                record["data_index"], record["model_index"] = mesh.data_index, mesh.model_index
                # the stripe the trainer's own loader takes from a dataset
                loader = trainer._make_loader(data["eval"], trainer.args.train_batch_size,
                                              shuffle=False)
                record["loader"] = [loader.batch_size, loader.data["item_id"][:, 0].tolist()]
                # a fresh trainer resumed from the save after step 2
                again = build_trainer(arm, weights, arm_dir, world, mesh)
                again.load(os.path.join(arm_dir, "checkpoint-2"))
                again._train_dataloader = [data_rows(data["train"][2], mesh.data_index,
                                                     mesh.data)]
                again.args.max_steps = 1
                again.train()
                again.save(os.path.join(arm_dir, "resumed"))
                with open(os.path.join(arm_dir, f"rank{rank}.json"), "w") as f:
                    json.dump(record, f)
        if world == 2:
            checkpoint_formats(weights, data, out_dir, rank, world)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
