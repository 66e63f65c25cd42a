"""End-to-end session-based training walkthrough.

Counterpart of the JAX package's ``examples/getting_started.py``: synthetic
e-commerce sessions → schema-driven XLNet-MLM next-item model → train →
evaluate (NDCG/Recall/MAP@k) → top-k predict.

Usage (on the card; ``--cpu`` runs it on the CPU):
  python -m transformers4rec_tpu_torch.examples.getting_started --steps 20
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--n-layer", type=int, default=2)
    ap.add_argument("--n-head", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=16, help="per device")
    ap.add_argument("--num-items", type=int, default=5000)
    ap.add_argument("--seq-len", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--masking", default="mlm", choices=["clm", "mlm", "plm", "rtd"])
    ap.add_argument("--arch", default="xlnet")
    ap.add_argument("--output-dir",
                    default=os.path.join(tempfile.gettempdir(), "t4r_getting_started"))
    ap.add_argument("--num-rows", type=int, default=2048)
    ap.add_argument("--pack", action="store_true",
                    help="session packing for train+eval loaders (~1.8 sessions/row, exact "
                         "metrics)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns the train and eval metrics, the logged losses and the top-k
    ids' shape."""
    args = parse_args(argv)
    import transformers4rec_tpu_torch as tr
    from transformers4rec_tpu_torch.data.synthetic import synthetic_ecommerce_data_schema

    device = "cpu" if args.cpu else "cuda"
    schema = synthetic_ecommerce_data_schema(
        num_items=args.num_items, num_categories=100, max_session_length=args.seq_len
    )
    input_module = tr.TabularSequenceFeatures.from_schema(
        schema, d_output=args.d_model, masking=args.masking, aggregation="concat"
    )
    cfg = tr.transformer_registry.parse(args.arch).build(
        d_model=args.d_model, n_head=args.n_head, n_layer=args.n_layer,
        total_seq_length=args.seq_len,
    )
    model = cfg.to_model(input_module, tr.NextItemPredictionTask(weight_tying=True),
                         device=device)

    targs = tr.T4RecTrainingArguments(
        output_dir=args.output_dir,
        data_loader_engine="synthetic",
        per_device_train_batch_size=args.batch_size,
        per_device_eval_batch_size=args.batch_size,
        max_steps=args.steps,
        learning_rate=args.lr,
        logging_steps=max(args.steps // 10, 1),
        max_sequence_length=args.seq_len,
        lr_scheduler_type="linear",
        warmup_steps=max(args.steps // 20, 0),
        pack_sessions=args.pack,
        pack_eval_sessions=args.pack,
    )
    trainer = tr.Trainer(model=model, args=targs, schema=schema, device=device)

    train_metrics = trainer.train()
    print("train:", json.dumps({k: round(v, 4) for k, v in train_metrics.items()}))
    losses = [h["loss"] for h in trainer.state.log_history if "loss" in h]
    print("loss trajectory:", [round(loss, 3) for loss in losses])
    assert losses[-1] < losses[0], "training loss did not decrease"

    eval_metrics = trainer.evaluate()
    print("eval:", json.dumps({k: round(v, 4) for k, v in eval_metrics.items()}))

    scores, ids = trainer.predict(top_k=10)
    print(f"predict: top-10 ids for {ids.shape[0]} sessions, e.g. {ids[0].tolist()}")
    return {"train": train_metrics, "eval": eval_metrics, "losses": losses,
            "top_k_shape": tuple(ids.shape)}


if __name__ == "__main__":
    main()
