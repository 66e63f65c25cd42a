"""End-to-end walkthrough: raw events → session ETL → incremental training →
evaluation → serving export → live batching daemon.

Counterpart of the JAX package's ``examples/end_to_end.py``: the NVTabular
groupby workflow is ``utils.data_utils.session_aggregator``, the Triton
ensemble is the exported ``torch.export`` program with its Categorify
mappings behind ``ServingServer``'s HTTP daemon on loopback, which takes and
returns RAW item ids.

  python -m transformers4rec_tpu_torch.examples.end_to_end
  python -m transformers4rec_tpu_torch.examples.end_to_end --cpu
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import urllib.request  # loopback only: talks to the local ServingServer daemon
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--days", type=int, default=3, help="incremental time windows")
    ap.add_argument("--steps-per-day", type=int, default=30)
    ap.add_argument("--top-k", type=int, default=10)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns each window's metrics and the daemon's raw top-k ids."""
    args = parse_args(argv)
    import numpy as np

    import transformers4rec_tpu_torch as tr
    from transformers4rec_tpu_torch.data.synthetic import (
        generate_item_interactions,
        synthetic_ecommerce_data_schema,
    )
    from transformers4rec_tpu_torch.serving import InferenceRunner, ServingServer, export_model
    from transformers4rec_tpu_torch.utils.data_utils import (
        CATEGORIFY_START_INDEX,
        add_item_first_seen_col_to_df,
        categorify,
        categorify_schema,
        remove_consecutive_interactions,
        session_aggregator,
    )

    device = "cpu" if args.cpu else "cuda"
    workdir = tempfile.mkdtemp(prefix="t4r_e2e_")
    num_items, seq = 2000, 15

    # ------------------------------------------------------------- 1. raw ETL
    # row-per-interaction events (what a clickstream log looks like)
    schema = synthetic_ecommerce_data_schema(
        num_items=num_items, num_categories=60, max_session_length=seq
    )
    raw = generate_item_interactions(12_000, schema, seed=11)
    raw["timestamp"] = np.arange(len(raw))
    raw["day"] = (raw["timestamp"] * args.days // len(raw)).astype(int)
    print(f"raw events: {len(raw)} rows, {raw['session_id'].nunique()} sessions")

    # raw catalogs have NON-contiguous ids (think REES46 product ids):
    # Categorify encodes them NVTabular-style (0=pad, 1=null, 2=OOV,
    # frequency order from 3) and the mapping rides into the serving artifact
    raw["item_id"] = raw["item_id"] * 131 + 1_000_000
    raw, category_maps = categorify(raw, ["item_id", "category"])
    schema = categorify_schema(schema, category_maps)
    print(f"categorified: {len(category_maps['item_id'])} unique raw item ids "
          f"→ contiguous [3, {2 + len(category_maps['item_id'])}]")

    raw = remove_consecutive_interactions(raw)
    raw = add_item_first_seen_col_to_df(raw)

    # per-day session aggregation → parquet (NVTabular-workflow analog)
    day_dirs = []
    for day, df_day in raw.groupby("day"):
        sessions = session_aggregator(schema, df_day, maximum_length=seq, minimum_length=2)
        d = os.path.join(workdir, f"day_{day}")
        os.makedirs(d, exist_ok=True)
        sessions.to_parquet(os.path.join(d, "data.parquet"))
        day_dirs.append(d)
        print(f"  day {day}: {len(sessions)} sessions → {d}")

    # ------------------------------------------- 2. model from the SAME schema
    input_module = tr.TabularSequenceFeatures.from_schema(
        schema, d_output=64, masking="mlm", aggregation="concat"
    )
    cfg = tr.XLNetConfig.build(d_model=64, n_head=4, n_layer=2, total_seq_length=seq)
    model = cfg.to_model(input_module, tr.NextItemPredictionTask(weight_tying=True),
                         device=device)

    targs = tr.T4RecTrainingArguments(
        output_dir=os.path.join(workdir, "out"),
        max_sequence_length=seq,
        per_device_train_batch_size=32,
        per_device_eval_batch_size=32,
        max_steps=args.steps_per_day,
        learning_rate=2e-3,
        logging_steps=10,
    )

    # ---------------------------- 3. incremental train over time windows
    # (examples_utils.fit_and_evaluate's loop: train on day d, evaluate day d+1)
    trainer = tr.Trainer(model=model, args=targs, schema=schema, device=device)
    windows = []
    for d in range(len(day_dirs) - 1):
        trainer.train_dataset = day_dirs[d]
        trainer._train_dataloader = None
        m = trainer.train()
        ev = trainer.evaluate(eval_dataset=day_dirs[d + 1])
        windows.append({"train": m, "eval": ev})
        print(
            f"window {d}: train_loss={m['train_loss']:.4f} "
            f"eval_loss={ev['eval_loss']:.4f} "
            f"recall@10={ev.get('eval_/next-item/recall_at_10', float('nan')):.4f}"
        )
        trainer.reset_lr_scheduler()

    # --------------------------------------------- 4. export + daemon serving
    artifact = os.path.join(workdir, "artifact")
    example = next(iter(trainer.get_eval_dataloader(day_dirs[-1])))
    export_model(model, example, artifact, top_k=args.top_k, categories=category_maps)
    print(f"exported artifact: {artifact} (with Categorify mappings)")

    server = ServingServer(artifact, port=0, max_batch_size=16, max_delay_ms=5.0,
                           device=device).start()
    try:
        base = f"http://{server.host}:{server.port}"
        # clients speak RAW ids: decode one encoded eval row back to raw —
        # the daemon re-encodes inputs and decodes its top-k output
        one = {}
        for k, v in example.items():
            a = np.asarray(v)[:1]
            if k in category_maps:
                m = category_maps[k]
                a = np.where(
                    a >= CATEGORIFY_START_INDEX,
                    m[np.clip(a - CATEGORIFY_START_INDEX, 0, len(m) - 1)],
                    0,
                )
            one[k] = a.tolist()
        print(f"request raw session: {[i for i in one['item_id'][0] if i]}")
        req = urllib.request.Request(
            f"{base}/v2/predict",
            data=json.dumps({"inputs": one}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        print(f"daemon top-{args.top_k} RAW item ids: {out['item_ids'][0]}")
        raw_vocab = set(category_maps["item_id"].tolist())
        assert all(i in raw_vocab or i == -1 for i in out["item_ids"][0])
        # the daemon must agree with the in-process runner on the same raw
        # request (catches any encode/decode asymmetry between the two paths)
        r_scores, r_ids = InferenceRunner(artifact, device=device).predict(one)
        assert np.allclose(np.asarray(out["item_id_scores"]), r_scores, atol=1e-5)
        assert np.array_equal(np.asarray(out["item_ids"]), r_ids)
        with urllib.request.urlopen(f"{base}/v2/health") as r:
            assert json.loads(r.read())["status"] == "ok"
    finally:
        server.stop()
    print("END-TO-END OK")
    return {"windows": windows, "item_ids": out["item_ids"][0]}


if __name__ == "__main__":
    main()
