"""Serving export walkthrough.

Counterpart of the JAX package's ``examples/serving_export.py``: train a
model → export the inference function with a top-k head (a batch-polymorphic
``torch.export`` program) → reload the artifact in a fresh "server" and
serve batched requests from it alone, with no model code.

  python -m transformers4rec_tpu_torch.examples.serving_export
  python -m transformers4rec_tpu_torch.examples.serving_export --cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact-dir",
                    default=os.path.join(tempfile.gettempdir(), "t4r_serving_artifact"))
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns the artifact's files and each served batch's top-k ids."""
    args = parse_args(argv)
    import transformers4rec_tpu_torch as tr
    from transformers4rec_tpu_torch.data.synthetic import (
        synthetic_data,
        synthetic_ecommerce_data_schema,
    )
    from transformers4rec_tpu_torch.serving import InferenceRunner, export_model
    from transformers4rec_tpu_torch.utils.examples_utils import visualize_response

    device = "cpu" if args.cpu else "cuda"
    # 1. train briefly
    schema = synthetic_ecommerce_data_schema(num_items=2000)
    im = tr.TabularSequenceFeatures.from_schema(
        schema, d_output=48, masking="mlm", aggregation="concat"
    )
    model = tr.XLNetConfig.build(48, 4, 2, 20).to_model(
        im, tr.NextItemPredictionTask(weight_tying=True), device=device
    )
    targs = tr.T4RecTrainingArguments(
        output_dir=os.path.join(tempfile.gettempdir(), "t4r_serving_train"),
        data_loader_engine="synthetic", per_device_train_batch_size=16,
        max_steps=args.steps, max_sequence_length=20,
    )
    trainer = tr.Trainer(model=model, args=targs, schema=schema, device=device)
    trainer.train()

    # 2. export: one batch-polymorphic program with the top-k head
    example = synthetic_data(schema, num_rows=4, max_session_length=20, seed=0)
    path = export_model(model, example, args.artifact_dir, top_k=args.top_k)
    files = sorted(os.listdir(path))
    print(f"exported artifact: {files}")

    # 3. "server" process: load the artifact (no model code needed) and serve
    runner = InferenceRunner(path, device=device)
    print("input schema:", runner.input_schema.column_names)
    print("output schema:", runner.output_schema.column_names)
    served = {}
    for batch_size in (1, 7, 32):
        request = synthetic_data(
            schema, num_rows=batch_size, max_session_length=20, seed=batch_size
        )
        scores, ids = runner.predict(request)
        assert ids.shape == (batch_size, args.top_k)
        served[batch_size] = ids
        print(f"served batch of {batch_size}: top-{args.top_k} ids, "
              f"e.g. {ids[0][:5].tolist()}")
    rows = visualize_response(request, (scores, ids), top_k=5)
    print("sample responses:", rows[:2])
    print("OK")
    return {"files": files, "served": served}


if __name__ == "__main__":
    main()
