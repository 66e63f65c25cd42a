"""The flagship configuration: REES46 XLNet-MLM, as the JAX ``bench.py`` builds it.

390,000 items (table rows padded to a multiple of 8, the true vocab bounds
softmax and top-k), d_model 192, 3 layers, 16 heads, sessions of 20, a
64-wide item table tied to the output through a 192→64 projection, MLM with
``mlm_probability=0.3``. ``build_model`` is also a serving model builder:
``--model-builder transformers4rec_tpu_torch.flagship:build_model``.
``build_trainer`` adds that benchmark's optimizer settings: batches of 128,
a constant rate of 6.7e-4, AdamW with weight decay 1e-4 on the dense
weights, unfactored Adafactor with a bf16 second moment on the embedding
tables, no gradient clipping, dropout 0.1.
"""

from __future__ import annotations

from .config import XLNetConfig
from .data.synthetic import synthetic_ecommerce_data_schema
from .features import TabularSequenceFeatures
from .model import Model, NextItemPredictionTask
from .trainer import T4RecTrainingArguments, Trainer

NUM_ITEMS = 390_000
NUM_CATEGORIES = 150
D_MODEL, N_LAYER, N_HEAD = 192, 3, 16
SEQ = 20
BATCH = 128
MLM_PROBABILITY = 0.3
LEARNING_RATE = 6.7e-4
WEIGHT_DECAY = 1e-4  # optax.adamw's default, which the benchmark leaves in place


def schema(num_items: int = NUM_ITEMS, seq: int = SEQ):
    return synthetic_ecommerce_data_schema(
        num_items=num_items, num_categories=NUM_CATEGORIES, max_session_length=seq
    )


def build_model(device=None, num_items: int = NUM_ITEMS, d_model: int = D_MODEL,
                n_layer: int = N_LAYER, n_head: int = N_HEAD, seq: int = SEQ,
                seed: int = 0, top_k=None, dropout: float = 0.1) -> Model:
    """The flagship model with weights drawn from ``seed``, on ``device``
    (CUDA unless ``"cpu"``)."""
    input_module = TabularSequenceFeatures.from_schema(
        schema(num_items, seq), d_output=d_model, masking="mlm", aggregation="concat",
        masking_kwargs={"mlm_probability": MLM_PROBABILITY},
    )
    cfg = XLNetConfig.build(d_model=d_model, n_head=n_head, n_layer=n_layer,
                            total_seq_length=seq, dropout=dropout)
    model = cfg.to_model(
        input_module,
        NextItemPredictionTask(weight_tying=True),
        device=device, seed=seed,
    )
    model.top_k = top_k
    return model


def build_trainer(device=None, seed: int = 0, train_dataset=None, eval_dataset=None,
                  output_dir: str = "./t4rec_output", **model_kwargs) -> Trainer:
    """A ``Trainer`` over the flagship model with the benchmark's optimizer
    settings, on ``device`` (CUDA unless ``"cpu"``). Without a dataset it
    trains on synthetic sessions drawn from the schema. ``model_kwargs``
    (``num_items``, ``d_model``, ...) go to ``build_model``."""
    model = build_model(device, seed=seed, **model_kwargs)
    args = T4RecTrainingArguments(
        output_dir=output_dir,
        learning_rate=LEARNING_RATE, lr_scheduler_type="constant",
        weight_decay=WEIGHT_DECAY, max_grad_norm=0.0,
        embedding_optimizer="adafactor", embedding_moment_dtype="bf16",
        per_device_train_batch_size=BATCH, per_device_eval_batch_size=BATCH,
        steps_per_execution=8, max_sequence_length=model_kwargs.get("seq", SEQ), seed=seed,
    )
    data_schema = schema(model_kwargs.get("num_items", NUM_ITEMS), model_kwargs.get("seq", SEQ))
    return Trainer(model, args, schema=data_schema, train_dataset=train_dataset,
                   eval_dataset=eval_dataset, device=device)
