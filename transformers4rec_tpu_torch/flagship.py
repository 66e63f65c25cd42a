"""The flagship configurations: REES46 XLNet-MLM, as the JAX ``bench.py``
builds it, and GPT-2 with causal language modelling on long sessions.

390,000 items (table rows padded to a multiple of 8, the true vocab bounds
softmax and top-k), d_model 192, 3 layers, 16 heads, sessions of 20, a
64-wide item table tied to the output through a 192→64 projection, MLM with
``mlm_probability=0.3``. ``build_model`` is also a serving model builder:
``--model-builder transformers4rec_tpu_torch.flagship:build_model``.
``build_trainer`` adds that benchmark's optimizer settings: batches of 128,
a constant rate of 6.7e-4, AdamW with weight decay 1e-4 on the dense
weights, unfactored Adafactor with a bf16 second moment on the embedding
tables, no gradient clipping, dropout 0.1. With ``streamed_table_update``
the tables take that benchmark's other arm instead: an f32 moment and the
two-pass streamed update of the item table (``ops.fused_adafactor``).

``scheme="clm"`` gives the second configuration, as the JAX
``benchmarks/convergence_check.py --masking clm --seq-len 256 --batch 32``
builds it: the same widths and tables under GPT-2 (causal attention, learned
absolute positions) with next-item labels at every position, sessions of up
to ``LONG_SEQ`` = 256 in batches of ``LONG_BATCH`` = 32. CLM has no loss-row
budget, so the cross-entropy runs on all 8,192 positions of a batch, and
attention runs through the flash kernels (``ops.attention``).

``scheme="plm"`` gives XLNet's own training scheme on the flagship's widths
and sessions: permutation language modelling with two-stream attention,
with the JAX ``examples/paper_repro/transf_exp_main.py`` defaults
(``plm_probability`` 0.25, spans of up to 5 items, ``permute_all`` off).
PLM has no loss-row budget, so the cross-entropy takes all 2,560 positions
of a batch. ``eval_on_last_item_seq_only=False`` evaluates on every
position instead of the last item (also under MLM and CLM).

``build_large_vocab_model`` / ``build_large_vocab_trainer`` give the JAX
package's baseline configuration 4, "large-vocab stress"
(``benchmarks/run_all.py:config_large_vocab``; its ``adafactor`` arm by
default, ``embedding_optimizer="sparse_adam"`` its other arm):
XLNet-MLM over ``LARGE_VOCAB_ITEMS`` = 4,000,000 items (table rows padded
to a multiple of 8), a tied 64-wide item table, d_model 192, 3 layers, 16
heads, sessions of 20 in batches of 128, MLM p = 0.3, sampled softmax over
8,192 log-uniform negatives a step, a learning rate of 1e-3 and the
arguments' other defaults (a linear schedule, the clip at 1, Adafactor
with a bf16 moment on the tables; on the ``sparse_adam`` arm lazy Adam
with bf16 moments on the item table's touched rows only, the clip over
the dense gradients and those rows jointly). Evaluation and top-k stay
full-catalogue. ``build_multitask_model`` / ``build_multitask_trainer``
give configuration 5, "multi-task stretch" (``config_multitask``):
ELECTRA-RTD (d_model 64, 4 heads, 2 layers, sessions of 20) on the
music-streaming schema (``data.music_streaming_testing_data``) without
its targets as features, with three tasks: next-item over the tied table,
``click`` (binary) and ``play_percentage`` (regression), batches of 128.
``build_trainer(gradient_accumulation_steps=K)`` makes one update of K
batches' mean gradient (each of the K micro-steps a ``global_step``).

``arch=`` replaces a scheme's default architecture by a registry name
(``transformer_registry``: ``"albert"``, ``"longformer"``, ``"transfoxl"``,
...), as the experiment script's ``--model_type`` does: the same widths,
tables, sessions and optimizer under that arch's encoder (for example
``build_trainer(scheme="mlm", arch="longformer", seq=LONG_SEQ,
batch=LONG_BATCH)``: Longformer-MLM on sessions of 256, its local window
of 8 a (1, 1, S, S) bias of the flash kernels). ``arch="reformer"`` gives
Reformer-MLM: local and LSH layers in turn, axial positions; at
``seq=LONG_SEQ`` its LSH layers take the sorted-chunk path (chunks of 64,
10 buckets, 2 hashes) and its local layers the flash kernels with the
window's bias.

``build_trainer(pack_sessions=True, pack_eval_sessions=True)`` packs the
training and evaluation loaders' sessions several to a row
(``data.packing``). Every trainer builder takes ``mesh=`` (a
``parallel.mesh.make_mesh`` layout of ranks); ``batch`` is then per rank.
``build_trainer(embedding_table_dtype="bf16")`` and
``build_large_vocab_trainer(embedding_table_dtype="bf16")`` store the
tables as bf16 (the training arguments' field, as the JAX trainer's).
"""

from __future__ import annotations

from typing import Optional

from .config import ElectraConfig, GPT2Config, XLNetConfig, transformer_registry
from .data.synthetic import synthetic_ecommerce_data_schema
from .data.testing import music_streaming_testing_data
from .features import TabularSequenceFeatures
from .model import (
    BinaryClassificationTask,
    Head,
    Model,
    NextItemPredictionTask,
    RegressionTask,
)
from .schema import Tags
from .ops.fused_adafactor import FusedAdafactor
from .trainer import T4RecTrainingArguments, Trainer

NUM_ITEMS = 390_000
NUM_CATEGORIES = 150
D_MODEL, N_LAYER, N_HEAD = 192, 3, 16
SEQ = 20
BATCH = 128
MLM_PROBABILITY = 0.3
LEARNING_RATE = 6.7e-4
WEIGHT_DECAY = 1e-4  # optax.adamw's default, which the benchmark leaves in place
LONG_SEQ = 256
LONG_BATCH = 32
# the item table's width in the paper's XLNet-MLM command
# (examples/paper_repro/README.md: --item_embedding_dim 448, tied through
# --mf_constrained_embeddings)
PAPER_ITEM_DIM = 448
PLM_PROBABILITY, PLM_MAX_SPAN_LENGTH = 0.25, 5
# the JAX benchmark's configurations 4 and 5 (benchmarks/run_all.py)
LARGE_VOCAB_ITEMS = 4_000_000
LARGE_VOCAB_ITEM_DIM = 64
LARGE_VOCAB_NEGATIVES = 8192
BENCH_LEARNING_RATE = 1e-3
MULTITASK_D_MODEL, MULTITASK_N_HEAD, MULTITASK_N_LAYER = 64, 4, 2
# masking scheme -> (architecture, masking arguments, sessions, batch)
SCHEMES = {
    "mlm": (XLNetConfig, {"mlm_probability": MLM_PROBABILITY}, SEQ, BATCH),
    "clm": (GPT2Config, {}, LONG_SEQ, LONG_BATCH),
    "plm": (XLNetConfig, {"plm_probability": PLM_PROBABILITY,
                          "max_span_length": PLM_MAX_SPAN_LENGTH}, SEQ, BATCH),
}


def _scheme(scheme: str):
    if scheme not in SCHEMES:
        raise ValueError(f"scheme must be one of {sorted(SCHEMES)}, got {scheme!r}")
    return SCHEMES[scheme]


def schema(num_items: int = NUM_ITEMS, seq: int = SEQ):
    return synthetic_ecommerce_data_schema(
        num_items=num_items, num_categories=NUM_CATEGORIES, max_session_length=seq
    )


def build_model(device=None, num_items: int = NUM_ITEMS, d_model: int = D_MODEL,
                n_layer: int = N_LAYER, n_head: int = N_HEAD, seq=None,
                seed: int = 0, top_k=None, dropout: float = 0.1,
                vocab_parallel_group=None, scheme: str = "mlm",
                item_dim: Optional[int] = None,
                eval_on_last_item_seq_only: bool = True, arch: Optional[str] = None,
                dtype=None, remat: bool = False, pre=None) -> Model:
    """The flagship model with weights drawn from ``seed``, on ``device``
    (CUDA unless ``"cpu"``): XLNet-MLM on sessions of 20, with
    ``scheme="clm"`` GPT-2-CLM on sessions of 256, with ``scheme="plm"``
    XLNet-PLM on sessions of 20 (``seq`` overrides each length). With ``vocab_parallel_group`` (a ``torch.distributed`` process
    group) the item table is drawn whole from the seed and this rank keeps
    its rows; loss, evaluation and top-k go over the group. ``item_dim``
    sets the item table's width (the column's ``embedding_dims``; 64 by
    default), to which the output is tied through a d_model→item_dim
    projection: ``PAPER_ITEM_DIM`` is the paper's XLNet-MLM command's.
    ``arch`` names a registered architecture in place of the scheme's.
    ``dtype`` (``torch.bfloat16`` or ``torch.float16``) and ``remat`` go to
    the encoder's config: its compute type and per-layer rematerialisation.
    ``pre`` is the input module's pre transformation (``"layer-norm"``
    normalises each raw continuous column over its positions)."""
    config, masking_kwargs, default_seq, _ = _scheme(scheme)
    if arch is not None:
        config = transformer_registry.parse(arch)
    seq = default_seq if seq is None else seq
    input_module = TabularSequenceFeatures.from_schema(
        schema(num_items, seq), d_output=d_model, masking=scheme, aggregation="concat",
        masking_kwargs=dict(masking_kwargs,
                            eval_on_last_item_seq_only=eval_on_last_item_seq_only),
        embedding_dims=None if item_dim is None else {"item_id": item_dim}, pre=pre,
    )
    cfg = config.build(d_model=d_model, n_head=n_head, n_layer=n_layer,
                       total_seq_length=seq, dropout=dropout, dtype=dtype, remat=remat)
    model = cfg.to_model(
        input_module,
        NextItemPredictionTask(weight_tying=True, vocab_parallel_group=vocab_parallel_group),
        device=device, seed=seed,
    )
    model.top_k = top_k
    return model


def build_clm_model(device=None, **kwargs) -> Model:
    """``build_model(scheme="clm")``: what a server is given to rebuild the
    GPT-2-CLM configuration (``--model-builder
    transformers4rec_tpu_torch.flagship:build_clm_model``)."""
    return build_model(device, scheme="clm", **kwargs)


def build_plm_model(device=None, **kwargs) -> Model:
    """``build_model(scheme="plm")``: what a server is given to rebuild the
    XLNet-PLM configuration (``--model-builder
    transformers4rec_tpu_torch.flagship:build_plm_model``).
    Inference under PLM hides the last item from every query and scores at
    the last position through the query stream, as the JAX package does."""
    return build_model(device, scheme="plm", **kwargs)


def build_trainer(device=None, seed: int = 0, train_dataset=None, eval_dataset=None,
                  output_dir: str = "./t4rec_output", streamed_table_update: bool = False,
                  scheme: str = "mlm", batch=None, pack_sessions: bool = False,
                  pack_eval_sessions: bool = False, gradient_accumulation_steps: int = 1,
                  embedding_table_dtype: Optional[str] = None, mesh=None,
                  **model_kwargs) -> Trainer:
    """A ``Trainer`` over the flagship model with the benchmark's optimizer
    settings, on ``device`` (CUDA unless ``"cpu"``). Without a
    ``train_dataset`` it trains, evaluates and predicts on synthetic
    sessions drawn from the schema (``data_loader_engine="synthetic"``).
    ``streamed_table_update`` gives the tables an f32 moment and the item
    table the two-pass streamed update. ``scheme`` picks the configuration
    (and its batch size, which ``batch`` overrides). ``pack_sessions`` and
    ``pack_eval_sessions`` pack the loaders' sessions;
    ``gradient_accumulation_steps`` averages that many batches' gradients
    into one update; ``embedding_table_dtype="bf16"`` stores the tables as
    bf16. ``model_kwargs``
    (``num_items``, ``d_model``, ``seq``, ``arch``, ``dtype``, ``remat``, ...)
    go to ``build_model``."""
    _, _, default_seq, default_batch = _scheme(scheme)
    seq = model_kwargs.get("seq") or default_seq
    batch = default_batch if batch is None else batch
    model = build_model(device, seed=seed, scheme=scheme, **model_kwargs)
    args = T4RecTrainingArguments(
        output_dir=output_dir,
        learning_rate=LEARNING_RATE, lr_scheduler_type="constant",
        weight_decay=WEIGHT_DECAY, max_grad_norm=0.0,
        embedding_optimizer="adafactor",
        embedding_moment_dtype="f32" if streamed_table_update else "bf16",
        per_device_train_batch_size=batch, per_device_eval_batch_size=batch,
        steps_per_execution=8, max_sequence_length=seq, seed=seed,
        data_loader_engine="synthetic" if train_dataset is None else "parquet",
        pack_sessions=pack_sessions, pack_eval_sessions=pack_eval_sessions,
        gradient_accumulation_steps=gradient_accumulation_steps,
        embedding_table_dtype=embedding_table_dtype,
    )
    data_schema = schema(model_kwargs.get("num_items", NUM_ITEMS), seq)
    table_optimizer = None
    if streamed_table_update:
        def table_optimizer(tables, schedule):
            return FusedAdafactor(tables, lr=schedule, use_pallas=True, moment_dtype=None)
    return Trainer(model, args, schema=data_schema, train_dataset=train_dataset,
                   eval_dataset=eval_dataset, device=device, table_optimizer=table_optimizer,
                   mesh=mesh)


def build_large_vocab_model(device=None, num_items: int = LARGE_VOCAB_ITEMS,
                            d_model: int = D_MODEL, n_layer: int = N_LAYER,
                            n_head: int = N_HEAD, seed: int = 0, top_k=None,
                            dropout: float = 0.1,
                            max_n_samples: int = LARGE_VOCAB_NEGATIVES) -> Model:
    """Configuration 4's model: XLNet-MLM with sampled softmax over a tied
    ``LARGE_VOCAB_ITEM_DIM``-wide table of ``num_items`` items."""
    input_module = TabularSequenceFeatures.from_schema(
        schema(num_items, SEQ), d_output=d_model, masking="mlm", aggregation="concat",
        masking_kwargs={"mlm_probability": MLM_PROBABILITY},
        embedding_dims={"item_id": LARGE_VOCAB_ITEM_DIM},
    )
    cfg = XLNetConfig.build(d_model=d_model, n_head=n_head, n_layer=n_layer,
                            total_seq_length=SEQ, dropout=dropout)
    model = cfg.to_model(
        input_module,
        NextItemPredictionTask(weight_tying=True, sampled_softmax=True,
                               max_n_samples=max_n_samples),
        device=device, seed=seed,
    )
    model.top_k = top_k
    return model


def build_multitask_model(device=None, d_model: int = MULTITASK_D_MODEL,
                          n_layer: int = MULTITASK_N_LAYER, n_head: int = MULTITASK_N_HEAD,
                          seed: int = 0, top_k=None, dropout: float = 0.1) -> Model:
    """Configuration 5's model: ELECTRA-RTD with next-item, ``click`` and
    ``play_percentage`` tasks on the music-streaming schema."""
    features = music_streaming_testing_data.schema.remove_by_tag(Tags.TARGET)
    input_module = TabularSequenceFeatures.from_schema(
        features, d_output=d_model, masking="rtd", aggregation="concat")
    cfg = ElectraConfig.build(d_model=d_model, n_head=n_head, n_layer=n_layer,
                              total_seq_length=SEQ, dropout=dropout)
    head = Head.from_body(
        input_module=input_module, transformer=cfg,
        tasks=[NextItemPredictionTask(weight_tying=True),
               BinaryClassificationTask(task_name="click", target_name="click"),
               RegressionTask(task_name="play_percentage", target_name="play_percentage")])
    model = Model(heads=(head,), device=device, seed=seed)
    model.top_k = top_k
    return model


def _bench_trainer(model: Model, data_schema, device, seed: int, train_dataset,
                   eval_dataset, output_dir: str, batch: int, mesh=None,
                   **arg_kwargs) -> Trainer:
    """A ``Trainer`` as the JAX benchmark's ``_make_trainer`` sets one up: a
    learning rate of 1e-3, batches of ``batch``, sessions of 20, the
    arguments' other defaults (``arg_kwargs`` set others, as the benchmark's
    ``**kw``); on synthetic sessions without a dataset."""
    args = T4RecTrainingArguments(
        output_dir=output_dir, learning_rate=BENCH_LEARNING_RATE,
        per_device_train_batch_size=batch, per_device_eval_batch_size=batch,
        max_sequence_length=SEQ, seed=seed,
        data_loader_engine="synthetic" if train_dataset is None else "parquet",
        **arg_kwargs,
    )
    return Trainer(model, args, schema=data_schema, train_dataset=train_dataset,
                   eval_dataset=eval_dataset, device=device, mesh=mesh)


def build_large_vocab_trainer(device=None, seed: int = 0, train_dataset=None,
                              eval_dataset=None, output_dir: str = "./t4rec_output",
                              batch: int = BATCH, embedding_optimizer: str = "adafactor",
                              embedding_table_dtype: Optional[str] = None, mesh=None,
                              **model_kwargs) -> Trainer:
    """Configuration 4: its ``adafactor`` arm, or with
    ``embedding_optimizer="sparse_adam"`` its other (``"sparse_adafactor"``
    too); ``embedding_table_dtype="bf16"`` stores the tables as bf16.
    ``model_kwargs`` go to ``build_large_vocab_model``."""
    model = build_large_vocab_model(device, seed=seed, **model_kwargs)
    data_schema = schema(model_kwargs.get("num_items", LARGE_VOCAB_ITEMS), SEQ)
    return _bench_trainer(model, data_schema, device, seed, train_dataset, eval_dataset,
                          output_dir, batch, mesh=mesh,
                          embedding_optimizer=embedding_optimizer,
                          embedding_table_dtype=embedding_table_dtype)


def build_multitask_trainer(device=None, seed: int = 0, train_dataset=None,
                            eval_dataset=None, output_dir: str = "./t4rec_output",
                            batch: int = BATCH, mesh=None, **model_kwargs) -> Trainer:
    """Configuration 5; the loaders read the whole music-streaming schema,
    targets included. ``model_kwargs`` go to ``build_multitask_model``."""
    model = build_multitask_model(device, seed=seed, **model_kwargs)
    return _bench_trainer(model, music_streaming_testing_data.schema, device, seed,
                          train_dataset, eval_dataset, output_dir, batch, mesh=mesh)
