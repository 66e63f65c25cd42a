"""The paper's experiment script on the port.

Counterpart of the JAX tree's ``examples/paper_repro/transf_exp_main.py``,
with the same flags, names and defaults: the RecSys'21 paper's command
line builds the model from the schema, trains on each time window and
evaluates on the next (``utils.examples_utils.fit_and_evaluate``), then
predicts the top 10 of the last evaluation window's sessions and writes
``{output_dir}/results.json``.

    python -m transformers4rec_tpu_torch.paper_repro.transf_exp_main \\
        --use_synthetic --model_type xlnet --mlm --d_model 64 --n_layer 2 \\
        --n_head 4 --start_time_window_index 1 --final_time_window_index 2

runs on the CUDA card; ``--cpu`` runs on the CPU instead. Real data:
``{data_path}/{window}/train.parquet`` (+ ``valid.parquet`` /
``test.parquet``) and a schema file (``--features_schema_path``).

As in the JAX experiment script, some flags are accepted and read nowhere:
``--input_dropout``, ``--inp_merge``, ``--similarity_type``,
``--tf_out_activation`` and ``--fp16`` (the port trains in float32), with
the reference's unused ones (``--loss_type``, ``--summary_type``, ...).
``--stochastic_shared_embeddings_replacement_prob`` only switches swap
noise on: its probability is the transformation's default, 0.1.

Every ``--model_type`` of the JAX script builds: ``xlnet``, ``gpt2``,
``bert``, ``roberta``, ``electra``, ``albert``, ``longformer``,
``reformer`` and ``transfoxl``, with ``--pre_ln`` turning the BERT family's
post-LN layers and embedding LayerNorm into the pre-LN form, and ``--rtd``
(with ``--rtd_sample_from_batch``) giving ELECTRA's RTD masking.
``--pack_sessions`` and ``--pack_eval_sessions`` pack the training and
evaluation loaders' sessions several to a row. ``--sampled_softmax``
trains with ``--sampled_softmax_max_n_samples`` log-uniform negatives a
step (evaluation stays full-catalogue).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import NamedTuple

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="transformers4rec_tpu_torch paper-repro experiments")
    # data
    p.add_argument("--data_path", default=None)
    p.add_argument("--raw_interactions_path", default=None,
                   help="raw row-per-interaction parquet; runs the full ETL "
                        "(dedup → first-seen → sessionize → time splits) into "
                        "{output_dir}/time_windows before training")
    p.add_argument("--raw_day_col", default=None,
                   help="per-event 1-based window index column in the raw "
                        "frame; derived from timestamps when absent")
    p.add_argument("--categorify", action="store_true",
                   help="with --raw_interactions_path: Categorify-encode raw "
                        "categorical values (0=pad, 1=null, 2=OOV, frequency "
                        "order from 3), writing categories/unique.<col>.parquet "
                        "and an updated schema.pbtxt next to the windowed splits")
    p.add_argument("--minimum_session_length", type=int, default=2)
    p.add_argument("--feature_config", default=None, help="schema pbtxt/json path")
    p.add_argument("--features_schema_path", default=None,
                   help="alias of --feature_config (reference arg name)")
    p.add_argument("--use_synthetic", action="store_true")
    p.add_argument("--use_side_information_features", action="store_true")
    p.add_argument("--start_time_window_index", type=int, default=1)
    p.add_argument("--final_time_window_index", type=int, default=2)
    p.add_argument("--time_window_folder_pad_digits", type=int, default=0)
    p.add_argument("--no_incremental_training", action="store_true")
    # reference command-line compatibility: the script always trains and
    # evaluates
    p.add_argument("--do_train", action="store_true",
                   help="accepted for parity; this script always trains")
    p.add_argument("--do_eval", action="store_true",
                   help="accepted for parity; this script always evaluates")
    p.add_argument("--overwrite_output_dir", action="store_true",
                   help="accepted for parity; output_dir is always reusable")
    p.add_argument("--fp16", action="store_true",
                   help="accepted for parity and read nowhere: the port trains in float32")
    p.add_argument("--eval_on_test_set", action="store_true",
                   help="evaluate each window's test.parquet instead of valid.parquet")
    p.add_argument("--dataloader_drop_last", action="store_true")
    p.add_argument("--report_to", default="none")
    p.add_argument("--logging_steps", type=int, default=100)
    p.add_argument("--save_steps", type=int, default=0,
                   help="checkpoint every N steps (0 = no checkpoints)")
    p.add_argument("--data_loader_engine", default="parquet",
                   help='"merlin" accepted as an alias of "parquet"')
    p.add_argument("--session_seq_length_max", type=int, default=20)
    # model
    p.add_argument("--model_type", default="xlnet",
                   choices=["xlnet", "gpt2", "bert", "roberta", "electra",
                            "albert", "longformer", "reformer", "transfoxl"])
    p.add_argument("--d_model", type=int, default=192)
    p.add_argument("--n_layer", type=int, default=3)
    p.add_argument("--n_head", type=int, default=16)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--input_features_aggregation", default="concat",
                   choices=["concat", "elementwise_sum_multiply_item_embedding"])
    p.add_argument("--item_embedding_dim", type=int, default=None)
    p.add_argument("--embedding_dim_from_cardinality_multiplier", type=float, default=2.0)
    p.add_argument("--stochastic_shared_embeddings_replacement_prob", type=float, default=0.0)
    p.add_argument("--layer_norm_featurewise", action="store_true")
    p.add_argument("--input_dropout", type=float, default=0.0)
    p.add_argument("--layer_norm_eps", type=float, default=1e-12)
    p.add_argument("--initializer_range", type=float, default=0.01)
    p.add_argument("--hidden_act", default="gelu")
    p.add_argument("--attn_type", default=None, choices=[None, "bi", "uni"],
                   help="override attention direction (bi/uni, XLNet arg)")
    p.add_argument("--pre_ln", action="store_true",
                   help="the BERT-family archs' pre-LN variant (norm_first=True, no "
                        "embedding LayerNorm)")
    p.add_argument("--item_id_embeddings_init_std", type=float, default=None)
    p.add_argument("--other_embeddings_init_std", type=float, default=None)
    p.add_argument("--numeric_features_project_to_embedding_dim", type=int, default=0)
    p.add_argument("--numeric_features_soft_one_hot_encoding_num_embeddings",
                   type=int, default=0)
    # masking / training scheme
    p.add_argument("--masking", default=None, choices=["clm", "mlm", "plm", "rtd"],
                   help="explicit scheme; otherwise bare --mlm/--plm/--rtd "
                        "(reference style), else the arch default "
                        "(causal archs → clm, encoder archs → mlm)")
    p.add_argument("--mlm", action="store_true")
    p.add_argument("--plm", action="store_true")
    p.add_argument("--rtd", action="store_true")
    p.add_argument("--mlm_probability", type=float, default=0.3)
    p.add_argument("--plm_probability", type=float, default=0.25)
    p.add_argument("--plm_max_span_length", type=int, default=5)
    p.add_argument("--plm_permute_all", action="store_true")
    p.add_argument("--rtd_sample_from_batch", action="store_true")
    p.add_argument("--train_on_last_item_seq_only", action="store_true")
    p.add_argument("--eval_on_last_item_seq_only", action="store_true", default=True)
    # accepted for reference command-line compatibility and read nowhere
    for flag, kw in [
        ("--loss_type", dict(default="cross_entropy")),
        ("--similarity_type", dict(default="concat_mlp")),
        ("--inp_merge", dict(default="mlp")),
        ("--tf_out_activation", dict(default="tanh")),
        ("--plm_mask_input", dict(action="store_true")),
        ("--summary_type", dict(default="last")),
        ("--avg_session_length", dict(type=int, default=None)),
        ("--training_time_window_size", dict(type=int, default=0)),
        ("--validate_every", dict(type=int, default=-1)),
        ("--rtd_use_batch_interaction", dict(action="store_true")),
        ("--rtd_discriminator_loss_weight", dict(type=float, default=1.0)),
        ("--rtd_generator_loss_weight", dict(type=float, default=1.0)),
        ("--rtd_tied_generator", dict(action="store_true")),
        ("--electra_generator_hidden_size", dict(type=float, default=0.4)),
        ("--num_hidden_groups", dict(type=int, default=-1)),
        ("--inner_group_num", dict(type=int, default=1)),
    ]:
        p.add_argument(flag, **kw)
    # output layer
    p.add_argument("--mf_constrained_embeddings", action="store_true", default=True,
                   help="weight tying (reference flag name)")
    p.add_argument("--sampled_softmax", action="store_true")
    p.add_argument("--sampled_softmax_max_n_samples", type=int, default=10000)
    p.add_argument("--label_smoothing", type=float, default=0.0)
    p.add_argument("--softmax_temperature", type=float, default=1.0)
    # optimization
    p.add_argument("--per_device_train_batch_size", type=int, default=128)
    p.add_argument("--pack_sessions", action="store_true",
                   help="train-loader session packing (not a reference flag)")
    p.add_argument("--pack_eval_sessions", action="store_true",
                   help="pack the evaluation loader too (not a reference flag)")
    p.add_argument("--steps_per_execution", type=int, default=1,
                   help="K optimizer steps enqueued between host reads (not a reference flag)")
    p.add_argument("--per_device_eval_batch_size", type=int, default=32)
    p.add_argument("--learning_rate", type=float, default=6.7e-4)
    p.add_argument("--learning_rate_schedule", default="linear",
                   choices=["linear", "cosine", "constant", "constant_with_warmup",
                            # reference names: warmup comes from
                            # --learning_rate_warmup_steps
                            "linear_with_warmup", "cosine_with_warmup"])
    p.add_argument("--learning_rate_warmup_steps", type=int, default=0)
    p.add_argument("--learning_rate_num_cosine_cycles_by_epoch", type=float, default=1.25)
    p.add_argument("--num_train_epochs", type=float, default=1.0)
    p.add_argument("--max_steps", type=int, default=-1)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=42)
    # evaluation / metrics
    p.add_argument("--eval_steps", type=int, default=None)
    p.add_argument("--compute_metrics_each_n_steps", type=int, default=1)
    p.add_argument("--predict_top_k", type=int, default=100)
    p.add_argument("--log_predictions", action="store_true")
    # misc
    p.add_argument("--output_dir", default="/tmp/t4r_paper_repro")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--synthetic_num_items", type=int, default=10000)
    p.add_argument("--synthetic_rows_per_window", type=int, default=2048)
    return p


def _normal_init(std: float):
    import torch

    def init(t, generator):
        torch.nn.init.normal_(t, 0.0, std, generator=generator)

    return init


def get_model(args, schema, device=None):
    """The model the command line asks for, initialised from ``--seed``, on
    ``device`` (CUDA unless ``--cpu`` or ``device="cpu"``)."""
    from .. import NextItemPredictionTask, TabularSequenceFeatures, transformer_registry
    from ..schema import Tags

    # explicit --masking > the bare reference flags (--mlm, --plm, --rtd) >
    # the arch's default (causal archs: clm, the others: mlm)
    if args.masking is None:
        bare = [f for f in ("mlm", "plm", "rtd") if getattr(args, f, False)]
        if bare:
            args.masking = bare[0]
        elif args.model_type in ("gpt2", "transfoxl"):
            args.masking = "clm"
        else:
            args.masking = "mlm"
    masking = args.masking
    masking_kwargs = {}
    if masking == "mlm":
        masking_kwargs["mlm_probability"] = args.mlm_probability
    elif masking == "plm":
        masking_kwargs["plm_probability"] = args.plm_probability
        masking_kwargs["max_span_length"] = args.plm_max_span_length
        masking_kwargs["permute_all"] = args.plm_permute_all
    elif masking == "rtd":
        masking_kwargs["mlm_probability"] = args.mlm_probability
        masking_kwargs["sample_from_batch"] = args.rtd_sample_from_batch
    elif masking == "clm":
        masking_kwargs["train_on_last_item_seq_only"] = args.train_on_last_item_seq_only

    agg = ("elementwise-sum-item-multi"
           if args.input_features_aggregation == "elementwise_sum_multiply_item_embedding"
           else "concat")
    post = ["layer-norm"] if args.layer_norm_featurewise else []
    pre = ["stochastic-swap-noise"] if args.stochastic_shared_embeddings_replacement_prob > 0 \
        else []

    item_col = schema.item_id_column_name
    embedding_dims = {item_col: args.item_embedding_dim} if args.item_embedding_dim else None
    embeddings_initializers = None
    if args.item_id_embeddings_init_std or args.other_embeddings_init_std:
        embeddings_initializers = {}
        for col in schema.select_by_tag([Tags.CATEGORICAL]):
            std = (args.item_id_embeddings_init_std if col.name == item_col
                   else args.other_embeddings_init_std)
            if std:
                embeddings_initializers[col.name] = _normal_init(std)

    extra = {}
    if args.numeric_features_project_to_embedding_dim:
        extra["continuous_projection"] = args.numeric_features_project_to_embedding_dim
    if args.numeric_features_soft_one_hot_encoding_num_embeddings:
        extra["continuous_soft_embeddings"] = True
        extra["soft_embedding_cardinality_default"] = (
            args.numeric_features_soft_one_hot_encoding_num_embeddings)

    input_module = TabularSequenceFeatures.from_schema(
        schema, d_output=args.d_model, masking=masking, masking_kwargs=masking_kwargs,
        aggregation=agg, embedding_dims=embedding_dims,
        infer_embedding_sizes=args.item_embedding_dim is None,
        infer_embedding_sizes_multiplier=args.embedding_dim_from_cardinality_multiplier,
        embeddings_initializers=embeddings_initializers,
        pre=pre or None, post=post or None, **extra,
    )
    build_kwargs = dict(
        d_model=args.d_model, n_head=args.n_head, n_layer=args.n_layer,
        total_seq_length=args.session_seq_length_max, dropout=args.dropout,
        layer_norm_eps=args.layer_norm_eps, initializer_range=args.initializer_range,
        hidden_act=args.hidden_act,
    )
    if args.attn_type is not None:
        build_kwargs["causal"] = args.attn_type == "uni"
    if args.pre_ln:
        build_kwargs.update(norm_first=True, embed_layer_norm=False)
    cfg = transformer_registry.parse(args.model_type).build(**build_kwargs)
    task = NextItemPredictionTask(
        weight_tying=args.mf_constrained_embeddings, sampled_softmax=args.sampled_softmax,
        max_n_samples=args.sampled_softmax_max_n_samples,
        label_smoothing=args.label_smoothing, softmax_temperature=args.softmax_temperature,
    )
    if device is None:
        device = "cpu" if args.cpu else None
    return cfg.to_model(input_module, task, device=device, seed=args.seed)


def make_synthetic_windows(args, schema, base_dir):
    """Write ``{index}/train.parquet`` and ``valid.parquet`` windows of
    synthetic sessions."""
    from ..data.synthetic import generate_item_interactions, interactions_to_sessions

    for t in range(args.start_time_window_index, args.final_time_window_index + 2):
        d = os.path.join(base_dir, str(t).zfill(args.time_window_folder_pad_digits or 1))
        os.makedirs(d, exist_ok=True)
        for split, seed in (("train", t * 2), ("valid", t * 2 + 1)):
            df = generate_item_interactions(args.synthetic_rows_per_window * 4, schema, seed=seed)
            sessions = interactions_to_sessions(
                df, schema, max_session_length=args.session_seq_length_max)
            sessions.to_parquet(os.path.join(d, f"{split}.parquet"))
    return base_dir


class Run(NamedTuple):
    """What ``run`` gives back: the per-window metrics, the trainer (its
    model is the trained one) and the simulated inference's top 10."""

    results: dict
    trainer: object
    top_scores: np.ndarray
    top_ids: np.ndarray


def setup(argv=None):
    """Parse ``argv``, load or make the data and build the model and its
    trainer: ``(args, data_path, trainer)``, what ``run`` then walks the
    time windows with."""
    from ..data.synthetic import synthetic_ecommerce_data_schema
    from ..schema import Schema
    from ..trainer import T4RecTrainingArguments, Trainer

    args = build_parser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    if args.features_schema_path and not args.feature_config:
        args.feature_config = args.features_schema_path
    if args.feature_config:
        schema = Schema.load(args.feature_config)
    elif args.use_synthetic:
        schema = synthetic_ecommerce_data_schema(
            num_items=args.synthetic_num_items, max_session_length=args.session_seq_length_max)
    else:
        raise SystemExit("Provide --feature_config or --use_synthetic")

    if not args.use_side_information_features:
        # the item id alone
        schema = schema.select_by_name([schema.item_id_column_name])

    data_path = args.data_path
    if args.raw_interactions_path:
        from ..utils.data_utils import etl_interactions_to_time_splits

        data_path = etl_interactions_to_time_splits(
            args.raw_interactions_path, schema, os.path.join(args.output_dir, "time_windows"),
            num_windows=args.final_time_window_index + 1, day_col=args.raw_day_col,
            maximum_length=args.session_seq_length_max,
            minimum_length=args.minimum_session_length,
            pad_digits=args.time_window_folder_pad_digits,
            categorify_columns=True if args.categorify else None,
        )
        if args.categorify:
            # the encoded splits carry the cardinalities after encoding
            schema = Schema.load(os.path.join(data_path, "schema.pbtxt"))
    elif args.use_synthetic and data_path is None:
        data_path = os.path.join(args.output_dir, "synthetic_windows")
        make_synthetic_windows(args, schema, data_path)

    schedule = args.learning_rate_schedule
    if schedule in ("linear_with_warmup", "cosine_with_warmup"):
        schedule = schedule.replace("_with_warmup", "")
    targs = T4RecTrainingArguments(
        output_dir=args.output_dir,
        data_loader_engine=args.data_loader_engine,
        logging_steps=args.logging_steps,
        save_steps=args.save_steps or None,
        per_device_train_batch_size=args.per_device_train_batch_size,
        per_device_eval_batch_size=args.per_device_eval_batch_size,
        steps_per_execution=args.steps_per_execution,
        pack_sessions=args.pack_sessions,
        pack_eval_sessions=args.pack_eval_sessions,
        learning_rate=args.learning_rate,
        lr_scheduler_type=schedule,
        warmup_steps=args.learning_rate_warmup_steps,
        learning_rate_num_cosine_cycles_by_epoch=args.learning_rate_num_cosine_cycles_by_epoch,
        num_train_epochs=args.num_train_epochs,
        max_steps=args.max_steps,
        weight_decay=args.weight_decay,
        max_grad_norm=args.max_grad_norm,
        seed=args.seed,
        max_sequence_length=args.session_seq_length_max,
        compute_metrics_each_n_steps=args.compute_metrics_each_n_steps,
        predict_top_k=args.predict_top_k,
        log_predictions=args.log_predictions,
        eval_on_test_set=args.eval_on_test_set,
        dataloader_drop_last=args.dataloader_drop_last,
        report_to=args.report_to,
    )
    model = get_model(args, schema, device=device)
    return args, data_path, Trainer(model=model, args=targs, schema=schema, device=device)


def run(argv=None) -> Run:
    """``setup(argv)``, then walk the time windows, predict the top 10 of
    the last evaluation window's ``valid.parquet`` and write
    ``results.json``."""
    from ..utils.examples_utils import fit_and_evaluate

    args, data_path, trainer = setup(argv)
    results = fit_and_evaluate(
        trainer, args.start_time_window_index, args.final_time_window_index, data_path,
        no_incremental_training=args.no_incremental_training,
        training_time_window_size=args.training_time_window_size,
        pad_digits=args.time_window_folder_pad_digits,
    )
    print("\nIndexed-by-time metrics:")
    print(json.dumps({k: [round(float(x), 4) for x in v] for k, v in results.items()},
                     indent=2))

    # simulated inference: the top 10 of the last evaluation window's sessions
    last_eval = os.path.join(
        data_path,
        str(args.final_time_window_index + 1).zfill(args.time_window_folder_pad_digits or 1),
        "valid.parquet",
    )
    scores, ids = trainer.predict(last_eval, top_k=10)
    print(f"\nsimulated inference: predicted top-10 for {ids.shape[0]} sessions")

    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "results.json"), "w") as f:
        json.dump({k: [float(x) for x in v] for k, v in results.items()}, f)
    return Run(results, trainer, scores, ids)


def main(argv=None):
    """The command line's entry point: ``run(argv).results``."""
    return run(argv).results


if __name__ == "__main__":
    main()
