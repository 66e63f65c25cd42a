"""Drivers of the paper's protocol.

Counterpart of ``transformers4rec_tpu/utils/examples_utils.py``:
``fit_and_evaluate`` walks the time windows that
``utils.data_utils.save_time_based_splits`` writes, training on window t
and evaluating on window t + 1; ``wipe_memory`` frees what a window leaves
behind; ``visualize_response`` formats a serving answer.
"""

from __future__ import annotations

import gc
import glob
import os
from typing import Dict, List

import numpy as np


def fit_and_evaluate(trainer, start_time_index: int, end_time_index: int, input_dir: str,
                     no_incremental_training: bool = False,
                     training_time_window_size: int = 0,
                     pad_digits: int = 0) -> Dict[str, List[float]]:
    """Train on ``input_dir/{t}/train.parquet`` and evaluate on
    ``input_dir/{t+1}/valid.parquet`` (``test.parquet`` with
    ``trainer.args.eval_on_test_set``) for t from ``start_time_index`` to
    ``end_time_index``. Returns ``{"indexed_by_time_<metric>@k": [one value
    per window]}``.

    Incremental by default: the model carries over from window to window
    and the learning-rate schedule restarts. ``no_incremental_training``
    retrains from the initial weights in each window on the last
    ``training_time_window_size`` windows of training data (0: every window
    from ``start_time_index``). ``pad_digits`` zero-pads the folder names
    ('0001')."""
    metrics: Dict[str, List[float]] = {}
    eval_file = "test.parquet" if trainer.args.eval_on_test_set else "valid.parquet"
    fmt = (lambda t: str(t).zfill(pad_digits)) if pad_digits else str
    for time_index in range(start_time_index, end_time_index + 1):
        if no_incremental_training:
            lo = (max(start_time_index, time_index - training_time_window_size + 1)
                  if training_time_window_size > 0 else start_time_index)
            train_paths = [p for t in range(lo, time_index + 1)
                           for p in glob.glob(os.path.join(input_dir, fmt(t), "train.parquet"))]
            trainer.reset_model()
        else:
            train_paths = glob.glob(os.path.join(input_dir, fmt(time_index), "train.parquet"))
        eval_paths = glob.glob(os.path.join(input_dir, fmt(time_index + 1), eval_file))

        print(f"\n***** Launch training for day {time_index}: *****")
        trainer.train_dataset = train_paths
        trainer.reset_lr_scheduler()
        trainer.train()

        trainer.eval_dataset = eval_paths
        eval_metrics = trainer.evaluate(metric_key_prefix="eval")
        print(f"\n***** Evaluation results for day {time_index + 1}:*****\n")
        for key in sorted(eval_metrics):
            if "at_" in key:
                print(f" {key.replace('_at_', '@')} = {eval_metrics[key]}")
                bucket = "indexed_by_time_" + key.replace("_at_", "@")
                metrics.setdefault(bucket, []).append(eval_metrics[key])
        wipe_memory(trainer)
    return metrics


def wipe_memory(trainer=None) -> None:
    """``trainer.wipe_memory()`` when given a trainer, else a garbage
    collection."""
    if trainer is not None and hasattr(trainer, "wipe_memory"):
        trainer.wipe_memory()
    else:
        gc.collect()


def visualize_response(batch, response, top_k: int, session_col: str = "session_id"):
    """``[{"session": id, "top_k_items": [...]}, ...]`` from a serving
    answer (``ids`` or ``(scores, ids)``)."""
    _, ids = response if isinstance(response, tuple) else (None, response)
    sessions = np.asarray(batch[session_col]) if session_col in batch else np.arange(len(ids))
    return [{"session": int(s), "top_k_items": [int(i) for i in row[:top_k]]}
            for s, row in zip(sessions, np.asarray(ids))]
