#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and
nothing else: every kernel is built from ``transformers4rec_tpu_torch/csrc``.

Phases, in order; any failure ends the run with a non-zero exit code:

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build every kernel (one ``nvcc`` per source, all started together);
3. hold K3 (``ce_rank``, the fused CE-and-rank pass) against its plain
   PyTorch version at the evaluation shape of the flagship model (four
   draws, one per evaluation batch), at an edge shape and at the
   every-position evaluation's 2,560 and 8,192 rows; hold K1
   (``ce_fwd``) and K2 (``ce_bwd``), the training cross-entropy's forward and
   backward, against theirs at the training shape (915 loss rows, about 30%
   of them with weight 0) and at an edge shape (label smoothing, labels of
   -1, an explicit eps/V), and K1, K2 and K3 with labels on the table's
   padding rows; hold K4 (``rank``, the count of logits above a given label
   logit) against its plain version at the evaluation shape and at an edge
   shape (labels of -1, a vocab bound far below the rows), and K1 + K4
   (``fused_label_rank``) against K3's ranks; hold K7a and K7b
   (``adafactor_a``, ``adafactor_b``, the streamed Adafactor table update)
   against theirs over three steps at the item table's shape and at an edge
   shape (a size off every vector width, the clip on and off), with the
   same bits on a second call; cut the table into two shards in one
   process, run K1, K2 and K4 per shard with per-shard bounds, merge, and
   hold loss, ranks, dx and dW against the unsharded K1, K2 and K3; hold K5
   (``flash_fwd``) and K6a, K6b, K6c (``flash_bwd_fused``, ``flash_bwd_dq``,
   ``flash_bwd_dkv``) against their plain versions at the long-session
   shape (32, 256, 16, 12) causal with ragged padding, at an edge shape
   (S = 333, Dh = 32, a (1, H, S, S) bias, a session wholly padded,
   non-causal), at (4, 2048, 8, 64) causal and at (4, 4096, 16, 12) causal
   with ragged padding, the shape of phase 11 and the only one at which a
   main path launches K6b and K6c, and at (32, 256, 16, 12) with the (B, H,
   S, S) bias of XLNet-PLM's query stream (perm mask plus relative bias,
   rows and key tiles blocked by the bias alone), and at (32, 256, 16, 12)
   with Longformer's local-window bias (non-causal) and TransfoXL's
   (1, H, S, S) relative bias (causal), with the same bits on a
   second call,
   K6a against K6b + K6c and, at head dims up to 32, the streamed K6b
   against the mma.sync body it replaces (the same bits); K1 and K2 at the
   long-session training shapes of 8,192 and 16,384 loss rows (every K1
   and K2 check also asks each kernel a second time for the same bits);
   and K1, K2, K3 and K4 on item
   tables wider than the narrow kernels hold (E = 192, 448, 1,000; label
   smoothing on and off; the same bits twice), with labels on padding rows
   and on two shards at E = 448;
4. evaluate: the REES46 XLNet-MLM model at full width (390,000 items,
   d_model 192, 3 layers, 16 heads, sessions of 20, weights from a seed)
   runs ``Model.evaluate`` over 4 synthetic batches of 128 sessions; K3 must
   launch once per batch, and the result must agree with an evaluation of
   the same weights on the CPU (which takes the plain version);
5. serve: ``export_model`` writes the artifact, ``ServingServer`` answers 8
   HTTP requests of ragged sessions (6 of them at once, so the batcher
   coalesces), and the answers must match ``InferenceRunner.predict``;
6. one training step of the same model and weights on the card and on the
   CPU, with the same injected mask and dropout off: the loss and the
   gradients of the item table and of the output projection must agree;
7. the vocab-parallel head: a process group of one rank on the card,
   ``flagship.build_model(vocab_parallel_group=...)`` with the same weights;
   ``Model.evaluate`` on the 4 batches (K1 and K4 once per batch, metrics
   equal to the unsharded evaluation), one training step (K1 and K2, the
   loss equal to the unsharded step's) and the top-k of 8 sessions (ids
   equal to the unsharded f32 top-k);
8. train: ``flagship.build_trainer`` takes 16 optimizer steps (two groups of
   ``steps_per_execution = 8``) on 16 synthetic batches of 128 sessions with
   dropout 0.1, then 32 more on one repeated batch; K1 and K2 must launch
   once per step, every loss read must be finite, the repeated batch's loss
   must fall, and the item table and its bf16 moment must have moved;
9. the streamed table update: the same run with
   ``build_trainer(streamed_table_update=True)``; K7a and K7b must also
   launch once per step and the moment is f32; and one step of it is held
   against one step of the plain f32-moment arm from the same weights, mask
   and dropout;
9a. Q, the README's entry path from Parquet files at full width: the
    port's ETL writes three daily windows of sessions (ids up to 390,000);
    ``flagship.build_trainer`` with ``data_loader_engine="parquet"`` trains
    8 steps from window 1's ``train.parquet`` (twice), and the same rows as
    an in-memory dict give the same losses; ``evaluate``, ``predict`` and
    ``log_predictions`` on window 2's ``valid.parquet`` (a tail of fewer
    than 128 sessions) against the CPU; an evaluation and a save every 4
    steps with ``save_total_limit=1`` and ``load_best_model_at_end`` keep
    the expected checkpoints, and a run resumed from ``checkpoint-4`` gives
    the unbroken run's last 4 losses; 8 steps under ``"parquet_streaming"``;
    ``fit_and_evaluate`` over windows 1 and 2; 3 steps of ``Model.fit``.
    K1 and K2 must launch once a step, K3 once an evaluation batch; the
    loaders' host time per batch is printed with the step times;
9b. the paper's tied width: the same XLNet-MLM with a 448-wide item table
    (``flagship.build_model(item_dim=448)``): ``Model.evaluate`` on one
    batch and one training step, each against the CPU, then 8 trainer
    steps (the wide kernels of K1, K2 and K3);
9b'. R, the paper's command line through the port's experiment script
    (``paper_repro.transf_exp_main``): R1 runs the README's headline
    XLNet-MLM command verbatim but for its paths (390,000 items, d_model
    192, a tied 448-wide item table, 3 layers, 16 heads, batches of 128 of
    20, swap noise and the per-feature LayerNorm, 5 epochs of windows 1 and
    2 of synthetic REES46 sessions read from Parquet, evaluation on the
    next window, the top 10 of window 3); R1b holds one training step of
    the trained model (the same mask and swap-noise draw on both) and one
    evaluation batch against the CPU; R2 trains the side-feature model
    (d_model 448, 2 layers, 8 heads, three categorical and seven
    continuous columns) for 8 steps once per numeric encoding (soft one-hot,
    projection) and holds its evaluation against the CPU. K1 and K2 launch
    once a step, K3 once an evaluation batch; ``[paper]`` lines give the
    step times;
9b''. S, the BERT family, ELECTRA's RTD scheme and TransfoXL at the same
    width through the same script (``run_paper_archs``): S1 the headline
    command as ALBERT-MLM (``--model_type albert --mlm_probability 0.6``,
    two windows), S2 as TransfoXL-CLM (without ``--attn_type bi --mlm``,
    one window), S3 as ELECTRA-RTD (``--rtd``, 8 steps); after each, one
    training step of the trained model against the CPU (the loss within
    1e-5, ALBERT's shared layer against the sum of its three uses); S4
    Longformer-MLM and TransfoXL-CLM at batch 32 of up to 256
    (``flagship.build_trainer(scheme=, arch=)``: K5 and K6a with the local
    window's bias, K5 with the relative bias), 8 steps and one evaluation
    batch each;
9b'''. T, the JAX benchmark's configurations 4 and 5 at full width: T1
    ``flagship.build_large_vocab_trainer`` (XLNet-MLM over 4,000,000 items,
    sampled softmax over 8,192 log-uniform negatives) takes a cold step,
    8 timed steps and a window under ``torch.profiler`` (the device's busy
    share, the memory peak), then one training step card against CPU with
    one mask and one draw of negatives, ``Model.evaluate`` over 2 batches
    (K3 at V = 4,000,001, held against its plain version and timed at that
    shape) and the top-k of 24 sessions, each against the CPU; T2
    ``flagship.build_multitask_trainer`` (ELECTRA-RTD with next-item,
    ``click`` and ``play_percentage`` tasks) trains 1 + 8 steps from
    Parquet files of the music-streaming fixture (K1 and K2 once a step),
    ``Trainer.evaluate`` (K3 once a batch) and one training step against
    the CPU, and the HTTP server's top-k of the next-item task;
9b'''w. W, the sparse table step and gradient accumulation at full width:
    W1 configuration 4's ``sparse_adam`` arm
    (``flagship.build_large_vocab_trainer(embedding_optimizer="sparse_adam")``:
    the item table's touched rows gathered outside autograd, lazy Adam on
    them with bf16 moments) takes a cold step, 8 timed steps and a profiled
    window (ms a step beside T1's ``adafactor`` arm, the busy share, the
    memory peak and each step's growth, below one (V, 64) float32 tensor),
    the item table never holding a gradient; one step of the trained
    weights and rows' state and 3 steps of ``sparse_adafactor``, card
    against CPU with one mask and one draw of negatives each (losses, the
    touched rows, their moments and the dense weights; untouched rows bit
    for bit); ``gradient_accumulation_steps=2`` against one update from
    the mean gradient written out; ``Model.evaluate`` (K3 at V =
    4,000,001) against the CPU. W2 the flagship XLNet-MLM at K = 2
    (``build_trainer(gradient_accumulation_steps=2)``): 2 + 8 micro-steps
    (K1 and K2 twice an update), one update against the mean gradient's,
    and 3 steps of ``lazy_adam`` leaving every row with a zero gradient
    bit for bit as it was;
9b'''x. X, the tables stored as bf16 (``embedding_table_dtype="bf16"``,
    ``run_bf16_tables``): first every kernel's bf16 form against its plain
    version (K1-K4 also against the f32 kernels on the same values, whose
    bits they must give, dW that sum rounded once to bf16) at the phase's
    shapes and at edge shapes (labels on padding rows, ``vocab_size`` 0, a
    ragged V, E = 64, 132, 192 and 448, K3 at 4,000,001 items; K7a and K7b
    over three steps); X1 the flagship through ``build_trainer`` with f32
    and with bf16 tables in turns (a warm group, 16 timed steps and a
    profiled window each: wall and device time, busy share, peak memory,
    side by side), then on the bf16 tables ``Model.evaluate`` and one
    optimizer step against the CPU (the loss, the dense weights' and the
    tables' steps, the moments), a save and a load into a trainer made
    without the field (bf16, the same bits), an export and 8 served
    requests; X2 the streamed update (K7a/K7b in bf16), X3 the paper's tied
    E = 448 (K1, K2 and K3 wide on bf16 images) with one evaluation batch
    against the CPU, X4 configuration 4's ``sparse_adam`` arm at 4,000,001
    items with one evaluation batch against the CPU, X5 the vocab-parallel
    head on a bf16 shard of a one-rank group (K1, K2, K4). The ``kernels``
    line lists each form as its own entry (``ce_fwd_bf16``, ...);
9b''''. U, session packing at full width (``run_packing``): U1 the flagship
    XLNet-MLM from Parquet files of the port's ETL through
    ``flagship.build_trainer(pack_sessions=True, pack_eval_sessions=True)``:
    the fill and sessions a row (``packing_stats``), the loader's host ms
    per batch packed and unpacked, a cold step and 8 timed steps of each
    arm (ms a step, sessions/s, a profiled window's busy share), one packed
    step against the CPU, packed ``Trainer.evaluate`` (K3 at 1,280 rows a
    batch) against the unpacked evaluation of the same weights and the
    CPU's; U2 GPT-2-CLM at batch 32 of rows of 256 packed from sessions of
    2 to 20 items (K5 and K6a with the (32, 1, 256, 256) block-diagonal
    bias, 3 times a step): a cold and 8 timed steps, one step at batch 4
    against the CPU (GPT-2's positions restart per segment), packed
    evaluation of one batch (K3 at 4,096 rows) against the CPU and against
    the same sessions unpacked;
9b'''''. V, Reformer and a recurrent body (``run_reformer_rnn``): V1 the
    headline command through the experiment script with ``--model_type
    reformer`` (local, LSH, local layers, axial positions; S = 20, the LSH
    layer's dense form), a cold and 8 timed steps, the protocol over one
    window and one step against the CPU; V2 Reformer-MLM at batch 32 of up
    to 256 (``build_trainer(arch="reformer", seq=256)``: the sorted LSH
    path, chunks of 64, 10 buckets, 2 hashes; K5 and K6a with the window's
    bias in the local layers): a cold and 8 timed steps, one step at batch
    4 against the CPU with the same weights and rotation buffers (the LSH
    layer's bucket flips between the devices counted, each a near tie),
    one evaluation batch against the CPU; V3 the GRU body
    (``build_gru_model``: ``MLPBlock`` → ``RNNBlock(192, "gru", 2)`` → the
    tied task, CLM, batch 128 of 20): a cold and 8 timed steps, one step,
    ``Model.evaluate`` and the served top-k, each against the CPU;
9c. P1, XLNet-PLM at full width (``flagship.build_model(scheme="plm")``:
    permutation language modelling, two-stream attention, sessions of 20):
    ``Model.evaluate`` over the 4 batches on the last item (K3 at 128 rows)
    and on every position (K3 at 2,560 rows), each against the CPU; one
    every-position batch with dense logits (``use_fused_ops=False``)
    against the fused pass; the top-k of 8 ragged sessions through the
    exported artifact against the CPU's; one training step card against CPU
    with the same perm mask (K1, K2 at 2,560 rows); and
    ``flagship.build_trainer(scheme="plm")`` for 8 + 16 steps;
10. GPT-2-CLM at full width on sessions of up to 256
    (``flagship.build_model(scheme="clm")``): ``Model.evaluate`` over 4
    batches of 32 sessions against the same weights on the CPU (K5 three
    times and K3 once per batch), the top-k of 8 ragged sessions through the
    exported artifact against the CPU's, one training step card against CPU
    at batch 4, and ``flagship.build_trainer(scheme="clm")`` for 8 + 16
    steps at batch 32 with dropout 0.1 (K5 and K6a three times a step, K1
    and K2 once; finite losses, the repeated batch's loss falling);
10b. P2, XLNet-PLM on sessions of up to 256: one every-position
    evaluation batch of 32 sessions (K5 twice a layer with a (B, H, S, S)
    bias, K3 at 8,192 rows) and one training step at batch 4, each against
    the CPU, then 8 trainer steps at batch 32 (K1 and K2 at 8,192 rows; the
    attention's backward is the dense one that yields the relative bias's
    gradient);
11. one cold training step of the one-layer model on 4 sessions of up to
    4,096 items through the same entry points, then 8 steady ones, timed:
    K6b and K6c launch once a step and K6a not at all (its dq partials would
    pass the cap);
12. time K3 and K4 at the evaluation shape, K1 and K2 at the three training
    shapes (915, 8,192 and 16,384 loss rows), all four again at E = 448 (K1
    and K2 at 915 and 8,192 rows), K7a and K7b at the item table's shape
    and K5, K6a, K6b, K6c at the shapes of phases 10 and 11 and at
    (4, 2048, 8, 64), K5 and K6a in both their designs (``mma.sync`` and
    ``wgmma``), K6b and K6c in both theirs (``mma.sync`` and streamed) and
    the split route K6b + K6c beside K6a, each beside its plain version and,
    where there is one, a library yardstick (CUDA events, median after warm-up; at 8,192 rows and
    more the cross-entropy's yardstick runs 1,024 rows at a time), and a
    whole table-optimizer step on each of its arms; K3 at 2,560 and 8,192
    rows, K5 with XLNet-PLM's bias, K5 and K6a with Longformer's, K5 and
    K6a with packed rows' block-diagonal bias, K3 at packed evaluation's
    1,280 and 4,096 rows.

The XLNet-MLM and -PLM paths (sessions of 20 and 21) must launch no flash
kernel.

The second-to-last line of standard output is one JSON object with a
``kernels`` list: each kernel's error, time and bound at the shape at which a
main path launches it (K5 and K6a at phase 10's, K6b and K6c at phase 11's),
and under ``also_at`` its times at other shapes, each marked ``main_path``:
true where a main path launches it there, false where only this script
does; the last is ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --profile-train [FILE]`` runs none of the above: it
trains the flagship model for a few groups of steps under ``torch.profiler``
and prints where a steady step's time goes (device time by kernel, the
device's busy share of the wall time, the first step's cost); the table
also goes to FILE when one is named. ``--profile-train-streamed [FILE]``
does the same with the streamed table update, ``--profile-train-clm [FILE]``
with GPT-2-CLM on batches of 32 sessions of up to 256 (the path on which
K1 and K2 take most of the device's time), ``--profile-train-plm [FILE]``
with XLNet-PLM on the same batches; ``--profile-train-arch NAME [FILE]``
does it for phase S's command line of ``albert`` (S1), ``transfoxl`` (S2)
or ``electra`` (S3), built by the experiment script and trained from a
Parquet window. ``--time-ce`` checks and times
K3 alone at the evaluation shape at E = 64, 128 and 256 (with its ring's
depth and, from ``torch.profiler``, the device time of each of its two
kernels) and K1 and K2 alone at the three training shapes, ``--time-flash``
K5, K6a, K6b and K6c alone in both their designs, and the split route
K6b + K6c beside K6a, at the CLM shape, at the S = 4,096 step's, at
(4, 2048, 8, 64) and where the designs meet (head dims 32, 48 and 128).
``--time-bf16`` times each vocabulary kernel and K7a/K7b in its form for a
bf16-stored table beside its f32 form, in turns, at the shapes of the
kernel table in ``PERF.md``.
``--time-long-step`` times the steady S = 4,096 step with K6b in each of
its designs in turns and profiles it (device time by kernel).
``--time-parquet`` times the flagship's training step from a Parquet file
against the same rows in memory, in turns, with the host time of the
file's decode, the loader's yield and the batch's copy, and profiles each
arm (device time per step and busy share).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# the card's published rates (NVIDIA H100 SXM data sheet): HBM3 bytes/s and
# dense bf16 tensor-core FLOP/s, for the least time a kernel could take; the
# special-function units give 16 results a clock on each SM (NVIDIA's CUDA C++
# programming manual, throughput of arithmetic instructions, compute
# capability 9.0), on 132 SMs at the 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12  # float32 outside the tensor cores
SFU_OPS_PER_S = 16 * 132 * 1.98e9

EVAL_BATCHES, EVAL_ROWS = 4, 128
# K3's rows in every-position evaluation of XLNet-PLM: 128 sessions of 20
# (main path P1) and 32 of 256 (P2)
PLM_EVAL_ROWS, PLM_LONG_EVAL_ROWS = 128 * 20, 32 * 256
# K3's rows in packed evaluation: at most S // 2 targets in each packed row,
# 128 rows of 20 (main path U1) and 32 of 256 (U2)
PACKED_EVAL_ROWS, PACKED_LONG_EVAL_ROWS = 128 * (20 // 2), 32 * (256 // 2)
TOP_K = 20
LONG_STEP_BATCH, LONG_STEP_SEQ = 4, 4096  # main path 7
LONG_STEP_STEADY = 8  # its steady steps after the cold one
TIMING_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
TRAIN_STEPS, REPEAT_STEPS = 16, 32


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def import_port():
    """The port from this checkout, never an installed copy."""
    sys.path.insert(0, HERE)
    try:
        import transformers4rec_tpu_torch as ttr
    except ImportError as e:
        fail(f"cannot import transformers4rec_tpu_torch next to this script: {e}")
    if not os.path.abspath(ttr.__file__).startswith(HERE + os.sep):
        fail(f"transformers4rec_tpu_torch was imported from {ttr.__file__}, not from {HERE}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        fail("nvidia-smi listed no card")
    return out[0].strip()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of one call of ``fn``, from CUDA events around each
    call. A sleep kernel keeps the card busy while the host enqueues all the
    calls, so the events time the device's work and not the host's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(200_000_000)  # about 0.1 s of clock cycles
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def kernel_us(fn, reps: int = 20) -> dict:
    """Device microseconds per call of ``fn``, by kernel name, from
    ``torch.profiler`` over ``reps`` calls after a warm-up: which of a
    wrapper's kernels takes the time (K3's partial kernel against its
    merge)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if total:
            out[ev.key] = total / reps
    return out


# ----------------------------------------------------------------- K3 check
def ce_rank_inputs(n: int, rows: int, vocab_size: int, e: int, beta_lo: float,
                   beta_hi: float, seed: int, device, table_dtype=torch.float32):
    """x (n, e), a (rows, e) table drawn like the model's (normal, std 0.05),
    stored as ``table_dtype`` (f32, or bf16 as a bf16-stored table), and
    labels in [1, vocab_size). Row i of x is ``beta_i * W[label_i] + N(0,
    1)``: with beta_i up to 12 the label logit sits in the upper tail of its
    row, as a trained model's does."""
    rng = np.random.default_rng(seed)
    W = rng.normal(0.0, 0.05, (rows, e)).astype(np.float32)
    labels = rng.integers(1, vocab_size, n).astype(np.int32)
    beta = rng.uniform(beta_lo, beta_hi, (n, 1)).astype(np.float32)
    x = (beta * W[labels] + rng.normal(0.0, 1.0, (n, e))).astype(np.float32)
    return (torch.from_numpy(x).to(device), torch.from_numpy(W).to(device).to(table_dtype),
            torch.from_numpy(labels).to(device))


def near_ties(x, W, labels, ll, vocab_size: int, rows: torch.Tensor) -> torch.Tensor:
    """For each of ``rows``, the logits other than the label's own that two
    summation orders may put on either side of the label logit: a float32
    sum of E products of the bf16-rounded operands (as K3 and its plain
    version take them) is within E·2⁻²⁴·Σ|x_e·w_e| of the exact sum in any
    order, so the two devices can disagree only where the plain logit lies
    within three such bounds of ``ll`` (both sums' errors and the plain
    one's own)."""
    xb = x[rows].to(torch.bfloat16).float()
    gamma = 3.0 * x.shape[1] * 2.0 ** -24
    count = torch.zeros(len(rows), dtype=torch.int64, device=x.device)
    for c0 in range(0, vocab_size, 1 << 20):
        c1 = min(c0 + (1 << 20), vocab_size)
        wb = W[c0:c1].to(torch.bfloat16).float()
        tol = gamma * (xb.abs() @ wb.abs().T)
        col = torch.arange(c0, c1, device=x.device)
        near = ((xb @ wb.T - ll[rows, None]).abs() <= tol) \
            & (col[None, :] != labels[rows, None].long())
        count += near.sum(-1)
    return count


def check_ce_rank(name: str, n: int, rows: int, vocab_size: int, smooth: bool,
                  beta_lo: float, beta_hi: float, seeds, device="cuda", e: int = 64,
                  min_exact: float = 0.99, table_dtype=torch.float32) -> dict:
    """K3 against ``ce_rank_plain`` on the same inputs, one call per seed.

    Criteria: lse within 1e-4 relative; zsum within 1e-4 of
    max(|zsum|, sqrt(V)), since it is a sum of V logits of both signs whose
    rounding grows with sqrt(V), not with |zsum|; ranks exact on at least
    ``min_exact`` (99%) of the rows of all calls and within 2 on every row,
    and every rank that differs differs by no more than the row's near ties
    (``near_ties``). The kernel's tensor cores sum each logit in another
    order than the plain version's matrix product, so a logit within an ulp
    of the label logit may land on the other side of it; the more columns,
    the more such logits (at 4,000,001 columns about 4% of the rows hold
    one, against under 1% at 390,001). ``table_dtype`` bf16 checks K3's
    form for a bf16-stored table."""
    from transformers4rec_tpu_torch.ops import vocab

    lse_abs, lse_rel, zs_err, diffs, ranks = 0.0, 0.0, 0.0, [], []
    unexplained = 0
    for seed in seeds:
        x, W, labels = ce_rank_inputs(n, rows, vocab_size, e, beta_lo, beta_hi, seed, device,
                                      table_dtype)
        ll = vocab.label_logits(x, W, labels)
        lse, rank, zs = vocab.ce_rank(x, W, labels, ll, vocab_size, smooth=smooth)
        lse_p, rank_p, zs_p = vocab.ce_rank_plain(x, W, labels, ll, vocab_size, smooth)
        again = vocab.ce_rank(x, W, labels, ll, vocab_size, smooth=smooth)
        sync(device)
        if not (torch.equal(again[0], lse) and torch.equal(again[1], rank)
                and (zs is None or torch.equal(again[2], zs))):
            fail(f"ce_rank {name}: a second call gave other bits")
        if not (torch.isfinite(lse).all() and torch.isfinite(lse_p).all()):
            fail(f"ce_rank {name}: non-finite lse")
        err = (lse - lse_p).abs()
        lse_abs = max(lse_abs, float(err.max()))
        lse_rel = max(lse_rel, float((err / lse_p.abs().clamp_min(1e-30)).max()))
        if smooth:
            scale = zs_p.abs().clamp_min(math.sqrt(vocab_size))
            zs_err = max(zs_err, float(((zs - zs_p).abs() / scale).max()))
        row_diff = (rank.long() - rank_p.long()).abs()
        differ = torch.nonzero(row_diff).flatten()
        if len(differ):
            ties = near_ties(x, W, labels, ll, vocab_size, differ)
            unexplained += int((row_diff[differ] > ties).sum())
        diffs.append(row_diff.cpu())
        ranks.append(rank_p.cpu())
    diff = torch.cat(diffs)
    out = {
        "shape": name, "N": n, "E": e, "calls": len(diffs), "table_rows": rows,
        "vocab_size": vocab_size, "smooth": smooth, "table_dtype": str(table_dtype)[6:],
        "lse_max_abs_err": lse_abs, "lse_max_rel_err": lse_rel,
        "rank_exact_share": float((diff == 0).float().mean()),
        "rank_max_diff": int(diff.max()),
        "rank_median": float(torch.cat(ranks).float().median()),
        "rank_diffs_beyond_near_ties": unexplained,
    }
    if smooth:
        out["zsum_max_scaled_err"] = zs_err
    print(f"[k3] {json.dumps(out)}")
    if lse_rel > 1e-4:
        fail(f"ce_rank {name}: lse relative error {lse_rel:.3g} > 1e-4")
    if zs_err > 1e-4:
        fail(f"ce_rank {name}: zsum error {zs_err:.3g} > 1e-4")
    if out["rank_exact_share"] < min_exact or out["rank_max_diff"] > 2 or unexplained:
        fail(f"ce_rank {name}: ranks exact on {out['rank_exact_share']:.4f} of rows, "
             f"max diff {out['rank_max_diff']}, {unexplained} beyond their near ties")
    return out



# ------------------------------------------------------------- K1 / K2 check
def ce_train_inputs(n: int, rows: int, vocab_size: int, seed: int, minus_one: bool, device,
                    e: int = 64, table_dtype=torch.float32):
    """Inputs as ``ce_rank_inputs`` draws them, plus row weights of which
    about 30% are 0 (the loss-row budget's spare rows) and, with
    ``minus_one``, a few labels of -1 among those."""
    x, W, labels = ce_rank_inputs(n, rows, vocab_size, e, 0.0, 12.0, seed, device, table_dtype)
    rng = np.random.default_rng(seed + 1000)
    w = (rng.random(n) >= 0.3).astype(np.float32)
    if minus_one:
        pad = torch.from_numpy((rng.random(n) < 0.1) & (w == 0)).to(device)
        labels = torch.where(pad, torch.full_like(labels, -1), labels)
    return x, W, labels, torch.from_numpy(w).to(device)


def grad_errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    got, want = got.float(), want.float()
    return {"max_abs_err": float((got - want).abs().max()),
            "max_err_over_peak": float((got - want).abs().max() / want.abs().max()),
            "rel_frobenius": float((got - want).norm() / want.norm())}


def check_grad(what: str, got: torch.Tensor, want: torch.Tensor, rel: float = 1e-3) -> dict:
    """A gradient against its reference: within 2e-2 of the reference's
    largest magnitude and ``rel`` (1e-3) in relative Frobenius norm. Both
    sides round the CE's residual (the attention's P and dS) to bf16, from
    exponentials that differ in the last bits, so single entries may land on
    neighbouring bf16 values."""
    if not torch.isfinite(got.float()).all():
        fail(f"{what}: non-finite values")
    err = grad_errors(got, want)
    if err["max_err_over_peak"] > 2e-2 or err["rel_frobenius"] > rel:
        fail(f"{what}: {err}")
    return err


def check_ce_train(name: str, n: int, rows: int, vocab_size: int, eps: float,
                   eps_over_v, minus_one: bool, seed: int, device="cuda", e: int = 64) -> dict:
    """K1 against ``ce_fwd_plain`` and K2 against ``ce_bwd_plain`` on the same
    inputs. Criteria: lse within 1e-4 relative; the label logit within 1e-4
    of max(|ll|, 1) (it may sit near 0) and exactly 0 for a label of -1; zsum
    as K3's; dx and dW as ``check_grad`` says; dW rows at and beyond the
    vocab exactly 0; the same bits from a second call of each kernel."""
    from transformers4rec_tpu_torch.ops import vocab

    x, W, labels, w = ce_train_inputs(n, rows, vocab_size, seed, minus_one, device, e)
    lse, ll, zs = vocab.ce_fwd(x, W, labels, vocab_size, smooth=eps > 0)
    lse_p, ll_p, zs_p = vocab.ce_fwd_plain(x, W, labels, vocab_size, eps > 0)
    coef = (w / w.sum().clamp_min(1.0)).contiguous()
    dx, dW = vocab.ce_bwd(x, W, labels, lse, coef, vocab_size, eps, eps_over_v)
    dx_p, dW_p = vocab.ce_bwd_plain(x, W, labels, lse, coef, vocab_size, eps, eps_over_v)
    sync(device)
    if not torch.isfinite(lse).all():
        fail(f"ce_fwd {name}: non-finite lse")
    out = {
        "shape": name, "N": n, "E": e, "table_rows": rows, "vocab_size": vocab_size,
        "eps": eps, "zero_weight_share": float((w == 0).float().mean()),
        "labels_minus_one": int((labels < 0).sum()),
        "lse_max_abs_err": float((lse - lse_p).abs().max()),
        "lse_max_rel_err": float(((lse - lse_p).abs() / lse_p.abs().clamp_min(1e-30)).max()),
        "ll_max_scaled_err": float(((ll - ll_p).abs() / ll_p.abs().clamp_min(1.0)).max()),
    }
    if eps > 0:
        scale = zs_p.abs().clamp_min(math.sqrt(vocab_size))
        out["zsum_max_scaled_err"] = float(((zs - zs_p).abs() / scale).max())
    if out["lse_max_rel_err"] > 1e-4 or out["ll_max_scaled_err"] > 1e-4 \
            or out.get("zsum_max_scaled_err", 0.0) > 1e-4:
        fail(f"ce_fwd {name}: {out}")
    if not bool((ll[labels < 0] == 0).all()):
        fail(f"ce_fwd {name}: a label of -1 has a label logit")
    out["dx"] = check_grad(f"ce_bwd {name} dx", dx, dx_p)
    out["dW"] = check_grad(f"ce_bwd {name} dW", dW, dW_p)
    if dW.shape != W.shape or not bool((dW[vocab_size:] == 0).all()):
        fail(f"ce_bwd {name}: dW rows beyond the vocab are not zero")
    if not bool((dx[w == 0] == 0).all()):
        fail(f"ce_bwd {name}: rows of weight 0 have a gradient")
    again = vocab.ce_fwd(x, W, labels, vocab_size, smooth=eps > 0)
    again_dx, again_dW = vocab.ce_bwd(x, W, labels, lse, coef, vocab_size, eps, eps_over_v)
    if not (torch.equal(again[0], lse) and torch.equal(again[1], ll)
            and (zs is None or torch.equal(again[2], zs))):
        fail(f"ce_fwd {name}: a second call gave other bits")
    if not (torch.equal(again_dx, dx) and torch.equal(again_dW, dW)):
        fail(f"ce_bwd {name}: a second call gave other bits")
    out["same_bits_twice"] = True
    print(f"[k1k2] {json.dumps(out)}")
    return out


def check_padding_row_labels(n: int, rows: int, vocab_size: int, eps: float,
                             device="cuda", e: int = 64) -> dict:
    """K1, K2 and K3 against their plain versions with four labels on the
    table's padding rows (``vocab_size <= label < rows``), inside and beyond
    the vocab's last chunk. K1's label logit there is exactly -1e30 in both;
    K2's dx and dW as ``check_grad`` says, its dW rows of those labels equal
    (one exact product each) and every other padding row exactly 0; K3 takes
    the gathered logit: ranks within 1."""
    from transformers4rec_tpu_torch.ops import vocab

    x, W, labels, w = ce_train_inputs(n, rows, vocab_size, 31, False, device, e)
    on_pad = torch.tensor([vocab_size, vocab_size + 1, rows - 2, rows - 1], device=device)
    labels[:4] = on_pad.to(torch.int32)
    w[:4] = 1.0
    lse, ll, _ = vocab.ce_fwd(x, W, labels, vocab_size, smooth=eps > 0)
    lse_p, ll_p, _ = vocab.ce_fwd_plain(x, W, labels, vocab_size, eps > 0)
    coef = (w / w.sum()).contiguous()
    dx, dW = vocab.ce_bwd(x, W, labels, lse, coef, vocab_size, eps)
    dx_p, dW_p = vocab.ce_bwd_plain(x, W, labels, lse, coef, vocab_size, eps)
    gathered = vocab.label_logits(x, W, labels)
    _, rank, _ = vocab.ce_rank(x, W, labels, gathered, vocab_size, smooth=eps > 0)
    _, rank_p, _ = vocab.ce_rank_plain(x, W, labels, gathered, vocab_size, eps > 0)
    sync(device)
    if not (bool((ll[:4] == -1e30).all()) and bool((ll_p[:4] == -1e30).all())):
        fail(f"padding-row labels: label logits {ll[:4].tolist()} vs plain {ll_p[:4].tolist()}")
    if float(((lse - lse_p).abs() / lse_p.abs()).max()) > 1e-4:
        fail("padding-row labels: lse differs")
    out = {"N": n, "E": e, "table_rows": rows, "vocab_size": vocab_size, "eps": eps,
           "dx": check_grad("padding-row labels dx", dx, dx_p),
           "dx_of_those_rows": check_grad("padding-row labels dx[:4]", dx[:4], dx_p[:4]),
           "dW": check_grad("padding-row labels dW", dW, dW_p),
           "rank_max_diff": int((rank.long() - rank_p.long()).abs().max())}
    if not torch.allclose(dW[on_pad], dW_p[on_pad], rtol=1e-6, atol=0) \
            or not bool(dW[on_pad].abs().sum(-1).gt(0).all()):
        fail("padding-row labels: the one-hot rows of dW differ")
    others = torch.ones(rows, dtype=torch.bool, device=device)
    others[:vocab_size] = False
    others[on_pad] = False
    if not bool((dW[others] == 0).all()):
        fail("padding-row labels: another padding row of dW is not zero")
    if out["rank_max_diff"] > 1:
        fail(f"padding-row labels: ranks differ by {out['rank_max_diff']}")
    print(f"[pad-labels] {json.dumps(out)}")
    return out


# ------------------------------------------------------------------ K4 check
def check_rank(name: str, n: int, rows: int, vocab_size: int, shard_bound, beta_lo: float,
               beta_hi: float, seeds, device="cuda", e: int = 64,
               table_dtype=torch.float32) -> dict:
    """K4 against ``rank_counts_plain`` on the same inputs, one call per seed,
    and ``fused_label_rank`` (K1 + K4) against K3's ranks. With a
    ``shard_bound`` below ``vocab_size`` the counts go over the columns below
    that bound only, as on the first shard of a vocab-parallel table: a label
    at or beyond it becomes -1 (another shard owns it, so no column is left
    out and its logit is no column's of this shard). Criteria: counts exact on >= 99% of
    the rows and within 2 on every row (tensor cores sum each logit in
    another order, so a logit within an ulp of the threshold may land on the
    other side of it); K1 + K4 equal to K3 on >= 99% of the rows and within 1
    elsewhere; the same counts on a second call."""
    from transformers4rec_tpu_torch.ops import vocab

    diffs, k3_diffs, minus_one = [], [], 0
    for seed in seeds:
        x, W, labels = ce_rank_inputs(n, rows, vocab_size, e, beta_lo, beta_hi, seed, device,
                                      table_dtype)
        ll = vocab.label_logits(x, W, labels)
        _, want_k3, _ = vocab.ce_rank(x, W, labels, ll, vocab_size)
        k3_diffs.append((vocab.fused_label_rank(x, W, labels, vocab_size).long()
                         - want_k3.long()).abs().cpu())
        bound_ = vocab_size if shard_bound is None else shard_bound
        labels = torch.where(labels < bound_, labels, torch.full_like(labels, -1))
        minus_one += int((labels < 0).sum())
        cnt = vocab.rank_counts(x, W, ll, labels, bound_)
        cnt_p = vocab.rank_counts_plain(x, W, ll, labels, bound_)
        again = vocab.rank_counts(x, W, ll, labels, bound_)
        sync(device)
        if cnt.dtype != torch.int32 or not torch.equal(cnt, again):
            fail(f"rank {name}: {cnt.dtype}, or a second call gave other counts")
        diffs.append((cnt.long() - cnt_p.long()).abs().cpu())
    diff, k3_diff = torch.cat(diffs), torch.cat(k3_diffs)
    out = {"shape": name, "N": n, "E": e, "calls": len(diffs), "table_rows": rows,
           "vocab_size": vocab_size, "shard_bound": shard_bound,
           "table_dtype": str(table_dtype)[6:],
           "labels_minus_one": minus_one,
           "count_exact_share": float((diff == 0).float().mean()),
           "count_max_diff": int(diff.max()),
           "label_rank_vs_k3_exact_share": float((k3_diff == 0).float().mean()),
           "label_rank_vs_k3_max_diff": int(k3_diff.max())}
    print(f"[k4] {json.dumps(out)}")
    if out["count_exact_share"] < 0.99 or out["count_max_diff"] > 2:
        fail(f"rank {name}: {out}")
    if out["label_rank_vs_k3_exact_share"] < 0.99 or out["label_rank_vs_k3_max_diff"] > 1:
        fail(f"fused_label_rank {name}: {out}")
    return out


# ---------------------------------------------------------- K5 / K6 checks
def plm_attention_bias(S: int, H: int, seed: int, pad) -> torch.Tensor:
    """The (B, H, S, S) bias that XLNet-PLM's query stream hands K5 on the
    flash path, for the sessions of ``pad``: the perm mask of the port's PLM
    sampler (a random factorisation order) on the first half of them and the
    causal one of every-position evaluation on the second, which leaves
    query rows without a visible key (position 0) and key tiles wholly
    blocked inside a session, plus a relative bias drawn per head (normal,
    std 0.5) over it, as the encoder sums them."""
    from transformers4rec_tpu_torch.blocks.transformer import make_extra_bias
    from transformers4rec_tpu_torch.masking import PermutationLanguageModeling

    g = torch.Generator(device=pad.device).manual_seed(seed)
    plm = PermutationLanguageModeling(hidden_size=1, plm_probability=0.25, max_span_length=5,
                                      eval_on_last_item_seq_only=False)
    ids = pad.long()  # an item id of 1 at each real position
    half = pad.shape[0] // 2
    perm = torch.cat([
        plm.compute_masked_targets(ids[:half], training=True, generator=g).perm_mask,
        plm.compute_masked_targets(ids[half:], testing=True).perm_mask])
    rel = torch.randn((1, H, S, S), generator=g, device=pad.device) * 0.5
    return (make_extra_bias(S, perm, None, query_stream=True) + rel).contiguous()


def packed_segments(B: int, S: int, seed: int, device) -> torch.Tensor:
    """(B, S) segment ids of rows of ``S`` packed (``data.pack_sessions``)
    from sessions of 2 to 20 items, as phase U2's loader packs them."""
    from transformers4rec_tpu_torch.data import pack_sessions

    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, 21, B * S // 8)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    packed = pack_sessions({"item_id__values": np.ones(offsets[-1], np.int64),
                            "item_id__offsets": offsets}, max_len=S, item_id_col="item_id",
                           num_rows=B)
    return torch.from_numpy(packed["segment_ids"]).long().to(device)


def flash_inputs(B: int, S: int, H: int, Dh: int, seed: int, device, ragged: bool = False,
                 wholly_padded: int = 0, bias_shape=None, plm: bool = False, window=None,
                 segments: bool = False):
    """q, k, v and dO (B, S, H, Dh) from a seed (standard normal), a (B, S)
    pad mask whose sessions have 2..S real items (the first ``wholly_padded``
    sessions none) or None, and a bias (normal, std 0.5) of ``bias_shape``,
    with ``plm`` the query stream's (``plm_attention_bias``), with ``window``
    Longformer's local window as the encoder builds it (1, 1, S, S), with
    ``segments`` the (B, 1, S, S) block-diagonal bias of packed rows
    (``packed_segments``; the pad mask is then theirs), or None."""
    rng = np.random.default_rng(seed)
    q, k, v, d_out = (torch.from_numpy(rng.normal(0.0, 1.0, (B, S, H, Dh)).astype(np.float32))
                      .to(device) for _ in range(4))
    pad = None
    if ragged:
        lengths = rng.integers(2, S + 1, B)
        lengths[:wholly_padded] = 0
        pad = torch.from_numpy(np.arange(S)[None, :] < lengths[:, None]).to(device)
    bias = None
    if bias_shape is not None:
        bias = torch.from_numpy(rng.normal(0.0, 0.5, bias_shape).astype(np.float32)).to(device)
    if plm:
        bias = plm_attention_bias(S, H, seed, pad)
    if window is not None:
        from transformers4rec_tpu_torch.blocks.transformer import make_extra_bias

        bias = make_extra_bias(S, local_window=window, device=device)
    if segments:
        from transformers4rec_tpu_torch.blocks.transformer import make_extra_bias

        seg = packed_segments(B, S, seed, device)
        pad = seg > 0
        bias = make_extra_bias(S, (seg[:, :, None] != seg[:, None, :]).float(), device=device)
    return q, k, v, d_out, pad, bias


def check_flash(name: str, B: int, S: int, H: int, Dh: int, causal: bool, seed: int,
                ragged: bool = False, wholly_padded: int = 0, bias_shape=None,
                device="cuda", plm: bool = False, window=None, segments: bool = False) -> dict:
    """K5 against ``flash_forward_plain``, and K6a and K6b + K6c against the
    two arithmetics of ``flash_backward_plain``, on the same inputs (the
    backward kernels and the plain versions all take the plain forward's out
    and lse). Criteria: out within 5e-3 of the plain version and 1e-3 in
    relative Frobenius norm, lse within 1e-4 on rows with a valid key and
    equal to the sentinel elsewhere, rows with no valid key exactly 0 (both
    sides round P to bf16 from exponentials that differ in the last bits, so
    single entries land on neighbouring bf16 values); dq, dk, dv as
    ``check_grad`` says; the same bits from a second call of each kernel; and
    K6a's mma.sync design against K6b + K6c at every shape: dk and dv within
    1e-6 of their peak (the same sums), dq within 1e-5 of its peak (partials
    added per key tile against one running sum). Where K6a takes its Hopper
    design (``uses_wgmma``), whose products sum in another order, that one is
    held to the plain version as above, and the mma.sync design is run
    beside it for the same-sums check. With ``plm`` the bias is XLNet-PLM's
    (``plm_attention_bias``): rows blocked by the bias alone must give 0 and
    the sentinel lse too, and some must. With ``window`` the bias is
    Longformer's local window, with ``segments`` packed rows' block-diagonal
    bias (``flash_inputs``)."""
    from transformers4rec_tpu_torch.ops import attention as fa

    q, k, v, d_out, pad, bias = flash_inputs(B, S, H, Dh, seed, device, ragged, wholly_padded,
                                             bias_shape, plm, window, segments)
    out, lse = fa.flash_fwd(q, k, v, bias, pad, causal)
    out2, lse2 = fa.flash_fwd(q, k, v, bias, pad, causal)
    out_p, lse_p = fa.flash_forward_plain(q, k, v, bias, pad, causal)
    sync(device)
    if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
        fail(f"flash_fwd {name}: a second call gave other bits")
    if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
        fail(f"flash_fwd {name}: non-finite values")
    masked = lse_p == fa.LSE_MASKED
    res = {"shape": name, "B": B, "S": S, "H": H, "Dh": Dh, "causal": causal,
           "ragged": ragged, "bias": None if bias is None else list(bias.shape),
           "rows_without_a_key": int(masked.sum()),
           "out": grad_errors(out, out_p),
           "lse_max_abs_err": float((lse - lse_p)[~masked].abs().max())}
    if res["out"]["max_abs_err"] > 5e-3 or res["out"]["rel_frobenius"] > 1e-3 \
            or res["lse_max_abs_err"] > 1e-4:
        fail(f"flash_fwd {name}: {res}")
    rows_masked = masked.reshape(B, H, S).permute(0, 2, 1)  # (B, S, H)
    if not torch.equal(lse[masked], lse_p[masked]) or not bool((out[rows_masked] == 0).all()):
        fail(f"flash_fwd {name}: rows without a valid key are not 0 with the sentinel lse")
    if wholly_padded and not res["rows_without_a_key"] >= wholly_padded * S * H:
        fail(f"flash_fwd {name}: expected {wholly_padded} sessions without a valid key")
    if plm:
        # query rows whose keys the perm mask blocks, inside the session
        blocked = ((bias <= fa.NEG / 2) | ~pad[:, None, None, :]).all(-1) & pad[:, None, :]
        res["rows_blocked_by_the_bias"] = int(blocked.sum())
        if not res["rows_blocked_by_the_bias"]:
            fail(f"flash_fwd {name}: the PLM bias blocked no row of a session")

    delta = fa.row_delta(d_out, out_p)
    args = (q, k, v, d_out, lse_p, delta, bias, pad, causal)
    fused = fa.flash_bwd_fused(*args)
    split = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
    again = fa.flash_bwd_fused(*args) + (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
    want_fused = fa.flash_backward_plain(q, k, v, bias, pad, causal, out_p, lse_p, d_out, True)
    want_split = fa.flash_backward_plain(q, k, v, bias, pad, causal, out_p, lse_p, d_out, False)
    sync(device)
    if not all(torch.equal(a, b) for a, b in zip(fused + split, again)):
        fail(f"flash_bwd {name}: a second call gave other bits")
    for tag, got, want in (("fused", fused, want_fused), ("split", split, want_split)):
        res[tag] = {g: check_grad(f"flash_bwd {tag} {name} {g}", a, b)
                    for g, a, b in zip(("dq", "dk", "dv"), got, want)}
    res["fused_design"] = "wgmma" if q.is_cuda and fa.uses_wgmma(Dh) else "mma.sync"
    mma = fa._flash_bwd_fused_cuda(*args, wgmma=False) if res["fused_design"] == "wgmma" \
        else fused
    res["fused_vs_split"] = {g: float((a - b).abs().max() / b.abs().max())
                             for g, a, b in zip(("dq", "dk", "dv"), mma, split)}
    fs = res["fused_vs_split"]
    if fs["dq"] > 1e-5 or fs["dk"] > 1e-6 or fs["dv"] > 1e-6:
        fail(f"flash_bwd {name}: fused (mma.sync) against split {fs}")
    if q.is_cuda and fa.uses_split_stream(Dh):
        # the streamed K6b against the mma.sync body it replaces: the same bits
        res["dq_streamed_equals_mma_sync"] = torch.equal(
            split[0], fa._flash_bwd_dq_cuda(*args, streamed=False))
        if not res["dq_streamed_equals_mma_sync"]:
            fail(f"flash_bwd_dq {name}: the streamed design and the mma.sync body differ")
    print(f"[k5k6] {json.dumps(res)}")
    return res


def attention_pairs(S: int, causal: bool, pad, B: int) -> int:
    """(query, key) pairs per head that the attention must score: keys that
    are real and, under the causal mask, not after the query."""
    if pad is None:
        per_session = S * (S + 1) // 2 if causal else S * S
        return B * per_session
    valid = pad.long()
    if causal:
        return int(valid.cumsum(1).sum())
    return int(valid.sum(1).sum() * S)


def time_flash(name: str, B: int, S: int, H: int, Dh: int, causal: bool, ragged: bool,
               reps: int) -> dict:
    """K5, K6a, K6b and K6c at one shape beside their plain versions and
    ``F.scaled_dot_product_attention`` (bf16 inputs cast outside the timed
    call, the same causal and padding mask; its backward alone for K6a, for
    dq alone and for dk and dv alone; never used by the port). The bounds
    count the pairs that the masks leave."""
    import torch.nn.functional as F

    from transformers4rec_tpu_torch.ops import attention as fa

    q, k, v, d_out, pad, _ = flash_inputs(B, S, H, Dh, 70, "cuda", ragged)
    out, lse = fa.flash_fwd(q, k, v, None, pad, causal)
    delta = fa.row_delta(d_out, out)
    args = (q, k, v, d_out, lse, delta, None, pad, causal)
    n = q.numel()
    pairs = attention_pairs(S, causal, pad, B) * H
    rows = B * H * S

    lq, lk, lv = (t.to(torch.bfloat16).permute(0, 2, 1, 3).contiguous().requires_grad_()
                  for t in (q, k, v))
    lg = d_out.to(torch.bfloat16).permute(0, 2, 1, 3).contiguous()
    mask = None
    if pad is not None:
        mask = pad[:, None, None, :]
        if causal:
            mask = mask & torch.ones(S, S, dtype=torch.bool, device="cuda").tril()

    def library_fwd():
        return F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                              is_causal=causal and mask is None)

    lout = library_fwd()

    def library_bwd(wrt):
        return lambda: torch.autograd.grad(lout, wrt, lg, retain_graph=True)

    pad_bytes = 0 if pad is None else pad.numel()
    with torch.no_grad():
        fwd_lib = cuda_ms(library_fwd, reps=reps)
    res = {
        "flash_fwd": {
            "ms": cuda_ms(lambda: fa.flash_fwd(q, k, v, None, pad, causal), reps=reps),
            "plain_ms": cuda_ms(lambda: fa.flash_forward_plain(q, k, v, None, pad, causal),
                                reps=max(3, reps // 3)),
            "library_ms": fwd_lib,
            # read q, k, v and the pad mask once, write out and lse once; two
            # products and one exponential a pair
            **bound(4 * 4 * n + 4 * rows + pad_bytes, 2 * 2 * Dh * pairs, pairs),
        },
        "flash_bwd_fused": {
            "ms": cuda_ms(lambda: fa.flash_bwd_fused(*args), reps=reps),
            "plain_ms": cuda_ms(lambda: fa.flash_backward_plain(
                q, k, v, None, pad, causal, out, lse, d_out, True), reps=max(3, reps // 3)),
            "library_ms": cuda_ms(library_bwd((lq, lk, lv)), reps=reps),
            # read q, k, v, dO, lse and delta once, write dq, dk, dv once; five
            # products a pair
            **bound(7 * 4 * n + 2 * 4 * rows + pad_bytes, 5 * 2 * Dh * pairs, pairs),
        },
        "flash_bwd_dq": {
            "ms": cuda_ms(lambda: fa.flash_bwd_dq(*args), reps=reps),
            "plain_ms": cuda_ms(lambda: fa.flash_bwd_dq_plain(q, k, v, d_out, lse, delta, None,
                                                              pad, causal), reps=max(3, reps // 3)),
            "library_ms": cuda_ms(library_bwd((lq,)), reps=reps),
            **bound(5 * 4 * n + 2 * 4 * rows + pad_bytes, 3 * 2 * Dh * pairs, pairs),
        },
        "flash_bwd_dkv": {
            "ms": cuda_ms(lambda: fa.flash_bwd_dkv(*args), reps=reps),
            "plain_ms": cuda_ms(lambda: fa.flash_bwd_dkv_plain(q, k, v, d_out, lse, delta, None,
                                                               pad, causal),
                                reps=max(3, reps // 3)),
            "library_ms": cuda_ms(library_bwd((lk, lv)), reps=reps),
            **bound(6 * 4 * n + 2 * 4 * rows + pad_bytes, 4 * 2 * Dh * pairs, pairs),
        },
    }
    # both designs of K5 and K6a at this shape, in the same call: the one
    # the wrappers pick (above) and the other
    res["flash_fwd"]["designs_ms"] = {
        design: cuda_ms(lambda: fa._flash_fwd_cuda(q, k, v, None, pad, causal,
                                                   wgmma=design == "wgmma"), reps=reps)
        for design in ("mma.sync", "wgmma")}
    res["flash_fwd"]["design"] = "wgmma" if fa.uses_wgmma(Dh) else "mma.sync"
    if Dh <= 64:  # K6a's Hopper design takes head dims up to 64
        res["flash_bwd_fused"]["designs_ms"] = {
            design: cuda_ms(lambda: fa._flash_bwd_fused_cuda(*args, wgmma=design == "wgmma"),
                            reps=reps)
            for design in ("mma.sync", "wgmma")}
    res["flash_bwd_fused"]["design"] = res["flash_fwd"]["design"]
    split = "streamed" if fa.uses_split_stream(Dh) else "mma.sync"
    if split == "streamed":  # the streamed K6b and K6c take head dims up to 32
        for kernel, launch in (("flash_bwd_dq", fa._flash_bwd_dq_cuda),
                               ("flash_bwd_dkv", fa._flash_bwd_dkv_cuda)):
            res[kernel]["designs_ms"] = {
                design: cuda_ms(lambda: launch(*args, streamed=design == "streamed"), reps=reps)
                for design in ("mma.sync", "streamed")}
    res["flash_bwd_dq"]["design"] = res["flash_bwd_dkv"]["design"] = split
    # the split route (K6b, then K6c) against K6a's time above, at this shape
    res["flash_bwd_fused"]["split_route_ms"] = cuda_ms(
        lambda: (fa.flash_bwd_dq(*args), fa.flash_bwd_dkv(*args)), reps=reps)
    for r in res.values():
        r["shape"] = name
        r["pairs"] = pairs
    return res


def time_flash_plm(name: str, B: int, S: int, H: int, Dh: int, reps: int) -> dict:
    """K5 with XLNet-PLM's (B, H, S, S) query-stream bias (``plm_attention_bias``,
    not causal, ragged padding) beside its plain version and
    ``F.scaled_dot_product_attention`` with the same bias and padding as a
    bf16 additive mask (it gives rows without a visible key the mean of v,
    not 0). The bound reads the bias once and counts the pairs that the
    bias and the padding leave."""
    import torch.nn.functional as F

    from transformers4rec_tpu_torch.ops import attention as fa

    q, k, v, _, pad, bias = flash_inputs(B, S, H, Dh, 70, "cuda", True, plm=True)
    pairs = int(((bias > fa.NEG / 2) & pad[:, None, None, :]).sum())
    lq, lk, lv = (t.to(torch.bfloat16).permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
    mask = (bias + torch.where(pad, 0.0, fa.NEG)[:, None, None, :]).to(torch.bfloat16)
    n = q.numel()
    res = {"ms": cuda_ms(lambda: fa.flash_fwd(q, k, v, bias, pad, False), reps=reps),
           "plain_ms": cuda_ms(lambda: fa.flash_forward_plain(q, k, v, bias, pad, False),
                               reps=max(3, reps // 3)),
           "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(lq, lk, lv,
                                                                        attn_mask=mask),
                                 reps=reps),
           # read q, k, v, the bias and the pad mask once, write out and lse once;
           # two products and one exponential a pair
           **bound(4 * 4 * n + 4 * bias.numel() + 4 * B * H * S + pad.numel(),
                   2 * 2 * Dh * pairs, pairs),
           "shape": name, "bias_shape": list(bias.shape), "pairs": pairs}
    return res


def time_flash_bias(name: str, B: int, S: int, H: int, Dh: int, reps: int, causal: bool = False,
                    window=None, segments: bool = False) -> dict:
    """K5 and K6a with a constant bias over the heads: Longformer's (1, 1, S,
    S) local window (``window``; not causal, ragged padding: main paths S4
    and V2's local layers) or packed rows' (B, 1, S, S) block-diagonal one
    (``segments``; causal: main path U2), beside their plain versions and
    ``F.scaled_dot_product_attention`` with the same bias, padding and
    causal mask as a bf16 additive mask (forward; its backward for dq, dk,
    dv). The bounds read the bias once and count the pairs that the bias,
    the causal mask and the padding leave."""
    import torch.nn.functional as F

    from transformers4rec_tpu_torch.ops import attention as fa

    q, k, v, d_out, pad, bias = flash_inputs(B, S, H, Dh, 71, "cuda", True, window=window,
                                             segments=segments)
    out, lse = fa.flash_fwd(q, k, v, bias, pad, causal)
    args = (q, k, v, d_out, lse, fa.row_delta(d_out, out), bias, pad, causal)
    allowed = (bias > fa.NEG / 2) & pad[:, None, None, :]
    if causal:
        allowed = allowed & torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    pairs = int(allowed.sum()) * (H // bias.shape[1])
    n, rows, extra = q.numel(), B * H * S, 4 * bias.numel() + pad.numel()
    lq, lk, lv = (t.to(torch.bfloat16).permute(0, 2, 1, 3).contiguous().requires_grad_()
                  for t in (q, k, v))
    additive = bias + torch.where(pad, 0.0, fa.NEG)[:, None, None, :]
    if causal:
        additive = additive + torch.ones(S, S, device="cuda").triu(1) * fa.NEG
    mask = additive.to(torch.bfloat16)
    lout = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask)
    lg = d_out.to(torch.bfloat16).permute(0, 2, 1, 3).contiguous()
    with torch.no_grad():
        fwd_lib = cuda_ms(lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask),
                          reps=reps)
    res = {
        "flash_fwd": {
            "ms": cuda_ms(lambda: fa.flash_fwd(q, k, v, bias, pad, causal), reps=reps),
            "plain_ms": cuda_ms(lambda: fa.flash_forward_plain(q, k, v, bias, pad, causal),
                                reps=max(3, reps // 3)),
            "library_ms": fwd_lib,
            **bound(4 * 4 * n + 4 * rows + extra, 2 * 2 * Dh * pairs, pairs)},
        "flash_bwd_fused": {
            "ms": cuda_ms(lambda: fa.flash_bwd_fused(*args), reps=reps),
            "plain_ms": cuda_ms(lambda: fa.flash_backward_plain(
                q, k, v, bias, pad, causal, out, lse, d_out, True), reps=max(3, reps // 3)),
            "library_ms": cuda_ms(lambda: torch.autograd.grad(lout, (lq, lk, lv), lg,
                                                              retain_graph=True), reps=reps),
            **bound(7 * 4 * n + 2 * 4 * rows + extra, 5 * 2 * Dh * pairs, pairs)},
    }
    for r in res.values():
        r.update(shape=name, bias_shape=list(bias.shape), pairs=pairs, causal=causal,
                 design="wgmma" if fa.uses_wgmma(Dh) else "mma.sync")
    return res


# ------------------------------------------------------------------ K7 check
def table_and_grad(rows: int, e: int, scale: float, seed: int, device):
    """A table like the model's (normal, std 0.05) and a dense gradient, as
    the softmax's dW is, whose last 7 rows are zero, as padding rows' are."""
    g = torch.Generator(device=device).manual_seed(seed)
    p = torch.randn(rows, e, generator=g, device=device) * 0.05
    grad = torch.randn(rows, e, generator=g, device=device) * scale
    grad[-7:] = 0.0
    return p, grad


def check_adafactor(name: str, rows: int, e: int, clip, device="cuda") -> dict:
    """K7a and K7b against ``adafactor_update_plain`` over three steps
    running, from the same table and gradients (scales 1e-2, 1 and 30: the
    clip engages on the last). Criteria, at every step: the moment within
    1e-6 relative (the kernel contracts to fused multiply-adds); the table
    within 1e-5 of the step's largest update plus the table's own float32
    spacing (an approximate rsqrt of 2 ulp, another order of the clip's
    sum); and the same bits from a second call on the same inputs."""
    from transformers4rec_tpu_torch.ops import fused_adafactor as fa

    p, _ = table_and_grad(rows, e, 1.0, 40, device)
    p_p, v, v_p = p.clone(), torch.zeros_like(p), torch.zeros_like(p)
    v_err = p_err = v_abs = p_abs = 0.0
    for step, scale in enumerate((1e-2, 1.0, 30.0)):
        _, g = table_and_grad(rows, e, scale, 41 + step, device)
        decay = 1.0 - torch.full((), float(step + 1), device=device) ** -0.8
        p2, v2, before = p.clone(), v.clone(), p_p.clone()
        fa.adafactor_update(p, g, v, decay, 6.7e-4, clip, 1e-30)
        fa.adafactor_update(p2, g, v2, decay, 6.7e-4, clip, 1e-30)
        fa.adafactor_update_plain(p_p, g, v_p, decay, 6.7e-4, clip, 1e-30)
        sync(device)
        if not (torch.equal(p, p2) and torch.equal(v, v2)):
            fail(f"adafactor {name}: a second call gave other bits at step {step}")
        if not (torch.isfinite(p).all() and torch.isfinite(v).all()):
            fail(f"adafactor {name}: non-finite values at step {step}")
        update = float((p_p - before).abs().max())
        allowed = 1e-5 * update + 2.0 ** -23 * float(p_p.abs().max())
        v_abs = max(v_abs, float((v - v_p).abs().max()))
        p_abs = max(p_abs, float((p - p_p).abs().max()))
        v_err = max(v_err, float(((v - v_p).abs() / v_p).max()))
        p_err = max(p_err, float((p - p_p).abs().max()) / allowed)
        del p2, v2, before, g
    out = {"shape": name, "rows": rows, "E": e, "clip": clip, "steps": 3,
           "moment_max_rel_err": v_err, "moment_max_abs_err": v_abs,
           "table_max_abs_err": p_abs, "table_err_over_allowed": p_err}
    print(f"[k7] {json.dumps(out)}")
    if v_err > 1e-6 or p_err > 1.0:
        fail(f"adafactor {name}: {out}")
    return out


# --------------------------------------------------------- two shards, merged
def check_two_shards(n: int, rows: int, vocab_size: int, eps: float, device="cuda",
                     e: int = 64) -> dict:
    """The table cut into two shards held by this one process: K1, K2 and K4
    run per shard with the shard's own bounds and labels, the partials are
    merged as a process group would merge them, and the results are held
    against the unsharded K1/K2 (``fused_softmax_ce``) and K3
    (``fused_ce_and_rank``) on the whole table: the losses within 1e-5
    relative, dx and dW as ``check_grad`` says, ranks equal on >= 99% of the
    rows and within 1 elsewhere."""
    from transformers4rec_tpu_torch.ops import vocab
    from transformers4rec_tpu_torch.parallel import (
        shard_table, sharded_ce_and_rank, sharded_softmax_ce)

    x, W, labels, w = ce_train_inputs(n, rows, vocab_size, 51, False, device, e)
    xs = x.clone().requires_grad_()
    shards = [shard_table(W, i, 2).clone().requires_grad_() for i in range(2)]
    loss = sharded_softmax_ce(xs, shards, labels, w, None, vocab_size=vocab_size,
                              label_smoothing=eps)
    loss.backward()
    eval_loss, ranks = sharded_ce_and_rank(x, [t.detach() for t in shards], labels, w, None,
                                           vocab_size=vocab_size, label_smoothing=eps)
    xu, Wu = x.clone().requires_grad_(), W.clone().requires_grad_()
    want = vocab.fused_softmax_ce(xu, Wu, labels, w, vocab_size=vocab_size, label_smoothing=eps)
    want.backward()
    want_eval, want_ranks = vocab.fused_ce_and_rank(x, W, labels, w, vocab_size=vocab_size,
                                                    label_smoothing=eps)
    sync(device)
    diff = (ranks.long() - want_ranks.long()).abs()
    out = {"N": n, "E": e, "table_rows": rows, "vocab_size": vocab_size, "eps": eps,
           "loss": float(loss.detach()), "unsharded_loss": float(want.detach()),
           "eval_loss": float(eval_loss), "unsharded_eval_loss": float(want_eval),
           "dx": check_grad("two shards dx", xs.grad, xu.grad),
           "dW": check_grad("two shards dW", torch.cat([t.grad for t in shards]), Wu.grad),
           "rank_exact_share": float((diff == 0).float().mean()),
           "rank_max_diff": int(diff.max())}
    print(f"[two-shards] {json.dumps(out)}")
    for a, b in (("loss", "unsharded_loss"), ("eval_loss", "unsharded_eval_loss")):
        if not abs(out[a] - out[b]) <= 1e-5 * abs(out[b]):
            fail(f"two shards: {a} {out[a]} vs {out[b]}")
    if out["rank_exact_share"] < 0.99 or out["rank_max_diff"] > 1:
        fail(f"two shards: ranks {out}")
    return out


# ------------------------------------------------- wide item tables (E > 256)
WIDE_E = (192, 448, 1000)  # K2's wide passes; the paper's width; off every slab


def check_wide_tables() -> dict:
    """K1, K2, K3 and K4 against their plain versions at widths beyond what
    the narrow kernels hold whole (K2 past 128, the rest past 256), at N and
    V off every tile size, with label smoothing on and off, by the criteria
    and the same-bits check of the narrow widths; then labels on padding
    rows and two shards at the paper's E = 448."""
    out = {"ce": [], "ce_rank": [], "rank": []}
    for i, e in enumerate(WIDE_E):
        for smooth in (False, True):
            eps = 0.1 if smooth else 0.0
            out["ce"].append(check_ce_train(f"wide-{e}", 1000, 100_008, 100_003, eps,
                                            eps / 100_003 if smooth else None, smooth,
                                            60 + 2 * i + smooth, e=e))
            out["ce_rank"].append(check_ce_rank(f"wide-{e}", EVAL_ROWS, 100_008, 100_003, smooth,
                                                0.0, 12.0, [70 + 2 * i + smooth], e=e))
        out["rank"].append(check_rank(f"wide-{e}", 1000, 100_008, 100_003, 60_003, 0.0, 12.0,
                                      [80 + i], e=e))
    e = WIDE_E[1]
    out["padding_rows"] = [check_padding_row_labels(300, 100_072, 100_003, eps, e=e)
                           for eps in (0.0, 0.1)]
    out["two_shards"] = check_two_shards(1000, 100_008, 100_003, 0.1, e=e)
    return out


def run_wide_flagship(flagship, vocab, card: str) -> dict:
    """The flagship XLNet-MLM at the paper's tied width: an item table of
    ``flagship.PAPER_ITEM_DIM`` = 448 values a row (390,000 items, d_model
    192, ``build_model(item_dim=...)``). ``Model.evaluate`` on one batch of
    128 sessions and one training step, each on the card against the same
    weights on the CPU with ``check_evaluate``'s and ``check_training_step``'s
    tolerances, then ``flagship.build_trainer`` for one group of 8 steps. The
    kernel counts are set to 0 just before each part and read just after."""
    from transformers4rec_tpu_torch.data import synthetic_data

    e = flagship.PAPER_ITEM_DIM
    counters = {"ce_fwd": vocab.ce_fwd, "ce_bwd": vocab.ce_bwd, "ce_rank": vocab.ce_rank}
    launches = dict.fromkeys(counters, 0)

    def add(got):
        for k, n in got.items():
            launches[k] += n

    model = flagship.build_model("cuda", seed=0, dropout=0.0, item_dim=e)
    table = model.heads[0].input_module.item_embedding_table()
    if table.shape[1] != e:
        fail(f"build_model(item_dim={e}) gave a table of {tuple(table.shape)}")
    loader = eval_batches(flagship, flagship.NUM_ITEMS, flagship.SEQ, 1, EVAL_ROWS)
    gpu_res, got, eval_s = counted(counters, lambda: model.evaluate(loader))
    expect_launches("the E = 448 evaluation", got, ce_rank=1)
    add(got)
    cpu_model = flagship.build_model("cpu", seed=0, dropout=0.0, item_dim=e)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_res = cpu_model.evaluate(loader)
    print(f"[wide-flagship] evaluate {eval_s:.3f}s cuda {json.dumps(gpu_res)} "
          f"cpu {json.dumps(cpu_res)}")
    check_evaluate(gpu_res, cpu_res, EVAL_ROWS)
    step, got, _ = counted(counters, lambda: check_training_step(model, cpu_model, loader[0]))
    expect_launches("the E = 448 training step", got, ce_fwd=1, ce_bwd=1)
    add(got)
    print(f"[wide-flagship] train-step {json.dumps(step)}")
    del model, cpu_model
    torch.cuda.empty_cache()

    steps = 8
    data = synthetic_data(flagship.schema(), num_rows=steps * flagship.BATCH,
                          max_session_length=flagship.SEQ, seed=600)
    trainer = flagship.build_trainer("cuda", seed=0, train_dataset=data, item_dim=e)
    trainer.args.max_steps, trainer.args.logging_steps = steps, steps
    metrics, got, wall = counted(counters, trainer.train)
    expect_launches("the E = 448 trainer", got, ce_fwd=steps, ce_bwd=steps)
    add(got)
    table = trainer.model.heads[0].input_module.item_embedding_table()
    if metrics["train_steps"] != steps or not math.isfinite(metrics["train_loss"]) \
            or not bool(torch.isfinite(table).all()):
        fail(f"the E = 448 trainer: {metrics}")
    res = {"E": e, "evaluate": gpu_res, "train_step": step, "train_steps": steps,
           "train_wall_s": wall, "ms_per_step": 1e3 * wall / steps,
           "mean_loss": metrics["train_loss"], "launches": launches}
    print(f"[wide-flagship] trainer on {card}: {json.dumps({k: res[k] for k in ('ms_per_step', 'mean_loss', 'launches')})}")
    del trainer
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------------ evaluate
def eval_batches(flagship, num_items: int, seq: int, batches: int, rows: int):
    from transformers4rec_tpu_torch.data import synthetic_data

    schema = flagship.schema(num_items, seq)
    return [synthetic_data(schema, num_rows=rows, max_session_length=seq, seed=100 + i)
            for i in range(batches)]


def run_evaluate(model, loader, vocab) -> tuple:
    """Model.evaluate with the kernel counts set to 0 just before and read
    just after."""
    vocab.ce_rank.launches = 0
    sync(model.device)
    t0 = time.perf_counter()
    results = model.evaluate(loader)
    sync(model.device)
    return results, {"ce_rank": vocab.ce_rank.launches}, time.perf_counter() - t0


def check_evaluate(gpu: dict, cpu: dict, rows_total: int) -> None:
    if set(gpu) != set(cpu) or "eval_/next-item/ndcg_at_10" not in gpu:
        fail(f"evaluate returned keys {sorted(gpu)}")
    for k, v in gpu.items():
        if not math.isfinite(v):
            fail(f"evaluate: {k} = {v}")
        if k != "eval_loss" and not 0.0 <= v <= 1.0:
            fail(f"evaluate: {k} = {v} outside [0, 1]")
    rel = abs(gpu["eval_loss"] - cpu["eval_loss"]) / abs(cpu["eval_loss"])
    if rel > 1e-4:
        fail(f"evaluate: GPU loss {gpu['eval_loss']} vs CPU {cpu['eval_loss']}")
    # a label whose rank flips across a cutoff moves that metric by at most
    # 1/rows (the two devices sum logits in different orders)
    for k in gpu:
        if k != "eval_loss" and abs(gpu[k] - cpu[k]) > 2.0 / rows_total:
            fail(f"evaluate: {k} GPU {gpu[k]} vs CPU {cpu[k]}")


# --------------------------------------------------------------------- serve
def serve_requests(flagship, num_items: int, seq: int, count: int, schema=None) -> list:
    """``count`` requests of 1-3 ragged sessions each, every list column of
    ``schema`` (the flagship's four by default)."""
    from transformers4rec_tpu_torch.data import synthetic_data

    rng = np.random.default_rng(7)
    sizes = rng.integers(1, 4, count)
    schema = schema if schema is not None else flagship.schema(num_items, seq)
    data = synthetic_data(schema, num_rows=int(sizes.sum()), max_session_length=seq,
                          ragged=True, seed=8)
    cols = [k[: -len("__values")] for k in data if k.endswith("__values")]
    sessions = {c: [data[f"{c}__values"][a:b].tolist() for a, b in
                    zip(data[f"{c}__offsets"][:-1], data[f"{c}__offsets"][1:])] for c in cols}
    reqs, at = [], 0
    for m in sizes:
        reqs.append({c: sessions[c][at:at + int(m)] for c in cols})
        at += int(m)
    return reqs


def post(url: str, payload: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def check_topk(got_s, got_i, want_s, want_i, vocab_size: int, what: str,
               atol: float = 1e-5, lowest_id: int = 1) -> None:
    """Top-k scores within ``atol`` and ids equal wherever neighbouring
    scores are more than ``atol`` apart; ids in ``[lowest_id, vocab_size)``
    (``lowest_id`` 0 where the padding row may rank, as in the reference)."""
    got_s, got_i = np.asarray(got_s), np.asarray(got_i)
    if got_i.shape != want_i.shape or got_i.min() < lowest_id or got_i.max() >= vocab_size:
        fail(f"{what}: ids shape {got_i.shape} range [{got_i.min()}, {got_i.max()}]")
    if not np.allclose(got_s, want_s, atol=atol, rtol=0):
        fail(f"{what}: scores differ by {np.abs(got_s - want_s).max()}")
    # the two calls sum in different orders, so near-tied scores may swap places
    gaps = np.abs(np.diff(want_s, axis=1)) > atol
    clear = np.ones_like(want_i, dtype=bool)
    clear[:, :-1] &= gaps
    clear[:, 1:] &= gaps
    if not np.array_equal(got_i[clear], want_i[clear]):
        fail(f"{what}: top-{want_i.shape[1]} ids differ where scores do not tie")


def run_serve(builder, model, example, vocab_size: int, requests: list, device,
              lowest_id: int = 1) -> dict:
    """Export ``model``, serve it over HTTP and hold every answer against an
    in-process ``InferenceRunner`` over the same artifact; the kernel counts
    are set to 0 just before the server starts and read just after it stops."""
    from transformers4rec_tpu_torch.ops import vocab
    from transformers4rec_tpu_torch.serving import InferenceRunner, ServingServer, export_model

    with tempfile.TemporaryDirectory() as path:
        export_model(model, example, path, top_k=TOP_K)
        runner = InferenceRunner(path, builder, device=device)
        vocab.ce_rank.launches = 0
        server = ServingServer(path, builder, host="127.0.0.1", port=0,
                               max_batch_size=64, max_delay_ms=50.0, device=device).start()
        try:
            url = f"http://127.0.0.1:{server.port}/v2/predict"
            t0 = time.perf_counter()
            answers = [post(url, {"inputs": r}) for r in requests[:2]]
            with ThreadPoolExecutor(len(requests) - 2) as pool:
                answers += list(pool.map(lambda r: post(url, {"inputs": r}), requests[2:]))
            wall = time.perf_counter() - t0
            with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/v2/stats",
                                        timeout=30) as r:
                stats = json.loads(r.read())
        finally:
            server.stop()
        launches = {"ce_rank": vocab.ce_rank.launches}
        for i, (req, ans) in enumerate(zip(requests, answers)):
            want_s, want_i = runner.predict(req)
            check_topk(ans["item_id_scores"], ans["item_ids"], want_s, want_i, vocab_size,
                       f"request {i}", lowest_id=lowest_id)
    if stats["requests"] != len(requests) or not stats["batches"] < stats["requests"]:
        fail(f"serve: stats {stats} show no coalescing of {len(requests)} requests")
    return {"stats": stats, "wall_s": wall, "launches": launches}



# ------------------------------------------- GPT-2-CLM on long sessions
def flash_counters(vocab, fa) -> dict:
    return {"flash_fwd": fa.flash_fwd, "flash_bwd_fused": fa.flash_bwd_fused,
            "flash_bwd_dq": fa.flash_bwd_dq, "flash_bwd_dkv": fa.flash_bwd_dkv,
            "ce_fwd": vocab.ce_fwd, "ce_bwd": vocab.ce_bwd, "ce_rank": vocab.ce_rank}


def counted(counters: dict, fn, device="cuda") -> tuple:
    """``fn()`` with every count set to 0 just before and read just after:
    ``(result, launches, seconds)``."""
    for c in counters.values():
        c.launches = 0
    sync(device)
    t0 = time.perf_counter()
    result = fn()
    sync(device)
    return result, {k: c.launches for k, c in counters.items()}, time.perf_counter() - t0


def expect_launches(what: str, got: dict, **want) -> None:
    """Fail unless the named kernels launched as often as given and every
    other kernel of ``got`` not at all."""
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        fail(f"{what} launched {got}, expected {full}")


def trainer_phases(trainer, counters, launches: dict, tag: str, card: str, rows: int, seq: int,
                   phases, per_step: dict) -> dict:
    """``trainer.train`` for each ``(name, steps, batches)`` of ``phases``
    (``batches``: None for the trainer's own data, else one batch repeated),
    the counts set to 0 just before each and read just after; each kernel
    of ``per_step`` must launch that many times a step, every other not at
    all, and every loss read must be finite."""
    a, out = trainer.args, {}
    for name, n, batch in phases:
        a.max_steps = n
        if batch is not None:
            trainer._train_dataloader = [batch] * n
        a.logging_steps = 1 if batch is not None else n
        metrics, got, wall = counted(counters, trainer.train)
        expect_launches(f"{tag} ({name})", got, **{k: c * n for k, c in per_step.items()})
        for k, c in got.items():
            launches[k] += c
        reads = [h["loss"] for h in trainer.state.log_history
                 if "loss" in h and h["step"] > trainer.state.global_step - n]
        if metrics["train_steps"] != n or not reads \
                or not all(math.isfinite(v) for v in reads + [metrics["train_loss"]]):
            fail(f"{tag} ({name}): {metrics}, loss reads {reads}")
        out[name] = {"steps": n, "wall_s": wall, "ms_per_step": 1e3 * wall / n,
                     "sessions_per_s": n * rows / wall, "positions_per_step": rows * seq,
                     "mean_loss": metrics["train_loss"], "loss_reads": reads}
        print(f"[{tag}] {name} on {card}: {json.dumps(out[name])}")
    return out


def run_clm(flagship, vocab, fa, card: str, vocab_size: int) -> dict:
    """GPT-2-CLM at full width on sessions of up to 256: evaluation and top-k
    on the card against the same weights on the CPU (which takes the plain
    versions), one training step card against CPU at batch 4, then the
    trainer for 8 steps over 8 batches of 32 sessions and 16 more on one
    repeated batch. Per step K5 and K6a launch once per layer, K1 and K2
    once."""
    from transformers4rec_tpu_torch.data import synthetic_data
    from transformers4rec_tpu_torch.serving import InferenceRunner, export_model

    seq, rows, layers = flagship.LONG_SEQ, flagship.LONG_BATCH, flagship.N_LAYER
    counters = flash_counters(vocab, fa)
    launches = dict.fromkeys(counters, 0)

    def add(got):
        for k, n in got.items():
            launches[k] += n

    # ---- evaluate: K5 once per layer and K3 once, per batch
    model = flagship.build_model("cuda", scheme="clm", seed=0, dropout=0.0)
    cpu_model = flagship.build_model("cpu", scheme="clm", seed=0, dropout=0.0)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    loader = eval_batches(flagship, flagship.NUM_ITEMS, seq, EVAL_BATCHES, rows)
    gpu_res, got, eval_s = counted(counters, lambda: model.evaluate(loader))
    print(f"[clm-evaluate] cuda {eval_s:.3f}s launches {got} {json.dumps(gpu_res)}")
    expect_launches("clm evaluate", got, flash_fwd=layers * EVAL_BATCHES, ce_rank=EVAL_BATCHES)
    add(got)
    cpu_res = cpu_model.evaluate(loader)
    print(f"[clm-evaluate] cpu reference {json.dumps(cpu_res)}")
    check_evaluate(gpu_res, cpu_res, EVAL_BATCHES * rows)

    # ---- top-k of 8 ragged sessions through the exported artifact
    requests = serve_requests(flagship, flagship.NUM_ITEMS, seq, 8)
    sessions = {c: sum((r[c] for r in requests), [])[:8] for c in requests[0]}
    with tempfile.TemporaryDirectory() as path:
        export_model(model, loader[0], path, top_k=TOP_K)
        runner = InferenceRunner(path, flagship.build_clm_model, device="cuda")
        cpu_runner = InferenceRunner(path, flagship.build_clm_model, device="cpu")
        (got_s, got_i), got, _ = counted(counters, lambda: runner.predict(sessions))
        want_s, want_i = cpu_runner.predict(sessions)
    expect_launches("clm predict", got, flash_fwd=layers)
    add(got)
    # the card's and the CPU's hidden states differ by bf16 roundings in three
    # layers of attention: scores within 1e-3, ids equal where no two
    # neighbouring scores are closer than that
    check_topk(got_s, got_i, want_s, want_i, vocab_size, "clm top-k against the CPU",
               atol=1e-3)
    print(f"[clm-predict] {len(got_i)} sessions, top-{TOP_K} ids agree with the CPU")

    # ---- one training step, the card against the CPU, at batch 4
    four = {k: v[:4] for k, v in loader[0].items()}
    step, got, _ = counted(counters, lambda: check_training_step(
        model, cpu_model, four, extra=("heads.0.body.blocks.1.encoder.position_embedding",)))
    expect_launches("clm training step", got, flash_fwd=layers, flash_bwd_fused=layers,
                    ce_fwd=1, ce_bwd=1)
    add(got)
    print(f"[clm-train-step] {json.dumps(step)}")
    del model, cpu_model, runner, cpu_runner
    torch.cuda.empty_cache()

    # ---- the trainer
    steps, repeat = 8, 16
    data = synthetic_data(flagship.schema(flagship.NUM_ITEMS, seq), num_rows=steps * rows,
                          max_session_length=seq, seed=400)
    trainer = flagship.build_trainer("cuda", seed=0, train_dataset=data, scheme="clm")
    a = trainer.args
    if a.per_device_train_batch_size != rows or a.max_sequence_length != seq:
        fail(f"build_trainer(scheme='clm'): batch {a.per_device_train_batch_size}, "
             f"sessions of {a.max_sequence_length}")
    out = {"evaluate": gpu_res, "train_step": step}
    out.update(trainer_phases(
        trainer, counters, launches, "clm-train", card, rows, seq,
        (("eight_batches", steps, None),
         ("one_batch_repeated", repeat, {k: v[:rows] for k, v in data.items()})),
        {"flash_fwd": layers, "flash_bwd_fused": layers, "ce_fwd": 1, "ce_bwd": 1}))
    reads = out["one_batch_repeated"]["loss_reads"]
    # dropout differs from step to step: the mean of the last 4 steps must
    # lie below the first loss
    if not float(np.mean(reads[-4:])) < reads[0]:
        fail(f"clm train: the repeated batch's loss did not fall: {reads}")
    out["launches"] = launches
    return out


def long_step_trainer(flagship) -> tuple:
    """``(trainer, data)``: the one-layer GPT-2-CLM trainer on 4 synthetic
    sessions of up to 4,096 items, a batch of 4."""
    from transformers4rec_tpu_torch.data import synthetic_data

    seq, rows = LONG_STEP_SEQ, LONG_STEP_BATCH
    data = synthetic_data(flagship.schema(flagship.NUM_ITEMS, seq), num_rows=rows,
                          max_session_length=seq, seed=500)
    return flagship.build_trainer("cuda", seed=0, train_dataset=data, scheme="clm", seq=seq,
                                  batch=rows, n_layer=1), data


def run_long_step(flagship, vocab, fa, card: str, steady: int = LONG_STEP_STEADY) -> dict:
    """Training steps of the one-layer GPT-2-CLM model on 4 sessions of up
    to 4,096 items, through ``flagship.build_trainer``: one cold step, then
    ``steady`` more, timed together (ms per step). K6a's dq partials would
    pass the cap there, so the backward takes K6b and K6c, once a step."""
    seq, rows = LONG_STEP_SEQ, LONG_STEP_BATCH
    trainer, data = long_step_trainer(flagship)
    counters = flash_counters(vocab, fa)
    torch.cuda.reset_peak_memory_stats()
    launches = dict.fromkeys(counters, 0)
    res = {"positions": rows * seq, "real_items": int((data["item_id"] != 0).sum()),
           "dq_partials_would_take_bytes": rows * seq * flagship.D_MODEL * 4 * (seq // 64)}
    for phase, n in (("cold", 1), ("steady", steady)):
        trainer.args.max_steps = n
        metrics, got, wall = counted(counters, trainer.train)
        expect_launches(f"the S = 4,096 steps ({phase})", got, flash_fwd=n, flash_bwd_dq=n,
                        flash_bwd_dkv=n, ce_fwd=n, ce_bwd=n)
        for k, c in got.items():
            launches[k] += c
        res[phase] = {"steps": n, "loss": metrics["train_loss"], "wall_s": wall,
                      "ms_per_step": 1e3 * wall / n}
        if phase == "cold":
            attn = trainer.model.heads[0].body.blocks[1].encoder.layers[0].attn
            res["grad_max_abs"] = {g: float(getattr(attn, g).weight.grad.abs().max())
                                   for g in ("q", "k", "v")}
    res["launches"] = launches
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    print(f"[long-step] on {card}: {json.dumps(res)}")
    if not all(math.isfinite(res[p]["loss"]) for p in ("cold", "steady")) \
            or not all(math.isfinite(g) and g > 0 for g in res["grad_max_abs"].values()):
        fail(f"the S = 4,096 steps: {res}")
    return res


# ------------------------------------------------- XLNet-PLM (two streams)
PLM_EXTRA = ("heads.0.body.blocks.1.encoder.query_stream_init",
             "heads.0.body.blocks.1.encoder.rel_pos.rel_bias")


def target_rows(loader) -> int:
    """Positions that carry a target in every-position evaluation: all but
    each session's last item."""
    return sum(int(((np.asarray(b["item_id"]) != 0).sum(1) - 1).clip(0).sum()) for b in loader)


def run_plm(flagship, vocab, fa, card: str, vocab_size: int) -> dict:
    """Main path P1: XLNet-PLM at full width (``flagship.build_model(scheme=
    "plm")``: two-stream attention, sessions of 20, every one of a batch's
    2,560 positions a CE row). ``Model.evaluate`` over 4 batches of 128
    sessions on the last item (K3 at 128 rows) and on every position (K3 at
    2,560 rows), each against the same weights on the CPU; one
    every-position batch with ``use_fused_ops=False`` (dense logits) against
    the fused result on the card; the top-k of 8 ragged sessions through the
    exported artifact against the CPU's; one training step card against CPU
    (``check_training_step``, the perm mask given to both); then
    ``flagship.build_trainer(scheme="plm")`` for 8 steps over 8 batches and
    16 on one repeated batch. No flash kernel runs at S = 20."""
    from transformers4rec_tpu_torch.data import synthetic_data
    from transformers4rec_tpu_torch.serving import InferenceRunner, export_model

    counters = flash_counters(vocab, fa)
    launches = dict.fromkeys(counters, 0)

    def add(got):
        for k, n in got.items():
            launches[k] += n

    def pair(last: bool):
        gpu = flagship.build_model("cuda", scheme="plm", seed=0, dropout=0.0,
                                   eval_on_last_item_seq_only=last)
        cpu = flagship.build_model("cpu", scheme="plm", seed=0, dropout=0.0,
                                   eval_on_last_item_seq_only=last)
        return gpu, cpu

    model, cpu_model = pair(True)
    every, cpu_every = pair(False)
    state = model.state_dict()
    every.load_state_dict(state)
    for m in (cpu_model, cpu_every):
        m.load_state_dict({k: v.cpu() for k, v in state.items()})
    loader = eval_batches(flagship, flagship.NUM_ITEMS, flagship.SEQ, EVAL_BATCHES, EVAL_ROWS)
    out = {"target_rows": target_rows(loader)}
    for tag, gpu, cpu, rows in (("last_item", model, cpu_model, EVAL_BATCHES * EVAL_ROWS),
                                ("every_position", every, cpu_every, out["target_rows"])):
        res, got, wall = counted(counters, lambda: gpu.evaluate(loader))
        expect_launches(f"plm evaluate ({tag})", got, ce_rank=EVAL_BATCHES)
        add(got)
        cpu_res = cpu.evaluate(loader)
        print(f"[plm-evaluate] {tag} {wall:.3f}s cuda {json.dumps(res)} cpu {json.dumps(cpu_res)}")
        check_evaluate(res, cpu_res, rows)
        out[tag] = {"evaluate": res, "wall_s": wall, "batches": EVAL_BATCHES}
    del cpu_every

    # ---- one every-position batch with dense logits, against the fused pass
    one = loader[:1]
    fused, got, _ = counted(counters, lambda: every.evaluate(one))
    expect_launches("plm evaluate (every position, one batch)", got, ce_rank=1)
    add(got)
    # K3's launches at 2,560 rows: the 4 batches and this one
    out["k3_launches_at_every_position"] = EVAL_BATCHES + 1
    every.heads[0].tasks[0].use_fused_ops = False
    dense, got, wall = counted(counters, lambda: every.evaluate(one))
    expect_launches("plm evaluate (every position, not fused)", got)
    every.heads[0].tasks[0].use_fused_ops = True
    check_evaluate(dense, fused, target_rows(one))
    out["every_position_dense"] = {"evaluate": dense, "wall_s": wall}
    print(f"[plm-evaluate] every position, dense logits {wall:.3f}s {json.dumps(dense)}")
    del every
    torch.cuda.empty_cache()

    # ---- top-k of 8 ragged sessions through the exported artifact
    requests = serve_requests(flagship, flagship.NUM_ITEMS, flagship.SEQ, 8)
    sessions = {c: sum((r[c] for r in requests), [])[:8] for c in requests[0]}
    with tempfile.TemporaryDirectory() as path:
        export_model(model, loader[0], path, top_k=TOP_K)
        runner = InferenceRunner(path, flagship.build_plm_model, device="cuda")
        cpu_runner = InferenceRunner(path, flagship.build_plm_model, device="cpu")
        (got_s, got_i), got, _ = counted(counters, lambda: runner.predict(sessions))
        want_s, want_i = cpu_runner.predict(sessions)
    expect_launches("plm predict", got)
    # f32 throughout on both devices: scores within 1e-4
    check_topk(got_s, got_i, want_s, want_i, vocab_size, "plm top-k against the CPU", atol=1e-4)
    print(f"[plm-predict] {len(got_i)} sessions, top-{TOP_K} ids agree with the CPU")
    del runner, cpu_runner

    # ---- one training step, the card against the CPU
    step, got, _ = counted(counters, lambda: check_training_step(model, cpu_model, loader[0],
                                                                 extra=PLM_EXTRA))
    expect_launches("plm training step", got, ce_fwd=1, ce_bwd=1)
    add(got)
    print(f"[plm-train-step] {json.dumps(step)}")
    out["train_step"] = step
    del model, cpu_model
    torch.cuda.empty_cache()

    # ---- the trainer
    rows, steps, repeat = flagship.BATCH, 8, 16
    data = synthetic_data(flagship.schema(), num_rows=steps * rows,
                          max_session_length=flagship.SEQ, seed=700)
    trainer = flagship.build_trainer("cuda", seed=0, train_dataset=data, scheme="plm")
    a = trainer.args
    if a.per_device_train_batch_size != rows or a.max_sequence_length != flagship.SEQ:
        fail(f"build_trainer(scheme='plm'): batch {a.per_device_train_batch_size}, "
             f"sessions of {a.max_sequence_length}")
    out.update(trainer_phases(
        trainer, counters, launches, "plm-train", card, rows, flagship.SEQ,
        (("eight_batches", steps, None),
         ("one_batch_repeated", repeat, {k: v[:rows] for k, v in data.items()})),
        {"ce_fwd": 1, "ce_bwd": 1}))
    reads = out["one_batch_repeated"]["loss_reads"]
    # masks differ from step to step: the mean of the last 4 steps must lie
    # below the first loss
    if not float(np.mean(reads[-4:])) < reads[0]:
        fail(f"plm train: the repeated batch's loss did not fall: {reads}")
    del trainer
    torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def run_plm_long(flagship, vocab, fa, card: str) -> dict:
    """Main path P2: XLNet-PLM on sessions of up to 256 at batch 32, where
    both streams of each layer take K5 with a (B, H, S, S) bias (the perm
    mask and the learned relative bias) and the dense backward that yields
    the bias gradient. One every-position evaluation batch (K3 at 8,192
    rows) and one training step at batch 4, each card against CPU, then 8
    trainer steps at batch 32 (K1 and K2 at 8,192 rows)."""
    from transformers4rec_tpu_torch.data import synthetic_data

    seq, rows, layers = flagship.LONG_SEQ, flagship.LONG_BATCH, flagship.N_LAYER
    counters = flash_counters(vocab, fa)
    launches = dict.fromkeys(counters, 0)

    def add(got):
        for k, n in got.items():
            launches[k] += n

    model = flagship.build_model("cuda", scheme="plm", seq=seq, seed=0, dropout=0.0,
                                 eval_on_last_item_seq_only=False)
    cpu_model = flagship.build_model("cpu", scheme="plm", seq=seq, seed=0, dropout=0.0,
                                     eval_on_last_item_seq_only=False)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    loader = eval_batches(flagship, flagship.NUM_ITEMS, seq, 1, rows)
    res, got, wall = counted(counters, lambda: model.evaluate(loader))
    expect_launches("plm-long evaluate", got, flash_fwd=2 * layers, ce_rank=1)
    add(got)
    cpu_res = cpu_model.evaluate(loader)
    print(f"[plm-long-evaluate] {wall:.3f}s cuda {json.dumps(res)} cpu {json.dumps(cpu_res)}")
    check_evaluate(res, cpu_res, target_rows(loader))
    out = {"evaluate": res, "eval_wall_s": wall, "k3_rows": rows * seq}

    four = {k: v[:4] for k, v in loader[0].items()}
    step, got, _ = counted(counters, lambda: check_training_step(model, cpu_model, four,
                                                                 extra=PLM_EXTRA))
    expect_launches("plm-long training step", got, flash_fwd=2 * layers, ce_fwd=1, ce_bwd=1)
    add(got)
    print(f"[plm-long-train-step] {json.dumps(step)}")
    out["train_step"] = step
    del model, cpu_model
    torch.cuda.empty_cache()

    steps = 8
    data = synthetic_data(flagship.schema(flagship.NUM_ITEMS, seq), num_rows=steps * rows,
                          max_session_length=seq, seed=800)
    trainer = flagship.build_trainer("cuda", seed=0, train_dataset=data, scheme="plm", seq=seq,
                                     batch=rows)
    out.update(trainer_phases(trainer, counters, launches, "plm-long-train", card, rows, seq,
                              (("eight_batches", steps, None),),
                              {"flash_fwd": 2 * layers, "ce_fwd": 1, "ce_bwd": 1}))
    del trainer
    torch.cuda.empty_cache()
    out["launches"] = launches
    return out


# ------------------------------------------------------- vocab-parallel head
def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_vocab_parallel(flagship, vocab, model, loader, gpu_res: dict, vocab_size: int,
                       table_dtype=None) -> dict:
    """The vocab-parallel head through the entry points, at full width, over
    a process group of one rank on the model's device (NCCL on the card):
    the group's collectives run, the table is one shard. ``model`` is the
    unsharded model with the same weights and ``gpu_res`` its evaluation of
    ``loader``; ``table_dtype`` bf16 stores the shard as bf16, as the model's
    tables are. The kernel counts are set to 0 just before each call and read
    just after."""
    from transformers4rec_tpu_torch.trainer import cast_tables_

    import torch.distributed as dist

    device = model.device
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        sharded = flagship.build_model(device, seed=0, dropout=0.0, vocab_parallel_group=group)
        if table_dtype is not None:
            cast_tables_(sharded, table_dtype)
        sharded.load_state_dict(model.state_dict())
        counters = {"ce_fwd": vocab.ce_fwd, "ce_bwd": vocab.ce_bwd, "rank": vocab.rank_counts,
                    "ce_rank": vocab.ce_rank}

        def on_group(fn):
            return counted(counters, fn, device)

        # ---- evaluate: K1 and K4 once per batch, K3 never
        res, eval_launches, eval_s = on_group(lambda: sharded.evaluate(loader))
        print(f"[vocab-parallel] evaluate {eval_s:.3f}s launches {eval_launches} "
              f"{json.dumps(res)}")
        if eval_launches != {"ce_fwd": len(loader), "rank": len(loader), "ce_bwd": 0,
                             "ce_rank": 0}:
            fail(f"vocab-parallel evaluate launched {eval_launches}")
        check_evaluate(res, gpu_res, EVAL_BATCHES * EVAL_ROWS)

        # ---- one training step, the same mask for both models
        batch = model._as_dense(loader[0])
        info = model.heads[0].input_module.masking.compute_masked_targets(
            batch["item_id"].long(), training=True,
            generator=torch.Generator(device=device).manual_seed(5))
        losses = {}

        def step(m):
            m.zero_grad(set_to_none=True)
            loss, _ = m(batch, targets=batch, training=True, masking_info=info)
            loss.backward()
            return float(loss.detach()), m.heads[0].input_module.item_embedding_table().grad

        (losses["sharded"], grad), train_launches, _ = on_group(lambda: step(sharded))
        losses["unsharded"], want_grad = step(model)
        if train_launches != {"ce_fwd": 1, "ce_bwd": 1, "rank": 0, "ce_rank": 0}:
            fail(f"vocab-parallel training step launched {train_launches}")
        if not abs(losses["sharded"] - losses["unsharded"]) <= 1e-6 * abs(losses["unsharded"]):
            fail(f"vocab-parallel training step: losses {losses}")
        table_grad = check_grad("vocab-parallel training step, item table gradient",
                                grad, want_grad)
        sharded.zero_grad(set_to_none=True)
        model.zero_grad(set_to_none=True)

        # ---- top-k of 8 sessions against the unsharded f32 top-k
        eight = {k: v[:8] for k, v in batch.items()}
        with torch.inference_mode():
            (got_s, got_i), _, _ = on_group(lambda: sharded(eight, top_k=TOP_K))
            want_s, want_i = model(eight, top_k=TOP_K)
        check_topk(got_s.cpu().numpy(), got_i.cpu().numpy(), want_s.cpu().numpy(),
                   want_i.cpu().numpy(), vocab_size, "vocab-parallel top-k")
        launches = {k: eval_launches[k] + train_launches[k] for k in eval_launches}
        return {"evaluate": res, "evaluate_s": eval_s, "losses": losses,
                "item_table_grad": table_grad, "launches": launches}
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------- train
def check_training_step(model, cpu_model, batch, extra=(), loss_rtol: float = 1e-4,
                        extra_rel: float = 5e-3, cpu_sums=None, neg_ids=None,
                        grad_rel: float = 1e-3) -> dict:
    """One training forward and backward of the same weights on the card and
    on the CPU (which takes the plain versions), with one mask, drawn once
    and given to both, and dropout off (both models are built with dropout
    0). The loss, and each task's, must agree within ``loss_rtol``
    relative; the gradients of the item table (the lookup's plus the CE's
    dW) and of the output projection as ``check_grad`` says, within
    ``grad_rel`` (1e-3) in relative Frobenius norm; those of the parameters
    named in ``extra`` within ``extra_rel`` in relative Frobenius norm (5e-3:
    they lie below every layer's bf16 roundings of q, k, v, P and dS on two
    devices where attention takes the flash path). A batch with
    ``segment_ids`` (packed rows) draws its mask per segment. ``cpu_sums`` maps a name
    of ``extra`` to the CPU model's parameters whose gradients add up to it
    (a shared layer against its unshared copies). ``neg_ids`` gives sampled
    softmax its negatives on both."""
    im = cpu_model.heads[0].input_module
    cb = cpu_model._as_dense(batch)
    # packed rows: the draw keeps its guarantees per segment
    info = im.masking.compute_masked_targets(cb[im.item_id].long(), training=True,
                                          generator=torch.Generator().manual_seed(5),
                                          segment_ids=cb.get("segment_ids"))
    if neg_ids is not None:
        info = info.replace(neg_ids=neg_ids)
    grads, losses, task_losses = {}, {}, {}
    # every field of the mask goes to the device (PLM's perm_mask too)
    fields = [f for f in ("targets", "mask", "input_schema", "pad_mask", "perm_mask", "neg_ids")
              if getattr(info, f) is not None]
    for name, m, b in (("cpu", cpu_model, cb), ("cuda", model, model._as_dense(batch))):
        dev_info = info.replace(**{f: getattr(info, f).to(m.device) for f in fields})
        m.zero_grad(set_to_none=True)
        loss, outs = m(b, targets=b, training=True, masking_info=dev_info)
        loss.backward()
        sync(m.device)
        losses[name] = float(loss.detach())
        task_losses[name] = {t: float(o.loss.detach()) for t, o in outs.items()}
        projection = m.heads[0].tasks[0].tying_projection
        named = dict(m.named_parameters())
        sums = (cpu_sums or {}) if name == "cpu" else {}
        grads[name] = {"item_table": m.heads[0].input_module.item_embedding_table().grad.cpu(),
                       **{n: sum(named[c].grad.cpu() for c in sums.get(n, (n,)))
                          for n in extra}}
        if projection is not None:  # none where d_model is the table's width
            grads[name]["projection"] = projection.weight.grad.cpu()
        m.zero_grad(set_to_none=True)
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    if not math.isfinite(losses["cuda"]) or rel > loss_rtol:
        fail(f"training step: loss on the card {losses['cuda']} vs CPU {losses['cpu']}")
    for t, want in task_losses["cpu"].items():
        got = task_losses["cuda"][t]
        if not math.isfinite(got) or abs(got - want) > loss_rtol * abs(want):
            fail(f"training step: task {t}'s loss on the card {got} vs CPU {want}")

    def short(n: str) -> str:
        # a shared layer's parameters by their names in the layer, a task's
        # by its place in the head, others by their last name
        if "layer_shared." in n:
            return n.rsplit("layer_shared.", 1)[-1]
        return n[len("heads.0."):] if n.startswith("heads.0.tasks.") else n.rsplit(".", 1)[-1]

    out = {"loss": losses, "targets": int(info.mask.sum()), "loss_rel_diff": rel,
           **{f"{g}_grad": check_grad(f"training step, {g} gradient", grads["cuda"][g],
                                      grads["cpu"][g], rel=grad_rel)
              for g in ("item_table", "projection") if g in grads["cpu"]},
           **{short(n) + "_grad": check_grad(f"training step, {n} gradient",
                                             grads["cuda"][n], grads["cpu"][n], rel=extra_rel)
              for n in extra}}
    if len(task_losses["cpu"]) > 1:
        out["task_losses"] = task_losses
    return out


def run_train(flagship, vocab, card: str, streamed: bool = False) -> dict:
    """The trainer at full width: 16 steps over 16 batches, then 32 steps on
    one repeated batch. With ``streamed`` the tables take the streamed update
    with an f32 moment (K7a and K7b on the item table). The kernel counts are
    set to 0 just before each ``train()`` and read just after."""
    from transformers4rec_tpu_torch.data import synthetic_data
    from transformers4rec_tpu_torch.ops import fused_adafactor as fa

    tag = "train-streamed" if streamed else "train"
    rows = flagship.BATCH
    data = synthetic_data(flagship.schema(), num_rows=TRAIN_STEPS * rows,
                          max_session_length=flagship.SEQ, seed=200)
    trainer = flagship.build_trainer("cuda", seed=0, train_dataset=data,
                                     streamed_table_update=streamed)
    a = trainer.args
    if a.steps_per_execution != 8 or a.per_device_train_batch_size != rows:
        fail(f"build_trainer: K={a.steps_per_execution}, batch={a.per_device_train_batch_size}")
    table = trainer.model.heads[0].input_module.item_embedding_table()
    table_before = table.detach().clone()
    counters = {"ce_fwd": vocab.ce_fwd, "ce_bwd": vocab.ce_bwd,
                "adafactor_a": fa.adafactor_pass_a, "adafactor_b": fa.adafactor_pass_b}
    launches = dict.fromkeys(counters, 0)
    out = {}

    def phase(name: str, steps: int) -> list:
        a.max_steps = steps
        for c in counters.values():
            c.launches = 0
        sync("cuda")
        t0 = time.perf_counter()
        metrics = trainer.train()
        sync("cuda")
        wall = time.perf_counter() - t0
        got = {k: c.launches for k, c in counters.items()}
        # the streamed update runs on the item table only, once per step
        table_steps = steps if streamed else 0
        if got != {"ce_fwd": steps, "ce_bwd": steps, "adafactor_a": table_steps,
                   "adafactor_b": table_steps} or metrics["train_steps"] != steps:
            fail(f"{tag} ({name}): {steps} steps launched {got}")
        for k in launches:
            launches[k] += got[k]
        reads = [h["loss"] for h in trainer.state.log_history
                 if "loss" in h and h["step"] > trainer.state.global_step - steps]
        if not reads or not all(math.isfinite(v) for v in reads + [metrics["train_loss"]]):
            fail(f"{tag} ({name}): loss reads {reads}, mean {metrics['train_loss']}")
        out[name] = {"steps": steps, "wall_s": wall, "steps_per_s": steps / wall,
                     "sessions_per_s": steps * rows / wall, "ms_per_step": 1e3 * wall / steps,
                     "mean_loss": metrics["train_loss"], "loss_reads": reads}
        print(f"[{tag}] {name} on {card}: {json.dumps(out[name])}")
        return reads

    a.logging_steps = 8  # one host read of the loss after each group of 8 steps
    if len(phase("sixteen_batches", TRAIN_STEPS)) != TRAIN_STEPS // 8:
        fail(f"{tag}: expected one loss read per group of 8 steps")
    batch = {k: v[:rows] for k, v in data.items()}
    trainer._train_dataloader = [batch] * REPEAT_STEPS
    a.logging_steps = 1
    reads = phase("one_batch_repeated", REPEAT_STEPS)
    # masks and dropout differ from step to step, so single losses are noisy:
    # the mean of the last 8 steps must lie below the first loss
    if not float(np.mean(reads[-8:])) < reads[0]:
        fail(f"{tag}: the repeated batch's loss did not fall: {reads}")
    moment = trainer.optimizers["table"].state[table]["v"]
    if moment.dtype != (torch.float32 if streamed else torch.bfloat16) \
            or moment.shape != table.shape:
        fail(f"{tag}: the table's moment is {moment.dtype} {tuple(moment.shape)}")
    if not (torch.isfinite(table).all() and torch.isfinite(moment.float()).all()):
        fail(f"{tag}: the item table or its moment holds a non-finite value")
    moved = float((table.detach() - table_before).abs().max())
    if not moved > 0 or not bool((moment != 0).any()):
        fail(f"{tag}: the item table or its moment did not change")
    out.update(launches=launches, global_step=trainer.state.global_step,
               table_max_move=moved, moment_nonzero_share=float((moment != 0).float().mean()))
    return out


def check_streamed_step(flagship) -> dict:
    """One optimizer step of the streamed arm against one of the plain
    f32-moment arm: two trainers from the same seed hold the same weights and
    the same generator, so they draw the same mask and dropout on the same
    batch. The item table's moment must agree within 1e-6 relative and the
    table within 1e-5 of the largest update plus its float32 spacing, as in
    ``check_adafactor``; the 150-row category table takes the plain chain on
    both arms and must be equal."""
    from transformers4rec_tpu_torch.data import synthetic_data

    data = synthetic_data(flagship.schema(), num_rows=flagship.BATCH,
                          max_session_length=flagship.SEQ, seed=300)
    results = {}
    for arm in ("streamed", "plain_f32"):
        trainer = flagship.build_trainer("cuda", seed=0, train_dataset=data,
                                         streamed_table_update=arm == "streamed")
        if arm == "plain_f32":
            trainer.args.embedding_moment_dtype = "f32"  # read when the optimizers are made
        trainer.args.max_steps = 1
        tables = trainer.model.heads[0].input_module.categorical_module.tables
        before = tables["item_id"].detach().clone()
        loss = trainer.train()["train_loss"]
        sync("cuda")
        state = trainer.optimizers["table"].state
        results[arm] = {"loss": loss, "before": before,
                        "item": tables["item_id"].detach().clone(),
                        "item_v": state[tables["item_id"]]["v"].clone(),
                        "category": tables["category"].detach().clone()}
        del trainer
    s, q = results["streamed"], results["plain_f32"]
    if s["item_v"].dtype != torch.float32 or q["item_v"].dtype != torch.float32:
        fail("streamed step: a moment is not f32")
    touched = q["item_v"] > 1e-20  # untouched rows hold (1 - decay) * eps in both
    update = float((q["item"] - q["before"]).abs().max())
    out = {"loss": {k: results[k]["loss"] for k in results},
           "largest_update": update,
           "touched_share": float(touched.float().mean()),
           "moment_max_rel_err": float(((s["item_v"] - q["item_v"]).abs()
                                        / q["item_v"]).max()),
           "table_max_abs_err": float((s["item"] - q["item"]).abs().max()),
           "category_equal": bool(torch.equal(s["category"], q["category"]))}
    print(f"[streamed-step] {json.dumps(out)}")
    allowed = 1e-5 * update + 2.0 ** -23 * float(q["item"].abs().max())
    if out["loss"]["streamed"] != out["loss"]["plain_f32"]:
        fail(f"streamed step: the two arms' losses differ: {out['loss']}")
    if not update > 0 or out["moment_max_rel_err"] > 1e-6 \
            or out["table_max_abs_err"] > allowed or not out["category_equal"]:
        fail(f"streamed step: {out}")
    return out


# ------------------------------------------ Q: from Parquet files, on the card
PARQUET_TRAIN_STEPS = 8
PARQUET_SESSIONS_PER_DAY = 1_500
PARQUET_VAL_SIZE = 0.12
# loss sequences of two runs on the card that should be one trajectory (the
# Parquet and the in-memory loader; a resumed and an unbroken run): the
# kernels are deterministic, PyTorch's embedding and index backward on CUDA
# accumulate with atomics, so the runs may part in the last bits of the
# table's gradient, which eight Adafactor steps carry into the loss
PARQUET_LOSS_RTOL = 1e-3


def parquet_windows(flagship, root: str, seed: int = 300,
                    sessions_per_day: int = PARQUET_SESSIONS_PER_DAY) -> tuple:
    """Raw interactions of three days of ``sessions_per_day`` sessions,
    drawn from ``seed``: sessions of 2 to 20 items, item ids in 1..390,000
    with log-normal popularity, a category derived from the item, the two
    continuous columns, increasing timestamps; the port's ETL (``etl_interactions_to_time_splits``,
    without ``categorify``: the ids stay below the table's rows) writes them
    into ``root/{1,2,3}/{train,valid,test}.parquet``. Returns ``root`` and
    the sessions of each file."""
    import pandas as pd

    from transformers4rec_tpu_torch.utils import data_utils

    rng = np.random.default_rng(seed)
    n_sessions = 3 * sessions_per_day
    lengths = rng.integers(2, flagship.SEQ + 1, n_sessions)
    sid = np.repeat(np.arange(1, n_sessions + 1), lengths)
    day = np.repeat(np.arange(n_sessions) // sessions_per_day + 1, lengths)
    n = len(sid)
    raw = rng.lognormal(3.0, 1.0, n)
    item = np.clip(1 + (raw / raw.max()) * (flagship.NUM_ITEMS - 1), 1,
                   flagship.NUM_ITEMS).astype(np.int64)
    frame = pd.DataFrame({
        "session_id": sid, "item_id": item,
        "category": 1 + item % (flagship.NUM_CATEGORIES - 1),
        "item_recency": rng.random(n).astype(np.float32),
        "weekday_sin": np.sin(rng.random(n) * 2 * np.pi),
        "timestamp": day * 86_400 + np.sort(rng.integers(0, 86_000, n)), "day": day})
    data_utils.etl_interactions_to_time_splits(
        frame, flagship.schema(), root, day_col="day", maximum_length=flagship.SEQ,
        val_size=PARQUET_VAL_SIZE, test_size=0.0)
    sizes = {f"{w}/{f}": len(pd.read_parquet(os.path.join(root, str(w), f"{f}.parquet")))
             for w in (1, 2, 3) for f in ("train", "valid")}
    return root, sizes


def dense_columns(flagship, path: str) -> dict:
    """The sessions of a Parquet file as a dict of (rows, 20) numpy columns,
    padded here with pandas and numpy, not by the port's loader."""
    import pandas as pd

    frame = pd.read_parquet(path)
    out = {}
    for col in flagship.schema():
        lists = frame[col.name].to_list()
        dtype = np.int64 if col.is_categorical else np.float32
        dense = np.zeros((len(lists), flagship.SEQ), dtype)
        for r, row in enumerate(lists):
            dense[r, :len(row)] = row[:flagship.SEQ]
        out[col.name] = dense
    return out


def loss_reads(trainer, steps: int) -> list:
    return [h["loss"] for h in trainer.state.log_history
            if "loss" in h and h["step"] > trainer.state.global_step - steps]


def same_trajectory(what: str, got: list, want: list) -> float:
    """Fail unless two loss sequences agree within ``PARQUET_LOSS_RTOL``;
    returns their largest relative difference."""
    if len(got) != len(want) or not all(math.isfinite(v) for v in got):
        fail(f"{what}: losses {got} against {want}")
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    if rel > PARQUET_LOSS_RTOL:
        fail(f"{what}: losses {got} against {want} (relative {rel})")
    return rel


def loader_ms(make, reps: int = 3) -> float:
    """Host milliseconds per batch to yield one epoch from a loader."""
    best = math.inf
    for _ in range(reps):
        loader = make()
        t0 = time.perf_counter()
        n = sum(1 for _ in loader)
        best = min(best, 1e3 * (time.perf_counter() - t0) / n)
    return best


def run_parquet_path(flagship, vocab, card: str) -> dict:
    """Main path Q: the README's entry path from Parquet files at full width.
    The port's ETL writes three daily windows; ``flagship.build_trainer``
    reads window 1's ``train.parquet`` (``data_loader_engine="parquet"``) for
    8 steps and window 2's ``valid.parquet`` for ``evaluate``, ``predict``
    and ``log_predictions``, each on the card and on the CPU; the same rows
    as an in-memory dict give the same losses; 8 steps with an evaluation
    and a save every 4 rotate to the expected checkpoints, and a run resumed
    from ``checkpoint-4`` gives the unbroken run's last 4 losses; 8 steps
    under ``"parquet_streaming"``; ``fit_and_evaluate`` over windows 1 and
    2; 3 steps of ``Model.fit``. The kernel counts are set to 0 just before
    each call and read just after: K1 and K2 once a step, K3 once an
    evaluation batch."""
    try:
        import pandas as pd
        import pyarrow
    except ImportError as e:
        fail(f"the Parquet path needs pyarrow and pandas: {e}")
    from transformers4rec_tpu_torch.data import ParquetDataLoader, StreamingParquetDataLoader
    from transformers4rec_tpu_torch.trainer import Trainer
    from transformers4rec_tpu_torch.utils.examples_utils import fit_and_evaluate

    print(f"[parquet] pyarrow {pyarrow.__version__}, pandas {pd.__version__}")
    t_phase = time.perf_counter()
    counters = {"ce_fwd": vocab.ce_fwd, "ce_bwd": vocab.ce_bwd, "ce_rank": vocab.ce_rank}
    launches = dict.fromkeys(counters, 0)
    steps, rows = PARQUET_TRAIN_STEPS, flagship.BATCH
    vocab_size = flagship.NUM_ITEMS + 1
    out = {}

    def run(what: str, fn, **want):
        result, got, wall = counted(counters, fn)
        expect_launches(f"parquet path ({what})", got, **want)
        for k, c in got.items():
            launches[k] += c
        return result, wall

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        windows, sizes = parquet_windows(flagship, os.path.join(root, "windows"))
        out["etl_s"] = time.perf_counter() - t0
        out["sessions"] = sizes
        train_file = os.path.join(windows, "1", "train.parquet")
        eval_file = os.path.join(windows, "2", "valid.parquet")
        n_eval = sizes["2/valid"]
        eval_batches = -(-n_eval // rows)
        if sizes["1/train"] < steps * rows or eval_batches != 2 or n_eval % rows == 0:
            fail(f"parquet path: the ETL wrote {sizes}")
        print(f"[parquet] ETL of 3 windows in {out['etl_s']:.3f}s: {json.dumps(sizes)}")

        def trainer(out_dir: str, dataset=train_file, **args):
            t = flagship.build_trainer("cuda", seed=0, train_dataset=dataset,
                                       eval_dataset=eval_file,
                                       output_dir=os.path.join(root, out_dir))
            t.args.max_steps, t.args.logging_steps = steps, 1
            for k, v in args.items():
                setattr(t.args, k, v)
            return t

        # 1. train from the file, twice 8 steps; then the same rows as a dict
        walls = {}
        for name, dataset in (("parquet", train_file),
                              ("in_memory", dense_columns(flagship, train_file))):
            t = trainer(name, dataset)
            walls[name] = []
            for _ in range(2):
                _, wall = run(f"{name} train", t.train, ce_fwd=steps, ce_bwd=steps)
                walls[name].append(wall)
            reads = loss_reads(t, 2 * steps)[:steps]
            out[f"{name}_losses"] = reads
            if name == "parquet":
                parquet = t
            else:
                in_memory = t
        out["in_memory_vs_parquet_rel"] = same_trajectory(
            "in-memory against Parquet", out["in_memory_losses"], out["parquet_losses"])
        out["step_ms"] = {name: [1e3 * w / steps for w in ws] for name, ws in walls.items()}
        print(f"[parquet] train, {steps} steps twice at batch {rows} of {flagship.SEQ} on "
              f"{card}: ms per step (wall, each train() call) {json.dumps(out['step_ms'])}; "
              f"losses within {out['in_memory_vs_parquet_rel']:.3g} relative")

        # 2-4. evaluate, predict and log_predictions on the card and on the CPU
        gpu_res, out["evaluate_s"] = run("evaluate", parquet.evaluate, ce_rank=eval_batches)
        cpu_model = flagship.build_model("cpu", seed=0)
        cpu_model.load_state_dict({k: v.cpu() for k, v in parquet.model.state_dict().items()})
        cpu = Trainer(cpu_model, parquet.args, schema=parquet.schema, eval_dataset=eval_file,
                      device="cpu")
        cpu_res = cpu.evaluate()

        def metrics(r):
            return {k: v for k, v in r.items() if "_runtime" not in k and "_per_second" not in k}

        check_evaluate(metrics(gpu_res), metrics(cpu_res), n_eval)
        (scores, ids), out["predict_s"] = run("predict", lambda: parquet.predict(eval_file,
                                                                                 top_k=TOP_K))
        if scores.shape != (n_eval, TOP_K):
            fail(f"parquet predict: {scores.shape} for {n_eval} sessions")
        cpu_s, cpu_i = cpu.predict(eval_file, top_k=TOP_K)
        check_topk(scores, ids, cpu_s, cpu_i, vocab_size, "parquet predict")
        parquet.args.predict_top_k = TOP_K
        logged = pd.read_parquet(parquet.log_predictions(eval_file))
        if len(logged) != n_eval or list(logged.columns) != ["pred_item_ids",
                                                             "pred_item_scores"]:
            fail(f"log_predictions wrote {logged.shape}, columns {list(logged.columns)}")
        out["evaluate"] = metrics(gpu_res)
        print(f"[parquet] evaluate ({eval_batches} batches, {n_eval} sessions) "
              f"{out['evaluate_s']:.3f}s and predict {out['predict_s']:.3f}s on the card, "
              f"both equal to the CPU's: {json.dumps(out['evaluate'])}")
        del cpu, cpu_model, parquet

        # 5. checkpoints: an evaluation and a save every 4 steps, one kept
        # beside the best; then a run resumed from the middle of the epoch
        t = trainer("ckpt", save_steps=4, eval_steps=4, save_total_limit=1,
                    load_best_model_at_end=True, metric_for_best_model="recall_at_20",
                    log_json=True)
        run("checkpointed train", t.train, ce_fwd=steps, ce_bwd=steps,
            ce_rank=2 * eval_batches)
        kept = sorted(d for d in os.listdir(t.args.output_dir) if d.startswith("checkpoint-"))
        want_kept = sorted({f"checkpoint-{steps}", os.path.basename(t._best_checkpoint or "")})
        with open(os.path.join(t.args.output_dir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        if kept != want_kept or len(records) != 3:
            fail(f"checkpoints {kept} (expected {want_kept}), {len(records)} metrics records")
        unbroken = loss_reads(t, steps)
        out["checkpointed_vs_parquet_rel"] = same_trajectory(
            "checkpointed against plain run", unbroken, out["parquet_losses"])
        first = trainer("resume", max_steps=steps // 2, save_steps=steps // 2)
        run("train to the checkpoint", first.train, ce_fwd=steps // 2, ce_bwd=steps // 2)
        resumed = trainer("resume")
        path = os.path.join(resumed.args.output_dir, f"checkpoint-{steps // 2}")
        run("resumed train", lambda: resumed.train(resume_from_checkpoint=path),
            ce_fwd=steps // 2, ce_bwd=steps // 2)
        if resumed.state.batches_in_epoch != steps or resumed.state.global_step != steps:
            fail(f"resumed run ended at {resumed.state}")
        out["resume_rel"] = same_trajectory("resumed against unbroken run",
                                            loss_reads(resumed, steps // 2),
                                            unbroken[steps // 2:])
        out["checkpoints_kept"] = kept
        print(f"[parquet] checkpoints kept {kept}; the resumed run's last {steps // 2} losses "
              f"within {out['resume_rel']:.3g} relative of the unbroken run's")
        del t, first, resumed

        # 6. the streaming engine with a shuffle buffer
        t = trainer("stream", data_loader_engine="parquet_streaming", shuffle_buffer_size=512)
        metrics_s, wall = run("streaming train", t.train, ce_fwd=steps, ce_bwd=steps)
        reads = loss_reads(t, steps)
        if len(reads) != steps or not all(math.isfinite(v) for v in reads):
            fail(f"streaming train: {metrics_s}, losses {reads}")
        out["streaming_step_ms"] = 1e3 * wall / steps
        del t

        # 7. the paper's protocol over windows 1 and 2
        eval_w3 = -(-sizes["3/valid"] // rows)
        by_time, out["fit_and_evaluate_s"] = run(
            "fit_and_evaluate", lambda: fit_and_evaluate(in_memory, 1, 2, windows),
            ce_fwd=2 * steps, ce_bwd=2 * steps, ce_rank=eval_batches + eval_w3)
        if "indexed_by_time_eval_/next-item/recall@20" not in by_time or any(
                len(v) != 2 or not all(math.isfinite(x) for x in v) for v in by_time.values()):
            fail(f"fit_and_evaluate returned {by_time}")
        out["fit_and_evaluate"] = by_time
        print(f"[parquet] fit_and_evaluate over windows 1, 2 in "
              f"{out['fit_and_evaluate_s']:.3f}s: {json.dumps(by_time)}")
        model = in_memory.model
        del in_memory

        # 8. Model.fit without a Trainer, from the file
        loader = ParquetDataLoader.from_schema(flagship.schema(), train_file, batch_size=rows)
        fit_losses, _ = run("Model.fit", lambda: model.fit(loader, max_steps=3),
                            ce_fwd=3, ce_bwd=3)
        if len(fit_losses) != 3 or not all(math.isfinite(v) for v in fit_losses):
            fail(f"Model.fit: {fit_losses}")
        del model

        # the loaders alone: host ms to yield a batch (decoding excluded), with
        # the background thread and without; the streaming loader decodes as
        # it goes
        schema = flagship.schema()
        t0 = time.perf_counter()
        ParquetDataLoader.from_schema(schema, train_file, batch_size=rows)
        out["decode_ms"] = 1e3 * (time.perf_counter() - t0)
        out["loader_ms_per_batch"] = {
            f"{name}_prefetch_{p}": loader_ms(lambda: make(schema, train_file, batch_size=rows,
                                                           prefetch=p))
            for name, make in (("parquet", ParquetDataLoader.from_schema),
                               ("streaming", StreamingParquetDataLoader.from_schema))
            for p in (0, 2)}
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[parquet] loaders on the host of {card}: decode {out['decode_ms']:.3f} ms for "
          f"{sizes['1/train']} sessions, ms per batch of {rows} "
          f"{json.dumps(out['loader_ms_per_batch'])}; streaming train "
          f"{out['streaming_step_ms']:.3f} ms per step; phase Q {out['phase_s']:.1f}s, "
          f"launches {json.dumps(launches)}")
    return out


# ------------------------------------------------------- the paper's experiment script
PAPER_SESSIONS = {"train": 2_048, "valid": 256, "test": 256}  # a window's files
# the JAX experiment script's results.json keys (tests/test_torch_paper_driver.py holds
# the port's experiment script to the JAX one on the CPU)
PAPER_RESULT_KEYS = sorted(f"indexed_by_time_eval_/next-item/{m}@{k}"
                           for m in ("avg_precision", "ndcg", "recall") for k in (10, 20))
# R2: REES46 with side features at the widths of the paper's side-feature
# XLNet-MLM (BASELINE.md), once per numeric encoding
PAPER_SIDE_WIDTHS = ["--d_model", "448", "--n_layer", "2", "--n_head", "8"]
PAPER_ENCODINGS = {
    "soft_one_hot": ["--numeric_features_soft_one_hot_encoding_num_embeddings", "10"],
    "projection": ["--numeric_features_project_to_embedding_dim", "64"],
}
PAPER_SIDE_STEPS = 8


def paper_readme_argv(data_path: str, schema_path: str) -> list:
    """The headline XLNet-MLM command line of ``examples/paper_repro/README.md``,
    verbatim but for ``$DATA_PATH`` and ``$SCHEMA``."""
    path = os.path.join(HERE, "examples", "paper_repro", "README.md")
    with open(path) as f:
        text = f.read()
    head = "python examples/paper_repro/transf_exp_main.py "
    start = text.index(head + "--output_dir ./tmp/") + len(head)
    block = text[start:text.index("```", start)]
    return [a.replace("$DATA_PATH", data_path).replace("$SCHEMA", schema_path)
            for a in block.replace("\\\n", " ").split()]


def paper_windows(schema, root: str, seed: int = 400) -> dict:
    """Windows ``root/{0001,0002,0003}/{train,valid,test}.parquet`` of
    sessions at ``schema`` (the REES46 columns), drawn from ``seed``:
    sessions of 2 to 20 items, ids in 1..390,000 with log-normal
    popularity, each categorical side column derived from the item, the
    continuous columns uniform in [-1, 1], increasing event times. Returns
    the sessions of each file."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    item_col = schema.item_id_column_name
    n_items = schema.categorical_cardinalities()[item_col] - 1
    sizes = {}
    for w in (1, 2, 3):
        d = os.path.join(root, str(w).zfill(4))
        os.makedirs(d)
        for split, n in PAPER_SESSIONS.items():
            lengths = rng.integers(2, 21, n)
            cuts = np.cumsum(lengths)[:-1]
            total = int(lengths.sum())
            raw = rng.lognormal(3.0, 1.0, total)
            item = np.clip(1 + (raw / raw.max()) * (n_items - 1), 1, n_items).astype(np.int64)
            cols = {}
            for col in schema:
                if col.name == item_col:
                    flat = item
                elif col.is_categorical:
                    flat = 1 + item * 2654435761 % (col.cardinality - 1)
                elif col.name == "sess_etime_seq":
                    flat = np.sort(rng.uniform(0, 1e6, total)) + w * 1e6
                else:
                    flat = rng.uniform(-1.0, 1.0, total).astype(np.float32)
                cols[col.name] = [list(x) for x in np.split(flat, cuts)]
            pd.DataFrame(cols).to_parquet(os.path.join(d, f"{split}.parquet"))
            sizes[f"{w}/{split}"] = n
    return sizes


def same_swap_draw(model, cpu_model, batch, seed: int) -> int:
    """One swap-noise draw of ``batch``, made once on the CPU from ``seed``
    and set as ``draws`` on both models' ``StochasticSwapNoise`` (moved to
    the card for the card's model): both then apply the same noise. Returns
    the number of item ids it swaps."""
    im = cpu_model.heads[0].input_module
    cb = cpu_model._as_dense(batch)
    draws = im.StochasticSwapNoise_0.draw(cb, cb[im.item_id].long() != im.padding_idx,
                                          torch.Generator().manual_seed(seed))
    im.StochasticSwapNoise_0.draws = draws
    model.heads[0].input_module.StochasticSwapNoise_0.draws = {
        k: (src.to(model.device), swap.to(model.device)) for k, (src, swap) in draws.items()}
    return int(draws[im.item_id][1].sum())


def run_paper_command(vocab, fa, card: str) -> dict:
    """Main path R: the paper's command line through the port's experiment script
    (``paper_repro.transf_exp_main``) at full width on the card.

    R1: the README's headline XLNet-MLM command, verbatim but for its paths,
    on the port's REES46 schema (``paper_repro.datasets_configs``, written as
    ``schema.pbtxt``) and three windows of synthetic sessions: 390,000
    items, d_model 192, a tied 448-wide item table, 3 layers, 16 heads,
    batches of 128 of 20, swap noise and the per-feature LayerNorm, 5
    epochs of each of windows 1 and 2, evaluation on the next window's
    ``test.parquet``, the top 10 of window 3's ``valid.parquet``. K1 and K2
    launch once a step, K3 once an evaluation batch; every logged loss is
    finite; ``results.json`` has the JAX experiment script's keys.
    R1b: one training step of the trained model on the card against the
    same weights on the CPU, with one MLM mask and one swap-noise draw given
    to both (``same_swap_draw``), dropout off (the command's): the loss, the
    item table's, the output projection's and the LayerNorm's gradients;
    then one evaluation batch.
    R2: REES46 with its side features (three categorical, seven continuous
    columns) at d_model 448, 2 layers, 8 heads, once per numeric encoding:
    8 steps on window 1 and the evaluation of window 2 through the script,
    then that evaluation on the card against the CPU."""
    from transformers4rec_tpu_torch.data import ParquetDataLoader
    from transformers4rec_tpu_torch.paper_repro import datasets_configs, transf_exp_main
    from transformers4rec_tpu_torch.trainer import Trainer

    t_phase = time.perf_counter()
    counters = flash_counters(vocab, fa)
    launches = dict.fromkeys(counters, 0)
    out = {"card": card}

    def run(what: str, fn, **want):
        result, got, wall = counted(counters, fn)
        expect_launches(f"paper experiment script ({what})", got, **want)
        for k, c in got.items():
            launches[k] += c
        return result, wall

    def metrics(r):
        return {k: v for k, v in r.items() if "_runtime" not in k and "_per_second" not in k}

    schema = datasets_configs.make_schema("rees46")
    vocab_size = schema.categorical_cardinalities()[schema.item_id_column_name]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        schema_path = os.path.join(root, "schema.pbtxt")
        schema.to_proto_text_file(schema_path)
        t0 = time.perf_counter()
        sizes = paper_windows(schema, os.path.join(root, "data"))
        out["windows_s"] = time.perf_counter() - t0
        argv = paper_readme_argv(os.path.join(root, "data"), schema_path)
        print(f"[paper] R1: transf_exp_main {' '.join(argv)}")
        # the command's --output_dir ./tmp/ lands in the temporary directory
        os.chdir(root)
        try:
            args = transf_exp_main.build_parser().parse_args(argv)
            rows = args.per_device_eval_batch_size
            eval_batches = sum(-(-sizes[f"{w}/test"] // rows) for w in (2, 3))
            # 2 windows of num_train_epochs, the tail dropped
            window_steps = int(args.num_train_epochs) * (
                PAPER_SESSIONS["train"] // args.per_device_train_batch_size)
            steps = 2 * window_steps
            r1, wall = run("R1, the README's command", lambda: transf_exp_main.run(argv),
                           ce_fwd=steps, ce_bwd=steps, ce_rank=eval_batches)
            with open(os.path.join(root, "tmp", "results.json")) as f:
                keys = sorted(json.load(f))
        finally:
            os.chdir(cwd)
        trainer = r1.trainer
        if trainer.state.global_step != steps or keys != PAPER_RESULT_KEYS \
                or sorted(r1.results) != PAPER_RESULT_KEYS:
            fail(f"R1: {trainer.state.global_step} steps, results.json keys {keys}")
        losses = [h["loss"] for h in trainer.state.log_history if "loss" in h]
        if len(losses) != 2 * -(-window_steps // args.logging_steps) \
                or not all(math.isfinite(v) for v in losses):
            fail(f"R1: logged losses {losses}")
        if any(len(v) != 2 or not all(math.isfinite(x) for x in v) for v in r1.results.values()):
            fail(f"R1: results {r1.results}")
        ids = r1.top_ids
        if ids.shape != (sizes["3/valid"], 10) or int(ids.min()) < 0 \
                or int(ids.max()) >= vocab_size:
            fail(f"R1: predict gave ids of shape {ids.shape} in [{ids.min()}, {ids.max()}]")
        runs = [h for h in trainer.state.log_history if "train_runtime" in h]
        out["R1"] = {"wall_s": wall, "steps": steps, "eval_batches": eval_batches,
                     "ms_per_step_by_window": [1e3 * h["train_runtime"] / h["train_steps"]
                                               for h in runs],
                     "losses": losses, "results": r1.results}
        print(f"[paper] R1 on {card}: {steps} steps and {eval_batches} evaluation batches in "
              f"{wall:.3f}s; ms per step (wall, window 1 then 2) "
              f"{json.dumps(out['R1']['ms_per_step_by_window'])}; logged losses "
              f"{json.dumps(losses)}")

        # R1b: one training step and one evaluation batch, card against CPU
        model = trainer.model
        item_only = schema.select_by_name([schema.item_id_column_name])
        cpu_model = transf_exp_main.get_model(args, item_only, device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        test_file = os.path.join(root, "data", "0003", "test.parquet")
        batch = next(iter(ParquetDataLoader.from_schema(
            item_only, test_file, batch_size=128, max_sequence_length=20, shuffle=False)))
        swapped = same_swap_draw(model, cpu_model, batch, seed=7)
        if swapped <= 0:
            fail("R1b: the swap-noise draw swapped no item id")
        ln = [f"heads.0.body.blocks.0.TabularLayerNorm_0.ln_{item_only.item_id_column_name}.{w}"
              for w in ("weight", "bias")]
        step, _ = run("R1b, one training step", lambda: check_training_step(
            model, cpu_model, batch, extra=ln), ce_fwd=1, ce_bwd=1)
        for m in (model, cpu_model):
            m.heads[0].input_module.StochasticSwapNoise_0.draws = None
        gpu_res, _ = run("R1b, one evaluation batch", lambda: model.evaluate([batch]), ce_rank=1)
        cpu_res = cpu_model.evaluate([batch])
        check_evaluate(gpu_res, cpu_res, 128)
        out["R1b"] = {"train_step": step, "swapped_ids": swapped, "evaluate": gpu_res}
        print(f"[paper] R1b card against CPU on {card}: {swapped} item ids swapped; "
              f"training step {json.dumps(step)}; evaluation {json.dumps(gpu_res)} against "
              f"{json.dumps(cpu_res)}")
        del trainer, model, cpu_model, r1
        torch.cuda.empty_cache()

        # R2: side features, once per numeric encoding
        out["R2"] = {}
        for name, encoding in PAPER_ENCODINGS.items():
            side = argv + PAPER_SIDE_WIDTHS + encoding + [
                "--use_side_information_features", "--start_time_window_index", "1",
                "--final_time_window_index", "1", "--max_steps", str(PAPER_SIDE_STEPS),
                "--logging_steps", "1", "--output_dir", os.path.join(root, f"side_{name}")]
            eval_file = os.path.join(root, "data", "0002", "test.parquet")
            n_eval = sizes["2/test"]
            r2, wall = run(f"R2, {name}", lambda: transf_exp_main.run(side),
                           ce_fwd=PAPER_SIDE_STEPS, ce_bwd=PAPER_SIDE_STEPS,
                           ce_rank=-(-n_eval // rows))
            t = r2.trainer
            reads = [h["loss"] for h in t.state.log_history if "loss" in h]
            if t.state.global_step != PAPER_SIDE_STEPS or not all(math.isfinite(v) for v in reads):
                fail(f"R2 {name}: {t.state.global_step} steps, losses {reads}")
            features = sorted(t.model.heads[0].input_module.feature_sizes())
            if "sess_etime_seq" in features or len(features) != 4 + (
                    7 if name == "soft_one_hot" else 1):
                fail(f"R2 {name}: features {features}")
            gpu_res, _ = run(f"R2, {name}, evaluation", lambda: t.evaluate(eval_file),
                             ce_rank=-(-n_eval // rows))
            sargs = transf_exp_main.build_parser().parse_args(side)
            cpu_model = transf_exp_main.get_model(sargs, schema, device="cpu")
            cpu_model.load_state_dict({k: v.cpu() for k, v in t.model.state_dict().items()})
            cpu_res = Trainer(cpu_model, t.args, schema=schema, device="cpu").evaluate(eval_file)
            check_evaluate(metrics(gpu_res), metrics(cpu_res), n_eval)
            run_ms = [1e3 * h["train_runtime"] / h["train_steps"]
                      for h in t.state.log_history if "train_runtime" in h]
            out["R2"][name] = {"wall_s": wall, "ms_per_step": run_ms, "losses": reads,
                               "features": features, "evaluate": metrics(gpu_res)}
            print(f"[paper] R2 {name} on {card}: {PAPER_SIDE_STEPS} steps at {run_ms[0]:.3f} ms "
                  f"per step (wall, the first included), losses {json.dumps(reads)}; "
                  f"evaluation of {n_eval} sessions card {json.dumps(metrics(gpu_res))} "
                  f"against CPU {json.dumps(metrics(cpu_res))}")
            del r2, t, cpu_model
            torch.cuda.empty_cache()
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[paper] phase R on {card}: {out['phase_s']:.1f}s (windows written in "
          f"{out['windows_s']:.1f}s), launches {json.dumps(launches)}")
    return out


# ------------------------------------ the BERT family and TransfoXL (phase S)
# each of phase S's command lines: the README's headline command with these
# flags dropped and set (``with_flags``), and its windows
PAPER_ARCH_LINES = {
    "S1": ("albert", (), {"model_type": "albert", "mlm_probability": "0.6"}, 2),
    "S2": ("transfoxl", ("--attn_type", "--mlm"),
           {"model_type": "transfoxl", "final_time_window_index": "1"}, 1),
    # --mlm dropped: the script takes the first of --mlm, --plm, --rtd it finds
    "S3": ("electra", ("--mlm",),
           {"model_type": "electra", "rtd": None, "final_time_window_index": "1",
            "max_steps": "8"}, 1),
}
ENCODER = "heads.0.body.blocks.1.encoder."
PAPER_WINDOW = 8  # Longformer's local window in the registry (S4)


def with_flags(argv: list, drop=(), flags=None) -> list:
    """``argv`` without the flags of ``drop`` and those of ``flags`` (each
    with its value, where it has one), then ``flags`` appended (a value of
    None: a switch)."""
    flags = flags or {}
    out, i = [], 0
    while i < len(argv):
        takes = i + 1 < len(argv) and not argv[i + 1].startswith("--")
        if argv[i] in drop or argv[i][2:] in flags:
            i += 2 if takes else 1
            continue
        out.append(argv[i])
        i += 1
    for k, v in flags.items():
        out += [f"--{k}"] + ([] if v is None else [v])
    return out


def paper_arch_argv(line: str, data_path: str, schema_path: str) -> list:
    _, drop, flags, _ = PAPER_ARCH_LINES[line]
    return with_flags(paper_readme_argv(data_path, schema_path), drop, flags)


def unshared(model):
    """``model`` with its encoder's shared layer replaced by ``n_layer``
    copies of it: the same function, with one gradient per use."""
    enc = model.heads[0].body.blocks[1].encoder
    enc.layers = torch.nn.ModuleList(copy.deepcopy(enc.layer_shared)
                                     for _ in range(enc.n_layer))
    del enc.layer_shared
    enc.share_layers = False
    return model


def run_paper_archs(flagship, vocab, fa, card: str) -> dict:
    """Main path S: the BERT family, ELECTRA's RTD scheme and TransfoXL at
    the paper's width (390,000 items, d_model 192, 3 layers, 16 heads, the
    tied 448-wide item table, batches of 128 of 20) through the port's
    experiment script on Parquet windows, as phase R runs the README's
    command (``PAPER_ARCH_LINES``): S1 ALBERT-MLM (the command with
    ``--model_type albert --mlm_probability 0.6``, two windows), S2
    TransfoXL-CLM (without ``--attn_type bi --mlm``: causal, the relative
    bias, a label at every position; one window), S3 ELECTRA-RTD (``--rtd``,
    one window of 8 steps). K1 and K2 launch once a step, K3 once an
    evaluation batch, no flash kernel at S = 20. After each, one training
    step of the trained model on the card against the CPU with one mask and
    one swap draw: the loss within 1e-5 relative, the item table's
    gradient within 1e-3; S1's shared layer's gradient against the sum of
    its three uses' on the CPU (an unshared copy), S2's relative bias's and
    S3's embedding LayerNorm's, each within 1e-3.
    S4: at batch 32 of up to 256, through ``flagship.build_trainer(scheme=,
    arch=)``: Longformer-MLM (K5 and K6a 3 times a step, with the local
    window's (1, 1, S, S) bias) and TransfoXL-CLM (K5 3 times a step with
    the relative bias, the dense backward), 8 steps each, then one
    evaluation batch each (K3)."""
    from transformers4rec_tpu_torch.data import ParquetDataLoader, synthetic_data
    from transformers4rec_tpu_torch.paper_repro import datasets_configs, transf_exp_main

    t_phase = time.perf_counter()
    counters = flash_counters(vocab, fa)
    launches = dict.fromkeys(counters, 0)
    out = {"card": card}

    def run(what: str, fn, **want):
        result, got, wall = counted(counters, fn)
        expect_launches(f"phase S ({what})", got, **want)
        for k, c in got.items():
            launches[k] += c
        return result, wall

    schema = datasets_configs.make_schema("rees46")
    item_only = schema.select_by_name([schema.item_id_column_name])
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        schema_path = os.path.join(root, "schema.pbtxt")
        schema.to_proto_text_file(schema_path)
        data = os.path.join(root, "data")
        sizes = paper_windows(schema, data, seed=401)
        batch = next(iter(ParquetDataLoader.from_schema(
            item_only, os.path.join(data, "0003", "test.parquet"), batch_size=128,
            max_sequence_length=20, shuffle=False)))
        for line, (arch, _, _, windows) in PAPER_ARCH_LINES.items():
            argv = paper_arch_argv(line, data, schema_path)
            print(f"[paper-archs] {line}: transf_exp_main {' '.join(argv)}")
            args = transf_exp_main.build_parser().parse_args(argv)
            rows = args.per_device_eval_batch_size
            first = args.start_time_window_index
            n_eval = sum(-(-sizes[f"{w + 1}/test"] // rows)
                               for w in range(first, first + windows))
            epoch_steps = PAPER_SESSIONS["train"] // args.per_device_train_batch_size
            window_steps = args.max_steps if args.max_steps > 0 \
                else int(args.num_train_epochs) * epoch_steps
            steps = windows * window_steps
            # the command's --output_dir ./tmp/ lands in the temporary directory
            os.chdir(root)
            try:
                r, wall = run(line, lambda: transf_exp_main.run(argv), ce_fwd=steps,
                              ce_bwd=steps, ce_rank=n_eval)
            finally:
                os.chdir(cwd)
            trainer = r.trainer
            losses = [h["loss"] for h in trainer.state.log_history if "loss" in h]
            if trainer.state.global_step != steps or sorted(r.results) != PAPER_RESULT_KEYS \
                    or not losses or not all(math.isfinite(v) for v in losses) \
                    or any(len(v) != windows or not all(math.isfinite(x) for x in v)
                           for v in r.results.values()):
                fail(f"{line}: {trainer.state.global_step} steps, losses {losses}, "
                     f"results {r.results}")
            enc = trainer.model.heads[0].body.blocks[1].encoder
            runs = [h for h in trainer.state.log_history if "train_runtime" in h]
            res = {"arch": arch, "masking": type(trainer.model.heads[0].input_module.masking)
                   .__name__, "wall_s": wall, "steps": steps, "eval_batches": n_eval,
                   "ms_per_step_by_window": [1e3 * h["train_runtime"] / h["train_steps"]
                                             for h in runs],
                   "losses": losses, "results": r.results,
                   "post_ln": not enc.norm_first, "shared_layer": enc.share_layers,
                   "causal": enc.causal}

            # one training step, the card against the CPU
            model = trainer.model
            cpu_model = transf_exp_main.get_model(args, item_only, device="cpu")
            cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
            extra, sums = (), None
            if arch == "albert":
                unshared(cpu_model)
                layer = [n for n, _ in enc.layer_shared.named_parameters()
                         if n != "attn.k.bias"]  # its true gradient is 0
                extra = tuple(f"{ENCODER}layer_shared.{n}" for n in layer)
                sums = {f"{ENCODER}layer_shared.{n}": tuple(
                    f"{ENCODER}layers.{i}.{n}" for i in range(enc.n_layer)) for n in layer}
            elif arch == "transfoxl":
                extra = (f"{ENCODER}rel_pos.rel_bias",)
            else:
                extra = (f"{ENCODER}ln_emb.weight", f"{ENCODER}ln_emb.bias")
            res["swapped_ids"] = same_swap_draw(model, cpu_model, batch, seed=7)
            step, _ = run(f"{line}, one training step", lambda: check_training_step(
                model, cpu_model, batch, extra=extra, loss_rtol=1e-5, extra_rel=1e-3,
                cpu_sums=sums), ce_fwd=1, ce_bwd=1)
            res["train_step"] = step
            out[line] = res
            print(f"[paper-archs] {line} {arch} on {card}: {steps} steps and {n_eval} "
                  f"evaluation batches in {wall:.3f}s; ms per step (wall, by window) "
                  f"{json.dumps(res['ms_per_step_by_window'])}; logged losses "
                  f"{json.dumps(losses)}; card against CPU {json.dumps(step)}")
            del r, trainer, model, cpu_model
            torch.cuda.empty_cache()

    # S4: Longformer-MLM and TransfoXL-CLM on sessions of up to 256
    seq, rows, layers = flagship.LONG_SEQ, flagship.LONG_BATCH, flagship.N_LAYER
    steps = 8
    out["S4"] = {}
    for arch, scheme, seed in (("longformer", "mlm", 410), ("transfoxl", "clm", 411)):
        data = synthetic_data(flagship.schema(flagship.NUM_ITEMS, seq), num_rows=steps * rows,
                              max_session_length=seq, seed=seed)
        trainer = flagship.build_trainer("cuda", seed=0, train_dataset=data, scheme=scheme,
                                         arch=arch, seq=seq, batch=rows)
        enc = trainer.model.heads[0].body.blocks[1].encoder
        per_step = {"flash_fwd": layers, "ce_fwd": 1, "ce_bwd": 1}
        if arch == "longformer":
            # a constant bias: the fused backward; TransfoXL's learned one
            # takes the dense backward that yields its gradient
            per_step["flash_bwd_fused"] = layers
        own = dict.fromkeys(counters, 0)  # this arch's launches
        res = trainer_phases(trainer, counters, own, f"paper-archs S4 {arch}", card, rows,
                             seq, (("eight_batches", steps, None),), per_step)
        loader = eval_batches(flagship, flagship.NUM_ITEMS, seq, 1, rows)
        ev, got, wall = counted(counters, lambda: trainer.model.evaluate(loader))
        expect_launches(f"phase S (S4 {arch}, one evaluation batch)", got, flash_fwd=layers,
                        ce_rank=1)
        if not all(math.isfinite(v) for v in ev.values()):
            fail(f"S4 {arch}: evaluation {ev}")
        for k in launches:
            own[k] += got[k]
            launches[k] += own[k]
        res.update(evaluate=ev, eval_wall_s=wall, local_window=enc.local_window,
                   causal=enc.causal, launches=own)
        out["S4"][arch] = res
        print(f"[paper-archs] S4 {arch} on {card}: evaluation {json.dumps(ev)} in {wall:.3f}s")
        del trainer
        torch.cuda.empty_cache()
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[paper-archs] phase S on {card}: {out['phase_s']:.1f}s, launches "
          f"{json.dumps(launches)}")
    return out


# ------------------------------- T: the JAX benchmark's configurations 4 and 5
T1_STEADY = 8  # timed steady steps after the cold one
T1_WINDOW = 8  # the profiled window's steps
T1_EVAL_BATCHES = 2
T1_SESSIONS_SERVED = 24
T2_STEADY = 8
T2_VALID_SESSIONS = 300  # a tail of 44 in the last batch of 128
# sampled softmax is float32 from end to end on both devices (the gathers,
# the products with TF32 off, the softmax over 1 + 8,192 columns): only the
# order of the sums differs, and the item table's gradient adds the rows of
# duplicate ids by atomics on the card
T1_LOSS_RTOL, T1_GRAD_REL = 1e-5, 1e-4
# the dense tasks' output layers see no bf16 rounding either
T2_DENSE_GRAD_REL = 1e-4
T2_MSE_RTOL = 1e-4


def large_vocab_negatives(sampler, seed: int) -> np.ndarray:
    """One draw of ``sampler``'s negatives, made with numpy as the JAX sampler
    makes it: ``floor(exp(u·log(range + 1))) - 1`` in float32, truncated,
    clipped, offset by ``min_id``."""
    u = np.random.default_rng(seed).random(sampler.max_n_samples, dtype=np.float32)
    ids = np.exp(u * np.log(np.float32(sampler.range + 1))).astype(np.int32) - 1
    return np.clip(ids, 0, sampler.range - 1).astype(np.int64) + sampler.min_id


def run_large_vocab(flagship, vocab, fa, card: str) -> dict:
    """Main path T1: the JAX benchmark's configuration 4 at full width
    (``flagship.build_large_vocab_trainer``: XLNet-MLM over 4,000,000 items,
    a tied 64-wide table, d_model 192, 3 layers, 16 heads, batches of 128 of
    20, sampled softmax over 8,192 log-uniform negatives). ``Trainer.train``
    takes a cold step and ``T1_STEADY`` timed steps, then a window under
    ``torch.profiler`` (the device's busy share); no kernel launches in
    training (the loss is a dense softmax over 1 + 8,192 columns, the
    table's Adafactor the plain chain). One training step of the trained
    weights with dropout off, card against CPU, with one MLM mask and one
    draw of negatives (numpy) given to both: the loss within
    ``T1_LOSS_RTOL``, the item table's and the projection's gradients within
    ``T1_GRAD_REL`` in relative Frobenius norm. ``Model.evaluate`` over
    ``T1_EVAL_BATCHES`` batches of 128 (K3 once a batch, at V = 4,000,001
    over 4,000,008 table rows) against the CPU's plain pass; the top-k of
    ``T1_SESSIONS_SERVED`` sessions (f32 ``torch.matmul`` and ``torch.topk``
    over 4M columns) against the CPU's. K3 is held against its plain version
    and timed at that table's shape."""
    from transformers4rec_tpu_torch.data import synthetic_data

    t_phase = time.perf_counter()
    counters = flash_counters(vocab, fa)
    launches = dict.fromkeys(counters, 0)
    items, rows, seq = flagship.LARGE_VOCAB_ITEMS, flagship.BATCH, flagship.SEQ
    vocab_size = items + 1
    table_rows = -(-vocab_size // 8) * 8
    schema = flagship.schema(items, seq)
    out = {"card": card, "num_items": items, "table_rows": table_rows}

    # K3 at this table's shape, before any model holds the card's memory
    # ten times the columns of the flagship's table: ten times the logits
    # within an ulp of the label logit, so fewer rows' ranks are exact
    # (about 96% at 128 rows), each difference held to the row's near ties
    out["k3_check"] = check_ce_rank("large_vocab", EVAL_ROWS, table_rows, vocab_size, False,
                                    4.0, 12.0, [95], min_exact=0.9)
    out["k3_timing"] = time_ce_rank(vocab, EVAL_ROWS, table_rows, vocab_size)
    torch.cuda.empty_cache()

    data = synthetic_data(schema, num_rows=16 * rows, max_session_length=seq, seed=600)
    t0 = time.perf_counter()
    trainer = flagship.build_large_vocab_trainer("cuda", seed=0, train_dataset=data)
    sync("cuda")
    out["build_s"] = time.perf_counter() - t0
    table = trainer.model.heads[0].input_module.item_embedding_table()
    task = trainer.model.heads[0].tasks[0]
    if tuple(table.shape) != (table_rows, flagship.LARGE_VOCAB_ITEM_DIM) \
            or not task.sampled_softmax or task.max_n_samples != flagship.LARGE_VOCAB_NEGATIVES:
        fail(f"large vocab: table {tuple(table.shape)}, task {task.sampled_softmax} "
             f"{task.max_n_samples}")
    table_before = table.detach().clone()
    trainer.create_optimizer_and_scheduler(1 + T1_STEADY + 2 * T1_WINDOW)
    torch.cuda.reset_peak_memory_stats()
    out["train"] = trainer_phases(
        trainer, counters, launches, "large-vocab", card, rows, seq,
        (("cold_step", 1, None), ("steady", T1_STEADY, None)), per_step={})
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    (window, prof_table), got, _ = counted(counters, lambda: traced_window(
        trainer, T1_WINDOW, rows=25))
    expect_launches("large vocab (profiled window)", got)
    out["profile"] = window
    print(prof_table)
    moved = float((table.detach() - table_before).abs().max())
    if not moved > 0 or not torch.isfinite(table).all():
        fail(f"large vocab: the item table moved by {moved}")
    out["table_max_move"] = moved

    # the trained weights with dropout off, on the card and on the CPU
    model = flagship.build_large_vocab_model("cuda", dropout=0.0)
    model.load_state_dict(trainer.model.state_dict())
    del trainer, table, table_before
    torch.cuda.empty_cache()
    cpu_model = flagship.build_large_vocab_model("cpu", dropout=0.0)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    sampler = model.heads[0].tasks[0].make_sampler(table_rows)
    neg = torch.from_numpy(large_vocab_negatives(sampler, seed=7))
    batch = {k: v[:rows] for k, v in data.items()}
    step, got, _ = counted(counters, lambda: check_training_step(
        model, cpu_model, batch, loss_rtol=T1_LOSS_RTOL, neg_ids=neg, grad_rel=T1_GRAD_REL))
    expect_launches("large vocab (one training step)", got)
    labels = cpu_model._as_dense(batch)["item_id"]
    step["accidental_hits"] = int(np.isin(neg.numpy(), labels.numpy()).sum())
    out["train_step"] = step

    loader = eval_batches(flagship, items, seq, T1_EVAL_BATCHES, EVAL_ROWS)
    gpu_res, got, wall = counted(counters, lambda: model.evaluate(loader))
    expect_launches("large vocab (evaluate)", got, ce_rank=T1_EVAL_BATCHES)
    for k, c in got.items():
        launches[k] += c
    t0 = time.perf_counter()
    cpu_res = cpu_model.evaluate(loader)
    check_evaluate(gpu_res, cpu_res, T1_EVAL_BATCHES * EVAL_ROWS)
    out["evaluate"] = {"cuda": gpu_res, "cpu": cpu_res, "wall_s": wall,
                       "cpu_s": time.perf_counter() - t0}

    served = synthetic_data(schema, num_rows=T1_SESSIONS_SERVED, max_session_length=seq,
                            seed=601)
    def top_k(m):
        with torch.inference_mode():
            return m(m._as_dense(served), top_k=TOP_K)

    (gs, gi), got, wall = counted(counters, lambda: top_k(model))
    expect_launches("large vocab (top-k)", got)
    ws, wi = top_k(cpu_model)
    check_topk(gs.cpu().numpy(), gi.cpu().numpy(), ws.numpy(), wi.numpy(), vocab_size,
               "large vocab top-k")
    out["topk"] = {"sessions": T1_SESSIONS_SERVED, "wall_s": wall}
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    k3 = out["k3_timing"]
    print(f"[large-vocab] on {card}: {json.dumps({k: out[k] for k in ('train_step', 'evaluate', 'topk', 'peak_memory_gb', 'table_max_move', 'launches')})}")
    print(f"[large-vocab] on {card}: a steady step {out['train']['steady']['ms_per_step']:.3f} "
          f"ms of wall time ({window['ms_per_step']:.3f} in the profiled window's untraced "
          f"run, {window['device_ms_per_step']:.3f} ms of device time, busy "
          f"{window['device_busy_share']:.3f}); K3 at N={EVAL_ROWS}, V={vocab_size} "
          f"{k3['ms']:.4f} ms against a bound of {k3['bound_ms']:.4f} ({k3['bound_by']}), "
          f"splits {k3['splits']}; peak memory {out['peak_memory_gb']:.2f} GB; phase T1 "
          f"{out['phase_s']:.1f}s")
    del model, cpu_model
    torch.cuda.empty_cache()
    return out


def run_multitask(flagship, vocab, fa, card: str) -> dict:
    """Main path T2: the JAX benchmark's configuration 5 at full width
    (``flagship.build_multitask_trainer``: ELECTRA-RTD, d_model 64, 4 heads,
    2 layers, sessions of 20, next-item, ``click`` and ``play_percentage``,
    batches of 128) from Parquet files of the music-streaming fixture
    (``data.testing.TestingDataset``, written into a temporary directory):
    ``Trainer.train`` takes a cold step and ``T2_STEADY`` steps (K1 and K2
    once a step), then a window under ``torch.profiler`` (the device's busy
    share); ``Trainer.evaluate`` (K3 once a batch) against the same
    weights' ``Model.evaluate`` on the CPU: the loss within 1e-4, the
    ranking and ``click`` metrics within 1e-6 (within one row's worth where
    a CPU prediction lies within 1e-5 of the 0.5 threshold), the mse within
    ``T2_MSE_RTOL``; one training step card against CPU with one RTD mask:
    the loss and each task's within 1e-4, the item table's and projection's
    gradients as ``check_grad`` says, the dense tasks' output layers within
    ``T2_DENSE_GRAD_REL``; the HTTP server's top-k of the next-item task."""
    import pathlib

    from transformers4rec_tpu_torch.data import testing
    from transformers4rec_tpu_torch.schema import Tags

    t_phase = time.perf_counter()
    counters = flash_counters(vocab, fa)
    launches = dict.fromkeys(counters, 0)
    rows, seq = flagship.BATCH, flagship.SEQ
    ms = testing.music_streaming_testing_data
    vocab_size = ms.schema.categorical_cardinalities()["item_id"]
    out = {"card": card}
    cache = testing._CACHE
    with tempfile.TemporaryDirectory() as root:
        # the fixture writes its files here, not under the user's cache
        testing._CACHE = pathlib.Path(root)
        try:
            train_path = testing.TestingDataset("music_streaming_train", ms.schema,
                                                num_rows=(1 + T2_STEADY) * rows, seed=501).path
            valid_path = testing.TestingDataset("music_streaming_valid", ms.schema,
                                                num_rows=T2_VALID_SESSIONS, seed=502).path
        finally:
            testing._CACHE = cache
        trainer = flagship.build_multitask_trainer(
            "cuda", seed=0, train_dataset=train_path, eval_dataset=valid_path,
            output_dir=os.path.join(root, "out"))
        names = [t.task_name for t in trainer.model.heads[0].tasks]
        if names != ["next-item", "click", "play_percentage"]:
            fail(f"multi-task: tasks {names}")
        trainer.create_optimizer_and_scheduler(1 + 3 * T2_STEADY)
        out["train"] = trainer_phases(
            trainer, counters, launches, "multi-task", card, rows, seq,
            (("cold_step", 1, None), ("steady", T2_STEADY, None)),
            per_step={"ce_fwd": 1, "ce_bwd": 1})
        (window, prof_table), got, _ = counted(counters, lambda: traced_window(
            trainer, T2_STEADY, rows=15))
        expect_launches("multi-task (profiled window)", got, ce_fwd=2 * T2_STEADY,
                        ce_bwd=2 * T2_STEADY)
        for k, c in got.items():
            launches[k] += c
        out["profile"] = window
        print(prof_table)

        n_eval = -(-T2_VALID_SESSIONS // rows)
        gpu_res, got, wall = counted(counters, trainer.evaluate)
        expect_launches("multi-task (evaluate)", got, ce_rank=n_eval)
        for k, c in got.items():
            launches[k] += c
        keys = ["eval_/next-item/ndcg_at_10", "eval_/click/accuracy", "eval_/click/precision",
                "eval_/click/recall", "eval_/play_percentage/mse"]
        if any(k not in gpu_res for k in keys):
            fail(f"multi-task evaluate returned {sorted(gpu_res)}")
        cpu_model = flagship.build_multitask_model("cpu", dropout=0.0)
        cpu_model.load_state_dict({k: v.cpu() for k, v in trainer.model.state_dict().items()})
        eval_loader = trainer.get_eval_dataloader()
        cpu_res = cpu_model.evaluate(eval_loader, max_sequence_length=seq)
        # the CPU's click predictions nearest the threshold
        margin = math.inf
        with torch.inference_mode():
            for b in eval_loader:
                d = cpu_model._as_dense(b, seq)
                _, outs = cpu_model(d, targets=d, testing=True)
                margin = min(margin, float((outs["click"].predictions - 0.5).abs().min()))
        rows_total = T2_VALID_SESSIONS
        click_tol = 1e-6 if margin > 1e-5 else 1.0 / rows_total + 1e-6
        for k in gpu_res:
            if not k.startswith("eval_") or k.endswith(("runtime", "per_second")):
                continue
            g, c = gpu_res[k], cpu_res[k]
            if k == "eval_loss":
                bad = abs(g - c) > 1e-4 * abs(c)
            elif k.endswith("/mse"):
                bad = abs(g - c) > T2_MSE_RTOL * abs(c)
            elif k.startswith("eval_/click/"):
                bad = abs(g - c) > click_tol
            else:  # a rank flipping across a cutoff moves a metric by 1/rows
                bad = abs(g - c) > 2.0 / rows_total
            if not math.isfinite(g) or bad:
                fail(f"multi-task evaluate: {k} on the card {g}, CPU {c}")
        out["evaluate"] = {"cuda": {k: gpu_res[k] for k in ["eval_loss"] + keys},
                           "cpu": {k: cpu_res[k] for k in ["eval_loss"] + keys},
                           "wall_s": wall, "click_margin": margin}

        # one training step of the trained weights, dropout off
        model = flagship.build_multitask_model("cuda", dropout=0.0)
        model.load_state_dict(trainer.model.state_dict())
        batch = next(iter(eval_loader))
        step, got, _ = counted(counters, lambda: check_training_step(
            model, cpu_model, batch, extra=("heads.0.tasks.1.output.weight",
                                            "heads.0.tasks.2.output.weight"),
            extra_rel=T2_DENSE_GRAD_REL))
        expect_launches("multi-task (one training step)", got, ce_fwd=1, ce_bwd=1)
        out["train_step"] = step

        # the next-item task's top-k through the HTTP server
        features = ms.schema.remove_by_tag(Tags.TARGET)
        requests = serve_requests(flagship, 0, seq, 8, schema=features)
        example = {k: v for k, v in batch.items() if k in features.column_names}
        serve = run_serve(flagship.build_multitask_model, trainer.model, example, vocab_size,
                          requests, "cuda", lowest_id=0)
        out["serve"] = serve
        del trainer, model, cpu_model
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[multi-task] on {card}: {json.dumps({k: out[k] for k in ('evaluate', 'train_step', 'serve', 'launches')})}")
    print(f"[multi-task] on {card}: a steady step {out['train']['steady']['ms_per_step']:.3f} "
          f"ms of wall time ({window['ms_per_step']:.3f} in the profiled window's untraced "
          f"run, {window['device_ms_per_step']:.3f} ms of device time, busy "
          f"{window['device_busy_share']:.3f}); phase T2 {out['phase_s']:.1f}s")
    return out


# ------------------------- W: the sparse table step and gradient accumulation
W1_STEADY = 8  # timed steady steps after the cold one
W1_WINDOW = 8  # the profiled window's steps
W1_EVAL_BATCHES = 2
W_ADAFACTOR_STEPS = 3  # sparse_adafactor steps, card against CPU
W2_MICRO_STEPS = 8  # four updates at K = 2
W2_LAZY_STEPS = 3
# sampled softmax is float32 from end to end on both devices (T1_LOSS_RTOL);
# an update's movement differs by the order of the rows' sums (index_add_
# adds by atomics on the card) carried through Adam's g / (|g| + eps), which
# turns last-bit differences of a gradient near eps into a visible share of
# its step: the movement is held in relative Frobenius norm, over the
# touched rows, the dense weights and the moments (bf16-stored moments may
# land one bf16 ulp, 2^-8, apart)
W_LOSS_RTOL = 1e-5
W_MOVE_REL = 1e-3
W_MOMENT_REL = 4e-3


def mlm_info(cpu_model, batch, seed: int, neg_ids=None):
    """One MLM draw on the CPU for ``batch`` (numpy columns), with the
    negatives ``neg_ids`` (numpy) when given: a ``MaskingInfo`` on the CPU."""
    im = cpu_model.heads[0].input_module
    ids = torch.as_tensor(np.asarray(batch[im.item_id])).long()
    info = im.masking.compute_masked_targets(ids, training=True,
                                             generator=torch.Generator().manual_seed(seed))
    return info if neg_ids is None else info.replace(neg_ids=torch.from_numpy(neg_ids))


def info_on(info, device):
    fields = [f for f in ("targets", "mask", "input_schema", "pad_mask", "perm_mask", "neg_ids")
              if getattr(info, f) is not None]
    return info.replace(**{f: getattr(info, f).to(device) for f in fields})


def movement_rel(got_after, want_after, before) -> float:
    """``|Δgot − Δwant| / |Δwant|`` in Frobenius norm, Δ the movement from
    ``before`` (float64 on the CPU)."""
    d_got = got_after.double() - before.double()
    d_want = want_after.double() - before.double()
    return float((d_got - d_want).norm() / d_want.norm().clamp_min(1e-300))


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as integers: -0.0 and +0.0 differ."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def sparse_pair_steps(flagship, models: dict, weights: dict, opt: str, batches: list,
                      infos: list, counters: dict, state_doc=None) -> dict:
    """Steps of the ``opt`` sparse arm from ``weights`` (and the rows' state
    ``state_doc``) on the card and on the CPU (``models``: device → model),
    each step given one mask and one draw of negatives (``infos``). The
    losses within ``W_LOSS_RTOL``; the movement of the touched rows and of
    the dense weights within ``W_MOVE_REL``; the touched rows' moments
    within ``W_MOMENT_REL``; untouched rows of the table and its moments,
    bit for bit, as they were; the item table never holds a gradient; no
    kernel launches (the sampled softmax is plain float32)."""
    touched = np.unique(np.concatenate(
        [np.asarray(b["item_id"]).reshape(-1) for b in batches]
        + [i.neg_ids.numpy() for i in infos]))
    res = {}
    for dev, m in models.items():
        m.load_state_dict(weights)
        tr = flagship._bench_trainer(m, None, dev, 0, None, None, tempfile.gettempdir(),
                                     flagship.BATCH, embedding_optimizer=opt)
        tr.create_optimizer_and_scheduler(len(batches))
        if state_doc is not None:
            tr._sparse.load_state_dict(state_doc)
        step = tr._sparse
        moments = {k: v for k, v in vars(step.state).items() if k != "count"}
        before = {"table": step.table.detach().clone(),
                  **{k: v.clone() for k, v in moments.items()}}
        dense_before = {n: p.detach().cpu().clone() for n, p in m.named_parameters()
                        if p is not step.table}

        def run():
            return [tr._train_step(m._as_dense(b), masking_info=info_on(i, dev))
                    for b, i in zip(batches, infos)]

        losses, got, _ = counted(counters, run, device=dev)
        expect_launches(f"{opt} steps on {dev}", got)
        if step.table.grad is not None:
            fail(f"{opt} on {dev}: the item table holds a gradient")
        after = {"table": step.table.detach(),
                 **{k: v for k, v in vars(step.state).items() if k != "count"}}
        untouched = torch.ones(step.table.shape[0], dtype=torch.bool, device=step.table.device)
        untouched[torch.from_numpy(touched).to(untouched.device)] = False
        for k in after:
            changed = (bits(after[k]) != bits(before[k])).any(dim=1) & untouched
            if bool(changed.any()):
                fail(f"{opt} on {dev}: {int(changed.sum())} untouched rows of {k} changed")
        idx = torch.from_numpy(touched).to(step.table.device)
        res[dev] = {"losses": [float(x) for x in losses], "count": int(step.state.count),
                    "rows": {k: v.index_select(0, idx).float().cpu() for k, v in after.items()},
                    "rows_before": before["table"].index_select(0, idx).cpu(),
                    "dense": {n: p.detach().cpu() for n, p in m.named_parameters()
                              if p is not step.table},
                    "dense_before": dense_before,
                    "untouched_rows": int(untouched.sum())}
        del tr, step, before, after, moments
    g, c = res["cuda"], res["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(g["losses"], c["losses"]))
    if not all(math.isfinite(x) for x in g["losses"]) or loss_rel > W_LOSS_RTOL \
            or g["count"] != c["count"]:
        fail(f"{opt}: losses {g['losses']} vs CPU {c['losses']}, counts {g['count']} "
             f"{c['count']}")
    out = {"steps": len(batches), "losses": g["losses"], "loss_rel_diff": loss_rel,
           "touched_rows": len(touched), "untouched_rows": g["untouched_rows"],
           "table_move_rel": movement_rel(g["rows"]["table"], c["rows"]["table"],
                                          c["rows_before"]),
           "dense_move_rel": movement_rel(
               torch.cat([v.reshape(-1) for v in g["dense"].values()]),
               torch.cat([v.reshape(-1) for v in c["dense"].values()]),
               torch.cat([v.reshape(-1) for v in c["dense_before"].values()]))}
    out["moments_rel"] = {k: float((g["rows"][k] - c["rows"][k]).norm() / c["rows"][k].norm())
                          for k in g["rows"] if k != "table"}
    if out["table_move_rel"] > W_MOVE_REL or out["dense_move_rel"] > W_MOVE_REL \
            or max(out["moments_rel"].values()) > W_MOMENT_REL:
        fail(f"{opt}, card against CPU: {out}")
    return out


def mean_update_reference(model, batches: list, infos: list, args, lr: float) -> None:
    """One update of the ``sparse_adam`` arm from the mean of the
    micro-batches' gradients, written out on ``model``'s device: the rows
    gathered, the dense gradients summed, the row gradients divided by K,
    one dedupe, one joint clip at ``args.max_grad_norm``, then fresh AdamW
    on the dense weights, fresh Adafactor (bf16 moment) on the other
    tables and lazy Adam (bf16 moments) on the item table's touched rows."""
    from transformers4rec_tpu_torch.ops.fused_adafactor import FusedAdafactor
    from transformers4rec_tpu_torch.ops.sparse_update import (
        dedupe_row_grads,
        sparse_rows_adam_init,
        sparse_rows_adam_update,
    )
    from transformers4rec_tpu_torch.trainer.sparse_embedding_step import gather_rows

    k = len(batches)
    table = model.heads[0].input_module.item_embedding_table()
    named = {n: p for n, p in model.named_parameters() if p is not table}
    sums = {n: torch.zeros_like(p) for n, p in named.items()}
    seen = set()  # a weight no micro-step gave a gradient keeps None, as in the trainer
    ids_all, rows_all = [], []
    dev = table.device
    for batch, info in zip(batches, infos):
        b = model._as_dense(batch)
        model.zero_grad(set_to_none=True)
        rows, ids = gather_rows(table, b["item_id"], info.neg_ids.to(dev), "mlm")
        loss, _ = model(b, targets=b, training=True, masking_info=info_on(info, dev),
                        sparse_rows=rows)
        loss.backward()
        for n, p in named.items():
            if p.grad is not None:
                sums[n] += p.grad
                seen.add(n)
        ids_all.append(ids)
        rows_all.append(rows.rows.grad / k)
    uids, g_sum = dedupe_row_grads(torch.cat(ids_all), torch.cat(rows_all), table.shape[0])
    mean = {n: sums[n] / k for n in seen}
    norm = torch.sqrt(sum((g ** 2).sum() for g in list(mean.values()) + [g_sum]))
    scale = torch.clamp(args.max_grad_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    for n, p in named.items():
        p.grad = mean[n] * scale if n in seen else None
    torch.optim.AdamW([p for n, p in named.items() if "tables." not in n], lr=lr,
                      betas=(args.adam_beta1, args.adam_beta2), eps=args.adam_epsilon,
                      weight_decay=args.weight_decay).step()
    FusedAdafactor([p for n, p in named.items() if "tables." in n], lr=lr,
                   moment_dtype=torch.bfloat16).step()
    sparse_rows_adam_update(table.data, sparse_rows_adam_init(table.detach(), torch.bfloat16),
                            uids, g_sum * scale, lr, b1=args.adam_beta1, b2=args.adam_beta2,
                            eps=args.adam_epsilon, deduped=True)
    model.zero_grad(set_to_none=True)


def params_flat(model) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1).cpu() for p in model.parameters()])


def run_sparse_large_vocab(flagship, vocab, fa, card: str) -> dict:
    """Main path W1: configuration 4's ``sparse_adam`` arm at full width
    (``flagship.build_large_vocab_trainer(embedding_optimizer="sparse_adam")``:
    XLNet-MLM over 4,000,000 items, a tied 64-wide table, d_model 192, 3
    layers, 16 heads, batches of 128 of 20, 8,192 negatives, bf16 moments,
    the clip at 1). ``Trainer.train`` takes a cold step and ``W1_STEADY``
    timed steps, then a window under ``torch.profiler``; the item table
    never holds a gradient and each step's memory peak grows by less than
    one (V, 64) float32 tensor. One step of the trained weights and rows'
    state, card against CPU, with one mask and one draw of negatives;
    ``W_ADAFACTOR_STEPS`` steps of the ``sparse_adafactor`` arm the same
    way; ``gradient_accumulation_steps=2`` on the card against one update
    from the mean gradient (``mean_update_reference``); ``Model.evaluate``
    of the trained weights over ``W1_EVAL_BATCHES`` batches (K3 at V =
    4,000,001) against the CPU's plain pass."""
    from transformers4rec_tpu_torch.data import synthetic_data

    t_phase = time.perf_counter()
    counters = flash_counters(vocab, fa)
    launches = dict.fromkeys(counters, 0)
    items, rows, seq = flagship.LARGE_VOCAB_ITEMS, flagship.BATCH, flagship.SEQ
    vocab_size = items + 1
    table_rows = -(-vocab_size // 8) * 8
    schema = flagship.schema(items, seq)
    dense_grad_bytes = table_rows * flagship.LARGE_VOCAB_ITEM_DIM * 4
    out = {"card": card, "num_items": items, "table_rows": table_rows}

    data = synthetic_data(schema, num_rows=16 * rows, max_session_length=seq, seed=600)
    t0 = time.perf_counter()
    trainer = flagship.build_large_vocab_trainer("cuda", seed=0, train_dataset=data,
                                                 embedding_optimizer="sparse_adam")
    sync("cuda")
    out["build_s"] = time.perf_counter() - t0
    table = trainer.model.heads[0].input_module.item_embedding_table()
    trainer.create_optimizer_and_scheduler(1 + W1_STEADY + 2 * W1_WINDOW)
    step = trainer._sparse
    if step is None or step.rule != "adam" or step.state.mu.dtype != torch.bfloat16 \
            or tuple(table.shape) != (table_rows, flagship.LARGE_VOCAB_ITEM_DIM):
        fail(f"sparse large vocab: the arm is {step and step.rule}, table {tuple(table.shape)}")
    table_before = table.detach().clone()
    out["train"], growth = {}, {}
    for name, n in (("cold_step", 1), ("steady", W1_STEADY)):
        sync("cuda")
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out["train"].update(trainer_phases(trainer, counters, launches, "sparse-large-vocab",
                                           card, rows, seq, ((name, n, None),), per_step={}))
        growth[name] = torch.cuda.max_memory_allocated() - base
    out["peak_growth_gb"] = {k: v / 1e9 for k, v in growth.items()}
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if table.grad is not None or max(growth.values()) >= dense_grad_bytes:
        fail(f"sparse large vocab: table gradient {table.grad is not None}, peak growth "
             f"{growth} against one (V, 64) f32 tensor of {dense_grad_bytes} bytes")
    (window, prof_table), got, _ = counted(counters, lambda: traced_window(
        trainer, W1_WINDOW, rows=25))
    expect_launches("sparse large vocab (profiled window)", got)
    out["profile"] = window
    print(prof_table)
    moved = (table.detach() != table_before).any(dim=1)
    out["rows_moved"] = int(moved.sum())
    if not 0 < out["rows_moved"] < table_rows or not torch.isfinite(table).all():
        fail(f"sparse large vocab: {out['rows_moved']} rows of the item table moved")
    weights = {k: v.detach().to("cpu", copy=True) for k, v in trainer.model.state_dict().items()}
    state_doc = {"state": {k: v.cpu() for k, v in vars(step.state).items()},
                 "accum": {"ids": [], "grads": []}}
    args = trainer.args
    del trainer, step, table, table_before, moved
    torch.cuda.empty_cache()

    # the trained weights with dropout off, on the card and on the CPU
    models = {"cuda": flagship.build_large_vocab_model("cuda", dropout=0.0),
              "cpu": flagship.build_large_vocab_model("cpu", dropout=0.0)}
    cpu_model = models["cpu"]
    sampler = cpu_model.heads[0].tasks[0].make_sampler(table_rows)
    batches = [{k: v[i * rows:(i + 1) * rows] for k, v in data.items()} for i in range(3)]
    infos = [mlm_info(cpu_model, b, seed=30 + i,
                      neg_ids=large_vocab_negatives(sampler, seed=40 + i))
             for i, b in enumerate(batches)]
    out["adam_step"] = sparse_pair_steps(flagship, models, weights, "sparse_adam", batches[:1],
                                         infos[:1], counters, state_doc=state_doc)
    out["adafactor_steps"] = sparse_pair_steps(flagship, models, weights, "sparse_adafactor",
                                               batches[:W_ADAFACTOR_STEPS],
                                               infos[:W_ADAFACTOR_STEPS], counters)
    print(f"[sparse-large-vocab] card against CPU on {card}: "
          f"{json.dumps({k: out[k] for k in ('adam_step', 'adafactor_steps')})}")

    # accumulation: two micro-steps on the card against one update from the mean
    model = models["cuda"]
    model.load_state_dict(weights)
    acc = flagship._bench_trainer(model, None, "cuda", 0, None, None, tempfile.gettempdir(),
                                  rows, embedding_optimizer="sparse_adam",
                                  gradient_accumulation_steps=2)
    acc.create_optimizer_and_scheduler(2)
    before = params_flat(model)
    acc._train_step(model._as_dense(batches[0]), masking_info=info_on(infos[0], "cuda"))
    mid = params_flat(model)
    acc._train_step(model._as_dense(batches[1]), masking_info=info_on(infos[1], "cuda"))
    got_after = params_flat(model)
    if not torch.equal(mid, before) or acc._opt_step != 1 \
            or int(acc._sparse.state.count) != 1:
        fail("sparse accumulation: the first micro-step moved the weights, or no update")
    lr = acc._schedule(0)
    del acc
    model.load_state_dict(weights)
    mean_update_reference(model, batches[:2], infos[:2], args, lr)
    out["accumulation"] = {"micro_steps": 2, "updates": 1,
                           "move_rel": movement_rel(got_after, params_flat(model), before)}
    if out["accumulation"]["move_rel"] > W_MOVE_REL:
        fail(f"sparse accumulation against the mean update: {out['accumulation']}")
    del before, mid, got_after

    # evaluation of the trained weights: K3 at V = 4,000,001
    model.load_state_dict(weights)
    cpu_model.load_state_dict(weights)
    loader = eval_batches(flagship, items, seq, W1_EVAL_BATCHES, EVAL_ROWS)
    gpu_res, got, wall = counted(counters, lambda: model.evaluate(loader))
    expect_launches("sparse large vocab (evaluate)", got, ce_rank=W1_EVAL_BATCHES)
    for k, c in got.items():
        launches[k] += c
    cpu_res = cpu_model.evaluate(loader)
    check_evaluate(gpu_res, cpu_res, W1_EVAL_BATCHES * EVAL_ROWS)
    out["evaluate"] = {"cuda": gpu_res, "cpu": cpu_res, "wall_s": wall}
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[sparse-large-vocab] on {card}: a steady step "
          f"{out['train']['steady']['ms_per_step']:.3f} ms of wall time "
          f"({window['ms_per_step']:.3f} in the profiled window's untraced run, "
          f"{window['device_ms_per_step']:.3f} ms of device time, busy "
          f"{window['device_busy_share']:.3f}); peak growth {json.dumps(out['peak_growth_gb'])} "
          f"GB, peak {out['peak_memory_gb']:.2f} GB; {out['rows_moved']} rows moved; "
          f"accumulation {json.dumps(out['accumulation'])}; phase W1 {out['phase_s']:.1f}s")
    del model, cpu_model, models
    torch.cuda.empty_cache()
    return out


def run_accumulation(flagship, vocab, fa, card: str) -> dict:
    """Main path W2: the flagship XLNet-MLM (390,000 items, full softmax
    through K1 and K2, the dense ``adafactor`` arm, dropout 0) with
    ``build_trainer(gradient_accumulation_steps=2)``: 2 + ``W2_MICRO_STEPS``
    micro-steps through ``Trainer.train`` (K1 and K2 once a micro-step, twice
    an update); one update from two micro-batches with given masks against
    the same update written out from the mean of their gradients; then
    ``W2_LAZY_STEPS`` steps of ``embedding_optimizer="lazy_adam"``, after
    each of which every table row whose gradient was zero is bit for bit
    as it was."""
    from transformers4rec_tpu_torch.data import synthetic_data
    from transformers4rec_tpu_torch.ops.fused_adafactor import FusedAdafactor

    t_phase = time.perf_counter()
    counters = flash_counters(vocab, fa)
    launches = dict.fromkeys(counters, 0)
    rows, seq = flagship.BATCH, flagship.SEQ
    data = synthetic_data(flagship.schema(), num_rows=8 * rows, max_session_length=seq,
                          seed=700)
    trainer = flagship.build_trainer("cuda", seed=0, train_dataset=data,
                                     gradient_accumulation_steps=2, dropout=0.0)
    model = trainer.model
    trainer.create_optimizer_and_scheduler(2 + W2_MICRO_STEPS)
    out = {"card": card, "train": trainer_phases(
        trainer, counters, launches, "accumulation", card, rows, seq,
        (("cold_steps", 2, None), ("steady", W2_MICRO_STEPS, None)),
        per_step={"ce_fwd": 1, "ce_bwd": 1})}
    if trainer._opt_step != (2 + W2_MICRO_STEPS) // 2:
        fail(f"accumulation: {trainer._opt_step} updates in {2 + W2_MICRO_STEPS} micro-steps")
    out["updates"] = trainer._opt_step
    out["ms_per_update"] = 2 * out["train"]["steady"]["ms_per_step"]

    # one update from two micro-batches, against the mean gradient's update
    weights = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
    cpu_model = flagship.build_model("cpu", dropout=0.0, seed=0)
    batches = [{k: v[i * rows:(i + 1) * rows] for k, v in data.items()} for i in range(2)]
    infos = [mlm_info(cpu_model, b, seed=50 + i) for i, b in enumerate(batches)]
    del cpu_model
    trainer.create_optimizer_and_scheduler(2)
    before = params_flat(model)

    def two_micro_steps():
        for b, i in zip(batches, infos):
            trainer._train_step(model._as_dense(b), masking_info=info_on(i, "cuda"))

    _, got, _ = counted(counters, two_micro_steps)
    expect_launches("accumulation (one update)", got, ce_fwd=2, ce_bwd=2)
    for k, c in got.items():
        launches[k] += c
    got_after = params_flat(model)
    a, lr = trainer.args, trainer._schedule(0)
    model.load_state_dict(weights)
    sums = {}
    for b, i in zip(batches, infos):
        model.zero_grad(set_to_none=True)
        bd = model._as_dense(b)
        loss, _ = model(bd, targets=bd, training=True, masking_info=info_on(i, "cuda"))
        loss.backward()
        for n, p in model.named_parameters():
            if p.grad is not None:
                sums[n] = sums[n] + p.grad if n in sums else p.grad.clone()
    named = dict(model.named_parameters())
    for n, p in named.items():
        p.grad = sums[n] / 2 if n in sums else None
    torch.optim.AdamW([p for n, p in named.items() if "tables." not in n], lr=lr,
                      betas=(a.adam_beta1, a.adam_beta2), eps=a.adam_epsilon,
                      weight_decay=a.weight_decay).step()
    FusedAdafactor([p for n, p in named.items() if "tables." in n], lr=lr,
                   moment_dtype=torch.bfloat16).step()
    out["mean_update_move_rel"] = movement_rel(got_after, params_flat(model), before)
    if out["mean_update_move_rel"] > W_MOVE_REL:
        fail(f"accumulation against the mean update: {out['mean_update_move_rel']}")
    del before, got_after, sums

    # lazy Adam: rows whose gradient is zero stay as they were
    model.load_state_dict(weights)
    trainer.args = dataclasses.replace(a, embedding_optimizer="lazy_adam",
                                       embedding_moment_dtype="f32",
                                       gradient_accumulation_steps=1)
    trainer.create_optimizer_and_scheduler(W2_LAZY_STEPS)
    tables = {n: p for n, p in model.named_parameters() if "tables." in n}
    untouched = {n: 0 for n in tables}
    for s in range(W2_LAZY_STEPS):
        before = {n: p.detach().clone() for n, p in tables.items()}
        _, got, _ = counted(counters, lambda: trainer._train_step(
            model._as_dense(batches[s % 2])))
        expect_launches("lazy_adam step", got, ce_fwd=1, ce_bwd=1)
        for k, c in got.items():
            launches[k] += c
        for n, p in tables.items():
            zero = (p.grad == 0).all(dim=1)
            changed = (bits(p.detach()) != bits(before[n])).any(dim=1)
            if bool((changed & zero).any()) or not bool(changed[~zero].any()):
                fail(f"lazy_adam step {s}: {n}: {int((changed & zero).sum())} rows with a zero "
                     f"gradient moved, {int(changed[~zero].sum())} others moved")
            untouched[n] += int(zero.sum())
    out["lazy_adam_untouched_rows"] = untouched
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[accumulation] on {card}: K = 2, a micro-step "
          f"{out['train']['steady']['ms_per_step']:.3f} ms, an update {out['ms_per_update']:.3f} "
          f"ms of wall time; the mean update's movement within "
          f"{out['mean_update_move_rel']:.3g}; lazy_adam rows with a zero gradient, all "
          f"unchanged: {json.dumps(untouched)}; launches {json.dumps(launches)}; phase W2 "
          f"{out['phase_s']:.1f}s")
    del trainer, model
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------- U: session packing
PACK_SESSIONS_PER_DAY = 4_000  # U1's windows: about 20 packed batches of 128
PACK_TIMED_STEPS = 8  # U1, U2, V1-V3: timed steps after the cold one
U2_SESSIONS = 7_000  # sessions of 2 to 20 items: 8 to 9 packed batches of 32 rows of 256
POSITIONS = ENCODER + "position_embedding"


def eval_metrics(results: dict) -> dict:
    """A Trainer evaluation's metrics without its runtime keys."""
    return {k: v for k, v in results.items() if "_runtime" not in k and "_per_second" not in k}


def unpack_rows(batch: dict, seq: int) -> dict:
    """The sessions of packed rows, one to a row of ``seq``."""
    seg = batch["segment_ids"]
    cols = [k for k in batch if k != "segment_ids"]
    out = {c: [] for c in cols}
    for r in range(seg.shape[0]):
        for s_id in np.unique(seg[r][seg[r] > 0]):
            at = seg[r] == s_id
            for c in cols:
                row = np.zeros(seq, batch[c].dtype)
                row[:int(at.sum())] = batch[c][r][at]
                out[c].append(row)
    return {c: np.stack(v) for c, v in out.items()}


def run_packing(flagship, vocab, fa, card: str) -> dict:
    """Main path U, session packing at full width. U1: the flagship
    XLNet-MLM (batch 128 of 20) from Parquet files of the port's ETL
    (three windows of ``PACK_SESSIONS_PER_DAY`` sessions of 2 to 20 items)
    through ``flagship.build_trainer(pack_sessions=True,
    pack_eval_sessions=True)``: the fill (``packing_stats``), the loader's
    host ms per batch packed and unpacked, a cold step and
    ``PACK_TIMED_STEPS`` timed steps of each arm (ms a step, sessions/s,
    the device's busy share of a profiled window); one packed step against
    the CPU on the same weights and mask; packed ``Trainer.evaluate`` (K3 at
    1,280 rows a batch: 128 rows of 20 hold at most 10 targets each) against
    the unpacked evaluation of the same weights and against the CPU's packed
    one, metric by metric. U2: GPT-2-CLM at batch 32 of rows of 256 packed
    from ``U2_SESSIONS`` sessions of 2 to 20 items (an in-memory dict
    through ``build_trainer(scheme="clm", pack_sessions=True)``): K5 and K6a
    with the (32, 1, 256, 256) block-diagonal bias, 3 times a step; a cold
    and ``PACK_TIMED_STEPS`` timed steps and a profiled window; one step at
    batch 4 against the CPU (GPT-2's positions restart per segment); packed evaluation of one
    batch (K3 at 4,096 rows) against the CPU and against the same sessions
    unpacked at S = 20."""
    from transformers4rec_tpu_torch.data import (
        ParquetDataLoader,
        pack_sessions,
        packing_stats,
        synthetic_data,
    )
    from transformers4rec_tpu_torch.trainer import Trainer

    t_phase = time.perf_counter()
    counters = flash_counters(vocab, fa)
    launches = dict.fromkeys(counters, 0)
    out = {"card": card}

    def run(what: str, fn, **want):
        result, got, wall = counted(counters, fn)
        expect_launches(f"phase U ({what})", got, **want)
        for k, c in got.items():
            launches[k] += c
        return result, wall

    rows, seq, layers = flagship.BATCH, flagship.SEQ, flagship.N_LAYER
    schema = flagship.schema()
    timed = (("cold", 1, None), ("timed", PACK_TIMED_STEPS, None))
    with tempfile.TemporaryDirectory() as root:
        windows, sizes = parquet_windows(flagship, os.path.join(root, "windows"), seed=500,
                                         sessions_per_day=PACK_SESSIONS_PER_DAY)
        train_file = os.path.join(windows, "1", "train.parquet")
        eval_file = os.path.join(windows, "2", "valid.parquet")
        times, loaded = {}, {}
        for arm, pack in (("unpacked", False), ("packed", True)):
            t0 = time.perf_counter()
            loaded[arm] = ParquetDataLoader.from_schema(schema, train_file, batch_size=rows,
                                                        pack=pack, shuffle=False).data
            times[arm] = 1e3 * (time.perf_counter() - t0)
        stats = packing_stats(loaded["packed"], "item_id")
        per_row = stats["sessions"] / stats["rows"]
        # packing keeps every session of two items or more
        kept = int(((loaded["unpacked"]["item_id"] != 0).sum(1) >= 2).sum())
        if stats["sessions"] != kept or not per_row > 1.2:
            fail(f"U1: packing_stats {stats} of {kept} sessions")
        out["u1_packing"] = {**stats, "sessions_per_row": per_row, "from_schema_ms": times,
                             "loader_ms": {
                                 arm: loader_ms(lambda: ParquetDataLoader.from_schema(
                                     schema, train_file, batch_size=rows, pack=pack,
                                     prefetch=0))
                                 for arm, pack in (("unpacked", False), ("packed", True))}}
        print(f"[pack] U1 on {card}: {sizes['1/train']} sessions of window 1 packed into "
              f"{stats['rows']} rows of {seq} ({per_row:.3f} sessions a row, fill "
              f"{stats['fill']}); {json.dumps(out['u1_packing'])}")

        arms = {}
        for arm, pack in (("unpacked", False), ("packed", True)):
            t = flagship.build_trainer("cuda", seed=0, train_dataset=train_file,
                                       eval_dataset=eval_file,
                                       output_dir=os.path.join(root, arm), pack_sessions=pack,
                                       pack_eval_sessions=pack)
            # the loader (decode and packing) is made once, outside the timing
            t._train_dataloader = t.get_train_dataloader()
            first = next(iter(t._train_dataloader))
            if pack != ("segment_ids" in first):
                fail(f"U1 {arm}: a training batch with keys {sorted(first)}")
            res = trainer_phases(t, counters, launches, f"pack U1 {arm}", card, rows, seq,
                                 timed, {"ce_fwd": 1, "ce_bwd": 1})
            rate = res["timed"]["sessions_per_s"] * (per_row if pack else 1.0)
            window, _ = traced_window(t, PACK_TIMED_STEPS)
            arms[arm] = {"cold_ms": res["cold"]["ms_per_step"],
                         "ms_per_step": res["timed"]["ms_per_step"], "rows_per_s":
                         res["timed"]["sessions_per_s"], "sessions_per_s": rate,
                         "profiled": window}
            if pack:
                packed_trainer = t
            else:
                del t
        out["u1_train"] = arms
        print(f"[pack] U1 training on {card}: {json.dumps(arms)}")

        # one packed step, the card against the CPU, on the same weights and mask
        model = flagship.build_model("cuda", seed=0, dropout=0.0)
        cpu_model = flagship.build_model("cpu", seed=0, dropout=0.0)
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        batch = {k: v[:rows] for k, v in loaded["packed"].items()}
        out["u1_train_step"], _ = run("U1 packed training step", lambda: check_training_step(
            model, cpu_model, batch), ce_fwd=1, ce_bwd=1)
        print(f"[pack] U1 packed training step, card against CPU: "
              f"{json.dumps(out['u1_train_step'])}")
        del model, cpu_model

        # packed evaluation against unpacked, and against the CPU
        n_eval = sizes["2/valid"]
        packed_rows = len(ParquetDataLoader.from_schema(schema, eval_file, batch_size=rows,
                                                        pack=True).data["item_id"])
        t = packed_trainer
        packed_res, packed_s = run("U1 packed evaluate", t.evaluate,
                                   ce_rank=-(-packed_rows // rows))
        t.args.pack_eval_sessions = False
        unpacked_res, unpacked_s = run("U1 unpacked evaluate", t.evaluate,
                                       ce_rank=-(-n_eval // rows))
        t.args.pack_eval_sessions = True
        cpu_model = flagship.build_model("cpu", seed=0)
        cpu_model.load_state_dict({k: v.cpu() for k, v in t.model.state_dict().items()})
        cpu_res = Trainer(cpu_model, t.args, schema=t.schema, eval_dataset=eval_file,
                          device="cpu").evaluate()
        check_evaluate(eval_metrics(packed_res), eval_metrics(unpacked_res), n_eval)
        check_evaluate(eval_metrics(packed_res), eval_metrics(cpu_res), n_eval)
        out["u1_evaluate"] = {
            "sessions": n_eval, "packed_rows": packed_rows, "packed_s": packed_s,
            "unpacked_s": unpacked_s, "packed": eval_metrics(packed_res),
            "max_abs_diff_to_unpacked": max(abs(packed_res[k] - unpacked_res[k])
                                            for k in eval_metrics(packed_res)),
            "max_abs_diff_to_cpu": max(abs(packed_res[k] - cpu_res[k])
                                       for k in eval_metrics(packed_res))}
        print(f"[pack] U1 evaluation of {n_eval} sessions in {packed_rows} packed rows on "
              f"{card}: {json.dumps(out['u1_evaluate'])}")
        del t, packed_trainer, cpu_model, loaded
        torch.cuda.empty_cache()

    # U2: GPT-2-CLM on rows of 256 packed from short sessions
    seq2, rows2 = flagship.LONG_SEQ, flagship.LONG_BATCH
    short = synthetic_data(flagship.schema(flagship.NUM_ITEMS, seq), num_rows=U2_SESSIONS,
                           max_session_length=seq, seed=510)
    packed2 = pack_sessions(short, max_len=seq2, item_id_col="item_id")
    stats2 = packing_stats(packed2, "item_id")
    per_row2 = stats2["sessions"] / stats2["rows"]
    trainer = flagship.build_trainer("cuda", seed=0, train_dataset=short, scheme="clm",
                                     pack_sessions=True)
    trainer._train_dataloader = trainer.get_train_dataloader()
    first = next(iter(trainer._train_dataloader))
    if first["segment_ids"].shape != (rows2, seq2) or int(first["segment_ids"].max()) < 5:
        fail(f"U2: packed batch {first['segment_ids'].shape}, "
             f"{int(first['segment_ids'].max())} sessions in a row")
    per_step = {"flash_fwd": layers, "flash_bwd_fused": layers, "ce_fwd": 1, "ce_bwd": 1}
    res = trainer_phases(trainer, counters, launches, "pack U2", card, rows2, seq2, timed,
                         per_step)
    window, _ = traced_window(trainer, PACK_TIMED_STEPS)
    out["u2_train"] = {"packing": {**stats2, "sessions_per_row": per_row2},
                       "cold_ms": res["cold"]["ms_per_step"],
                       "ms_per_step": res["timed"]["ms_per_step"],
                       "sessions_per_s": res["timed"]["sessions_per_s"] * per_row2,
                       "profiled": window}
    print(f"[pack] U2 GPT-2-CLM on {card}: {json.dumps(out['u2_train'])}")
    del trainer
    torch.cuda.empty_cache()

    model = flagship.build_model("cuda", scheme="clm", seed=0, dropout=0.0)
    cpu_model = flagship.build_model("cpu", scheme="clm", seed=0, dropout=0.0)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    four = {k: v[:4] for k, v in packed2.items()}
    # the positions' gradient restarts at every segment: rows of 256 hold
    # positions 0..19 only
    out["u2_train_step"], _ = run("U2 packed training step", lambda: check_training_step(
        model, cpu_model, four, extra=(POSITIONS,)), **per_step)
    print(f"[pack] U2 packed training step at batch 4, card against CPU: "
          f"{json.dumps(out['u2_train_step'])}")
    batch = {k: v[:rows2] for k, v in packed2.items()}
    sessions = unpack_rows(batch, seq)
    n = len(sessions["item_id"])
    gpu_res, packed_s = run("U2 packed evaluate", lambda: model.evaluate([batch]),
                            flash_fwd=layers, ce_rank=1)
    alone = [{k: v[i:i + EVAL_ROWS] for k, v in sessions.items()}
             for i in range(0, n, EVAL_ROWS)]
    unpacked_res, _ = run("U2 the same sessions unpacked", lambda: model.evaluate(alone),
                          ce_rank=len(alone))
    cpu_res = cpu_model.evaluate([batch])
    check_evaluate(gpu_res, cpu_res, n)
    check_evaluate(gpu_res, unpacked_res, n)
    out["u2_evaluate"] = {"sessions": n, "packed_s": packed_s, "packed": gpu_res,
                          "max_abs_diff_to_unpacked": max(abs(gpu_res[k] - unpacked_res[k])
                                                          for k in gpu_res),
                          "max_abs_diff_to_cpu": max(abs(gpu_res[k] - cpu_res[k])
                                                     for k in gpu_res)}
    print(f"[pack] U2 evaluation of {n} sessions in one packed batch on {card}: "
          f"{json.dumps(out['u2_evaluate'])}")
    del model, cpu_model
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[pack] phase U on {card}: {out['phase_s']:.1f}s, launches {json.dumps(launches)}")
    return out


# --------------------------------------------- V: Reformer and recurrent bodies
LSH_TIE_MARGIN = 1e-3  # V2: the card's and the CPU's hidden states differ by bf16 roundings


def build_gru_model(device=None, seed: int = 0, dropout: float = 0.0):
    """V3's GRU4Rec-style model from the public API, at the flagship's item
    table and width: ``TabularSequenceFeatures`` (CLM) → ``MLPBlock(192)`` →
    ``RNNBlock(192, "gru", num_layers=2)`` → the tied next-item task. Also
    the serving builder (``builder(device)``)."""
    from transformers4rec_tpu_torch import (
        Head,
        MLPBlock,
        Model,
        NextItemPredictionTask,
        RNNBlock,
        TabularSequenceFeatures,
        flagship,
    )

    im = TabularSequenceFeatures.from_schema(flagship.schema(), d_output=flagship.D_MODEL,
                                             masking="clm", aggregation="concat")
    head = Head.from_body(im, tasks=[NextItemPredictionTask(weight_tying=True)],
                          extra_blocks=[MLPBlock((flagship.D_MODEL,)),
                                        RNNBlock(units=flagship.D_MODEL, cell_type="gru",
                                                 num_layers=2, dropout=dropout)])
    return Model(heads=(head,), device=device, seed=seed)


def lsh_flips(model, cpu_model, batch, layer: int) -> dict:
    """The buckets of LSH layer ``layer`` on the card and on the CPU for one
    forward of ``batch`` (dropout off): how many differ, and the CPU's gap
    between the top two of ``[xR, -xR]`` at each that does, which must be
    within ``LSH_TIE_MARGIN``."""
    from transformers4rec_tpu_torch.ops import lsh_attention as lsh

    seen = {}
    for name, m in (("cuda", model), ("cpu", cpu_model)):
        attn = m.heads[0].body.blocks[1].encoder.stack()[layer].attn

        def hook(mod, args, name=name):
            x = args[0]
            B, S, _ = x.shape
            k = lsh._normalize_keys(mod.qk(x).view(B, S, mod.n_head, -1))
            proj = torch.einsum("bshd,drn->bshrn", k.float(), mod.rotations.float())
            seen[name] = (lsh.hash_buckets(k, mod.rotations).cpu(),
                          torch.cat([proj, -proj], -1).cpu())

        handle = attn.register_forward_pre_hook(hook)
        with torch.no_grad():
            b = m._as_dense(batch)
            m(b, targets=b, testing=True)
        handle.remove()
    diff = seen["cuda"][0] != seen["cpu"][0]
    top2 = seen["cpu"][1].double().topk(2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1])[diff]
    if len(gaps) and float(gaps.max()) > LSH_TIE_MARGIN:
        fail(f"LSH layer {layer}: buckets differ between the card and the CPU where the top "
             f"two are {float(gaps.max())} apart")
    return {"decisions": diff.numel(), "flips": int(diff.sum()),
            "max_gap_of_a_flip": float(gaps.max()) if len(gaps) else None}


def run_reformer_rnn(flagship, vocab, fa, card: str) -> dict:
    """Main path V, Reformer and a recurrent body at full width. V1: the
    headline command through the port's experiment script with
    ``--model_type reformer`` (local, LSH, local layers; axial positions; at
    S = 20 the LSH layer takes ``lsh_reference``): a cold step and
    ``PACK_TIMED_STEPS`` timed steps from window 1, then the whole protocol
    over one window (K1, K2 once a step, K3 once an evaluation batch), then
    one training step of the trained model against the CPU. V2:
    Reformer-MLM at batch 32 of up to 256 (``build_trainer(arch="reformer",
    seq=LONG_SEQ)``: chunks of 64, 10 buckets, 2 hashes, the sorted path;
    the local layers' K5 and K6a with the window's (1, 1, S, S) bias, twice
    a step): a cold and timed steps; one step at batch 4 against the CPU with
    the same weights and rotation buffers, the LSH layer's buckets on both
    (``lsh_flips``); one evaluation batch against the CPU. V3: the GRU body
    (``build_gru_model``, CLM, batch 128 of 20) through a ``Trainer`` with
    the flagship's optimizer settings: a cold and timed steps; one step
    against the CPU; ``Model.evaluate`` over 4 batches against the CPU; the
    server's top-k over HTTP and the CPU's on the same artifact."""
    from transformers4rec_tpu_torch.data import ParquetDataLoader, synthetic_data
    from transformers4rec_tpu_torch.paper_repro import datasets_configs, transf_exp_main
    from transformers4rec_tpu_torch.serving import InferenceRunner, export_model
    from transformers4rec_tpu_torch.trainer import T4RecTrainingArguments, Trainer

    t_phase = time.perf_counter()
    counters = flash_counters(vocab, fa)
    launches = dict.fromkeys(counters, 0)
    out = {"card": card}

    def run(what: str, fn, **want):
        result, got, wall = counted(counters, fn)
        expect_launches(f"phase V ({what})", got, **want)
        for k, c in got.items():
            launches[k] += c
        return result, wall

    timed = (("cold", 1, None), ("timed", PACK_TIMED_STEPS, None))
    step_kernels = {"ce_fwd": 1, "ce_bwd": 1}
    reformer_extra = (ENCODER + "axial_pos_0", ENCODER + "axial_pos_1",
                      ENCODER + "layers.1.attn.qk.weight")

    # V1: the headline command as Reformer-MLM through the experiment script
    schema = datasets_configs.make_schema("rees46")
    item_only = schema.select_by_name([schema.item_id_column_name])
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        schema_path = os.path.join(root, "schema.pbtxt")
        schema.to_proto_text_file(schema_path)
        data = os.path.join(root, "data")
        sizes = paper_windows(schema, data, seed=402)
        argv = with_flags(paper_readme_argv(data, schema_path), (),
                          {"model_type": "reformer", "final_time_window_index": "1"})
        print(f"[reformer] V1: transf_exp_main {' '.join(argv)}")
        os.chdir(root)  # the command's --output_dir ./tmp/
        try:
            args, data_path, trainer = transf_exp_main.setup(argv)
            enc = trainer.model.heads[0].body.blocks[1].encoder
            if enc.attn_layers != ("local", "lsh", "local") or enc.pos_encoding != "axial":
                fail(f"V1: encoder {enc.attn_layers}, {enc.pos_encoding}")
            first = str(args.start_time_window_index).zfill(args.time_window_folder_pad_digits
                                                            or 1)
            trainer.train_dataset = os.path.join(data_path, first, "train.parquet")
            rows = args.per_device_train_batch_size
            res = trainer_phases(trainer, counters, launches, "reformer V1", card, rows,
                                 args.session_seq_length_max, timed, step_kernels)
            out["v1_train"] = {"cold_ms": res["cold"]["ms_per_step"],
                               "ms_per_step": res["timed"]["ms_per_step"],
                               "sessions_per_s": res["timed"]["sessions_per_s"]}
            del trainer
            steps = int(args.num_train_epochs) * (PAPER_SESSIONS["train"] // rows)
            n_eval = -(-sizes[f"{args.start_time_window_index + 1}/test"]
                       // args.per_device_eval_batch_size)
            r, wall = run("V1 the experiment script", lambda: transf_exp_main.run(argv),
                          ce_fwd=steps, ce_bwd=steps, ce_rank=n_eval)
        finally:
            os.chdir(cwd)
        losses = [h["loss"] for h in r.trainer.state.log_history if "loss" in h]
        if r.trainer.state.global_step != steps or sorted(r.results) != PAPER_RESULT_KEYS \
                or not all(math.isfinite(v) for v in losses) \
                or not all(math.isfinite(x) for v in r.results.values() for x in v):
            fail(f"V1: {r.trainer.state.global_step} steps, losses {losses}, {r.results}")
        batch = next(iter(ParquetDataLoader.from_schema(
            item_only, os.path.join(data, "0003", "test.parquet"), batch_size=128,
            max_sequence_length=20, shuffle=False)))
        model = r.trainer.model
        cpu_model = transf_exp_main.get_model(args, item_only, device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        swapped = same_swap_draw(model, cpu_model, batch, seed=7)
        step, _ = run("V1 training step", lambda: check_training_step(
            model, cpu_model, batch, extra=reformer_extra, loss_rtol=1e-5, extra_rel=1e-3),
            **step_kernels)
        out["v1"] = {"steps": steps, "eval_batches": n_eval, "wall_s": wall, "losses": losses,
                     "results": r.results, "swapped_ids": swapped, "train_step": step}
        print(f"[reformer] V1 on {card}: {json.dumps(out['v1_train'])}; the script's run "
              f"{json.dumps(out['v1'])}")
        del r, model, cpu_model
        torch.cuda.empty_cache()

    # V2: Reformer-MLM on sessions of up to 256, the sorted LSH path
    seq, rows, layers = flagship.LONG_SEQ, flagship.LONG_BATCH, flagship.N_LAYER
    data = synthetic_data(flagship.schema(flagship.NUM_ITEMS, seq), num_rows=8 * rows,
                          max_session_length=seq, seed=520)
    trainer = flagship.build_trainer("cuda", seed=0, train_dataset=data, arch="reformer",
                                     seq=seq, batch=rows)
    enc = trainer.model.heads[0].body.blocks[1].encoder
    lsh_attn = enc.stack()[1].attn
    plan = {"attn_layers": enc.attn_layers, "local_window": enc.local_window,
            "chunk": lsh_attn.chunk_size, "rotations": list(lsh_attn.rotations.shape)}
    if plan != {"attn_layers": ("local", "lsh", "local"), "local_window": PAPER_WINDOW,
                "chunk": 64, "rotations": [flagship.D_MODEL // flagship.N_HEAD, 2, 5]}:
        fail(f"V2: {plan}")
    local = layers - 1
    per_step = {"flash_fwd": local, "flash_bwd_fused": local, **step_kernels}
    res = trainer_phases(trainer, counters, launches, "reformer V2", card, rows, seq, timed,
                         per_step)
    out["v2_train"] = {"plan": plan, "cold_ms": res["cold"]["ms_per_step"],
                       "ms_per_step": res["timed"]["ms_per_step"],
                       "sessions_per_s": res["timed"]["sessions_per_s"]}
    del trainer
    torch.cuda.empty_cache()
    model = flagship.build_model("cuda", seed=0, dropout=0.0, arch="reformer", seq=seq)
    cpu_model = flagship.build_model("cpu", seed=0, dropout=0.0, arch="reformer", seq=seq)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    four = {k: v[:4] for k, v in data.items()}
    flips = lsh_flips(model, cpu_model, four, 1)
    step, _ = run("V2 training step", lambda: check_training_step(
        model, cpu_model, four, extra=reformer_extra), **per_step)
    loader = eval_batches(flagship, flagship.NUM_ITEMS, seq, 1, rows)
    gpu_res, eval_s = run("V2 evaluate", lambda: model.evaluate(loader), flash_fwd=local,
                          ce_rank=1)
    check_evaluate(gpu_res, cpu_model.evaluate(loader), rows)
    out["v2"] = {"lsh_buckets": flips, "train_step": step, "evaluate": gpu_res,
                 "evaluate_s": eval_s}
    print(f"[reformer] V2 on {card}: {json.dumps(out['v2_train'])}; card against CPU "
          f"{json.dumps(out['v2'])}")
    del model, cpu_model
    torch.cuda.empty_cache()

    # V3: the GRU body at the flagship's width
    seq, rows = flagship.SEQ, flagship.BATCH
    data = synthetic_data(flagship.schema(), num_rows=16 * rows, max_session_length=seq,
                          seed=530)
    with tempfile.TemporaryDirectory() as root:
        args = T4RecTrainingArguments(
            output_dir=root, learning_rate=flagship.LEARNING_RATE,
            lr_scheduler_type="constant", weight_decay=flagship.WEIGHT_DECAY, max_grad_norm=0.0,
            embedding_optimizer="adafactor", embedding_moment_dtype="bf16",
            per_device_train_batch_size=rows, per_device_eval_batch_size=rows,
            steps_per_execution=8, max_sequence_length=seq, seed=0)
        trainer = Trainer(build_gru_model("cuda", dropout=0.1), args, schema=flagship.schema(),
                          train_dataset=data, device="cuda")
        res = trainer_phases(trainer, counters, launches, "gru V3", card, rows, seq, timed,
                             step_kernels)
    out["v3_train"] = {"cold_ms": res["cold"]["ms_per_step"],
                       "ms_per_step": res["timed"]["ms_per_step"],
                       "sessions_per_s": res["timed"]["sessions_per_s"]}
    del trainer
    model, cpu_model = build_gru_model("cuda"), build_gru_model("cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    body = "heads.0.body.blocks.2."
    step, _ = run("V3 training step", lambda: check_training_step(
        model, cpu_model, {k: v[:rows] for k, v in data.items()},
        extra=(body + "gru_0.weight_ih_l0", body + "gru_0.weight_hh_l0",
               body + "gru_1.bias_hh_l0"), loss_rtol=1e-5, extra_rel=1e-3), **step_kernels)
    loader = eval_batches(flagship, flagship.NUM_ITEMS, seq, EVAL_BATCHES, rows)
    gpu_res, eval_s = run("V3 evaluate", lambda: model.evaluate(loader),
                          ce_rank=EVAL_BATCHES)
    check_evaluate(gpu_res, cpu_model.evaluate(loader), EVAL_BATCHES * rows)
    vocab_size = flagship.NUM_ITEMS + 1
    requests = serve_requests(flagship, flagship.NUM_ITEMS, seq, 8)
    serve = run_serve(build_gru_model, model, loader[0], vocab_size, requests, "cuda")
    sessions = {c: sum((r[c] for r in requests), [])[:8] for c in requests[0]}
    with tempfile.TemporaryDirectory() as path:
        export_model(model, loader[0], path, top_k=TOP_K)
        got_s, got_i = InferenceRunner(path, build_gru_model, device="cuda").predict(sessions)
        want_s, want_i = InferenceRunner(path, build_gru_model, device="cpu").predict(sessions)
    check_topk(got_s, got_i, want_s, want_i, vocab_size, "GRU top-k against the CPU")
    launches["ce_rank"] += serve["launches"]["ce_rank"]
    out["v3"] = {"train_step": step, "evaluate": gpu_res, "evaluate_s": eval_s,
                 "serve": serve["stats"], "serve_wall_s": serve["wall_s"]}
    print(f"[gru] V3 on {card}: {json.dumps(out['v3_train'])}; card against CPU "
          f"{json.dumps(out['v3'])}")
    del model, cpu_model
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[reformer-gru] phase V on {card}: {out['phase_s']:.1f}s, launches "
          f"{json.dumps(launches)}")
    return out


# -------------------------------------------------------------------- timing
# ------------------------------------------- X: bf16-stored tables on the card
X_STEPS = 8  # a trainer's group of steps (steps_per_execution)
X1_TIMED = 16  # X1's timed steps of each table type, after a warm group
X_EVAL_BATCHES = 2  # X1's evaluation batches, card against CPU
# one optimizer step of the bf16-table flagship, card against CPU, in two
# parts. The gradients from the same weights and mask: the loss within 1e-4
# relative, each dense gradient within ``X_GRAD_REL`` in relative Frobenius
# norm (the CE rounds its residual to bf16 on both devices from
# exponentials of their own: 1e-3, as ``check_grad`` holds it, and a
# rounding of 2^-8 more where the two devices' sums fall on either side of
# one). A bf16 table's gradient is bf16 (the CE's dW and the lookup's, each
# rounded, summed in bf16), and the lookup's sums a row's repeated ids: the
# CPU's embedding backward adds them one by one in bf16, rounding each time
# (as the JAX package's CPU scatter-add does), the card's sums them in f32
# and rounds once; k additions drift by about 2^-9·sqrt(k) in norm (1.1e-2
# measured on the category table, some 17 positions a row): within
# ``X_TABLE_GRAD_REL``. A key's bias takes rounding noise only (the softmax
# ignores it) and is left out. The update: the CPU's optimizers given the card's gradients
# from the same weights, so that a gradient whose sign the two devices'
# roundings flip (Adam's and Adafactor's first steps, g / (|g| + eps) and
# g / sqrt(g² + eps), make its step full size either way) tests the
# gradient and not the update: a dense weight's movement within
# ``X_MOVE_REL`` in relative Frobenius norm (p + step rounds at 2^-24 of p,
# some 1e-5 of a step), a bf16 table's values within one bf16 spacing of
# the CPU's and one of their step (the update and the sum each round to
# bf16 once, from f32 values whose last bits the devices' rsqrt may move),
# the bf16 moments within one bf16 spacing.
X_GRAD_REL = 1e-3 + 2.0 ** -8
X_TABLE_GRAD_REL = 3e-2
X_MOVE_REL = 1e-4
X_NOISE_ONLY = "attn.k.bias"
X_PAIR_DEVICES = ("cuda", "cpu")  # the card, then the reference's device


def bf16_counters(vocab, fa) -> dict:
    return {"ce_fwd": vocab.ce_fwd, "ce_bwd": vocab.ce_bwd, "ce_rank": vocab.ce_rank,
            "rank": vocab.rank_counts, "adafactor_a": fa.adafactor_pass_a,
            "adafactor_b": fa.adafactor_pass_b}


def table_dtypes(model) -> set:
    """The types of ``model``'s tables (``trainer.table_param_names``)."""
    from transformers4rec_tpu_torch.trainer import table_param_names

    params = dict(model.named_parameters())
    return {params[n].dtype for n in table_param_names(model)}


def check_bf16_ce(name: str, n: int, rows: int, vocab_size: int, eps: float, e: int,
                  seed: int, minus_one: bool = False, pad_labels: bool = False,
                  device="cuda") -> dict:
    """K1, K2, K3 and K4 on a bf16-stored table against the f32 kernels on the
    same values held as f32 (``W.float()``): the images are the same bytes
    and K3's ring and K4's loads give the tensor cores the same bf16 pairs,
    so K1's outputs, K2's dx, K3's ranks and K4's counts must be those
    kernels' bits, and K2's dW their f32 sum rounded once to bf16 (nearest
    even, as ``Tensor.to``). Against the plain versions: lse within 1e-4
    relative, the label logit within 1e-4 of max(|ll|, 1), dx and the f32
    kernel's dW as ``check_grad`` says, the bf16 dW within 1e-3 + 2^-8 (one
    more rounding) of the plain bf16 dW in relative Frobenius norm.
    ``pad_labels`` puts two labels on the table's padding rows."""
    from transformers4rec_tpu_torch.ops import vocab

    x, W, labels, w = ce_train_inputs(n, rows, vocab_size, seed, minus_one, device, e,
                                      torch.bfloat16)
    if pad_labels:
        labels[:2] = torch.tensor([vocab_size, rows - 1], dtype=torch.int32, device=device)
        w[:2] = 1.0
    Wf, smooth = W.float(), eps > 0
    fwd = vocab.ce_fwd(x, W, labels, vocab_size, smooth=smooth)
    fwd_f = vocab.ce_fwd(x, Wf, labels, vocab_size, smooth=smooth)
    lse_p, ll_p, _ = vocab.ce_fwd_plain(x, W, labels, vocab_size, smooth)
    coef = (w / w.sum().clamp_min(1.0)).contiguous()
    dx, dW = vocab.ce_bwd(x, W, labels, fwd[0], coef, vocab_size, eps)
    dx_f, dW_f = vocab.ce_bwd(x, Wf, labels, fwd[0], coef, vocab_size, eps)
    dx_p, dW_p = vocab.ce_bwd_plain(x, Wf, labels, fwd[0], coef, vocab_size, eps)
    gathered = vocab.label_logits(x, W, labels)
    _, rank, _ = vocab.ce_rank(x, W, labels, gathered, vocab_size, smooth=smooth)
    _, rank_f, _ = vocab.ce_rank(x, Wf, labels, gathered, vocab_size, smooth=smooth)
    cnt = vocab.rank_counts(x, W, gathered, labels, vocab_size)
    cnt_f = vocab.rank_counts(x, Wf, gathered, labels, vocab_size)
    sync(device)
    if not all((a is None and b is None) or torch.equal(a, b) for a, b in zip(fwd, fwd_f)):
        fail(f"bf16 table {name}: ce_fwd differs from the f32 kernel on the same values")
    if dW.dtype != torch.bfloat16 or not torch.equal(dx, dx_f) \
            or not torch.equal(dW, dW_f.to(torch.bfloat16)):
        fail(f"bf16 table {name}: ce_bwd is not the f32 kernel's dx and rounded dW")
    if not (torch.equal(rank, rank_f) and torch.equal(cnt, cnt_f)):
        fail(f"bf16 table {name}: ce_rank's ranks or rank's counts differ from the f32 "
             "kernels'")
    keep = torch.ones(n, dtype=torch.bool, device=device)
    keep[:2] = not pad_labels
    out = {"shape": name, "N": n, "E": e, "table_rows": rows, "vocab_size": vocab_size,
           "eps": eps, "f32_kernels_bits": True,
           "lse_max_abs_err": float((fwd[0] - lse_p).abs().max()),
           "lse_max_rel_err": float(((fwd[0] - lse_p).abs() / lse_p.abs()).max()),
           "ll_max_scaled_err": float(((fwd[1] - ll_p).abs()[keep]
                                       / ll_p.abs()[keep].clamp_min(1.0)).max()),
           "dx": check_grad(f"bf16 table {name} dx", dx, dx_p),
           "dW_f32": check_grad(f"bf16 table {name} dW before its rounding", dW_f, dW_p),
           "dW_rel_frobenius": float((dW.float() - dW_p.to(torch.bfloat16).float()).norm()
                                     / dW_p.norm())}
    if pad_labels and not bool((fwd[1][:2] == -1e30).all()):
        fail(f"bf16 table {name}: a label on a padding row has the logit {fwd[1][:2]}")
    if out["lse_max_rel_err"] > 1e-4 or out["ll_max_scaled_err"] > 1e-4 \
            or out["dW_rel_frobenius"] > 1e-3 + 2.0 ** -8:
        fail(f"bf16 table {name}: {out}")
    print(f"[bf16-k1k2k3k4] {json.dumps(out)}")
    return out


def check_adafactor_bf16(name: str, rows: int, e: int, clip, device="cuda") -> dict:
    """K7a and K7b on bf16 g, v and p against the plain passes over three
    steps (scales 1e-2, 1 and 30: the clip engages on the last), each step
    from the same moment and coefficient: the coefficient within 1e-5
    relative (the clip's sum in another order, an approximate rsqrt), the
    moment and the table within one bf16 spacing (of the value, and for the
    table of its step as well), the same bits twice."""
    from transformers4rec_tpu_torch.ops import fused_adafactor as fa

    def spacing(t):
        return torch.ldexp(torch.ones_like(t, dtype=torch.float32),
                           torch.frexp(t.float().abs().clamp_min(2.0 ** -126)).exponent - 8)

    p, _ = table_and_grad(rows, e, 1.0, 40, device)
    p = p.to(torch.bfloat16)
    v = torch.zeros_like(p)
    worst = {"coef_rel": 0.0, "moment_over_spacing": 0.0, "table_over_spacing": 0.0}
    for step, scale in enumerate((1e-2, 1.0, 30.0)):
        _, g = table_and_grad(rows, e, scale, 41 + step, device)
        g = g.to(torch.bfloat16)
        decay = 1.0 - torch.full((), float(step + 1), device=device) ** -0.8
        v_k, v_p, p_k, p_p = v.clone(), v.clone(), p.clone(), p.clone()
        coef = fa.adafactor_pass_a(g, v_k, decay, 6.7e-4, clip, 1e-30)
        again = v.clone()
        coef2 = fa.adafactor_pass_a(g, again, decay, 6.7e-4, clip, 1e-30)
        coef_p = fa.adafactor_pass_a_plain(g, v_p, decay, 6.7e-4, clip, 1e-30)
        fa.adafactor_pass_b(p_k, g, v_p, coef_p)
        p2 = p.clone()
        fa.adafactor_pass_b(p2, g, v_p, coef_p)
        fa.adafactor_pass_b_plain(p_p, g, v_p, coef_p)
        sync(device)
        if not (torch.equal(v_k, again) and torch.equal(coef, coef2) and torch.equal(p_k, p2)):
            fail(f"adafactor bf16 {name}: a second call gave other bits at step {step}")
        if v_k.dtype != torch.bfloat16 or p_k.dtype != torch.bfloat16:
            fail(f"adafactor bf16 {name}: {v_k.dtype}, {p_k.dtype}")
        worst["coef_rel"] = max(worst["coef_rel"], float((coef - coef_p).abs() / coef_p.abs()))
        worst["moment_over_spacing"] = max(worst["moment_over_spacing"], float(
            ((v_k.float() - v_p.float()).abs() / spacing(v_p)).max()))
        allowed = spacing(p_p) + spacing(p_p.float() - p.float())
        worst["table_over_spacing"] = max(worst["table_over_spacing"], float(
            ((p_k.float() - p_p.float()).abs() / allowed).max()))
        worst.setdefault("moment_max_abs_err", 0.0)
        worst["moment_max_abs_err"] = max(worst["moment_max_abs_err"],
                                          float((v_k.float() - v_p.float()).abs().max()))
        worst["table_max_abs_err"] = max(worst.get("table_max_abs_err", 0.0),
                                         float((p_k.float() - p_p.float()).abs().max()))
        v, p = v_p, p_p
    out = {"shape": name, "rows": rows, "E": e, "clip": clip, "steps": 3, **worst}
    print(f"[k7-bf16] {json.dumps(out)}")
    if worst["coef_rel"] > 1e-5 or worst["moment_over_spacing"] > 1.0 \
            or worst["table_over_spacing"] > 1.0:
        fail(f"adafactor bf16 {name}: {out}")
    return out


def check_bf16_kernels(table_rows: int, vocab_size: int, large_rows: int,
                       large_vocab: int) -> dict:
    """Every kernel's bf16 form against its plain version (and K1–K4 against
    the f32 kernels) at the phase's shapes and at edge shapes: a label on a
    padding row, ``vocab_size`` 0, a ragged V, E = 64, 132 (off 8: K3's ring
    copies the vocab's last 8 bytes itself), 192 and 448. Returns each
    kernel's largest error, as the ``kernels`` line takes it."""
    from transformers4rec_tpu_torch.ops import vocab

    ce = [check_bf16_ce("train", 915, table_rows, vocab_size, 0.0, 64, 11, pad_labels=True),
          check_bf16_ce("edge", 1000, 100_008, 100_003, 0.1, 64, 12, minus_one=True),
          check_bf16_ce("e132-odd-tail", 300, 10_008, 10_001, 0.0, 132, 13, pad_labels=True),
          check_bf16_ce("e192", 1000, 100_008, 100_003, 0.1, 192, 14),
          check_bf16_ce("e448", 915, table_rows, vocab_size, 0.0, 448, 15, pad_labels=True)]
    x, W, _, _ = ce_train_inputs(70, 512, 500, 16, False, "cuda", 64, torch.bfloat16)
    minus_one = torch.full((70,), -1, dtype=torch.int32, device="cuda")
    zeros = torch.zeros(70, device="cuda")
    lse, ll, _ = vocab.ce_fwd(x, W, minus_one, 0)
    lse3, rank, _ = vocab.ce_rank(x, W, minus_one, zeros, 0)
    dx, dW = vocab.ce_bwd(x, W, minus_one, zeros, torch.full((70,), 1 / 70, device="cuda"), 0)
    if not (bool((lse == -1e30).all()) and bool((lse3 == -1e30).all()) and not ll.any()
            and not rank.any() and not dx.any() and not dW.any() and dW.dtype == W.dtype
            and not vocab.rank_counts(x, W, zeros, minus_one, 0).any()):
        fail("bf16 table: vocab_size 0")
    k3 = [check_ce_rank("bf16-eval", EVAL_ROWS, table_rows, vocab_size, False, 4.0, 12.0,
                        [101, 102], table_dtype=torch.bfloat16),
          check_ce_rank("bf16-edge", 1000, 100_008, 100_003, True, 0.0, 12.0, [103],
                        table_dtype=torch.bfloat16),
          check_ce_rank("bf16-e448", EVAL_ROWS, 100_008, 100_003, True, 0.0, 12.0, [104],
                        e=448, table_dtype=torch.bfloat16),
          check_ce_rank("bf16-large-vocab", EVAL_ROWS, large_rows, large_vocab, False, 4.0,
                        12.0, [105], min_exact=0.9, table_dtype=torch.bfloat16)]
    k4 = [check_rank("bf16-eval", EVAL_ROWS, table_rows, vocab_size, None, 4.0, 12.0, [106],
                     table_dtype=torch.bfloat16),
          check_rank("bf16-edge", 1000, 100_008, 100_003, 60_003, 0.0, 12.0, [107],
                     table_dtype=torch.bfloat16),
          check_rank("bf16-e448", 1000, 100_008, 100_003, 60_003, 0.0, 12.0, [108], e=448,
                     table_dtype=torch.bfloat16)]
    k7 = [check_adafactor_bf16("item table", table_rows, 64, 1.0),
          check_adafactor_bf16("edge", 2051, 13, 1.0),
          check_adafactor_bf16("edge, no clip", 2051, 13, None)]
    torch.cuda.empty_cache()
    return {"ce_fwd": max(c["lse_max_abs_err"] for c in ce),
            "ce_bwd": max(c[g]["max_abs_err"] for c in ce for g in ("dx", "dW_f32")),
            "ce_rank": max(c["lse_max_abs_err"] for c in k3),
            "rank": max(c["count_max_diff"] for c in k4),
            "adafactor_a": max(c["moment_max_abs_err"] for c in k7),
            "adafactor_b": max(c["table_max_abs_err"] for c in k7)}


def bf16_spacing(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |t| (8 significant bits)."""
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32),
                       torch.frexp(t.float().abs().clamp_min(2.0 ** -126)).exponent - 8)


def update_check(what: str, got: dict, want: dict, before: dict, tables) -> dict:
    """The card's update of each tensor against the CPU's on the same
    gradients: a dense weight's movement within ``X_MOVE_REL`` in relative
    Frobenius norm, a bf16 table's values (``tables``) within one bf16
    spacing of the CPU's and one of their step, with the share of them that
    are equal."""
    out = {}
    for n in got:
        if n in tables:
            diff = (got[n] - want[n]).abs()
            allowed = bf16_spacing(want[n]) + bf16_spacing(want[n] - before[n])
            res = {"equal_share": float((diff == 0).float().mean()),
                   "over_allowed": float((diff / allowed).max())}
            ok = res["over_allowed"] <= 1.0
        else:
            d_got = got[n].double() - before[n].double()
            d_want = want[n].double() - before[n].double()
            res = {"rel": float((d_got - d_want).norm() / d_want.norm().clamp_min(1e-300))}
            ok = res["rel"] <= X_MOVE_REL
        out[n] = res
        if not ok:
            fail(f"{what}: {n} stepped apart from the CPU's: {res}")
    return out


def bf16_pair_step(flagship, weights: dict, batch: dict, counters: dict) -> dict:
    """One optimizer step of the bf16-table flagship (AdamW on the dense
    weights, Adafactor with a bf16 moment on the bf16 tables) from the same
    weights on the card and on the CPU, one mask drawn on the CPU for both,
    dropout off, held as the ``X_GRAD_REL`` note says: the gradients of the
    two devices, then the CPU's update from the card's gradients against the
    card's update."""
    from transformers4rec_tpu_torch.trainer import table_param_names

    info = None
    res = {}
    for dev in X_PAIR_DEVICES:
        tr = flagship.build_trainer(dev, seed=0, embedding_table_dtype="bf16", dropout=0.0,
                                    output_dir=tempfile.gettempdir())
        tr.model.load_state_dict({k: v.to(dev) for k, v in weights.items()})
        if info is None:
            info = mlm_info(tr.model, {k: np.asarray(v) for k, v in batch.items()}, 9)
        tr.create_optimizer_and_scheduler(1)
        params = dict(tr.model.named_parameters())
        tables = table_param_names(tr.model)
        b = tr.model._as_dense(batch)
        if dev == X_PAIR_DEVICES[0]:  # the card: the trainer's own step
            loss, got, _ = counted(
                counters, lambda: tr._train_step(b, masking_info=info_on(info, dev)), device=dev)
            expect_launches("the bf16 flagship's step on the card", got, ce_fwd=1, ce_bwd=1)
            grads = {n: p.grad.detach().cpu() for n, p in params.items()}
            card_grads = grads
        else:  # the CPU: its own gradients, then its optimizers on the card's
            tr.model.zero_grad(set_to_none=True)
            loss, _ = tr.model(b, targets=b, training=True, masking_info=info_on(info, dev))
            loss.backward()
            grads = {n: p.grad.detach().clone() for n, p in params.items()}
            for n, p in params.items():
                p.grad = card_grads[n].to(p.dtype)
            # as ``Trainer._train_step`` closes an update (the flagship clips nothing)
            lr = tr._schedule(tr._opt_step)
            for group in tr.optimizers["dense"].param_groups:
                group["lr"] = lr
            for opt in tr.optimizers.values():
                opt.step()
            got = {}
        state = tr.optimizers["table"].state
        res[dev] = {"loss": float(loss.detach()), "launches": got, "grads": grads,
                    "after": {n: p.detach().float().cpu() for n, p in params.items()},
                    "moments": {n: state[params[n]]["v"].float().cpu() for n in tables},
                    "dtypes": {str(state[params[n]]["v"].dtype) for n in tables}
                    | {str(params[n].dtype) for n in tables}}
        del tr
    g, c = (res[d] for d in X_PAIR_DEVICES)
    rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    if not math.isfinite(g["loss"]) or rel > 1e-4:
        fail(f"bf16 flagship step: loss {g['loss']} on the card, {c['loss']} on the CPU")
    if g["dtypes"] != {"torch.bfloat16"} or c["dtypes"] != {"torch.bfloat16"}:
        fail(f"bf16 flagship step: tables and moments {g['dtypes']} {c['dtypes']}")
    tables = set(c["moments"])
    grads_rel = {n: float((w.float() - c["grads"][n].float()).norm()
                          / c["grads"][n].float().norm().clamp_min(1e-30))
                 for n, w in g["grads"].items() if not n.endswith(X_NOISE_ONLY)}
    worst = max((n for n in grads_rel if n not in tables), key=grads_rel.get)
    for n, limit in [(worst, X_GRAD_REL)] + [(n, X_TABLE_GRAD_REL) for n in tables]:
        if grads_rel[n] > limit:
            fail(f"bf16 flagship step: the gradient of {n} differs by {grads_rel[n]:.3g}: "
                 f"{json.dumps(grads_rel)}")
    before = {n: v.float().cpu() for n, v in weights.items() if n in c["after"]}
    moments = {n: float(((g["moments"][n] - m).abs() / bf16_spacing(m)).max())
               for n, m in c["moments"].items()}
    out = {"loss": {"cuda": g["loss"], "cpu": c["loss"]}, "loss_rel_diff": rel,
           "launches": g["launches"],
           "grads_rel": {k: grads_rel[k] for k in sorted(grads_rel) if k in tables}
           | {"worst": [worst, grads_rel[worst]]},
           "update": update_check("bf16 flagship step", g["after"], c["after"], before, tables),
           "moments_over_spacing": moments}
    if max(moments.values()) > 1.0:
        fail(f"bf16 flagship step: moments {moments}")
    print(f"[bf16-flagship] one step, card against CPU: "
          f"{json.dumps({k: v for k, v in out.items() if k != 'launches'})}")
    return out


def run_bf16_tables(flagship, vocab, fa, card: str) -> dict:
    """Main path X: the tables stored as bf16 (``embedding_table_dtype=
    "bf16"``) at full width, each part counted from 0, after every kernel's
    bf16 form is held against its plain version (``check_bf16_kernels``).

    X1 the flagship (REES46 XLNet-MLM, 390,000 items, tied E = 64):
    ``build_trainer`` with f32 and with bf16 tables in turns, a warm group,
    ``X1_TIMED`` timed steps and a profiled window each (wall, device time,
    busy share, peak memory, reported side by side); then on the bf16
    trainer ``Model.evaluate`` (K3 on the bf16 table) against the CPU, one
    optimizer step against the CPU (``bf16_pair_step``), a save and a load
    into a trainer made without the field (tables bf16 and the same bits),
    an export and 8 served requests. X2 the streamed update on the bf16
    table (K7a/K7b bf16), X3 the paper's tied E = 448 (the wide kernels on
    bf16 images) with one evaluation batch against the CPU, X4
    configuration 4's ``sparse_adam`` arm at 4,000,001 items with one
    evaluation batch (K3 at V = 4,000,001) against the CPU, X5 the
    vocab-parallel head on a bf16 shard (K1, K2, K4)."""
    from transformers4rec_tpu_torch.data import synthetic_data
    from transformers4rec_tpu_torch.trainer import cast_tables_

    t_phase = time.perf_counter()
    counters = bf16_counters(vocab, fa)
    vocab_size = flagship.NUM_ITEMS + 1
    large_vocab = flagship.LARGE_VOCAB_ITEMS + 1
    errors = check_bf16_kernels(-(-vocab_size // 8) * 8, vocab_size, -(-large_vocab // 8) * 8,
                                large_vocab)
    launches = dict.fromkeys(counters, 0)  # the bf16 forms'
    f32_launches = dict.fromkeys(counters, 0)
    rows, seq = flagship.BATCH, flagship.SEQ
    bf16 = {torch.bfloat16}
    out = {}

    def add(got, into=launches):
        for k, n in got.items():
            into[k] += n

    # ---- X1: the flagship, f32 and bf16 tables side by side
    data = synthetic_data(flagship.schema(), num_rows=16 * rows, max_session_length=seq,
                          seed=700)
    side = {}
    for dtype in ("f32", "bf16"):
        gc.collect()  # earlier phases' garbage goes first: the peak is this arm's
        held = torch.cuda.memory_allocated()  # what is held before this arm's trainer
        trainer = flagship.build_trainer("cuda", seed=0, train_dataset=data,
                                         embedding_table_dtype=None if dtype == "f32" else dtype)
        if table_dtypes(trainer.model) != ({torch.float32} if dtype == "f32" else bf16):
            fail(f"X1 ({dtype}): tables {table_dtypes(trainer.model)}")
        weights_gb = (torch.cuda.memory_allocated() - held) / 1e9  # the model, before a step
        torch.cuda.reset_peak_memory_stats()
        into = f32_launches if dtype == "f32" else launches
        phases = trainer_phases(trainer, counters, into, f"bf16-tables X1 {dtype}", card, rows,
                                seq, (("warm", X_STEPS, None), ("timed", X1_TIMED, None)),
                                per_step={"ce_fwd": 1, "ce_bwd": 1})
        (window, prof), got, _ = counted(counters, lambda: traced_window(trainer, X_STEPS,
                                                                         rows=12))
        expect_launches(f"X1 {dtype} (profiled window)", got, ce_fwd=2 * X_STEPS,
                        ce_bwd=2 * X_STEPS)
        add(got, into)
        side[dtype] = {"ms_per_step": phases["timed"]["ms_per_step"],
                       "mean_loss": phases["timed"]["mean_loss"], "window": window,
                       "peak_memory_gb": (torch.cuda.max_memory_allocated() - held) / 1e9,
                       "weights_gb": weights_gb}
        print(prof)
        if dtype == "f32":
            del trainer
            gc.collect()  # the trainer's reference cycles: its memory goes before bf16's run
            torch.cuda.empty_cache()
    out["side_by_side"] = side
    print(f"[bf16-tables] X1 on {card}: the flagship's steady step with f32 against bf16 "
          f"tables: {side['f32']['ms_per_step']:.3f} against {side['bf16']['ms_per_step']:.3f} "
          f"ms of wall time, {side['f32']['window']['device_ms_per_step']:.3f} against "
          f"{side['bf16']['window']['device_ms_per_step']:.3f} ms of device time (busy "
          f"{side['f32']['window']['device_busy_share']:.3f} against "
          f"{side['bf16']['window']['device_busy_share']:.3f}), peak memory "
          f"{side['f32']['peak_memory_gb']:.3f} against {side['bf16']['peak_memory_gb']:.3f} GB "
          f"(the weights {side['f32']['weights_gb']:.3f} against "
          f"{side['bf16']['weights_gb']:.3f} GB)")
    table = trainer.model.heads[0].input_module.item_embedding_table()
    if table_dtypes(trainer.model) != bf16 or not bool(torch.isfinite(table.float()).all()):
        fail("X1: after training the tables are not bf16 and finite")

    # Model.evaluate on the bf16 table (K3), card against CPU
    loader = eval_batches(flagship, flagship.NUM_ITEMS, seq, X_EVAL_BATCHES, EVAL_ROWS)
    model = trainer.model
    gpu_res, got, wall = counted(counters, lambda: model.evaluate(loader))
    expect_launches("X1 evaluate", got, ce_rank=X_EVAL_BATCHES)
    add(got)
    cpu_model = flagship.build_model("cpu", seed=0, dropout=0.0)
    cast_tables_(cpu_model, torch.bfloat16)
    weights = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
    cpu_model.load_state_dict(weights)
    check_evaluate(gpu_res, cpu_model.evaluate(loader), X_EVAL_BATCHES * EVAL_ROWS)
    out["evaluate"] = {"cuda": gpu_res, "wall_s": wall}
    del cpu_model

    # one optimizer step, card against CPU
    out["pair_step"] = bf16_pair_step(flagship, weights, loader[0], counters)
    add(out["pair_step"].pop("launches"))

    # a save, and a load into a trainer made without the field
    with tempfile.TemporaryDirectory() as path:
        trainer.save(path)
        fresh = flagship.build_trainer("cuda", seed=1, output_dir=path)
        if table_dtypes(fresh.model) != {torch.float32}:
            fail("X1: a trainer made without the field holds bf16 tables")
        fresh.load(path)
        same = all(torch.equal(p.detach(), model.state_dict()[n])
                   for n, p in fresh.model.named_parameters())
        if table_dtypes(fresh.model) != bf16 or not same:
            fail(f"X1: the reloaded tables are {table_dtypes(fresh.model)}, same bits {same}")
        del fresh

    # export and serve (the runner and the server load the bf16 tables as bf16)
    from transformers4rec_tpu_torch.serving import InferenceRunner, export_model

    requests = serve_requests(flagship, flagship.NUM_ITEMS, seq, 8)
    with tempfile.TemporaryDirectory() as path:
        export_model(model, loader[0], path, top_k=TOP_K)
        runner = InferenceRunner(path, flagship.build_model, device="cuda")
        if table_dtypes(runner.model) != bf16:
            fail(f"X1: the runner serves {table_dtypes(runner.model)} tables")
        with torch.inference_mode():
            want_s, want_i = model(model._as_dense({k: v[:8] for k, v in loader[0].items()}),
                                   top_k=TOP_K)
        got_s, got_i = runner.predict({k: v[:8] for k, v in loader[0].items()})
        check_topk(got_s, got_i, want_s.cpu().numpy(), want_i.cpu().numpy(), vocab_size,
                   "X1 runner top-k")
        del runner
    serve = run_serve(flagship.build_model, model, loader[0], vocab_size, requests, "cuda")
    add(serve["launches"])
    out["serve"] = serve["stats"]
    del trainer, model, table
    torch.cuda.empty_cache()

    # ---- X2: the streamed update on the bf16 table (K7a and K7b in bf16)
    trainer = flagship.build_trainer("cuda", seed=0, train_dataset=data,
                                     streamed_table_update=True, embedding_table_dtype="bf16")
    table = trainer.model.heads[0].input_module.item_embedding_table()
    before = table.detach().clone()
    out["streamed"] = trainer_phases(
        trainer, counters, launches, "bf16-tables X2", card, rows, seq,
        (("steps", X_STEPS, None),), per_step={"ce_fwd": 1, "ce_bwd": 1, "adafactor_a": 1,
                                               "adafactor_b": 1})
    moment = trainer.optimizers["table"].state[table]["v"]
    if table.dtype != torch.bfloat16 or moment.dtype != torch.bfloat16 \
            or torch.equal(table.detach(), before) \
            or not bool(torch.isfinite(moment.float()).all()):
        fail(f"X2: table {table.dtype}, moment {moment.dtype}, or nothing moved")
    del trainer, table, before, moment
    torch.cuda.empty_cache()

    # ---- X3: the paper's tied E = 448 on a bf16 table (the wide kernels)
    e = flagship.PAPER_ITEM_DIM
    trainer = flagship.build_trainer("cuda", seed=0, train_dataset=data, item_dim=e,
                                     embedding_table_dtype="bf16")
    out["wide"] = trainer_phases(trainer, counters, launches, "bf16-tables X3", card, rows, seq,
                                 (("steps", X_STEPS, None),),
                                 per_step={"ce_fwd": 1, "ce_bwd": 1})
    model = trainer.model
    gpu_res, got, _ = counted(counters, lambda: model.evaluate(loader[:1]))
    expect_launches("X3 evaluate", got, ce_rank=1)
    add(got)
    cpu_model = flagship.build_model("cpu", seed=0, dropout=0.0, item_dim=e)
    cast_tables_(cpu_model, torch.bfloat16)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    check_evaluate(gpu_res, cpu_model.evaluate(loader[:1]), EVAL_ROWS)
    out["wide"]["evaluate"] = gpu_res
    del trainer, model, cpu_model
    torch.cuda.empty_cache()

    # ---- X4: configuration 4's sparse_adam arm on a 4,000,001-item bf16 table
    items = flagship.LARGE_VOCAB_ITEMS
    large_data = synthetic_data(flagship.schema(items, seq), num_rows=X_STEPS * rows,
                                max_session_length=seq, seed=701)
    trainer = flagship.build_large_vocab_trainer("cuda", seed=0, train_dataset=large_data,
                                                 embedding_optimizer="sparse_adam",
                                                 embedding_table_dtype="bf16")
    table = trainer.model.heads[0].input_module.item_embedding_table()
    before = table.detach().clone()
    out["sparse"] = trainer_phases(trainer, counters, launches, "bf16-tables X4", card, rows,
                                   seq, (("steps", X_STEPS, None),), per_step={})
    state = trainer._sparse.state
    if table.dtype != torch.bfloat16 or state.mu.dtype != torch.bfloat16 \
            or table.grad is not None or torch.equal(table.detach(), before):
        fail(f"X4: table {table.dtype}, moments {state.mu.dtype}, or nothing moved")
    model = trainer.model
    large_loader = eval_batches(flagship, items, seq, 1, EVAL_ROWS)
    gpu_res, got, _ = counted(counters, lambda: model.evaluate(large_loader))
    expect_launches("X4 evaluate", got, ce_rank=1)
    add(got)
    del trainer, before, state
    torch.cuda.empty_cache()
    cpu_model = flagship.build_large_vocab_model("cpu", dropout=0.0)
    cast_tables_(cpu_model, torch.bfloat16)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    check_evaluate(gpu_res, cpu_model.evaluate(large_loader), EVAL_ROWS)
    out["sparse"]["evaluate"] = gpu_res
    del model, cpu_model, table
    torch.cuda.empty_cache()

    # ---- X5: the vocab-parallel head over a one-rank group on a bf16 shard
    model = flagship.build_model("cuda", seed=0, dropout=0.0)
    cast_tables_(model, torch.bfloat16)
    gpu_res, got, _ = counted(counters, lambda: model.evaluate(loader))
    add(got)
    parallel = run_vocab_parallel(flagship, vocab, model, loader, gpu_res, vocab_size,
                                  table_dtype=torch.bfloat16)
    add(parallel["launches"])
    out["vocab_parallel"] = {k: parallel[k] for k in ("losses", "item_table_grad")}
    del model
    torch.cuda.empty_cache()

    if any(n < 1 for n in launches.values()):
        fail(f"phase X: a kernel's bf16 form was never launched: {launches}")
    out["launches"], out["f32_launches"], out["errors"] = launches, f32_launches, errors
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[bf16-tables] on {card}: launches of the bf16 forms {json.dumps(launches)}; "
          f"phase X {out['phase_s']:.1f}s")
    return out


def bound(nbytes: int, flops: int, exps: int = 0, f32_flops: int = 0) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their units' peak rates (the bf16
    products on the tensor cores, the exponentials and reciprocal roots on
    the special-function units, float32 arithmetic on the CUDA cores; the
    three run side by side)."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    tensor_ms, exp_ms = flops / BF16_FLOPS * 1e3, exps / SFU_OPS_PER_S * 1e3
    f32_ms = f32_flops / F32_FLOPS * 1e3
    ops_ms = max(tensor_ms, exp_ms, f32_ms)
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops, "exps": exps, "f32_flops": f32_flops,
            "bytes_ms": bytes_ms, "tensor_ms": tensor_ms, "exp_ms": exp_ms, "f32_ms": f32_ms}


def time_ce_train(vocab, n: int, rows: int, vocab_size: int, chunk_rows: int = 0,
                  e: int = 64, table_dtype=torch.float32) -> dict:
    """K1 and K2 at a training shape beside their plain versions and a
    library yardstick that materialises the logits (bf16 products through
    torch.matmul; never used by the port). Without ``chunk_rows`` the
    yardstick is one set of calls on the whole (N, V) logits, ``library_ms``.
    With it (at 8,192 rows the logits would take 12.8 GB) the same calls run
    on ``chunk_rows`` rows at a time, dW summed over the chunks in f32, and
    the time goes under ``library_chunked_ms``: no single call fits at that
    size, so ``library_ms`` is None. ``table_dtype`` bf16 times the kernels'
    forms for a bf16-stored table (its bytes, and dW's, count 2 a value)."""
    x, W, labels, w = ce_train_inputs(n, rows, vocab_size, 1, False, "cuda", e, table_dtype)
    E, wb = x.shape[1], W.element_size()
    coef = (w / w.sum()).contiguous()
    lse, _, _ = vocab.ce_fwd(x, W, labels, vocab_size)
    xb16 = x.to(torch.bfloat16)
    Wb16 = W[:vocab_size].to(torch.bfloat16)  # cast once, outside the timed calls
    idx = labels.long()[:, None]

    def library_fwd(rows_=slice(None)):
        logits = torch.matmul(xb16[rows_], Wb16.T).float()
        return torch.logsumexp(logits, -1), logits.gather(1, idx[rows_])

    def library_bwd(rows_=slice(None)):
        r = torch.softmax(torch.matmul(xb16[rows_], Wb16.T).float(), -1)
        r.scatter_add_(1, idx[rows_], torch.full_like(coef[rows_], -1.0)[:, None])
        r = (r * coef[rows_, None]).to(torch.bfloat16)
        return torch.matmul(r, Wb16), torch.matmul(r.T, xb16[rows_])

    step = chunk_rows or n
    chunks = [slice(r0, min(r0 + step, n)) for r0 in range(0, n, step)]

    def chunked_fwd():
        return [library_fwd(c) for c in chunks]

    def chunked_bwd():
        dW = torch.zeros((vocab_size, E), dtype=torch.float32, device="cuda")
        dx = []
        for c in chunks:
            dx_c, dW_c = library_bwd(c)
            dx.append(dx_c)
            dW += dW_c
        return torch.cat(dx), dW

    def yardstick(whole, chunked) -> dict:
        if chunk_rows:
            return {"library_ms": None, "library_chunked_ms": cuda_ms(chunked, reps=5),
                    "library_chunk_rows": chunk_rows}
        return {"library_ms": cuda_ms(whole, reps=10)}

    fwd = {
        "ms": cuda_ms(lambda: vocab.ce_fwd(x, W, labels, vocab_size)),
        "plain_ms": cuda_ms(lambda: vocab.ce_fwd_plain(x, W, labels, vocab_size, False), reps=10),
        **yardstick(library_fwd, chunked_fwd),
        # read x, the used rows of W and the labels once, write lse and ll once
        **bound(4 * (n * E + n) + wb * vocab_size * E + 4 * 2 * n, 2 * n * E * vocab_size,
                n * vocab_size),
    }
    bwd = {
        "ms": cuda_ms(lambda: vocab.ce_bwd(x, W, labels, lse, coef, vocab_size)),
        "plain_ms": cuda_ms(lambda: vocab.ce_bwd_plain(x, W, labels, lse, coef, vocab_size),
                            reps=10),
        **yardstick(library_bwd, chunked_bwd),
        # read x, the used rows of W, labels, lse and coef once; write dx and
        # the whole of dW (in W's type) once; three products and one set of
        # exponentials
        **bound(4 * (n * E + 3 * n) + wb * vocab_size * E + 4 * n * E + wb * rows * E,
                3 * 2 * n * E * vocab_size, n * vocab_size),
    }
    # K2's wide passes form the residual once for every 128 columns of E
    bwd["recompute"] = vocab.ce_plan(n, E, vocab_size, rows, 1, True).e_splits
    for r in (fwd, bwd):
        r["N"], r["E"], r["table_dtype"] = n, E, str(W.dtype)[6:]
    return {"ce_fwd": fwd, "ce_bwd": bwd}


def time_ce_rank(vocab, n: int, rows: int, vocab_size: int, e: int = 64,
                 chunk_rows: int = 0, table_dtype=torch.float32) -> dict:
    """K3 beside its plain version and a library yardstick that materialises
    the (N, V) logits; with the launch plan's ring (``stages`` slots of
    ``slot_rows`` rows a block, ``blocks_per_sm``; none past E = 256, where
    the wide kernel runs) and splits. With ``chunk_rows`` the yardstick runs
    on that many rows at a time (``library_chunked_ms``; ``library_ms`` is
    None), as ``time_ce_train``'s; ``table_dtype`` as there."""
    x, W, labels = ce_rank_inputs(n, rows, vocab_size, e, 4.0, 12.0, 1, "cuda", table_dtype)
    ll = vocab.label_logits(x, W, labels)
    xb16 = x.to(torch.bfloat16)
    Wb16 = W[:vocab_size].to(torch.bfloat16)  # cast once, outside the timed call

    def library(rows_=slice(None)):
        logits = torch.matmul(xb16[rows_], Wb16.T).float()  # materialises (N, V)
        return torch.logsumexp(logits, -1), (logits > ll[rows_, None]).sum(-1)

    ms = cuda_ms(lambda: vocab.ce_rank(x, W, labels, ll, vocab_size))
    plain_ms = cuda_ms(lambda: vocab.ce_rank_plain(x, W, labels, ll, vocab_size, False),
                       reps=10 if chunk_rows else 30)
    if chunk_rows:
        chunks = [slice(r0, min(r0 + chunk_rows, n)) for r0 in range(0, n, chunk_rows)]
        yardstick = {"library_ms": None, "library_chunk_rows": chunk_rows,
                     "library_chunked_ms": cuda_ms(lambda: [library(c) for c in chunks],
                                                   reps=5)}
    else:
        yardstick = {"library_ms": cuda_ms(library)}
    E, wb, bf16 = x.shape[1], W.element_size(), W.dtype == torch.bfloat16
    # least work: read x, the vocab_size used rows of W, labels and ll once,
    # write lse and rank once; 2·N·E·V operations of the product and N·V
    # exponentials
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = vocab.ce_plan(n, E, vocab_size, rows, sms, False, vocab.K3_CHUNK, streamed=True,
                         table_bf16=bf16)
    return {
        "ms": ms, "plain_ms": plain_ms, **yardstick, "N": n, "E": E,
        "table_dtype": str(W.dtype)[6:], "stages": plan.stages or None,
        "slot_rows": None if plan.wide else vocab.k3_slot(E, bf16)[0],
        "blocks_per_sm": None if plan.wide else plan.blocks_per_sm, "splits": plan.splits,
        **bound(4 * (n * E + 2 * n) + wb * vocab_size * E + 4 * 2 * n, 2 * n * E * vocab_size,
                n * vocab_size),
    }


def time_rank(vocab, n: int, rows: int, vocab_size: int, e: int = 64,
              table_dtype=torch.float32) -> dict:
    """K4 at the evaluation shape beside its plain version and the library
    yardstick: a bf16 ``torch.matmul`` that materialises the (N, V) logits,
    then a ``>`` count; ``table_dtype`` as ``time_ce_train``'s."""
    x, W, labels = ce_rank_inputs(n, rows, vocab_size, e, 4.0, 12.0, 1, "cuda", table_dtype)
    ll = vocab.label_logits(x, W, labels)
    xb16 = x.to(torch.bfloat16)
    Wb16 = W[:vocab_size].to(torch.bfloat16)  # cast once, outside the timed call
    E, wb = x.shape[1], W.element_size()

    def library():
        return (torch.matmul(xb16, Wb16.T).float() > ll[:, None]).sum(-1)

    return {
        "ms": cuda_ms(lambda: vocab.rank_counts(x, W, ll, labels, vocab_size)),
        "plain_ms": cuda_ms(lambda: vocab.rank_counts_plain(x, W, ll, labels, vocab_size)),
        "library_ms": cuda_ms(library), "N": n, "E": E, "table_dtype": str(W.dtype)[6:],
        # read x, the vocab_size used rows of W, labels and ll once, write the
        # counts once; 2·N·E·V operations of the product
        **bound(4 * (n * E + 2 * n) + wb * vocab_size * E + 4 * n, 2 * n * E * vocab_size),
    }


def time_adafactor(rows: int, e: int, table_dtype=torch.float32) -> dict:
    """K7a and K7b at the item table's shape beside their plain versions, and
    a whole ``FusedAdafactor.step`` of that table on each arm (the streamed
    kernels; the plain chain with an f32 and with a bf16 moment). No single
    PyTorch call computes a pass, so there is no library yardstick. The
    table (100 MB) is twice the L2 cache, so every call reads device memory.
    ``table_dtype`` bf16 times the forms for a bf16-stored table (g, v and p
    bf16; the arms the streamed one and the plain chain, each moment bf16)."""
    from transformers4rec_tpu_torch.ops import fused_adafactor as fa

    p, g = table_and_grad(rows, e, 1.0, 60, "cuda")
    v = torch.rand_like(p) + 0.1
    p, g, v = p.to(table_dtype), g.to(table_dtype), v.to(table_dtype)
    decay = torch.full((), 0.4, device="cuda")
    coef = torch.full((1,), -1e-9, device="cuda")  # p barely moves over the timed calls
    n, eb = p.numel(), p.element_size()
    out = {
        "adafactor_a": {
            "ms": cuda_ms(lambda: fa.adafactor_pass_a(g, v, decay, 6.7e-4, 1.0, 1e-30)),
            "plain_ms": cuda_ms(lambda: fa.adafactor_pass_a_plain(g, v, decay, 6.7e-4, 1.0,
                                                                  1e-30), reps=10),
            "library_ms": None,
            # read g and v, write v in place; about 10 float32 operations and
            # one reciprocal root an element
            **bound(3 * eb * n, 0, n, 10 * n),
        },
        "adafactor_b": {
            "ms": cuda_ms(lambda: fa.adafactor_pass_b(p, g, v, coef)),
            "plain_ms": cuda_ms(lambda: fa.adafactor_pass_b_plain(p, g, v, coef), reps=10),
            "library_ms": None,
            # read g, v and p, write p in place
            **bound(4 * eb * n, 0, n, 4 * n),
        },
    }
    for r in (out["adafactor_a"], out["adafactor_b"]):
        r["shape"], r["table_dtype"] = [rows, e], str(table_dtype)[6:]
    if not (torch.isfinite(v).all() and torch.isfinite(p).all()):
        fail("time_adafactor: non-finite values after the timed calls")
    steps = {}
    arms = ((("streamed_f32", {"use_pallas": True}), ("plain_f32", {}),
             ("plain_bf16", {"moment_dtype": torch.bfloat16}))
            if table_dtype == torch.float32 else
            (("streamed_bf16", {"use_pallas": True}),
             ("plain_bf16", {"moment_dtype": torch.bfloat16})))
    for arm, kwargs in arms:
        param = torch.nn.Parameter(p.clone())
        param.grad = g
        opt = fa.FusedAdafactor([param], lr=6.7e-4, **kwargs)
        steps[arm] = cuda_ms(opt.step, reps=10)
        del opt, param
    out["table_optimizer_step_ms"] = steps
    return out


def profile_train(card: str, out_file: str = "", streamed: bool = False,
                  scheme: str = "mlm") -> None:
    """Where a training step's time goes: the first step alone, a steady
    window by the host's clock, and the same window under ``torch.profiler``
    (device time by kernel; busy share = device time over wall time). With
    ``streamed`` the tables take the streamed update with an f32 moment;
    ``scheme="clm"`` trains GPT-2-CLM on batches of 32 sessions of up to 256
    instead of the flagship, ``scheme="plm"`` XLNet-PLM on the same batches
    (main path P2)."""
    from transformers4rec_tpu_torch import flagship
    from transformers4rec_tpu_torch.data import synthetic_data
    from transformers4rec_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.build()  # so that the first step below does not wait for nvcc
    print(f"[profile] kernels built in {time.perf_counter() - t0:.1f}s")
    long = scheme in ("clm", "plm")
    rows = flagship.LONG_BATCH if long else flagship.BATCH
    seq = flagship.LONG_SEQ if long else flagship.SEQ
    data = synthetic_data(flagship.schema(flagship.NUM_ITEMS, seq), num_rows=8 * rows,
                          max_session_length=seq, seed=200)
    t0 = time.perf_counter()
    trainer = flagship.build_trainer("cuda", seed=0, train_dataset=data,
                                     streamed_table_update=streamed, scheme=scheme, seq=seq,
                                     batch=rows)
    sync("cuda")
    print(f"[profile] build_trainer(streamed_table_update={streamed}, scheme={scheme!r}) "
          f"{time.perf_counter() - t0:.3f}s")
    profile_steps(trainer, {"card": card, "scheme": scheme, "batch": rows, "seq": seq,
                            "streamed_table_update": streamed}, out_file)


def profile_paper_arch(card: str, arch: str, out_file: str = "") -> None:
    """``profile_steps`` for the trainer of phase S's command line for
    ``arch`` (``albert``: S1, ALBERT-MLM; ``transfoxl``: S2, TransfoXL-CLM;
    ``electra``: S3), built by the experiment script
    (``transf_exp_main.setup``) at the paper's width and trained from
    window 1's ``train.parquet`` of synthetic REES46 sessions."""
    from transformers4rec_tpu_torch.ops import build
    from transformers4rec_tpu_torch.paper_repro import datasets_configs, transf_exp_main

    lines = {a: line for line, (a, *_) in PAPER_ARCH_LINES.items()}
    if arch not in lines:
        fail(f"--profile-train-arch takes one of {sorted(lines)}, not {arch!r}")
    out_file = os.path.abspath(out_file) if out_file else ""  # the run changes directory
    build.build()  # so that the first step below does not wait for nvcc
    schema = datasets_configs.make_schema("rees46")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        schema_path = os.path.join(root, "schema.pbtxt")
        schema.to_proto_text_file(schema_path)
        data = os.path.join(root, "data")
        paper_windows(schema, data, seed=401)
        argv = paper_arch_argv(lines[arch], data, schema_path)
        os.chdir(root)
        try:
            args, _, trainer = transf_exp_main.setup(argv)
            trainer.train_dataset = [os.path.join(data, "0001", "train.parquet")]
            profile_steps(trainer, {"card": card, "arch": arch, "line": lines[arch],
                                    "masking": args.masking,
                                    "batch": args.per_device_train_batch_size,
                                    "seq": args.session_seq_length_max}, out_file)
        finally:
            os.chdir(cwd)


def timed_train(trainer, steps: int) -> float:
    """Seconds of ``steps`` steps of ``trainer.train()``, the card synchronised
    before and after."""
    trainer.args.max_steps = steps
    sync("cuda")
    t0 = time.perf_counter()
    trainer.train()
    sync("cuda")
    return time.perf_counter() - t0


def traced_window(trainer, window: int, rows: int = 40) -> tuple:
    """A steady window of ``window`` steps by the host's clock, then the same
    window under ``torch.profiler``: ``(summary, table)``, the table the
    device time by kernel and the summary the busy share (device time over
    untraced wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    plain_s = timed_train(trainer, window)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_s = timed_train(trainer, window)
    # the device's own events (kernels, copies, fills): the rows of the table
    # also list each operator with the time of the kernels it launched
    device_us = sum(e.device_time_total for e in prof.events()
                    if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=rows,
                                      max_name_column_width=70)
    return {"steps": window, "ms_per_step": plain_s / window * 1e3,
            "ms_per_step_traced": traced_s / window * 1e3,
            "device_ms_per_step": device_us / window / 1e3,
            # against the untraced wall time: tracing slows the host, not the device
            "device_busy_share": device_us / 1e6 / plain_s}, table


def profile_steps(trainer, summary: dict, out_file: str = "", window: int = 16) -> None:
    """The first step alone, a steady window by the host's clock, and the
    same window under ``torch.profiler``: device time by kernel and the busy
    share (device time over untraced wall time), printed with ``summary``
    and written to ``out_file`` when one is named."""
    first, second = timed_train(trainer, 1), timed_train(trainer, 1)
    print(f"[profile] first step {first:.3f}s, second step {second:.3f}s, "
          f"next 8 steps {timed_train(trainer, 8) / 8 * 1e3:.3f} ms/step")
    window_summary, table = traced_window(trainer, window)
    summary = {**summary, **window_summary}
    print(table)
    print(f"[profile] {json.dumps(summary)}")
    if out_file:
        os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
        with open(out_file, "w") as f:
            f.write(json.dumps(summary) + "\n" + table + "\n")


def time_ce_kernels(card: str) -> None:
    """K3 alone at the evaluation shape (128 rows against the REES46 table)
    at E = 64, 128 and 256 (the narrow kernel's widths), then K1 and K2 at
    the three training shapes (915, 8,192 and 16,384 loss rows), each held
    against its plain version (``check_ce_rank``, ``check_ce_train``) and
    timed (``time_ce_rank``, ``time_ce_train``) as the smoke run does: the
    quick loop for work on these kernels."""
    from transformers4rec_tpu_torch import flagship
    from transformers4rec_tpu_torch.ops import build, vocab

    build.build(["ce_rank", "ce_fwd", "ce_bwd"])
    vocab_size = flagship.NUM_ITEMS + 1
    rows = -(-vocab_size // 8) * 8
    for e in (64, 128, 256):
        check_ce_rank(f"eval-{e}", EVAL_ROWS, rows, vocab_size, False, 4.0, 12.0, [1], e=e)
        timing = time_ce_rank(vocab, EVAL_ROWS, rows, vocab_size, e=e)
        x, W, labels = ce_rank_inputs(EVAL_ROWS, rows, vocab_size, e, 4.0, 12.0, 1, "cuda")
        ll = vocab.label_logits(x, W, labels)
        timing["kernel_us"] = kernel_us(lambda: vocab.ce_rank(x, W, labels, ll, vocab_size))
        print(f"[time-ce] ce_rank on {card}: {json.dumps(timing)}", flush=True)
        del x, W
        torch.cuda.empty_cache()
    for name, n, seed in (("train", 915, 11),
                          ("clm", flagship.LONG_BATCH * flagship.LONG_SEQ, 13),
                          ("long_step", LONG_STEP_BATCH * LONG_STEP_SEQ, 14)):
        check_ce_train(name, n, rows, vocab_size, 0.0, None, False, seed)
        timing = time_ce_train(vocab, n, rows, vocab_size, chunk_rows=1024 if n > 915 else 0)
        print(f"[time-ce] on {card}: {json.dumps(timing)}", flush=True)
        torch.cuda.empty_cache()


def time_bf16_kernels(card: str) -> None:
    """``--time-bf16``: each vocab kernel and K7a/K7b in its form for a
    bf16-stored table beside its f32 form at the shapes of the kernel table
    in PERF.md, the two forms in turns in one call: K1 and K2 at 915, 8,192
    and 16,384 rows and at E = 448 with 915 and 8,192; K3 at 128 rows (E =
    64 and 448), at every position's 2,560 and 8,192 rows, at packed
    evaluation's 1,280 and 4,096 and at 4,000,001 items; K4 at 128 rows (E
    = 64 and 448); K7a and K7b at the item table's shape. One line a
    measurement (``[bf16-timing]``), then one JSON object of them all."""
    from transformers4rec_tpu_torch import flagship
    from transformers4rec_tpu_torch.ops import build, vocab

    build.build(["ce_fwd", "ce_bwd", "ce_rank", "rank", "adafactor"])
    vocab_size = flagship.NUM_ITEMS + 1
    rows = -(-vocab_size // 8) * 8
    large = flagship.LARGE_VOCAB_ITEMS + 1
    e = flagship.PAPER_ITEM_DIM
    plan = [
        ("ce_train", 915, {}), ("ce_train", 8192, {"chunk_rows": 1024}),
        ("ce_train", 16384, {"chunk_rows": 1024}), ("ce_train", 915, {"e": e}),
        ("ce_train", 8192, {"chunk_rows": 1024, "e": e}),
        ("ce_rank", EVAL_ROWS, {}), ("ce_rank", EVAL_ROWS, {"e": e}),
        ("ce_rank", PLM_EVAL_ROWS, {}), ("ce_rank", PLM_LONG_EVAL_ROWS, {"chunk_rows": 1024}),
        ("ce_rank", PACKED_EVAL_ROWS, {}), ("ce_rank", PACKED_LONG_EVAL_ROWS, {}),
        ("ce_rank_large", EVAL_ROWS, {}), ("rank", EVAL_ROWS, {}), ("rank", EVAL_ROWS, {"e": e}),
        ("adafactor", rows, {})]
    results = []
    for what, n, kw in plan:
        for dtype in (torch.float32, torch.bfloat16):
            if what == "ce_train":
                got = time_ce_train(vocab, n, rows, vocab_size, table_dtype=dtype, **kw)
            elif what == "ce_rank":
                got = {"ce_rank": time_ce_rank(vocab, n, rows, vocab_size, table_dtype=dtype,
                                               **kw)}
            elif what == "ce_rank_large":
                got = {"ce_rank": {**time_ce_rank(vocab, n, -(-large // 8) * 8, large,
                                                  table_dtype=dtype), "V": large}}
            elif what == "rank":
                got = {"rank": time_rank(vocab, n, rows, vocab_size, table_dtype=dtype, **kw)}
            else:
                got = time_adafactor(n, 64, table_dtype=dtype)
            for name, t in got.items():
                line = {"kernel": name, "table_dtype": str(dtype)[6:], **{
                    k: t[k] for k in TIMING_KEYS + ("N", "E", "V", "shape", "stages",
                                                     "library_chunked_ms") if k in t}} \
                    if name != "table_optimizer_step_ms" else {
                        "kernel": "FusedAdafactor.step", "table_dtype": str(dtype)[6:],
                        "ms": t}
                print(f"[bf16-timing] on {card}: {json.dumps(line)}")
                results.append(line)
            torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"bf16_timing": results}))


def time_flash_kernels(card: str) -> None:
    """K5, K6a, K6b and K6c alone at the CLM path's shape (32, 256, 16, 12) with
    ragged padding, at the S = 4,096 step's (4, 4096, 16, 12) with ragged
    padding and at (4, 2048, 8, Dh) for Dh = 64 and, where the two
    designs meet, at (32, 256, 16, Dh) for Dh = 32 and 48 and at
    (4, 2048, 8, Dh) for Dh = 32, 48 and 128, all causal: each held against its plain
    version (``check_flash``) and timed in both designs beside
    ``scaled_dot_product_attention`` (``time_flash``): the quick loop for
    work on them, and the times that ``ops/attention.py:uses_wgmma`` and
    ``uses_split_stream`` keep."""
    from transformers4rec_tpu_torch.ops import build

    build.build(["flash_fwd", "flash_bwd"])
    for name, dims, ragged, seed in (("main", (32, 256, 16, 12), True, 21),
                                     ("long_step", (LONG_STEP_BATCH, LONG_STEP_SEQ, 16, 12),
                                      True, 24),
                                     ("long", (4, 2048, 8, 64), False, 23),
                                     ("main_dh32", (32, 256, 16, 32), True, 28),
                                     ("main_dh48", (32, 256, 16, 48), True, 29),
                                     ("long_dh32", (4, 2048, 8, 32), False, 25),
                                     ("long_dh48", (4, 2048, 8, 48), False, 26),
                                     ("long_dh128", (4, 2048, 8, 128), False, 27)):
        check_flash(name, *dims, True, seed, ragged=ragged)
        timing = time_flash(name, *dims, True, ragged, 30)
        keep = ("ms", "bound_ms", "library_ms", "design", "designs_ms", "split_route_ms")
        torch.cuda.empty_cache()
        print(f"[time-flash] {name} {dims} on {card}: "
              f"{json.dumps({k: {f: v[f] for f in keep if f in v} for k, v in timing.items()})}",
              flush=True)


def time_long_step(card: str, steady: int = 32) -> None:
    """The steady S = 4,096 step (``run_long_step``, ``steady`` steps a
    reading) with K6b forced into each of its designs in turns (streamed,
    mma.sync, mma.sync, streamed, streamed, mma.sync), then a
    ``torch.profiler`` window of 12 steady steps on the designs the wrappers
    pick: device time by kernel and the device's busy share."""
    from transformers4rec_tpu_torch import flagship
    from transformers4rec_tpu_torch.ops import attention, build, vocab

    build.build()
    launch = attention._flash_bwd_dq_cuda
    ms = {"streamed": [], "mma.sync": []}
    try:
        for design in ("streamed", "mma.sync", "mma.sync", "streamed", "streamed", "mma.sync"):
            attention._flash_bwd_dq_cuda = functools.partial(launch,
                                                             streamed=design == "streamed")
            ms[design].append(run_long_step(flagship, vocab, attention, card,
                                            steady)["steady"]["ms_per_step"])
            torch.cuda.empty_cache()
    finally:
        attention._flash_bwd_dq_cuda = launch
    print(f"[time-long-step] ms per steady step by K6b's design on {card}: {json.dumps(ms)}")

    steps = 4
    trainer, _ = long_step_trainer(flagship)
    trainer.args.max_steps = steps
    trainer.train()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        trainer.train()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / (3 * steps)
    per_step = {k: v / steps / 1e3 for k, v in kernel_us(trainer.train, reps=3).items()}
    device_ms = sum(per_step.values())
    top = sorted(per_step.items(), key=lambda kv: -kv[1])[:16]
    print(f"[time-long-step] profile on {card}: " + json.dumps({
        "wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / wall_ms, "top_kernels_ms": top}))


def time_parquet(card: str, calls: int = 8, steps: int = 16) -> None:
    """The flagship's training step from Parquet against the same rows held
    in memory (phase Q's two arms), ``calls`` ``train()`` calls of
    ``steps`` steps each, in turns (Parquet, memory, memory, Parquet, ...)
    after one warm-up call per arm; then the host time of what the Parquet
    arm adds or changes: the file's decode in each call, the loader's yield
    per batch and the batch's copy to the card (``Model._as_dense``, whose
    float64 columns are narrowed on the host), and a ``torch.profiler``
    window of each arm: device time per step and the device's busy share."""
    from transformers4rec_tpu_torch import flagship
    from transformers4rec_tpu_torch.data import ParquetDataLoader
    from transformers4rec_tpu_torch.ops import build

    build.build(["ce_fwd", "ce_bwd"])
    with tempfile.TemporaryDirectory() as root:
        windows, _ = parquet_windows(flagship, os.path.join(root, "windows"))
        train_file = os.path.join(windows, "1", "train.parquet")
        arms = {"parquet": train_file, "in_memory": dense_columns(flagship, train_file)}
        trainers = {}
        for name, dataset in arms.items():
            t = flagship.build_trainer("cuda", seed=0, train_dataset=dataset,
                                       output_dir=os.path.join(root, name))
            t.args.max_steps, t.args.logging_steps = steps, steps
            t.train()
            trainers[name] = t
        ms = {name: [] for name in arms}
        for name in ("parquet", "in_memory", "in_memory", "parquet") * (calls // 2):
            _, _, wall = counted({}, trainers[name].train)
            ms[name].append(1e3 * wall / steps)
        print(f"[time-parquet] ms per step (wall, {steps} steps a train() call) in turns on "
              f"{card}: {json.dumps(ms)}; medians {json.dumps({k: float(np.median(v)) for k, v in ms.items()})}")

        schema = flagship.schema()
        decode = []
        for _ in range(5):
            t0 = time.perf_counter()
            loader = ParquetDataLoader.from_schema(schema, train_file, batch_size=flagship.BATCH)
            decode.append(1e3 * (time.perf_counter() - t0))
        model = trainers["parquet"].model
        pieces = {"decode_ms_per_call": float(np.median(decode)),
                  "yield_ms_per_batch": loader_ms(lambda: ParquetDataLoader.from_schema(
                      schema, train_file, batch_size=flagship.BATCH))}
        for name, dataset in (("parquet", train_file), ("in_memory", arms["in_memory"])):
            batch = next(iter(trainers[name]._make_loader(dataset, flagship.BATCH, shuffle=True,
                                                          is_train=True)))
            copies = []
            for _ in range(20):
                sync("cuda")
                t0 = time.perf_counter()
                model._as_dense(batch, flagship.SEQ, non_blocking=True)
                sync("cuda")
                copies.append(1e3 * (time.perf_counter() - t0))
            pieces[f"copy_ms_per_batch_{name}"] = float(np.median(copies))
            pieces[f"dtypes_{name}"] = sorted({str(v.dtype) for v in batch.values()})
        print(f"[time-parquet] host pieces on {card}: {json.dumps(pieces)}")

        for name, t in trainers.items():
            _, _, wall = counted({}, t.train)
            per_call = kernel_us(t.train, reps=2)
            device_ms = sum(per_call.values()) / 1e3 / steps
            wall_ms = 1e3 * wall / steps
            top = sorted(((k, v / 1e3 / steps) for k, v in per_call.items()),
                         key=lambda kv: -kv[1])[:8]
            print(f"[time-parquet] profile of the {name} arm on {card}: " + json.dumps({
                "wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
                "device_busy_share": device_ms / wall_ms, "top_kernels_ms": top}))


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs an NVIDIA GPU")
    import_port()
    if sys.argv[1:] == ["--time-ce"]:
        time_ce_kernels(card_line())
        return
    if sys.argv[1:] == ["--time-bf16"]:
        time_bf16_kernels(card_line())
        return
    if sys.argv[1:] == ["--time-flash"]:
        time_flash_kernels(card_line())
        return
    if sys.argv[1:] == ["--time-long-step"]:
        time_long_step(card_line())
        return
    if sys.argv[1:] == ["--time-parquet"]:
        time_parquet(card_line())
        return
    profiles = {"--profile-train": "mlm", "--profile-train-streamed": "mlm",
                "--profile-train-clm": "clm", "--profile-train-plm": "plm"}
    if sys.argv[1:2] and sys.argv[1] in profiles and len(sys.argv) <= 3:
        profile_train(card_line(), *sys.argv[2:3],
                      streamed=sys.argv[1] == "--profile-train-streamed",
                      scheme=profiles[sys.argv[1]])
        return
    if sys.argv[1:2] == ["--profile-train-arch"] and len(sys.argv) in (3, 4):
        profile_paper_arch(card_line(), *sys.argv[2:4])
        return
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}")
    from transformers4rec_tpu_torch import flagship
    from transformers4rec_tpu_torch.ops import attention, build, vocab
    from transformers4rec_tpu_torch.ops import fused_adafactor as fa

    card = card_line()
    print(f"[card] {card}")
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = build.build(ptxas_verbose=True)  # registers, shared memory and spills per kernel
    for name, log in logs.items():
        print(f"[build] {name}:\n{log.strip()}")
    print(f"[build] {len(logs)} source(s) compiled in {time.perf_counter() - t0:.1f}s")

    vocab_size = flagship.NUM_ITEMS + 1  # item ids 1..NUM_ITEMS, 0 pads
    table_rows = -(-vocab_size // 8) * 8
    checks = [
        # the evaluation shape, once for each of the main path's batches
        check_ce_rank("eval", EVAL_ROWS, table_rows, vocab_size, False, 4.0, 12.0,
                      range(1, EVAL_BATCHES + 1)),
        # N and V off every tile size, label smoothing on
        check_ce_rank("edge", 1000, 100_008, 100_003, True, 0.0, 12.0, [EVAL_BATCHES + 1]),
        # every-position evaluation: XLNet-PLM's 128 x 20 rows (P1) and its
        # 32 x 256 (P2)
        check_ce_rank("every_position", PLM_EVAL_ROWS, table_rows, vocab_size, False, 4.0,
                      12.0, [90]),
        check_ce_rank("every_position_long", PLM_LONG_EVAL_ROWS, table_rows, vocab_size, False,
                      4.0, 12.0, [91]),
        # packed evaluation's rows: 128 packed rows of 20 (U1) and 32 of 256
        # (U2), at most S // 2 targets a row
        check_ce_rank("packed_eval", PACKED_EVAL_ROWS, table_rows, vocab_size, False, 4.0,
                      12.0, [92]),
        check_ce_rank("packed_eval_long", PACKED_LONG_EVAL_ROWS, table_rows, vocab_size, False,
                      4.0, 12.0, [93]),
    ]
    # the training shape: the flagship's loss-row budget of its 128 x 20 positions
    train_rows = flagship.build_model("cpu", num_items=50, d_model=16, n_layer=1, n_head=2,
                                      seq=4).heads[0].tasks[0]._budget_rows(
                                          flagship.BATCH * flagship.SEQ)
    if train_rows != 915:
        fail(f"the flagship's loss-row budget is {train_rows}, expected 915")
    train_checks = [
        check_ce_train("train", train_rows, table_rows, vocab_size, 0.0, None, False, 11),
        # N and V off every tile size, label smoothing with an explicit eps/V,
        # some labels of -1
        check_ce_train("edge", 1000, 100_008, 100_003, 0.1, 0.05 / 100_003, True, 12),
    ]
    # labels on padding rows, inside and beyond the vocab's last chunk of 64
    check_padding_row_labels(300, 100_072, 100_003, 0.1)
    check_padding_row_labels(train_rows, table_rows, vocab_size, 0.0)
    rank_checks = [
        check_rank("eval", EVAL_ROWS, table_rows, vocab_size, None, 4.0, 12.0,
                   range(1, EVAL_BATCHES + 1)),
        # N off every tile size, a shard's bound far below its rows, labels of -1
        check_rank("edge", 1000, 100_008, 100_003, 60_003, 0.0, 12.0, [EVAL_BATCHES + 1]),
    ]
    adafactor_checks = [
        check_adafactor("item table", table_rows, 64, 1.0),
        # a size off every vector width (numel mod 4 = 3), the clip on and off
        check_adafactor("edge", 2051, 13, 1.0),
        check_adafactor("edge, no clip", 2051, 13, None),
    ]
    torch.cuda.empty_cache()
    check_two_shards(train_rows, table_rows, vocab_size, 0.1)
    # CLM has no loss-row budget: every position of 32 sessions of 256 is a row
    clm_rows = flagship.LONG_BATCH * flagship.LONG_SEQ
    train_checks.append(check_ce_train("clm", clm_rows, table_rows, vocab_size, 0.0, None,
                                       False, 13))
    torch.cuda.empty_cache()
    # the step at S = 4,096: 4 sessions, every position a row
    long_rows = LONG_STEP_BATCH * LONG_STEP_SEQ
    train_checks.append(check_ce_train("long_step", long_rows, table_rows, vocab_size, 0.0, None,
                                       False, 14))
    torch.cuda.empty_cache()
    wide_checks = check_wide_tables()
    train_checks += wide_checks["ce"]
    checks += wide_checks["ce_rank"]
    rank_checks += wide_checks["rank"]
    torch.cuda.empty_cache()
    head_dim = flagship.D_MODEL // flagship.N_HEAD
    # main and long_step are the shapes of main paths 6 and 7; long is a shape
    # that the tensor cores bound, on no main path
    flash_shapes = {"main": (flagship.LONG_BATCH, flagship.LONG_SEQ, flagship.N_HEAD, head_dim),
                    "long_step": (LONG_STEP_BATCH, LONG_STEP_SEQ, flagship.N_HEAD, head_dim),
                    "long": (4, 2048, 8, 64)}
    flash_checks = [
        check_flash("main", *flash_shapes["main"], True, 21, ragged=True),
        # S off every tile, a bias broadcast over the batch, one session
        # wholly padded, non-causal
        check_flash("edge", 3, 333, 4, 32, False, 22, ragged=True, wholly_padded=1,
                    bias_shape=(1, 4, 333, 333)),
        check_flash("long", *flash_shapes["long"], True, 23),
        # the one shape at which a main path launches K6b and K6c: 64 tiles a
        # side, the head dim padded from 12 to 16
        check_flash("long_step", *flash_shapes["long_step"], True, 24, ragged=True),
        # the query stream's bias of XLNet-PLM on sessions of 256 (P2): the
        # perm mask and the relative bias over batch and head, not causal
        check_flash("plm", *flash_shapes["main"], False, 25, ragged=True, plm=True),
        # phase S4's attention: Longformer's local window of 8 as a (1, 1, S,
        # S) bias, not causal (K5 and K6a), and TransfoXL's relative bias
        # over the heads, causal (K5; its backward is the dense one)
        check_flash("longformer", *flash_shapes["main"], False, 26, ragged=True,
                    window=PAPER_WINDOW),
        check_flash("transfoxl", *flash_shapes["main"], True, 27, ragged=True,
                    bias_shape=(1, flagship.N_HEAD, flagship.LONG_SEQ, flagship.LONG_SEQ)),
        # phase U2's attention: rows of 256 packed from sessions of 2 to 20,
        # the (B, 1, S, S) block-diagonal bias, causal (K5 and K6a)
        check_flash("segments", *flash_shapes["main"], True, 28, segments=True),
    ]
    torch.cuda.empty_cache()
    flash = flash_counters(vocab, attention)
    for name in ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"):
        flash[name].launches = 0

    # ---- main path 1: evaluate at full width, on the card and on the CPU
    # dropout 0: it plays no part in evaluation or serving, and the training
    # step below compares the card with the CPU without it
    model = flagship.build_model("cuda", seed=0, dropout=0.0)
    loader = eval_batches(flagship, flagship.NUM_ITEMS, flagship.SEQ, EVAL_BATCHES, EVAL_ROWS)
    gpu_res, eval_launches, eval_s = run_evaluate(model, loader, vocab)
    print(f"[evaluate] cuda {eval_s:.3f}s launches {eval_launches} {json.dumps(gpu_res)}")
    if eval_launches["ce_rank"] != EVAL_BATCHES:
        fail(f"evaluate launched ce_rank {eval_launches['ce_rank']} times, "
             f"expected {EVAL_BATCHES}")
    cpu_model = flagship.build_model("cpu", seed=0, dropout=0.0)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_res, _, cpu_s = run_evaluate(cpu_model, loader, vocab)
    print(f"[evaluate] cpu reference {cpu_s:.3f}s {json.dumps(cpu_res)}")
    check_evaluate(gpu_res, cpu_res, EVAL_BATCHES * EVAL_ROWS)

    # ---- main path 2: serve ragged sessions over HTTP
    requests = serve_requests(flagship, flagship.NUM_ITEMS, flagship.SEQ, 8)
    serve = run_serve(flagship.build_model, model, loader[0], vocab_size, requests, "cuda")
    print(f"[serve] {json.dumps(serve)}")

    # ---- one training step, the card against the CPU
    step = check_training_step(model, cpu_model, loader[0])
    print(f"[train-step] {json.dumps(step)}")
    del cpu_model

    # ---- main path 3: the vocab-parallel head over a process group on the card
    parallel = run_vocab_parallel(flagship, vocab, model, loader, gpu_res, vocab_size)
    print(f"[vocab-parallel] {json.dumps({k: parallel[k] for k in ('losses', 'item_table_grad', 'launches')})}")
    del model
    torch.cuda.empty_cache()

    # ---- main path 4: train at full width
    summary = ("launches", "global_step", "table_max_move", "moment_nonzero_share")
    train = run_train(flagship, vocab, card)
    print(f"[train] {json.dumps({k: train[k] for k in summary})}")

    # ---- main path 5: train with the streamed table update
    streamed = run_train(flagship, vocab, card, streamed=True)
    print(f"[train-streamed] {json.dumps({k: streamed[k] for k in summary})}")
    check_streamed_step(flagship)
    torch.cuda.empty_cache()

    # ---- main path Q: the README's entry path from Parquet files
    parquet = run_parquet_path(flagship, vocab, card)

    # ---- main path 5b: XLNet-MLM at the paper's tied width, E = 448
    wide = run_wide_flagship(flagship, vocab, card)
    # sessions of 20 (21 at inference) stay on the dense attention path
    stray = {name: flash[name].launches
             for name in ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")}
    if any(stray.values()):
        fail(f"the XLNet-MLM paths at S = {flagship.SEQ} launched flash kernels: {stray}")

    # ---- main path R: the paper's command line through the port's experiment script
    paper = run_paper_command(vocab, attention, card)

    # ---- main path S: the BERT family, ELECTRA-RTD and TransfoXL
    archs = run_paper_archs(flagship, vocab, attention, card)

    # ---- main path T: the JAX benchmark's configurations 4 and 5
    large = run_large_vocab(flagship, vocab, attention, card)
    checks.append(large["k3_check"])
    multi = run_multitask(flagship, vocab, attention, card)
    torch.cuda.empty_cache()

    # ---- main path W: configuration 4's sparse_adam arm, gradient accumulation
    sparse = run_sparse_large_vocab(flagship, vocab, attention, card)
    accumulation = run_accumulation(flagship, vocab, attention, card)
    w1, t1 = sparse["profile"], large["profile"]
    print(f"[sparse-large-vocab] against T1's adafactor arm on {card}: a steady step "
          f"{sparse['train']['steady']['ms_per_step']:.3f} ms of wall time against "
          f"{large['train']['steady']['ms_per_step']:.3f}; the profiled windows "
          f"{w1['ms_per_step']:.3f} against {t1['ms_per_step']:.3f} ms, device "
          f"{w1['device_ms_per_step']:.3f} against {t1['device_ms_per_step']:.3f} ms, busy "
          f"{w1['device_busy_share']:.3f} against {t1['device_busy_share']:.3f}; peak memory "
          f"{sparse['peak_memory_gb']:.2f} against {large['peak_memory_gb']:.2f} GB")

    # ---- main path X: the tables stored as bf16 (every path's kernels on bf16 tables)
    bf16_tables = run_bf16_tables(flagship, vocab, fa, card)

    # ---- main path U: session packing (XLNet-MLM from Parquet, GPT-2-CLM on rows of 256)
    packing = run_packing(flagship, vocab, attention, card)

    # ---- main path V: Reformer (the script, and on sessions of 256) and a GRU body
    reformer_rnn = run_reformer_rnn(flagship, vocab, attention, card)

    # ---- main path P1: XLNet-PLM at full width, two streams, every position
    plm = run_plm(flagship, vocab, attention, card, vocab_size)
    print(f"[plm] {json.dumps(plm['launches'])}")

    # ---- main path 6: GPT-2-CLM on sessions of up to 256
    clm = run_clm(flagship, vocab, attention, card, vocab_size)
    print(f"[clm] {json.dumps(clm['launches'])}")
    torch.cuda.empty_cache()

    # ---- main path P2: XLNet-PLM on sessions of up to 256
    plm_long = run_plm_long(flagship, vocab, attention, card)
    print(f"[plm-long] {json.dumps(plm_long['launches'])}")

    # ---- main path 7: one training step at S = 4,096
    long_step = run_long_step(flagship, vocab, attention, card)
    torch.cuda.empty_cache()

    # ---- timing at the evaluation, the training and the table's shape
    timing = {"ce_rank": time_ce_rank(vocab, EVAL_ROWS, table_rows, vocab_size),
              **time_ce_train(vocab, train_rows, table_rows, vocab_size),
              "rank": time_rank(vocab, EVAL_ROWS, table_rows, vocab_size),
              **time_adafactor(table_rows, 64)}
    optimizer_ms = timing.pop("table_optimizer_step_ms")
    torch.cuda.empty_cache()
    # the bf16 forms at the shapes at which phase X launches them: K1, K2 and
    # K3 at E = 64 (X1) and 448 (X3), K3 at 4,000,001 items (X4), K4 (X5),
    # K7a and K7b (X2)
    bf16, wide_e = torch.bfloat16, flagship.PAPER_ITEM_DIM
    large_vocab = flagship.LARGE_VOCAB_ITEMS + 1
    bf16_timing = {"ce_rank": time_ce_rank(vocab, EVAL_ROWS, table_rows, vocab_size,
                                           table_dtype=bf16),
                   **time_ce_train(vocab, train_rows, table_rows, vocab_size, table_dtype=bf16),
                   "rank": time_rank(vocab, EVAL_ROWS, table_rows, vocab_size, table_dtype=bf16),
                   **time_adafactor(table_rows, 64, table_dtype=bf16)}
    bf16_optimizer_ms = bf16_timing.pop("table_optimizer_step_ms")
    bf16_wide = time_ce_train(vocab, train_rows, table_rows, vocab_size, e=wide_e,
                              table_dtype=bf16)
    bf16_also = {"ce_fwd": [bf16_wide["ce_fwd"]], "ce_bwd": [bf16_wide["ce_bwd"]],
                 "ce_rank": [time_ce_rank(vocab, EVAL_ROWS, table_rows, vocab_size, e=wide_e,
                                          table_dtype=bf16),
                             {**time_ce_rank(vocab, EVAL_ROWS, -(-large_vocab // 8) * 8,
                                             large_vocab, table_dtype=bf16), "V": large_vocab}]}
    print(f"[timing] the bf16 forms on {card}: {json.dumps(bf16_timing)}; at E={wide_e} and "
          f"V={large_vocab}: {json.dumps(bf16_also)}; one FusedAdafactor.step of the bf16 item "
          f"table {json.dumps(bf16_optimizer_ms)} ms")
    torch.cuda.empty_cache()
    clm_timing = time_ce_train(vocab, clm_rows, table_rows, vocab_size, chunk_rows=1024)
    long_timing = time_ce_train(vocab, long_rows, table_rows, vocab_size, chunk_rows=1024)
    torch.cuda.empty_cache()
    # the wide kernels at the paper's E = 448: training at the flagship's 915
    # loss rows and at 8,192, evaluation at 128 rows
    wide_timing = {
        "train": time_ce_train(vocab, train_rows, table_rows, vocab_size, e=wide_e),
        "clm": time_ce_train(vocab, clm_rows, table_rows, vocab_size, chunk_rows=1024, e=wide_e),
        "ce_rank": time_ce_rank(vocab, EVAL_ROWS, table_rows, vocab_size, e=wide_e),
        "rank": time_rank(vocab, EVAL_ROWS, table_rows, vocab_size, e=wide_e)}
    print(f"[timing] the wide kernels at E={wide_e}, V={vocab_size} on {card}: "
          f"{json.dumps(wide_timing)}; recompute is how often K2 forms each residual")
    print(f"[timing] ce_fwd and ce_bwd at N={clm_rows} and N={long_rows}, E=64, V={vocab_size} "
          f"on {card}: {json.dumps([clm_timing, long_timing])}; library_chunked_ms is the "
          "N=915 yardstick run on 1,024 rows at a time (the whole logits would not fit)")
    torch.cuda.empty_cache()
    flash_timing = {shape: time_flash(shape, *dims, True, shape != "long",
                                      30 if shape == "main" else 10)
                    for shape, dims in flash_shapes.items()}
    print(f"[timing] flash attention, causal, at main = {flash_shapes['main']} and long_step = "
          f"{flash_shapes['long_step']} with ragged padding and long = {flash_shapes['long']} "
          f"(B, S, H, Dh) on {card}: "
          f"{json.dumps(flash_timing)}; library_ms is F.scaled_dot_product_attention on "
          "bf16 inputs with the same mask (forward; its backward for dq, dk, dv; for dq "
          "alone; for dk and dv alone)")
    # every-position evaluation (P1, P2) and K5 with XLNet-PLM's bias (P2)
    plm_timing = {
        "ce_rank": time_ce_rank(vocab, PLM_EVAL_ROWS, table_rows, vocab_size),
        "ce_rank_long": time_ce_rank(vocab, PLM_LONG_EVAL_ROWS, table_rows, vocab_size,
                                     chunk_rows=1024),
        "flash_fwd": time_flash_plm("plm", *flash_shapes["main"], 30)}
    plm_timing["ce_rank"]["launches"] = plm["k3_launches_at_every_position"]
    plm_timing["ce_rank_long"]["launches"] = plm_long["launches"]["ce_rank"]
    plm_timing["flash_fwd"]["launches"] = plm_long["launches"]["flash_fwd"]
    # K5 and K6a with Longformer's local-window bias (S4)
    window_timing = time_flash_bias("longformer", *flash_shapes["main"], 30, window=PAPER_WINDOW)
    s4 = archs["S4"]["longformer"]["launches"]
    for name in window_timing:
        # phase S4's Longformer and phase V2's local layers: one shape
        window_timing[name]["launches"] = s4[name] + reformer_rnn["launches"][name]
    # K5 and K6a with packed rows' block-diagonal bias (U2) and K3 at packed
    # evaluation's rows (U1, U2)
    packed_timing = time_flash_bias("segments", *flash_shapes["main"], 30, causal=True,
                                    segments=True)
    for name in packed_timing:
        packed_timing[name]["launches"] = packing["launches"][name]
    packed_timing["ce_rank"] = time_ce_rank(vocab, PACKED_EVAL_ROWS, table_rows, vocab_size)
    packed_timing["ce_rank_long"] = time_ce_rank(vocab, PACKED_LONG_EVAL_ROWS, table_rows,
                                                 vocab_size)
    print(f"[timing] packed rows on {card}: K5 and K6a with the (B, 1, S, S) block-diagonal "
          f"bias, causal, at {flash_shapes['main']}; ce_rank at N={PACKED_EVAL_ROWS} and "
          f"N={PACKED_LONG_EVAL_ROWS}, E=64, V={vocab_size}: {json.dumps(packed_timing)}; "
          "library_ms is F.scaled_dot_product_attention with the same bias, padding and "
          "causal mask as a bf16 additive mask (forward; its backward), and "
          "torch.matmul(bf16) with logsumexp + count for ce_rank")
    print(f"[timing] K5 and K6a with Longformer's (1, 1, S, S) local-window bias at "
          f"{flash_shapes['main']} on {card}: {json.dumps(window_timing)}; library_ms is "
          "F.scaled_dot_product_attention with the same bias and padding as a bf16 additive "
          "mask (forward; its backward)")
    print(f"[timing] every-position evaluation and XLNet-PLM's attention on {card}: ce_rank at "
          f"N={PLM_EVAL_ROWS} and N={PLM_LONG_EVAL_ROWS}, E=64, V={vocab_size}; flash_fwd at "
          f"{flash_shapes['main']} with the query stream's (B, H, S, S) bias: "
          f"{json.dumps(plm_timing)}; the flash library_ms is F.scaled_dot_product_attention "
          "with the same bias as a bf16 additive mask")
    print(f"[share] on {card}: an XLNet-PLM training step takes "
          f"{plm['one_batch_repeated']['ms_per_step']:.3f} ms of wall time at batch 128 of 20 "
          f"and {plm_long['eight_batches']['ms_per_step']:.3f} ms at batch 32 of up to 256; "
          f"4 evaluation batches take {plm['last_item']['wall_s']:.3f} s on the last item and "
          f"{plm['every_position']['wall_s']:.3f} s on every position")
    # each kernel's entry at the shape its main path gives it: K5 and K6a run
    # three times a CLM step at the main shape, K6b and K6c only in the step
    # at S = 4,096
    timing.update({name: flash_timing["main" if name in ("flash_fwd", "flash_bwd_fused")
                                      else "long_step"][name] for name in flash_timing["main"]})
    # the kernel at other shapes: those at which a main path launches it
    # ("main_path": true) and those that no main path gives it (false): K1
    # and K2 at E = 448 with 8,192 rows, K4 at E = 448, K5 and K6a at
    # (4, 2048, 8, 64), K6b and K6c at the CLM path's shape
    def on(t, main_path):
        return {**t, "main_path": main_path}

    also = {"ce_fwd": [on(clm_timing["ce_fwd"], True), on(long_timing["ce_fwd"], True),
                       on(wide_timing["train"]["ce_fwd"], True),
                       on(wide_timing["clm"]["ce_fwd"], False)],
            "ce_bwd": [on(clm_timing["ce_bwd"], True), on(long_timing["ce_bwd"], True),
                       on(wide_timing["train"]["ce_bwd"], True),
                       on(wide_timing["clm"]["ce_bwd"], False)],
            "ce_rank": [on(wide_timing["ce_rank"], True), on(plm_timing["ce_rank"], True),
                        on(plm_timing["ce_rank_long"], True),
                        on(packed_timing["ce_rank"], True),
                        on(packed_timing["ce_rank_long"], True),
                        on({**large["k3_timing"], "V": large["table_rows"],
                            "launches": large["launches"]["ce_rank"]
                            + sparse["launches"]["ce_rank"]}, True)],
            "rank": [on(wide_timing["rank"], False)],
            "flash_fwd": [on(flash_timing["long_step"]["flash_fwd"], True),
                          on(flash_timing["long"]["flash_fwd"], False),
                          on(plm_timing["flash_fwd"], True),
                          on(window_timing["flash_fwd"], True),
                          on(packed_timing["flash_fwd"], True)],
            "flash_bwd_fused": [on(flash_timing["long"]["flash_bwd_fused"], False),
                                on(window_timing["flash_bwd_fused"], True),
                                on(packed_timing["flash_bwd_fused"], True)],
            "flash_bwd_dq": [on(flash_timing["main"]["flash_bwd_dq"], False)],
            "flash_bwd_dkv": [on(flash_timing["main"]["flash_bwd_dkv"], False)]}
    clm_step_ms = clm["one_batch_repeated"]["ms_per_step"]
    attn_ms = flagship.N_LAYER * (flash_timing["main"]["flash_fwd"]["ms"]
                                  + flash_timing["main"]["flash_bwd_fused"]["ms"])
    print(f"[share] on {card}: a GPT-2-CLM training step (32 sessions of up to 256) takes "
          f"{clm_step_ms:.3f} ms of wall time, of which ce_fwd + ce_bwd take "
          f"{clm_timing['ce_fwd']['ms'] + clm_timing['ce_bwd']['ms']:.3f} ms and "
          f"{flagship.N_LAYER} x (flash_fwd + flash_bwd_fused) {attn_ms:.3f} ms on the device")
    print(f"[timing] ce_rank and rank at N={EVAL_ROWS}, ce_fwd and ce_bwd at N={train_rows}, "
          f"E=64, V={vocab_size}, adafactor_a and adafactor_b at ({table_rows}, 64) on {card}: "
          f"{json.dumps(timing)}; library_ms is torch.matmul(bf16) with logsumexp + count "
          "(ce_rank), a count (rank), logsumexp + gather (ce_fwd), softmax + two more "
          "products (ce_bwd), each materialising (N, V)")
    step_ms = train["one_batch_repeated"]["ms_per_step"]
    print(f"[share] on {card}: a training step takes {step_ms:.3f} ms of wall time, of which "
          f"ce_fwd + ce_bwd take {timing['ce_fwd']['ms'] + timing['ce_bwd']['ms']:.3f} ms "
          "on the device")
    print(f"[share] on {card}: one FusedAdafactor.step of the item table alone takes "
          f"{json.dumps(optimizer_ms)} ms on the device; a training step takes "
          f"{step_ms:.3f} ms of wall time on the bf16 arm and "
          f"{streamed['one_batch_repeated']['ms_per_step']:.3f} ms on the streamed arm")

    vocab_py, adafactor_py, attention_py = ("transformers4rec_tpu/ops/vocab.py",
                                            "transformers4rec_tpu/ops/fused_adafactor.py",
                                            "transformers4rec_tpu/ops/attention.py")
    # name -> (source, file and line of the TPU kernel body)
    sources = {"ce_rank": ("ce_rank.cu", f"{vocab_py}:758"),
               "ce_fwd": ("ce_fwd.cu", f"{vocab_py}:105"),
               "ce_bwd": ("ce_bwd.cu", f"{vocab_py}:349"),
               "rank": ("rank.cu", f"{vocab_py}:639"),
               "adafactor_a": ("adafactor.cu", f"{adafactor_py}:83"),
               "adafactor_b": ("adafactor.cu", f"{adafactor_py}:103"),
               "flash_fwd": ("flash_fwd.cu", f"{attention_py}:92"),
               "flash_bwd_fused": ("flash_bwd.cu", f"{attention_py}:284"),
               "flash_bwd_dq": ("flash_bwd.cu", f"{attention_py}:158"),
               "flash_bwd_dkv": ("flash_bwd.cu", f"{attention_py}:217")}
    launches = {"ce_rank": eval_launches["ce_rank"] + serve["launches"]["ce_rank"]
                + parallel["launches"]["ce_rank"] + wide["launches"]["ce_rank"]
                + parquet["launches"]["ce_rank"] + paper["launches"]["ce_rank"]}
    for name in ("ce_fwd", "ce_bwd", "adafactor_a", "adafactor_b"):
        launches[name] = (train["launches"][name] + streamed["launches"][name]
                          + parallel["launches"].get(name, 0) + wide["launches"].get(name, 0)
                          + parquet["launches"].get(name, 0) + paper["launches"].get(name, 0)
                          + bf16_tables["f32_launches"][name])
    launches["rank"] = parallel["launches"]["rank"]
    # paths 6 and 7, P1, P2, S, T, U, V and W: every kernel of the CLM, PLM
    # and phase S to W paths
    for name in flash:
        launches[name] = (launches.get(name, 0) + clm["launches"][name]
                          + long_step["launches"][name] + plm["launches"][name]
                          + plm_long["launches"][name] + archs["launches"][name]
                          + large["launches"][name] + multi["launches"][name]
                          + packing["launches"][name] + reformer_rnn["launches"][name]
                          + sparse["launches"][name] + accumulation["launches"][name])
    errors = {"ce_rank": max(c["lse_max_abs_err"] for c in checks),
              "ce_fwd": max(c["lse_max_abs_err"] for c in train_checks),
              "ce_bwd": max(c[g]["max_abs_err"] for c in train_checks for g in ("dx", "dW")),
              "rank": max(c["count_max_diff"] for c in rank_checks),
              "adafactor_a": max(c["moment_max_abs_err"] for c in adafactor_checks),
              "adafactor_b": max(c["table_max_abs_err"] for c in adafactor_checks),
              "flash_fwd": max(c["out"]["max_abs_err"] for c in flash_checks),
              "flash_bwd_fused": max(c["fused"][g]["max_abs_err"] for c in flash_checks
                                     for g in ("dq", "dk", "dv")),
              "flash_bwd_dq": max(c["split"]["dq"]["max_abs_err"] for c in flash_checks),
              "flash_bwd_dkv": max(c["split"][g]["max_abs_err"] for c in flash_checks
                                   for g in ("dk", "dv"))}
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": f"transformers4rec_tpu_torch/csrc/{source}",
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": errors[name],
        **{k: timing[name][k] for k in TIMING_KEYS + ("N", "E", "shape", "design", "designs_ms",
                                                      "stages")
           if k in timing[name]},
        "also_at": [{k: t[k] for k in t
                     if k in TIMING_KEYS + ("N", "E", "V", "shape", "library_chunked_ms",
                                            "recompute", "design", "designs_ms", "main_path",
                                            "launches", "bias_shape")}
                    for t in also.get(name, [])],
    } for name, (source, replaces) in sources.items()]
    # each kernel's form for a bf16-stored table: launched by phase X, held
    # against its plain version there, timed at X's shapes
    kernels += [{
        "name": f"{name}_bf16",
        "route": "cuda",
        "source": f"transformers4rec_tpu_torch/csrc/{sources[name][0]}",
        "replaces": sources[name][1],
        "launches": bf16_tables["launches"][name],
        "max_abs_err": bf16_tables["errors"][name],
        **{k: bf16_timing[name][k] for k in TIMING_KEYS + ("N", "E", "shape", "stages",
                                                           "table_dtype")
           if k in bf16_timing[name]},
        "also_at": [{**{k: t[k] for k in t if k in TIMING_KEYS + ("N", "E", "V", "table_dtype")},
                     "main_path": True} for t in bf16_also.get(name, [])],
    } for name in ("ce_fwd", "ce_bwd", "ce_rank", "rank", "adafactor_a", "adafactor_b")]
    if any(k["launches"] < 1 for k in kernels):
        fail(f"a kernel of the main path was never launched: {launches}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
