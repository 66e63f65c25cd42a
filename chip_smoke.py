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
   draws, one per evaluation batch) and at an edge shape; hold K1
   (``ce_fwd``) and K2 (``ce_bwd``), the training cross-entropy's forward and
   backward, against theirs at the training shape (915 loss rows, about 30%
   of them with weight 0) and at an edge shape (label smoothing, labels of
   -1, an explicit eps/V);
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
7. train: ``flagship.build_trainer`` takes 16 optimizer steps (two groups of
   ``steps_per_execution = 8``) on 16 synthetic batches of 128 sessions with
   dropout 0.1, then 32 more on one repeated batch; K1 and K2 must launch
   once per step, every loss read must be finite, the repeated batch's loss
   must fall, and the item table and its bf16 moment must have moved;
8. time K3 at the evaluation shape and K1 and K2 at the training shape, each
   beside its plain version and a library yardstick (CUDA events, median
   after warm-up).

The second-to-last line of standard output is one JSON object with a
``kernels`` list; the last is ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --profile-train [FILE]`` runs none of the above: it
trains the flagship model for a few groups of steps under ``torch.profiler``
and prints where a steady step's time goes (device time by kernel, the
device's busy share of the wall time, the first step's cost); the table
also goes to FILE when one is named.
"""

from __future__ import annotations

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
SFU_OPS_PER_S = 16 * 132 * 1.98e9

EVAL_BATCHES, EVAL_ROWS = 4, 128
TOP_K = 20
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


# ----------------------------------------------------------------- K3 check
def ce_rank_inputs(n: int, rows: int, vocab_size: int, e: int, beta_lo: float,
                   beta_hi: float, seed: int, device):
    """x (n, e), a (rows, e) table drawn like the model's (normal, std 0.05),
    labels in [1, vocab_size) and their label logits. Row i of x is
    ``beta_i * W[label_i] + N(0, 1)``: with beta_i up to 12 the label logit
    sits in the upper tail of its row, as a trained model's does."""
    rng = np.random.default_rng(seed)
    W = rng.normal(0.0, 0.05, (rows, e)).astype(np.float32)
    labels = rng.integers(1, vocab_size, n).astype(np.int32)
    beta = rng.uniform(beta_lo, beta_hi, (n, 1)).astype(np.float32)
    x = (beta * W[labels] + rng.normal(0.0, 1.0, (n, e))).astype(np.float32)
    return (torch.from_numpy(x).to(device), torch.from_numpy(W).to(device),
            torch.from_numpy(labels).to(device))


def check_ce_rank(name: str, n: int, rows: int, vocab_size: int, smooth: bool,
                  beta_lo: float, beta_hi: float, seeds, device="cuda") -> dict:
    """K3 against ``ce_rank_plain`` on the same inputs, one call per seed.

    Criteria: lse within 1e-4 relative; zsum within 1e-4 of
    max(|zsum|, sqrt(V)), since it is a sum of V logits of both signs whose
    rounding grows with sqrt(V), not with |zsum|; ranks exact on >= 99% of
    the rows of all calls and within 2 on every row. The kernel's tensor
    cores sum each logit in another order than the plain version's matrix
    product, so a logit within an ulp of the label logit may land on the
    other side of it."""
    from transformers4rec_tpu_torch.ops import vocab

    lse_abs, lse_rel, zs_err, diffs, ranks = 0.0, 0.0, 0.0, [], []
    for seed in seeds:
        x, W, labels = ce_rank_inputs(n, rows, vocab_size, 64, beta_lo, beta_hi, seed, device)
        ll = vocab.label_logits(x, W, labels)
        lse, rank, zs = vocab.ce_rank(x, W, labels, ll, vocab_size, smooth=smooth)
        lse_p, rank_p, zs_p = vocab.ce_rank_plain(x, W, labels, ll, vocab_size, smooth)
        sync(device)
        if not (torch.isfinite(lse).all() and torch.isfinite(lse_p).all()):
            fail(f"ce_rank {name}: non-finite lse")
        err = (lse - lse_p).abs()
        lse_abs = max(lse_abs, float(err.max()))
        lse_rel = max(lse_rel, float((err / lse_p.abs().clamp_min(1e-30)).max()))
        if smooth:
            scale = zs_p.abs().clamp_min(math.sqrt(vocab_size))
            zs_err = max(zs_err, float(((zs - zs_p).abs() / scale).max()))
        diffs.append((rank.long() - rank_p.long()).abs().cpu())
        ranks.append(rank_p.cpu())
    diff = torch.cat(diffs)
    out = {
        "shape": name, "N": n, "calls": len(diffs), "table_rows": rows,
        "vocab_size": vocab_size, "smooth": smooth,
        "lse_max_abs_err": lse_abs, "lse_max_rel_err": lse_rel,
        "rank_exact_share": float((diff == 0).float().mean()),
        "rank_max_diff": int(diff.max()),
        "rank_median": float(torch.cat(ranks).float().median()),
    }
    if smooth:
        out["zsum_max_scaled_err"] = zs_err
    print(f"[k3] {json.dumps(out)}")
    if lse_rel > 1e-4:
        fail(f"ce_rank {name}: lse relative error {lse_rel:.3g} > 1e-4")
    if zs_err > 1e-4:
        fail(f"ce_rank {name}: zsum error {zs_err:.3g} > 1e-4")
    if out["rank_exact_share"] < 0.99 or out["rank_max_diff"] > 2:
        fail(f"ce_rank {name}: ranks exact on {out['rank_exact_share']:.4f} of rows, "
             f"max diff {out['rank_max_diff']}")
    return out



# ------------------------------------------------------------- K1 / K2 check
def ce_train_inputs(n: int, rows: int, vocab_size: int, seed: int, minus_one: bool, device):
    """Inputs as ``ce_rank_inputs`` draws them, plus row weights of which
    about 30% are 0 (the loss-row budget's spare rows) and, with
    ``minus_one``, a few labels of -1 among those."""
    x, W, labels = ce_rank_inputs(n, rows, vocab_size, 64, 0.0, 12.0, seed, device)
    rng = np.random.default_rng(seed + 1000)
    w = (rng.random(n) >= 0.3).astype(np.float32)
    if minus_one:
        pad = torch.from_numpy((rng.random(n) < 0.1) & (w == 0)).to(device)
        labels = torch.where(pad, torch.full_like(labels, -1), labels)
    return x, W, labels, torch.from_numpy(w).to(device)


def grad_errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    return {"max_abs_err": float((got - want).abs().max()),
            "max_err_over_peak": float((got - want).abs().max() / want.abs().max()),
            "rel_frobenius": float((got - want).norm() / want.norm())}


def check_grad(what: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """A gradient against its reference: within 2e-2 of the reference's
    largest magnitude and 1e-3 in relative Frobenius norm. Both sides round
    the CE's residual to bf16, from exponentials that differ in the last
    bits, so single entries may land on neighbouring bf16 values."""
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite values")
    err = grad_errors(got, want)
    if err["max_err_over_peak"] > 2e-2 or err["rel_frobenius"] > 1e-3:
        fail(f"{what}: {err}")
    return err


def check_ce_train(name: str, n: int, rows: int, vocab_size: int, eps: float,
                   eps_over_v, minus_one: bool, seed: int, device="cuda") -> dict:
    """K1 against ``ce_fwd_plain`` and K2 against ``ce_bwd_plain`` on the same
    inputs. Criteria: lse within 1e-4 relative; the label logit within 1e-4
    of max(|ll|, 1) (it may sit near 0) and exactly 0 for a label of -1; zsum
    as K3's; dx and dW as ``check_grad`` says; dW rows at and beyond the
    vocab exactly 0."""
    from transformers4rec_tpu_torch.ops import vocab

    x, W, labels, w = ce_train_inputs(n, rows, vocab_size, seed, minus_one, device)
    lse, ll, zs = vocab.ce_fwd(x, W, labels, vocab_size, smooth=eps > 0)
    lse_p, ll_p, zs_p = vocab.ce_fwd_plain(x, W, labels, vocab_size, eps > 0)
    coef = (w / w.sum().clamp_min(1.0)).contiguous()
    dx, dW = vocab.ce_bwd(x, W, labels, lse, coef, vocab_size, eps, eps_over_v)
    dx_p, dW_p = vocab.ce_bwd_plain(x, W, labels, lse, coef, vocab_size, eps, eps_over_v)
    sync(device)
    if not torch.isfinite(lse).all():
        fail(f"ce_fwd {name}: non-finite lse")
    out = {
        "shape": name, "N": n, "table_rows": rows, "vocab_size": vocab_size, "eps": eps,
        "zero_weight_share": float((w == 0).float().mean()),
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
    print(f"[k1k2] {json.dumps(out)}")
    return out


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
def serve_requests(flagship, num_items: int, seq: int, count: int) -> list:
    """``count`` requests of 1-3 ragged sessions each, all four columns."""
    from transformers4rec_tpu_torch.data import synthetic_data

    rng = np.random.default_rng(7)
    sizes = rng.integers(1, 4, count)
    data = synthetic_data(flagship.schema(num_items, seq), num_rows=int(sizes.sum()),
                          max_session_length=seq, ragged=True, seed=8)
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


def check_topk(got_s, got_i, want_s, want_i, vocab_size: int, what: str) -> None:
    got_s, got_i = np.asarray(got_s), np.asarray(got_i)
    if got_i.shape != want_i.shape or got_i.min() < 1 or got_i.max() >= vocab_size:
        fail(f"{what}: ids shape {got_i.shape} range [{got_i.min()}, {got_i.max()}]")
    if not np.allclose(got_s, want_s, atol=1e-5, rtol=0):
        fail(f"{what}: scores differ by {np.abs(got_s - want_s).max()}")
    # the two calls batch differently, so near-tied scores may swap places
    gaps = np.abs(np.diff(want_s, axis=1)) > 1e-5
    clear = np.ones_like(want_i, dtype=bool)
    clear[:, :-1] &= gaps
    clear[:, 1:] &= gaps
    if not np.array_equal(got_i[clear], want_i[clear]):
        fail(f"{what}: top-{want_i.shape[1]} ids differ where scores do not tie")


def run_serve(builder, model, example, vocab_size: int, requests: list, device) -> dict:
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
                       f"request {i}")
    if stats["requests"] != len(requests) or not stats["batches"] < stats["requests"]:
        fail(f"serve: stats {stats} show no coalescing of {len(requests)} requests")
    return {"stats": stats, "wall_s": wall, "launches": launches}



# --------------------------------------------------------------------- train
def check_training_step(model, cpu_model, batch) -> dict:
    """One training forward and backward of the same weights on the card and
    on the CPU (which takes the plain versions), with one mask, drawn once
    and given to both, and dropout off (both models are built with dropout
    0). The loss must agree within 1e-4 relative; the gradients of the item
    table (the lookup's plus the CE's dW) and of the output projection as
    ``check_grad`` says."""
    masking = cpu_model.heads[0].input_module.masking
    cb = cpu_model._as_dense(batch)
    info = masking.compute_masked_targets(cb["item_id"].long(), training=True,
                                          generator=torch.Generator().manual_seed(5))
    grads, losses = {}, {}
    for name, m, b in (("cpu", cpu_model, cb), ("cuda", model, model._as_dense(batch))):
        dev_info = info.replace(**{f: getattr(info, f).to(m.device)
                                   for f in ("targets", "mask", "input_schema", "pad_mask")})
        m.zero_grad(set_to_none=True)
        loss, _ = m(b, targets=b, training=True, masking_info=dev_info)
        loss.backward()
        sync(m.device)
        losses[name] = float(loss.detach())
        task = m.heads[0].tasks[0]
        grads[name] = (m.heads[0].input_module.item_embedding_table().grad.cpu(),
                       task.tying_projection.weight.grad.cpu())
        m.zero_grad(set_to_none=True)
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    if not math.isfinite(losses["cuda"]) or rel > 1e-4:
        fail(f"training step: loss on the card {losses['cuda']} vs CPU {losses['cpu']}")
    return {"loss": losses, "targets": int(info.mask.sum()),
            "item_table_grad": check_grad("training step, item table gradient",
                                          grads["cuda"][0], grads["cpu"][0]),
            "projection_grad": check_grad("training step, projection gradient",
                                          grads["cuda"][1], grads["cpu"][1])}


def run_train(flagship, vocab, card: str) -> dict:
    """The trainer at full width: 16 steps over 16 batches, then 32 steps on
    one repeated batch. The kernel counts are set to 0 just before each
    ``train()`` and read just after."""
    from transformers4rec_tpu_torch.data import synthetic_data

    rows = flagship.BATCH
    data = synthetic_data(flagship.schema(), num_rows=TRAIN_STEPS * rows,
                          max_session_length=flagship.SEQ, seed=200)
    trainer = flagship.build_trainer("cuda", seed=0, train_dataset=data)
    a = trainer.args
    if a.steps_per_execution != 8 or a.per_device_train_batch_size != rows:
        fail(f"build_trainer: K={a.steps_per_execution}, batch={a.per_device_train_batch_size}")
    table = trainer.model.heads[0].input_module.item_embedding_table()
    table_before = table.detach().clone()
    launches = {"ce_fwd": 0, "ce_bwd": 0}
    out = {}

    def phase(name: str, steps: int) -> list:
        a.max_steps = steps
        vocab.ce_fwd.launches = vocab.ce_bwd.launches = 0
        sync("cuda")
        t0 = time.perf_counter()
        metrics = trainer.train()
        sync("cuda")
        wall = time.perf_counter() - t0
        got = {"ce_fwd": vocab.ce_fwd.launches, "ce_bwd": vocab.ce_bwd.launches}
        if got != {"ce_fwd": steps, "ce_bwd": steps} or metrics["train_steps"] != steps:
            fail(f"train ({name}): {steps} steps launched {got}")
        for k in launches:
            launches[k] += got[k]
        reads = [h["loss"] for h in trainer.state.log_history
                 if "loss" in h and h["step"] > trainer.state.global_step - steps]
        if not reads or not all(math.isfinite(v) for v in reads + [metrics["train_loss"]]):
            fail(f"train ({name}): loss reads {reads}, mean {metrics['train_loss']}")
        out[name] = {"steps": steps, "wall_s": wall, "steps_per_s": steps / wall,
                     "sessions_per_s": steps * rows / wall, "ms_per_step": 1e3 * wall / steps,
                     "mean_loss": metrics["train_loss"], "loss_reads": reads}
        print(f"[train] {name} on {card}: {json.dumps(out[name])}")
        return reads

    a.logging_steps = 8  # one host read of the loss after each group of 8 steps
    if len(phase("sixteen_batches", TRAIN_STEPS)) != TRAIN_STEPS // 8:
        fail("train: expected one loss read per group of 8 steps")
    batch = {k: v[:rows] for k, v in data.items()}
    trainer._train_dataloader = [batch] * REPEAT_STEPS
    a.logging_steps = 1
    reads = phase("one_batch_repeated", REPEAT_STEPS)
    # masks and dropout differ from step to step, so single losses are noisy:
    # the mean of the last 8 steps must lie below the first loss
    if not float(np.mean(reads[-8:])) < reads[0]:
        fail(f"train: the repeated batch's loss did not fall: {reads}")
    moment = trainer.optimizers["table"].state[table]["v"]
    if moment.dtype != torch.bfloat16 or moment.shape != table.shape:
        fail(f"train: the table's moment is {moment.dtype} {tuple(moment.shape)}")
    if not (torch.isfinite(table).all() and torch.isfinite(moment.float()).all()):
        fail("train: the item table or its moment holds a non-finite value")
    moved = float((table.detach() - table_before).abs().max())
    if not moved > 0 or not bool((moment != 0).any()):
        fail("train: the item table or its moment did not change")
    out.update(launches=launches, global_step=trainer.state.global_step,
               table_max_move=moved, moment_nonzero_share=float((moment != 0).float().mean()))
    return out


# -------------------------------------------------------------------- timing
def bound(nbytes: int, flops: int, exps: int = 0) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their units' peak rates (the
    products on the tensor cores, the exponentials on the special-function
    units; the two run side by side)."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    tensor_ms, exp_ms = flops / BF16_FLOPS * 1e3, exps / SFU_OPS_PER_S * 1e3
    ops_ms = max(tensor_ms, exp_ms)
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops, "exps": exps,
            "bytes_ms": bytes_ms, "tensor_ms": tensor_ms, "exp_ms": exp_ms}


def time_ce_train(vocab, n: int, rows: int, vocab_size: int) -> dict:
    """K1 and K2 at the training shape beside their plain versions and a
    library yardstick that materialises the (N, V) logits (bf16 products
    through torch.matmul; never used by the port)."""
    x, W, labels, w = ce_train_inputs(n, rows, vocab_size, 1, False, "cuda")
    E = x.shape[1]
    coef = (w / w.sum()).contiguous()
    lse, _, _ = vocab.ce_fwd(x, W, labels, vocab_size)
    xb16 = x.to(torch.bfloat16)
    Wb16 = W[:vocab_size].to(torch.bfloat16)  # cast once, outside the timed calls
    idx = labels.long()[:, None]

    def library_fwd():
        logits = torch.matmul(xb16, Wb16.T).float()
        return torch.logsumexp(logits, -1), logits.gather(1, idx)

    def library_bwd():
        r = torch.softmax(torch.matmul(xb16, Wb16.T).float(), -1)
        r.scatter_add_(1, idx, torch.full_like(coef, -1.0)[:, None])
        r = (r * coef[:, None]).to(torch.bfloat16)
        return torch.matmul(r, Wb16), torch.matmul(r.T, xb16)

    fwd = {
        "ms": cuda_ms(lambda: vocab.ce_fwd(x, W, labels, vocab_size)),
        "plain_ms": cuda_ms(lambda: vocab.ce_fwd_plain(x, W, labels, vocab_size, False), reps=10),
        "library_ms": cuda_ms(library_fwd, reps=10),
        # read x, the used rows of W and the labels once, write lse and ll once
        **bound(4 * (n * E + vocab_size * E + n) + 4 * 2 * n, 2 * n * E * vocab_size,
                n * vocab_size),
    }
    bwd = {
        "ms": cuda_ms(lambda: vocab.ce_bwd(x, W, labels, lse, coef, vocab_size)),
        "plain_ms": cuda_ms(lambda: vocab.ce_bwd_plain(x, W, labels, lse, coef, vocab_size),
                            reps=10),
        "library_ms": cuda_ms(library_bwd, reps=10),
        # read x, the used rows of W, labels, lse and coef once; write dx and
        # the whole of dW once; three products and one set of exponentials
        **bound(4 * (n * E + vocab_size * E + 3 * n) + 4 * (n * E + rows * E),
                3 * 2 * n * E * vocab_size, n * vocab_size),
    }
    return {"ce_fwd": fwd, "ce_bwd": bwd}


def time_ce_rank(vocab, n: int, rows: int, vocab_size: int) -> dict:
    x, W, labels = ce_rank_inputs(n, rows, vocab_size, 64, 4.0, 12.0, 1, "cuda")
    ll = vocab.label_logits(x, W, labels)
    xb16 = x.to(torch.bfloat16)
    Wb16 = W[:vocab_size].to(torch.bfloat16)  # cast once, outside the timed call

    def library():
        logits = torch.matmul(xb16, Wb16.T).float()  # materialises (N, V)
        return torch.logsumexp(logits, -1), (logits > ll[:, None]).sum(-1)

    ms = cuda_ms(lambda: vocab.ce_rank(x, W, labels, ll, vocab_size))
    plain_ms = cuda_ms(lambda: vocab.ce_rank_plain(x, W, labels, ll, vocab_size, False))
    library_ms = cuda_ms(library)
    E = x.shape[1]
    # least work: read x, the vocab_size used rows of W, labels and ll once,
    # write lse and rank once; 2·N·E·V operations of the product and N·V
    # exponentials
    return {
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        **bound(4 * (n * E + vocab_size * E + 2 * n) + 4 * 2 * n, 2 * n * E * vocab_size,
                n * vocab_size),
    }


def profile_train(card: str, out_file: str = "") -> None:
    """Where a training step's time goes: the first step alone, a steady
    window by the host's clock, and the same window under ``torch.profiler``
    (device time by kernel; busy share = device time over wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from transformers4rec_tpu_torch import flagship
    from transformers4rec_tpu_torch.data import synthetic_data
    from transformers4rec_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.build()  # so that the first step below does not wait for nvcc
    print(f"[profile] kernels built in {time.perf_counter() - t0:.1f}s")
    rows, window = flagship.BATCH, 16
    data = synthetic_data(flagship.schema(), num_rows=8 * rows,
                          max_session_length=flagship.SEQ, seed=200)
    t0 = time.perf_counter()
    trainer = flagship.build_trainer("cuda", seed=0, train_dataset=data)
    sync("cuda")
    print(f"[profile] build_trainer {time.perf_counter() - t0:.3f}s")

    def run(steps: int) -> float:
        trainer.args.max_steps = steps
        sync("cuda")
        t0 = time.perf_counter()
        trainer.train()
        sync("cuda")
        return time.perf_counter() - t0

    print(f"[profile] first step {run(1):.3f}s, second step {run(1):.3f}s, "
          f"next 8 steps {run(8) / 8 * 1e3:.3f} ms/step")
    plain_s = run(window)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_s = run(window)
    # the device's own events (kernels, copies, fills): the rows of the table
    # below also list each operator with the time of the kernels it launched
    device_us = sum(e.device_time_total for e in prof.events()
                    if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40,
                           max_name_column_width=70)
    summary = {
        "card": card, "steps": window,
        "ms_per_step": plain_s / window * 1e3,
        "ms_per_step_traced": traced_s / window * 1e3,
        "device_ms_per_step": device_us / window / 1e3,
        # against the untraced wall time: tracing slows the host, not the device
        "device_busy_share": device_us / 1e6 / plain_s,
    }
    print(table)
    print(f"[profile] {json.dumps(summary)}")
    if out_file:
        os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
        with open(out_file, "w") as f:
            f.write(json.dumps(summary) + "\n" + table + "\n")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs an NVIDIA GPU")
    import_port()
    if sys.argv[1:2] == ["--profile-train"] and len(sys.argv) <= 3:
        profile_train(card_line(), *sys.argv[2:])
        return
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}")
    from transformers4rec_tpu_torch import flagship
    from transformers4rec_tpu_torch.ops import build, vocab

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
    del model, cpu_model
    torch.cuda.empty_cache()

    # ---- main path 3: train at full width
    train = run_train(flagship, vocab, card)
    print(f"[train] {json.dumps({k: train[k] for k in ('launches', 'global_step', 'table_max_move', 'moment_nonzero_share')})}")

    # ---- timing at the evaluation and the training shape
    timing = {"ce_rank": time_ce_rank(vocab, EVAL_ROWS, table_rows, vocab_size),
              **time_ce_train(vocab, train_rows, table_rows, vocab_size)}
    print(f"[timing] ce_rank at N={EVAL_ROWS}, ce_fwd and ce_bwd at N={train_rows}, E=64, "
          f"V={vocab_size} on {card}: {json.dumps(timing)}; library_ms is torch.matmul(bf16) "
          "with logsumexp + count (ce_rank), logsumexp + gather (ce_fwd), softmax + two "
          "more products (ce_bwd), each materialising (N, V)")
    step_ms = train["one_batch_repeated"]["ms_per_step"]
    print(f"[share] on {card}: a training step takes {step_ms:.3f} ms of wall time, of which "
          f"ce_fwd + ce_bwd take {timing['ce_fwd']['ms'] + timing['ce_bwd']['ms']:.3f} ms "
          "on the device")

    sources = {"ce_rank": 758, "ce_fwd": 105, "ce_bwd": 349}  # line of the TPU kernel body
    launches = {"ce_rank": eval_launches["ce_rank"] + serve["launches"]["ce_rank"],
                **train["launches"]}
    errors = {"ce_rank": max(c["lse_max_abs_err"] for c in checks),
              "ce_fwd": max(c["lse_max_abs_err"] for c in train_checks),
              "ce_bwd": max(c[g]["max_abs_err"] for c in train_checks for g in ("dx", "dW"))}
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": f"transformers4rec_tpu_torch/csrc/{name}.cu",
        "replaces": f"transformers4rec_tpu/ops/vocab.py:{line}",
        "launches": launches[name],
        "max_abs_err": errors[name],
        **{k: timing[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    } for name, line in sources.items()]
    if any(k["launches"] < 1 for k in kernels):
        fail(f"a kernel of the main path was never launched: {launches}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
