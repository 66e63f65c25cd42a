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
   draws, one per evaluation batch) and at an edge shape;
4. evaluate: the REES46 XLNet-MLM model at full width (390,000 items,
   d_model 192, 3 layers, 16 heads, sessions of 20, weights from a seed)
   runs ``Model.evaluate`` over 4 synthetic batches of 128 sessions; K3 must
   launch once per batch, and the result must agree with an evaluation of
   the same weights on the CPU (which takes the plain version);
5. serve: ``export_model`` writes the artifact, ``ServingServer`` answers 8
   HTTP requests of ragged sessions (6 of them at once, so the batcher
   coalesces), and the answers must match ``InferenceRunner.predict``;
6. time K3, its plain version and a library yardstick at the evaluation
   shape (CUDA events, median of 30 after warm-up).

The second-to-last line of standard output is one JSON object with a
``kernels`` list; the last is ``{"ok": true, "device": {...}}``.
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
# dense bf16 tensor-core FLOP/s, for the least time a kernel could take
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

EVAL_BATCHES, EVAL_ROWS = 4, 128
TOP_K = 20


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


# -------------------------------------------------------------------- timing
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
    # write lse and rank once; 2·N·E·V operations of the product
    nbytes = 4 * (n * E + vocab_size * E + 2 * n) + 4 * 2 * n
    flops = 2 * n * E * vocab_size
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return {
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": nbytes, "flops": flops,
    }


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs an NVIDIA GPU")
    import_port()
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

    # ---- main path 1: evaluate at full width, on the card and on the CPU
    model = flagship.build_model("cuda", seed=0)
    loader = eval_batches(flagship, flagship.NUM_ITEMS, flagship.SEQ, EVAL_BATCHES, EVAL_ROWS)
    gpu_res, eval_launches, eval_s = run_evaluate(model, loader, vocab)
    print(f"[evaluate] cuda {eval_s:.3f}s launches {eval_launches} {json.dumps(gpu_res)}")
    if eval_launches["ce_rank"] != EVAL_BATCHES:
        fail(f"evaluate launched ce_rank {eval_launches['ce_rank']} times, "
             f"expected {EVAL_BATCHES}")
    cpu_model = flagship.build_model("cpu", seed=0)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_res, _, cpu_s = run_evaluate(cpu_model, loader, vocab)
    print(f"[evaluate] cpu reference {cpu_s:.3f}s {json.dumps(cpu_res)}")
    check_evaluate(gpu_res, cpu_res, EVAL_BATCHES * EVAL_ROWS)
    del cpu_model

    # ---- main path 2: serve ragged sessions over HTTP
    requests = serve_requests(flagship, flagship.NUM_ITEMS, flagship.SEQ, 8)
    serve = run_serve(flagship.build_model, model, loader[0], vocab_size, requests, "cuda")
    print(f"[serve] {json.dumps(serve)}")

    # ---- timing at the evaluation shape
    timing = time_ce_rank(vocab, EVAL_ROWS, table_rows, vocab_size)
    print(f"[timing] ce_rank at N={EVAL_ROWS}, E=64, V={vocab_size} on {card}: "
          f"{json.dumps(timing)}; library_ms is torch.matmul(bf16) + logsumexp + count, "
          "materialising (N, V)")

    kernels = [{
        "name": "ce_rank",
        "route": "cuda",
        "source": "transformers4rec_tpu_torch/csrc/ce_rank.cu",
        "replaces": "transformers4rec_tpu/ops/vocab.py:758",
        "launches": eval_launches["ce_rank"] + serve["launches"]["ce_rank"],
        "max_abs_err": max(c["lse_max_abs_err"] for c in checks),
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
