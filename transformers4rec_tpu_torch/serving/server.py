"""Serving daemon with dynamic request batching.

Counterpart of ``transformers4rec_tpu/serving/server.py``: a stdlib HTTP
daemon over an ``InferenceRunner``. One worker thread owns the device: it
drains the request queue into micro-batches (up to ``max_batch_size`` rows
or ``max_delay_ms``, whichever comes first), pads each to the next
power-of-two bucket, runs the model and splits the results back to the
waiting requests.

Endpoints (JSON):
- ``POST /v2/predict`` — ``{"inputs": {col: [[...], ...]}}`` →
  ``{"item_ids": [...], "item_id_scores": [...]}`` (top-k artifact) or
  ``{"scores": [...]}``
- ``GET /v2/health`` — liveness + artifact metadata
- ``GET /v2/stats`` — request/batch counters (observed dynamic batching)

CLI: ``python -m transformers4rec_tpu_torch.serving.server --artifact DIR
[--device cuda|cpu] --port N`` serves the artifact's program alone (it runs
on the device type it was traced on). ``--model-builder MODULE:FUNC``
rebuilds the model from code instead, and with ``--model-axis M`` serves
through ``ShardedInferenceRunner``: the item table split into M row shards
over the machine's cards (an artifact exported with ``bundle_params=True``).
Raw Categorify values are encoded and ragged sessions densified once, in
the request's handler.
"""

from __future__ import annotations

import argparse
import importlib
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

import numpy as np

from .export import InferenceRunner
from .sharded import ShardedInferenceRunner


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class DynamicBatcher:
    """Coalesce single requests into padded micro-batches, executed by one
    device-owning worker thread."""

    def __init__(self, runner: InferenceRunner, max_batch_size: int = 64,
                 max_delay_ms: float = 5.0):
        self.runner = runner
        self.max_batch_size = max_batch_size
        self.max_delay_ms = max_delay_ms
        self._q: "queue.Queue" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "rows": 0}  # written by the worker only
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, inputs: Dict[str, np.ndarray]) -> Future:
        """inputs: dict of (rows, ...) arrays, already densified."""
        fut: Future = Future()
        self._q.put((inputs, fut))
        return fut

    def close(self):
        self._stop.set()
        self._q.put(None)
        self._worker.join(timeout=5)

    def _run(self):
        carry = None  # a request that would have overflowed the cap
        while not self._stop.is_set():
            item = carry if carry is not None else self._q.get()
            carry = None
            if item is None:
                break
            pending = [item]
            rows = item[0][next(iter(item[0]))].shape[0]
            deadline = time.monotonic() + self.max_delay_ms / 1e3
            while rows < self.max_batch_size:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._stop.set()
                    break
                n_next = nxt[0][next(iter(nxt[0]))].shape[0]
                if rows + n_next > self.max_batch_size:
                    carry = nxt  # seeds the next batch
                    break
                pending.append(nxt)
                rows += n_next
            self._execute(pending)

    def _execute(self, pending):
        try:
            keys = list(pending[0][0].keys())
            batch = {k: np.concatenate([req[k] for req, _ in pending], axis=0) for k in keys}
            n = batch[keys[0]].shape[0]
            # pad to a power-of-two bucket: a bounded set of batch shapes
            bucket = min(_next_pow2(n), max(self.max_batch_size, n))
            if bucket > n:
                batch = {
                    k: np.concatenate([v, np.zeros((bucket - n, *v.shape[1:]), v.dtype)], axis=0)
                    for k, v in batch.items()
                }
            out = self.runner.predict(batch, encode_inputs=False)
            self.stats["requests"] += len(pending)
            self.stats["batches"] += 1
            self.stats["rows"] += n
            ofs = 0
            for req, fut in pending:
                m = req[keys[0]].shape[0]
                if isinstance(out, tuple):
                    fut.set_result((out[0][ofs:ofs + m], out[1][ofs:ofs + m]))
                else:
                    fut.set_result(out[ofs:ofs + m])
                ofs += m
        except Exception as e:  # surfaced to every waiting caller
            for _, fut in pending:
                if not fut.done():
                    fut.set_exception(e)


class ServingServer:
    """HTTP frontend over a DynamicBatcher. Start with ``.serve_forever()``
    (blocking) or ``.start()`` (background thread; ``.stop()`` to shut down).
    ``port=0`` picks a free port (read it back from ``.port``)."""

    def __init__(
        self,
        artifact_path: str,
        model_builder: Optional[Callable] = None,
        host: str = "127.0.0.1",
        port: int = 8000,
        max_batch_size: int = 64,
        max_delay_ms: float = 5.0,
        runner: Optional[InferenceRunner] = None,
        device=None,
        model_axis: Optional[int] = None,
    ):
        if runner is None:
            if model_axis is None:
                runner = InferenceRunner(artifact_path, model_builder, device=device)
            elif model_builder is None:
                raise ValueError("model-parallel serving (model_axis) needs a model_builder")
            else:
                runner = ShardedInferenceRunner(artifact_path, model_builder,
                                                model_axis=model_axis, device=device)
        self.runner = runner
        if not runner.metadata.get("batch_polymorphic", True):
            # a program of one batch size takes no larger batch
            max_batch_size = min(max_batch_size,
                                 runner.metadata.get("example_batch_size", max_batch_size))
        self.batcher = DynamicBatcher(runner, max_batch_size=max_batch_size,
                                      max_delay_ms=max_delay_ms)
        feats = runner.metadata["features"]
        dtypes = runner.metadata["dtypes"]
        batcher = self.batcher
        meta = runner.metadata

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/v2/health":
                    self._json(200, {"status": "ok", "metadata": meta})
                elif self.path == "/v2/stats":
                    self._json(200, dict(batcher.stats))
                else:
                    self._json(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                if self.path != "/v2/predict":
                    self._json(404, {"error": f"unknown path {self.path}"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length))
                    inputs = {}
                    for k, spec_shape in feats.items():
                        if k not in payload.get("inputs", {}):
                            raise KeyError(f"missing input column '{k}'")
                        # encode raw values (a bundled Categorify mapping) and
                        # densify ragged sessions here, once, so the batcher
                        # coalesces plain fixed-shape arrays and the worker
                        # runs predict(encode_inputs=False)
                        v = runner.encode(k, payload["inputs"][k])
                        arr = np.asarray(runner._densify(k, v, spec_shape, dtypes[k]),
                                         dtype=dtypes[k])
                        if list(arr.shape[1:]) != list(spec_shape):
                            raise ValueError(
                                f"column '{k}': expected trailing shape {spec_shape}, "
                                f"got {list(arr.shape[1:])}"
                            )
                        inputs[k] = arr
                    out = batcher.submit(inputs).result(timeout=60)
                    if isinstance(out, tuple):
                        self._json(200, {
                            "item_id_scores": np.asarray(out[0], np.float64).tolist(),
                            "item_ids": np.asarray(out[1]).tolist(),
                        })
                    else:
                        self._json(200, {"scores": np.asarray(out, np.float64).tolist()})
                except (KeyError, ValueError, json.JSONDecodeError) as e:
                    self._json(400, {"error": str(e)})
                except Exception as e:  # the daemon keeps serving; the caller sees why
                    self._json(500, {"error": str(e)})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def serve_forever(self):
        self._httpd.serve_forever()

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self.batcher.close()
        if self._thread:
            self._thread.join(timeout=5)


def load_builder(spec: str) -> Callable:
    """``MODULE:FUNC`` → the callable (``FUNC(device) -> Model``)."""
    mod_name, _, fn_name = spec.partition(":")
    if not mod_name or not fn_name:
        raise ValueError(f"model builder must be MODULE:FUNC, got {spec!r}")
    return getattr(importlib.import_module(mod_name), fn_name)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--artifact", required=True, help="export_model output dir")
    ap.add_argument(
        "--model-builder", default=None, metavar="MODULE:FUNC",
        help="an importable callable taking a device and returning the Model the "
        "artifact was exported from: serve the rebuilt model instead of the "
        "artifact's program (needed for --model-axis)",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--model-axis", type=int, default=None,
                    help="split the item table into this many row shards over the cards "
                    "(ShardedInferenceRunner)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch-size", type=int, default=64)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    args = ap.parse_args(argv)
    if args.model_axis is not None and args.model_builder is None:
        ap.error("--model-axis needs --model-builder")
    builder = load_builder(args.model_builder) if args.model_builder else None
    server = ServingServer(
        args.artifact, builder, host=args.host, port=args.port,
        max_batch_size=args.max_batch_size, max_delay_ms=args.max_delay_ms,
        device=args.device, model_axis=args.model_axis,
    )
    print(f"serving {args.artifact} on {server.host}:{server.port} "
          f"(max_batch={args.max_batch_size}, delay={args.max_delay_ms}ms)", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
