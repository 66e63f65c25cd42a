"""Serving export: a model directory and an in-process predictor.

Counterpart of ``transformers4rec_tpu/serving/export.py``. The artifact
directory holds:

- ``model.pt``          — the model's ``state_dict`` (CPU tensors)
- ``input_schema.json`` / ``output_schema.json`` — feature wiring for the
  serving frontend
- ``metadata.json``     — top_k, per-feature trailing shapes and dtypes,
  batch-size information (the JAX package's keys)

The architecture is code, not data: ``InferenceRunner`` rebuilds the model
with a builder callable (``builder(device) -> Model``, the contract of the
JAX server's ``--model-builder``), loads the weights and serves
``predict(dict of arrays) → (scores, ids)``. Ragged sessions are densified
as the JAX runner does (keep the first ``max_len`` items, right-pad 0).

Not ported yet: Categorify bundling (raw ids in and out) and a
``torch.export`` program artifact.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data.padding import pad_ragged
from ..model.base import Model
from ..schema import Schema
from ..utils.device import resolve_device


def _as_numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def export_model(
    model: Model,
    example_batch: Dict[str, object],
    path: str,
    top_k: Optional[int] = None,
) -> str:
    """Write the artifact directory for ``model`` (weights, schemas, and the
    feature shapes of ``example_batch``). Returns ``path``."""
    os.makedirs(path, exist_ok=True)
    example = {k: _as_numpy(v) for k, v in example_batch.items()}
    top_k = top_k or model.top_k
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(path, "model.pt"))
    with open(os.path.join(path, "input_schema.json"), "w") as f:
        f.write(model.input_schema.to_json())
    with open(os.path.join(path, "output_schema.json"), "w") as f:
        f.write(model.output_schema_for(top_k).to_json())
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(
            {
                "top_k": top_k,
                "features": {k: list(v.shape[1:]) for k, v in example.items()},
                "dtypes": {k: str(v.dtype) for k, v in example.items()},
                "batch_polymorphic": True,
                "weights_dtype": None,
                "example_batch_size": int(next(iter(example.values())).shape[0]),
                "bundled_params": False,
                "categories": [],
                "item_id_column": None,
            },
            f,
        )
    return path


class InferenceRunner:
    """In-process predictor over an exported artifact directory."""

    def __init__(self, path: str, model_builder: Callable[[torch.device], Model],
                 device=None):
        self.device = resolve_device(device)
        with open(os.path.join(path, "metadata.json")) as f:
            self.metadata = json.load(f)
        if self.metadata.get("categories"):
            raise NotImplementedError("Categorify bundling is not ported yet")
        self.input_schema = Schema.from_json(os.path.join(path, "input_schema.json"))
        self.output_schema = Schema.from_json(os.path.join(path, "output_schema.json"))
        model = model_builder(self.device)
        state = torch.load(os.path.join(path, "model.pt"), map_location=self.device,
                           weights_only=True)
        model.load_state_dict(state)
        self.model = model.to(self.device).eval()

    def predict(self, batch: Dict[str, object]):
        """Run inference on a dict of (rows, ...) arrays or lists of ragged
        sessions. Returns ``(scores, ids)`` numpy arrays for a top-k artifact,
        else the (rows, V) scores."""
        feats = self.metadata["features"]
        dtypes = self.metadata["dtypes"]
        arrs = {
            k: torch.as_tensor(self._densify(k, v, feats[k], dtypes[k])).to(self.device)
            for k, v in batch.items()
            if k in feats
        }
        with torch.inference_mode():
            out = self.model(arrs, top_k=self.metadata.get("top_k"))
        if isinstance(out, tuple):
            return _as_numpy(out[0]), _as_numpy(out[1])
        return _as_numpy(out)

    def _densify(self, name: str, v, feat_shape, dtype) -> np.ndarray:
        """Accept ragged sequence inputs (a list of variable-length sessions)
        besides dense arrays: keep the first ``max_len`` items, right-pad 0."""
        if feat_shape and isinstance(v, (list, tuple)) and len(v) and isinstance(
            v[0], (list, tuple, np.ndarray)
        ):
            lens = {len(r) for r in v}
            if len(lens) > 1 or lens != {feat_shape[0]}:
                values = np.concatenate([np.asarray(r, dtype=dtype) for r in v])
                offsets = np.zeros(len(v) + 1, np.int64)
                np.cumsum([len(r) for r in v], out=offsets[1:])
                return pad_ragged(values, offsets, feat_shape[0])
        arr = np.asarray(v, dtype=dtype)
        if feat_shape and arr.ndim == 2 and arr.shape[1] != feat_shape[0]:
            # dense batch at the wrong session length: keep-first / right-pad-0
            L = feat_shape[0]
            arr = arr[:, :L] if arr.shape[1] >= L else np.pad(
                arr, ((0, 0), (0, L - arr.shape[1]))
            )
        return arr
