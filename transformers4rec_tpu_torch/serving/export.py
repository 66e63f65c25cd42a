"""Serving export: a program artifact and an in-process predictor.

Counterpart of ``transformers4rec_tpu/serving/export.py``. The JAX package
serializes its jitted inference function as StableHLO; here
``torch.export`` does the same for the model's inference call, with
``top_k`` closed over and the weights inside, so that a server runs the
artifact without the model's Python code. The directory holds:

- ``model.pt2``         — ``torch.export.save`` of ``model(batch, top_k=k)``,
  batch-polymorphic by default (the batch a ``torch.export.Dim``), traced
  on the device the model is on: a program keeps its device in its
  factory calls, so it serves on that device type only. The flash
  forward (K5) is the registered operator ``t4r::flash_fwd``, a node of
  the program that launches the kernel on the card (importing this
  package registers it, before a program is loaded).
- ``input_schema.json`` / ``output_schema.json`` — feature wiring for the
  serving frontend
- ``metadata.json``     — the JAX package's keys (top_k, per-feature
  trailing shapes and dtypes, batch-size information, the weights' type,
  the Categorify columns) and ``device_type``, the device type the program
  was traced on
- ``categories/``       — optional Categorify mappings (``categories=``):
  raw ids in, raw top-k ids out
- ``model.pt``          — with ``bundle_params=True`` only: the
  ``state_dict`` after the ``weights_dtype`` cast (the JAX package's
  ``params.msgpack``), which ``ShardedInferenceRunner`` loads

``InferenceRunner(path)`` serves ``predict(dict of arrays) → (scores, ids)``
from the program alone; ``InferenceRunner(path, model_builder)`` rebuilds
the model with a builder callable (``builder(device) -> Model``) and loads
the weights into it. Ragged sessions are densified as the JAX runner does
(keep the first ``max_len`` items, right-pad 0).
"""

from __future__ import annotations

import copy
import json
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..data.padding import pad_ragged
from ..model.base import Model, load_weights
from ..parallel.mesh import all_gather_rows
from ..schema import Schema
from ..utils.data_utils import (
    CATEGORIFY_START_INDEX,
    build_category_codes,
    encode_with_categories,
    load_categories,
    save_categories,
)
from ..utils.device import module_device, resolve_device

PROGRAM_FILE = "model.pt2"
PARAMS_FILE = "model.pt"


def _as_numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


class _Inference(nn.Module):
    """``model(batch, top_k=top_k)``: the function a program holds."""

    def __init__(self, model: Model, top_k: Optional[int]):
        super().__init__()
        self.model = model
        self.top_k = top_k

    def forward(self, batch: Dict[str, torch.Tensor]):
        return self.model(batch, top_k=self.top_k)


def single_device_model(model: Model) -> Model:
    """A copy of ``model`` for one device, as the JAX package's
    ``_strip_vocab_parallel`` gives: a table row-sharded over a process
    group gathered whole (a collective: every rank of the group calls
    this), a table split inside the process put back together on the
    model's device, and no task keeps its group."""
    groups = {}
    for m in model.modules():
        for g in list(getattr(m, "table_groups", {}).values()) + [
                getattr(m, "vocab_parallel_group", None)]:
            if g is not None:
                groups[id(g)] = g
    clone = copy.deepcopy(model, memo=dict(groups))
    device = module_device(model)
    with torch.no_grad():
        for m in clone.modules():
            for name, group in list(getattr(m, "table_groups", {}).items()):
                m.tables[name] = nn.Parameter(all_gather_rows(m.tables[name].detach(), group))
                del m.table_groups[name]
            for name, shards in list(getattr(m, "table_shards", {}).items()):
                m.tables[name] = nn.Parameter(torch.cat([s.to(device) for s in shards]))
                del m.table_shards[name]
            if getattr(m, "vocab_parallel_group", None) is not None:
                m.vocab_parallel_group = None
    return clone


def cast_weights_(model: nn.Module, dtype) -> None:
    """Every floating parameter of ``model`` cast to ``dtype`` (a
    ``torch.dtype`` or its name), as the JAX export casts its params. The
    modules then compute in the promotion of their input's type and their
    parameters' (``blocks.transformer.Linear``/``LayerNorm``)."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    with torch.no_grad():
        for p in model.parameters():
            if p.is_floating_point():
                p.data = p.data.to(dtype)


def export_model(
    model: Model,
    example_batch: Dict[str, object],
    path: str,
    top_k: Optional[int] = None,
    batch_polymorphic: bool = True,
    weights_dtype: Optional[str] = None,
    categories=None,
    bundle_params: bool = False,
) -> str:
    """Trace the inference path with ``torch.export`` on the model's device
    and write the artifact directory. Returns ``path``.

    ``batch_polymorphic`` exports the batch as a symbolic dimension, so one
    program serves any batch size. ``weights_dtype`` (``"bfloat16"``)
    casts every floating parameter first (scores still come out f32).
    ``categories`` bundles Categorify mappings: a ``{col: raw_values}``
    dict or a path to a ``categories/`` directory of
    ``unique.<col>.parquet`` files (the ETL writes one). ``bundle_params``
    also writes ``model.pt`` for ``ShardedInferenceRunner``. ``model``
    itself is not changed."""
    os.makedirs(path, exist_ok=True)
    top_k = top_k or model.top_k
    device = module_device(model)
    model = single_device_model(model).eval()
    if weights_dtype is not None:
        cast_weights_(model, weights_dtype)
    for p in model.parameters():
        p.requires_grad_(False)
    example = {k: _as_numpy(v) for k, v in example_batch.items()}
    rows = int(next(iter(example.values())).shape[0])
    traced = {k: torch.as_tensor(v).to(device) for k, v in example.items()}
    dynamic = None
    if batch_polymorphic:
        if rows < 2:  # a batch of one would be specialised to 1
            traced = {k: v.repeat(2, *([1] * (v.dim() - 1))) for k, v in traced.items()}
        batch = torch.export.Dim("batch")
        dynamic = ({k: {0: batch} for k in traced},)
    program = torch.export.export(_Inference(model, top_k), (traced,),
                                  dynamic_shapes=dynamic, strict=False)
    torch.export.save(program, os.path.join(path, PROGRAM_FILE))
    with open(os.path.join(path, "input_schema.json"), "w") as f:
        f.write(model.input_schema.to_json())
    with open(os.path.join(path, "output_schema.json"), "w") as f:
        f.write(model.output_schema_for(top_k).to_json())
    if bundle_params:
        torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
                   os.path.join(path, PARAMS_FILE))
    category_cols = []
    if categories is not None:
        if isinstance(categories, (str, os.PathLike)):
            categories = load_categories(str(categories))
        save_categories(categories, os.path.join(path, "categories"))
        category_cols = sorted(categories)
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(
            {
                "top_k": top_k,
                "features": {k: list(v.shape[1:]) for k, v in example.items()},
                "dtypes": {k: str(v.dtype) for k, v in example.items()},
                "batch_polymorphic": batch_polymorphic,
                "weights_dtype": weights_dtype,
                "example_batch_size": rows,
                "bundled_params": bundle_params,
                "categories": category_cols,
                "item_id_column": model.input_schema.item_id_column_name
                if category_cols else None,
                "device_type": device.type,
            },
            f,
        )
    return path


class InferenceRunner:
    """In-process predictor over an exported artifact directory: the
    program alone, or with ``model_builder`` a model rebuilt from code and
    given the artifact's weights."""

    def __init__(self, path: str, model_builder: Optional[Callable[[torch.device], Model]] = None,
                 device=None):
        self.device = resolve_device(device)
        self._load_artifact_meta(path)
        self.model = self._program = None
        if model_builder is None:
            traced = self.metadata.get("device_type")
            if traced != self.device.type:
                raise ValueError(
                    f"the program in {path} was traced for {traced!r} and serves there only "
                    f"(this runner is on {self.device.type!r}): export it again on "
                    f"{self.device.type!r}, or serve it with a model builder")
            self._program = torch.export.load(os.path.join(path, PROGRAM_FILE)).module()
            return
        model = model_builder(self.device)
        # a bf16 weight (a bf16-stored table, weights_dtype) is served as exported
        load_weights(model, self._artifact_state(path))
        self.model = model.to(self.device).eval()

    def _load_artifact_meta(self, path: str) -> None:
        """Schemas, metadata and Categorify mappings: shared by the program
        runner, the builder runner and ``ShardedInferenceRunner``."""
        with open(os.path.join(path, "metadata.json")) as f:
            self.metadata = json.load(f)
        self.input_schema = Schema.from_json(os.path.join(path, "input_schema.json"))
        self.output_schema = Schema.from_json(os.path.join(path, "output_schema.json"))
        self.categories: Dict[str, np.ndarray] = {}
        self._codes: Dict[str, object] = {}
        if self.metadata.get("categories"):
            self.categories = load_categories(os.path.join(path, "categories"))
            # raw → id hash indexes built once (O(V) each): a request's
            # encode is then a vectorised lookup
            self._codes = {k: build_category_codes(v) for k, v in self.categories.items()}

    def _artifact_state(self, path: str) -> Dict[str, torch.Tensor]:
        """The artifact's weights: ``model.pt`` when bundled, else the
        program's own."""
        if self.metadata.get("bundled_params"):
            return torch.load(os.path.join(path, PARAMS_FILE), map_location=self.device,
                              weights_only=True)
        program = torch.export.load(os.path.join(path, PROGRAM_FILE))
        prefix = "model."
        return {k[len(prefix):]: v.to(self.device) for k, v in program.state_dict.items()}

    def _call(self, arrs: Dict[str, torch.Tensor]):
        with torch.inference_mode():
            if self._program is not None:
                return self._program(arrs)
            return self.model(arrs, top_k=self.metadata.get("top_k"))

    def predict(self, batch: Dict[str, object], decode_ids: bool = True,
                encode_inputs: bool = True):
        """Run inference on a dict of (rows, ...) arrays or lists of ragged
        sessions. With bundled Categorify mappings, categorical inputs are
        raw values (0/"" = padding) and, with ``decode_ids``, the top-k ids
        come back raw (ids the mapping cannot invert decode to -1 / "").
        ``encode_inputs=False`` is for callers that ran :meth:`encode`
        already (the HTTP handler): encoding is not idempotent. Returns
        ``(scores, ids)`` numpy arrays for a top-k artifact, else the
        (rows, V) scores."""
        feats = self.metadata["features"]
        dtypes = self.metadata["dtypes"]
        missing = [k for k in feats if k not in batch]
        if missing:
            raise KeyError(f"missing input columns {missing}")
        # the program's inputs in the order it was traced with
        arrs = {
            k: torch.as_tensor(self._densify(
                k, self.encode(k, batch[k]) if encode_inputs else batch[k], feats[k], dtypes[k]
            )).to(self.device)
            for k in feats
        }
        out = self._call(arrs)
        if isinstance(out, (tuple, list)) and len(out) == 2:
            ids = _as_numpy(out[1])
            return _as_numpy(out[0]), self.decode_item_ids(ids) if decode_ids else ids
        return _as_numpy(out)

    # ------------------------------------------------------------ categorify
    def encode(self, name: str, v):
        """Raw values → contiguous ids when a Categorify mapping of ``name``
        is bundled; pass-through otherwise. Raw 0/"" encodes to padding,
        nulls to 1, unseen values to 2, in ragged lists and dense arrays
        alike."""
        if name not in self.categories:
            return v
        codes = self._codes[name]
        if isinstance(v, (list, tuple)) and len(v) and isinstance(
            v[0], (list, tuple, np.ndarray)
        ):
            # a list of sessions stays ragged, even when its lengths agree,
            # so that _densify pads or cuts it to the artifact's length
            return [encode_with_categories(r, codes) for r in v]
        return encode_with_categories(v, codes)

    def decode_item_ids(self, ids: np.ndarray) -> np.ndarray:
        """Predicted contiguous item ids → raw item ids through the bundled
        mapping (the inverse of the ETL's Categorify)."""
        item_col = self.metadata.get("item_id_column")
        if not item_col or item_col not in self.categories:
            return ids
        raw_values = self.categories[item_col]
        idx = np.clip(ids - CATEGORIFY_START_INDEX, 0, len(raw_values) - 1)
        raw = raw_values[idx]
        fill = -1 if np.issubdtype(raw.dtype, np.number) else ""
        return np.where(ids >= CATEGORIFY_START_INDEX, raw, np.asarray(fill, raw.dtype))

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
