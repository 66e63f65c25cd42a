"""Weights from the JAX package into the port's modules.

``params_from_jax(tree)`` takes a flax parameter tree whose leaves the
caller has already turned into numpy arrays, and returns a ``state_dict``
for the port's counterpart module (a whole ``Model``, or a lone
``TransformerEncoder``). It needs no JAX. The layout rules:

- ``nn.Dense`` kernels are (in, out), the transpose of ``nn.Linear.weight``;
- the q/k/v ``DenseGeneral`` kernels are (D, H, Dh) with (H, Dh) biases, and
  ``out`` is (H, Dh, D): they flatten the heads into one (D, D) Linear;
- LayerNorm ``scale`` is ``weight``;
- the relative-bias table stays (buckets, H), the learned absolute positions
  keep their name and shape (``position_embedding`` (max_position, D), the
  port's ``encoder.position_embedding``), so does the two-stream query
  stream's start vector (``query_stream_init`` (D,), the port's
  ``encoder.query_stream_init``), and embedding tables keep their padded
  row count.

Every registered arch but Reformer is carried (XLNet, GPT-2, the BERT
family, TransfoXL), with the input options of the paper's command line.
These weights keep their flax names in the port's modules, so they need
no rule of their own: ALBERT's one shared layer (``layer_shared``, the
port's ``encoder.layer_shared``), the BERT family's embedding LayerNorm
(``ln_emb``), the per-feature LayerNorms
(``TabularLayerNorm_{i}/ln_{feature}``), the continuous projection
(``continuous_projection_{i}``), soft embeddings
(``soft_{column}/projection`` and ``soft_{column}/embedding_table``),
pretrained tables and their projections (``{column}_pretrained``,
``{column}_proj``), an ``MLPBlock``'s ``dense_{i}`` and ``norm_{i}``, and
the prediction tasks' ``task_block_{i}``, the dense tasks' ``output``
layer and the untied ``output_layer`` (target_dim, d_model), a bare param
that keeps its layout (a Head's ``tasks_{i}`` becomes ``tasks.{i}``).
The sequence projection ``projection_{i}`` becomes ``projections.{i}`` and a
``MergeTabular``'s ``to_merge_{i}`` becomes ``to_merge.{i}``.

``params_from_jax(tree, shard=(rank, world), sharded_tables=("item_id",))``
keeps rows ``[rank·V_l, (rank+1)·V_l)`` of the named tables, for a module
that holds them as shards (a vocab-parallel model shards its item table).

Load the result with ``module.load_state_dict(sd)`` (strict, so a missing
or extra weight is an error). Training adds no weights, so the same rules
serve it. ``params_to_jax(state_dict, template)`` goes the other way: the
port's weights into a tree shaped like a flax ``template`` (numpy leaves),
every leaf found and every weight used.

``masking_info_from_jax(targets, mask, pad_mask, input_schema=None,
perm_mask=None, neg_ids=None)`` turns the arrays of the JAX package's ``MaskingInfo``
(numpy) into the port's, to give both packages the same mask
(``Model(..., masking_info=...)``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .masking import MaskingInfo

_INDEXED = {"heads": "heads", "blocks": "blocks", "tasks": "tasks",
            "projection": "projections", "layer": "layers", "to_merge": "to_merge"}


def _segment(seg: str, parent: str) -> str:
    m = re.fullmatch(r"(heads|blocks|tasks|projection|layer|to_merge)_(\d+)", seg)
    if m:
        return f"{_INDEXED[m.group(1)]}.{m.group(2)}"
    if seg == "TransformerEncoder_0":
        return "encoder"
    return seg


def _leaf_name(name: str, parent: str) -> str:
    if parent == "categorical_module" and name.endswith("_table"):
        return "tables." + name[: -len("_table")]
    if name in ("kernel", "scale"):
        return "weight"
    return name


def _leaf(name: str, parent: str, value: np.ndarray):
    v = np.asarray(value)
    if name == "kernel":
        if v.ndim == 3 and parent == "out":  # (H, Dh, D)
            v = v.reshape(-1, v.shape[-1]).T
        elif v.ndim == 3:  # q/k/v: (D, H, Dh)
            v = v.reshape(v.shape[0], -1).T
        else:
            v = v.T
    elif name == "bias" and v.ndim == 2:  # (H, Dh)
        v = v.reshape(-1)
    return _leaf_name(name, parent), v


def params_from_jax(tree: Mapping, shard: Optional[Tuple[int, int]] = None,
                    sharded_tables: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """flax params (numpy leaves) → the port's ``state_dict``. With
    ``shard=(rank, world)``, the tables named in ``sharded_tables`` keep this
    rank's rows only (their rows must divide by ``world``)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, (name, key, parent) in _port_names(tree).items():
        leaf, arr = _leaf(key, parent, _get(tree, path))
        if shard is not None and leaf.startswith("tables.") \
                and leaf[len("tables."):] in sharded_tables:
            rank, world = shard
            if arr.shape[0] % world:
                raise ValueError(f"table {name}: {arr.shape[0]} rows do not divide by {world}")
            rows = arr.shape[0] // world
            arr = arr[rank * rows:(rank + 1) * rows]
        out[name] = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return out


def _port_names(tree: Mapping) -> Dict[Tuple[str, ...], Tuple[str, str, str]]:
    """{flax leaf path: (port name, leaf key, parent key)}."""
    out: Dict[Tuple[str, ...], Tuple[str, str, str]] = {}

    def walk(node: Mapping, path: Tuple[str, ...], prefix: str, parent: str):
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, path + (key,), prefix + _segment(key, parent) + ".", key)
            else:
                out[path + (key,)] = (prefix + _leaf_name(key, parent), key, parent)

    walk(tree, (), "", "")
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor], template: Mapping) -> Dict:
    """The port's ``state_dict`` → a flax parameter tree (numpy leaves)
    shaped like ``template`` (e.g. the JAX model's ``init``), undoing the
    layout rules of ``params_from_jax``. Raises unless every template leaf
    has its weight, of its shape, and every weight is used."""
    wrapped = set(template) == {"params"}
    tree = template["params"] if wrapped else template
    names = _port_names(tree)
    used = set()
    out: Dict = {}
    for path, (name, key, parent) in names.items():
        if name not in state_dict:
            raise KeyError(f"no weight {name} for {'/'.join(path)}")
        shape = np.shape(_get(tree, path))
        v = state_dict[name].detach().cpu().numpy()
        if key == "kernel":
            v = v.T.reshape(shape)
        elif key == "bias" and len(shape) == 2:
            v = v.reshape(shape)
        if v.shape != shape:
            raise ValueError(f"{name}: shape {v.shape}, the template's {shape}")
        node = out
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = np.ascontiguousarray(v)
        used.add(name)
    extra = sorted(set(state_dict) - used)
    if extra:
        raise KeyError(f"weights without a place in the template: {extra}")
    return {"params": out} if wrapped else out


def _get(tree: Mapping, path: Tuple[str, ...]):
    for seg in path:
        tree = tree[seg]
    return tree


def masking_info_from_jax(targets, mask, pad_mask=None, device=None,
                          input_schema=None, perm_mask=None, neg_ids=None) -> MaskingInfo:
    """numpy ``(targets, mask, pad_mask)`` of a JAX ``MaskingInfo`` → the
    port's ``MaskingInfo`` on ``device``. ``input_schema`` defaults to the
    mask: under MLM and PLM the positions replaced by the [MASK] embedding
    are the target positions. CLM's last-item branches keep the whole
    non-pad mask there, so their caller passes it. PLM's caller passes its
    ``perm_mask`` (B, S, S), sampled softmax's its negatives ``neg_ids``
    (n,)."""
    def as_bool(a):
        return torch.from_numpy(np.asarray(a).astype(bool)).to(device)

    m = as_bool(mask)
    return MaskingInfo(
        targets=torch.from_numpy(np.asarray(targets).astype(np.int64)).to(device),
        mask=m, input_schema=m if input_schema is None else as_bool(input_schema),
        pad_mask=None if pad_mask is None else as_bool(pad_mask),
        perm_mask=None if perm_mask is None else torch.from_numpy(
            np.array(perm_mask, dtype=np.float32)).to(device),
        neg_ids=None if neg_ids is None else torch.from_numpy(
            np.asarray(neg_ids).astype(np.int64)).to(device),
    )
