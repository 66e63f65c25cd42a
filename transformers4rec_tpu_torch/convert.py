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

Every registered arch is carried (XLNet, GPT-2, the BERT family,
TransfoXL, Reformer), with the input options of the paper's command line.
Reformer's LSH layers (``attn/qk``, ``attn/v``, ``attn/out``) take the
q/k/v rules and its axial positions keep their names (``axial_pos_0``,
``axial_pos_1``). An LSH layer's rotations are a constant of the JAX
layer's seed, not in the flax tree: ``params_from_jax(...,
lsh_rotations={"layer_1": R})`` gives each LSH layer of that flax name its
(Dh, rounds, buckets / 2) buffer ``attn.rotations``; ``params_to_jax``
leaves the buffers out. An ``RNNBlock``'s flax cells (``GRUCell_{i}``,
``OptimizedLSTMCell_{i}``, one per layer, their gates' kernels (in, out))
become the port's ``gru_{i}``/``lstm_{i}`` (one ``nn.GRU``/``nn.LSTM``
each: ``weight_ih_l0``, ``weight_hh_l0``, ``bias_ih_l0``, ``bias_hh_l0``),
the gates stacked in torch's order (GRU r, z, n from ``ir``/``hr``,
``iz``/``hz``, ``in``/``hn``; LSTM i, f, g, o), the biases flax has not at
zero.
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

A bf16 leaf (``ml_dtypes.bfloat16`` numpy: a JAX trainer's tables under
``embedding_table_dtype="bf16"``) becomes a ``torch.bfloat16`` tensor of the
same bits, and ``params_to_jax`` gives a bf16 weight back as an
``ml_dtypes.bfloat16`` leaf. A module loads a bf16 table into a bf16
parameter (``trainer.cast_tables_`` makes its tables so first).

Load the result with ``module.load_state_dict(sd)`` (strict, so a missing
or extra weight is an error). Training adds no weights, so the same rules
serve it. ``params_to_jax(state_dict, template)`` goes the other way: the
port's weights into a tree shaped like a flax ``template`` (numpy leaves),
every leaf found and every weight used.

``masking_info_from_jax(targets, mask, pad_mask, input_schema=None,
perm_mask=None, neg_ids=None)`` turns the arrays of the JAX package's ``MaskingInfo``
(numpy) into the port's, to give both packages the same mask
(``Model(..., masking_info=...)``).

``sparse_state_from_jax(state)`` turns a JAX ``SparseRowsAdamState`` or
``SparseRowsAdafactorState`` (its fields as numpy arrays; bf16 moments as
``ml_dtypes.bfloat16``) into the port's, so that an update can start from
the same nonzero state in both packages.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .masking import MaskingInfo
from .ops.sparse_update import SparseRowsAdafactorState, SparseRowsAdamState

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


# torch's gate order per cell, each gate's flax (input, recurrent) names
_RNN_GATES = {"gru": (("ir", "hr"), ("iz", "hz"), ("in", "hn")),
              "lstm": (("ii", "hi"), ("if", "hf"), ("ig", "hg"), ("io", "ho"))}
_RNN_CELL = {"GRUCell": "gru", "OptimizedLSTMCell": "lstm"}


def _rnn_cells(tree: Mapping, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], str]]:
    """(path of each flax RNN cell, ``"gru"`` or ``"lstm"``)."""
    for key, val in tree.items():
        if not isinstance(val, Mapping):
            continue
        m = re.fullmatch(r"(GRUCell|OptimizedLSTMCell)_\d+", key)
        if m and set(val) == {g for pair in _RNN_GATES[_RNN_CELL[m.group(1)]] for g in pair}:
            yield path + (key,), _RNN_CELL[m.group(1)]
        else:
            yield from _rnn_cells(val, path + (key,))


def _rnn_prefix(path: Tuple[str, ...], kind: str) -> str:
    """The port's name of a cell's layer: ``GRUCell_1`` → ``gru_1``."""
    index = path[-1].rsplit("_", 1)[1]
    return "".join(_segment(seg, "") + "." for seg in path[:-1]) + f"{kind}_{index}."


def _rnn_from_jax(cell: Mapping, kind: str) -> Dict[str, np.ndarray]:
    """A flax cell's gates → one torch layer's four tensors."""
    gates = _RNN_GATES[kind]
    w_ih = np.concatenate([np.asarray(cell[i]["kernel"]).T for i, _ in gates])
    w_hh = np.concatenate([np.asarray(cell[h]["kernel"]).T for _, h in gates])
    zeros = [np.zeros(w_hh.shape[1], w_hh.dtype)] * len(gates)
    b_ih = [np.asarray(cell[i]["bias"]) if "bias" in cell[i] else z
            for (i, _), z in zip(gates, zeros)]
    b_hh = [np.asarray(cell[h]["bias"]) if "bias" in cell[h] else z
            for (_, h), z in zip(gates, zeros)]
    return {"weight_ih_l0": w_ih, "weight_hh_l0": w_hh,
            "bias_ih_l0": np.concatenate(b_ih), "bias_hh_l0": np.concatenate(b_hh)}


def _rnn_to_jax(state_dict: Mapping[str, torch.Tensor], prefix: str, template: Mapping,
                kind: str) -> Tuple[Dict, set]:
    """One torch layer's tensors → a flax cell shaped like ``template``;
    also the names it used."""
    gates = _RNN_GATES[kind]
    names = {k: prefix + k for k in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")}
    t = {k: state_dict[n].detach().cpu().numpy() for k, n in names.items()}
    n = len(gates)
    cell: Dict = {}
    for g, (i, h) in enumerate(gates):
        for flax_name, w, b in ((i, "weight_ih_l0", "bias_ih_l0"),
                                (h, "weight_hh_l0", "bias_hh_l0")):
            leaf = {"kernel": np.ascontiguousarray(np.split(t[w], n)[g].T)}
            if "bias" in template[flax_name]:
                leaf["bias"] = np.ascontiguousarray(np.split(t[b], n)[g])
            cell[flax_name] = leaf
    return cell, set(names.values())


def params_from_jax(tree: Mapping, shard: Optional[Tuple[int, int]] = None,
                    sharded_tables: Sequence[str] = (),
                    lsh_rotations: Optional[Mapping[str, np.ndarray]] = None
                    ) -> Dict[str, torch.Tensor]:
    """flax params (numpy leaves) → the port's ``state_dict``. With
    ``shard=(rank, world)``, the tables named in ``sharded_tables`` keep this
    rank's rows only (their rows must divide by ``world``).
    ``lsh_rotations`` maps a flax layer name (``"layer_1"``) to the
    rotations of the LSH layers of that name."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    rnn = dict(_rnn_cells(tree))
    for path, kind in rnn.items():
        for key, arr in _rnn_from_jax(_get(tree, path), kind).items():
            out[_rnn_prefix(path, kind) + key] = _tensor(arr)
    for path, (name, key, parent) in _port_names(tree).items():
        if any(path[:len(p)] == p for p in rnn):
            continue
        if path[-3:] == ("attn", "qk", "kernel") and lsh_rotations \
                and path[-4] in lsh_rotations:
            out[name[:-len("qk.weight")] + "rotations"] = torch.from_numpy(
                np.array(lsh_rotations[path[-4]], dtype=np.float32))
        leaf, arr = _leaf(key, parent, _get(tree, path))
        if shard is not None and leaf.startswith("tables.") \
                and leaf[len("tables."):] in sharded_tables:
            rank, world = shard
            if arr.shape[0] % world:
                raise ValueError(f"table {name}: {arr.shape[0]} rows do not divide by {world}")
            rows = arr.shape[0] // world
            arr = arr[rank * rows:(rank + 1) * rows]
        out[name] = _tensor(arr)
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
    rnn = dict(_rnn_cells(tree))
    for path, kind in rnn.items():
        node = out
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]], names_used = _rnn_to_jax(state_dict, _rnn_prefix(path, kind),
                                                 _get(tree, path), kind)
        used |= names_used
    for path, (name, key, parent) in names.items():
        if any(path[:len(p)] == p for p in rnn):
            continue
        if name not in state_dict:
            raise KeyError(f"no weight {name} for {'/'.join(path)}")
        shape = np.shape(_get(tree, path))
        v = _array(state_dict[name])
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
    # an LSH layer's rotations are constants, not flax params
    extra = sorted(n for n in set(state_dict) - used if not n.endswith("attn.rotations"))
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


def _tensor(a, device=None) -> torch.Tensor:
    """A numpy array as a tensor of its own (a copy) on ``device``. torch
    takes no ``ml_dtypes`` bfloat16 array: one is carried through float32,
    exactly, to ``torch.bfloat16``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _array(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 as an ``ml_dtypes`` bfloat16 array of the same
    bits (numpy has no bfloat16 of its own; ``ml_dtypes`` comes with JAX)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def sparse_state_from_jax(state, device=None):
    """A JAX sparse-rows state (a ``NamedTuple`` with numpy fields: ``count``
    and ``mu``, ``nu``, or ``v``) → the port's ``SparseRowsAdamState`` or
    ``SparseRowsAdafactorState`` on ``device``, moments in their dtype."""
    count = torch.tensor(int(np.asarray(state.count)), dtype=torch.int32, device=device)
    if hasattr(state, "v"):
        return SparseRowsAdafactorState(count=count, v=_tensor(state.v, device))
    return SparseRowsAdamState(count=count, mu=_tensor(state.mu, device),
                               nu=_tensor(state.nu, device))
