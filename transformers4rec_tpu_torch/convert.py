"""Weights from the JAX package into the port's modules.

``params_from_jax(tree)`` takes a flax parameter tree whose leaves the
caller has already turned into numpy arrays, and returns a ``state_dict``
for the port's counterpart module (a whole ``Model``, or a lone
``TransformerEncoder``). It needs no JAX. The layout rules:

- ``nn.Dense`` kernels are (in, out), the transpose of ``nn.Linear.weight``;
- the q/k/v ``DenseGeneral`` kernels are (D, H, Dh) with (H, Dh) biases, and
  ``out`` is (H, Dh, D): they flatten the heads into one (D, D) Linear;
- LayerNorm ``scale`` is ``weight``;
- the relative-bias table stays (buckets, H), and embedding tables keep their
  padded row count.

Load the result with ``module.load_state_dict(sd)`` (strict, so a missing
or extra weight is an error). Training adds no weights, so the same rules
serve it.

``masking_info_from_jax(targets, mask, pad_mask)`` turns the arrays of the
JAX package's ``MaskingInfo`` (numpy) into the port's, to give both packages
the same mask (``Model(..., masking_info=...)``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from .masking import MaskingInfo

_INDEXED = {"heads": "heads", "blocks": "blocks", "tasks": "tasks",
            "projection": "projections", "layer": "layers"}


def _segment(seg: str, parent: str) -> str:
    m = re.fullmatch(r"(heads|blocks|tasks|projection|layer)_(\d+)", seg)
    if m:
        return f"{_INDEXED[m.group(1)]}.{m.group(2)}"
    if seg == "TransformerEncoder_0":
        return "encoder"
    return seg


def _leaf(name: str, parent: str, value: np.ndarray):
    v = np.asarray(value)
    if parent == "categorical_module" and name.endswith("_table"):
        return "tables." + name[: -len("_table")], v
    if name == "kernel":
        if v.ndim == 3 and parent == "out":  # (H, Dh, D)
            v = v.reshape(-1, v.shape[-1]).T
        elif v.ndim == 3:  # q/k/v: (D, H, Dh)
            v = v.reshape(v.shape[0], -1).T
        else:
            v = v.T
        return "weight", v
    if name == "bias" and v.ndim == 2:  # (H, Dh)
        return "bias", v.reshape(-1)
    if name == "scale":
        return "weight", v
    return name, v


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax params (numpy leaves) → the port's ``state_dict``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str, parent: str):
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, prefix + _segment(key, parent) + ".", key)
            else:
                name, arr = _leaf(key, parent, val)
                out[prefix + name] = torch.from_numpy(np.ascontiguousarray(arr).copy())

    walk(tree, "", "")
    return out


def masking_info_from_jax(targets, mask, pad_mask=None, device=None) -> MaskingInfo:
    """numpy ``(targets, mask, pad_mask)`` of a JAX ``MaskingInfo`` → the
    port's ``MaskingInfo`` on ``device``. Under MLM the positions replaced by
    the [MASK] embedding are the target positions."""
    m = torch.from_numpy(np.asarray(mask).astype(bool)).to(device)
    return MaskingInfo(
        targets=torch.from_numpy(np.asarray(targets).astype(np.int64)).to(device),
        mask=m, input_schema=m,
        pad_mask=(None if pad_mask is None
                  else torch.from_numpy(np.asarray(pad_mask).astype(bool)).to(device)),
    )
