"""Which parameters are embedding tables.

Counterpart of ``transformers4rec_tpu/ops/sparse_update.py:label_embedding_params``:
the labels that route every embedding table (not only the item table) to the
table optimizer and everything else to the dense one. The lazy and sparse
row-wise optimizers of that module are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch


def label_embedding_params(named_parameters: Iterable[Tuple[str, torch.Tensor]],
                           pattern: str = "_table") -> Dict[str, str]:
    """``{name: "table" | "dense"}``. A parameter is a table when its name
    contains ``pattern``. The reference names a table ``<feature>_table``; the
    port keeps its tables in ``EmbeddingFeatures.tables`` (``...tables.<feature>``),
    which the default pattern matches too."""
    def is_table(name: str) -> bool:
        if pattern in name:
            return True
        return pattern == "_table" and ("tables." in name)

    return {name: "table" if is_table(name) else "dense" for name, _ in named_parameters}
