"""Model-parallel serving: one process scores an exported artifact with its
item table split over several devices.

Counterpart of ``transformers4rec_tpu/serving/sharded.py``. The artifact
must have been exported with ``bundle_params=True``: the runner rebuilds
the model with its builder, loads ``model.pt`` into it and then splits the tied item
table into ``model_axis`` row shards, shard i on ``cuda:(i mod cards)``
(on the CPU with ``device="cpu"``), by the training layout's rule
(``parallel.mesh.shards_rows``: at least ``MIN_ROWS_TO_SHARD`` rows that
divide the shard count; else the table stays whole). The item lookup and
the top-k then run the group-less, shards-in-one-process forms of
``parallel.sharded_embedding``: ``sharded_embedding_lookup`` sums each
shard's masked gather, ``sharded_topk`` takes a local top-k on each
shard's device and merges the candidates; the (V, E) table is never put
back together. ``predict()`` is ``InferenceRunner``'s; the HTTP daemon takes
it through ``--model-axis``.

The whole table passes through the first device while the artifact loads.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..model.base import Model
from ..parallel.mesh import shards_rows
from .export import InferenceRunner


class ShardedInferenceRunner(InferenceRunner):
    """``InferenceRunner`` with the tied item table split into
    ``model_axis`` shards (default: every card of the machine)."""

    def __init__(self, path: str, model_builder: Callable[[torch.device], Model],
                 model_axis: Optional[int] = None, device=None):
        self._load_artifact_meta(path)
        if not self.metadata.get("bundled_params"):
            raise ValueError(
                "artifact has no bundled params — re-export with "
                "export_model(..., bundle_params=True) to serve model-parallel")
        super().__init__(path, model_builder, device=device)
        cuda = self.device.type == "cuda"
        cards = torch.cuda.device_count() if cuda else 1
        n = model_axis or cards
        devices = [torch.device("cuda", i % cards) if cuda else self.device for i in range(n)]
        self.model_axis = n
        self.sharded = False
        for head in self.model.heads:
            im = head.input_module
            cat = getattr(im, "categorical_module", None)
            item = getattr(im, "item_id", None)
            if cat is None or item not in getattr(cat, "tables", {}):
                continue
            if shards_rows(cat.tables[item].shape[0], n):
                cat.split_table(item, devices)
                self.sharded = True

