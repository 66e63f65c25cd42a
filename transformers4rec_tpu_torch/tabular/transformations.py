"""Tabular transformations: swap noise, per-feature LayerNorm, dropout.

Counterpart of ``transformers4rec_tpu/tabular/transformations.py``.

Swap noise is two plain functions: ``swap_noise_draw`` makes the random
part, ``(source index, swap mask)`` for one feature, from a
``torch.Generator``; ``swap_noise_apply`` is deterministic,
``val.where(~swap, flat[src])``. ``StochasticSwapNoise`` draws for every
feature and applies; a caller that must give two models the same noise
(the card against the CPU, the port against the JAX package) sets
``draws`` to ``{feature: (src, swap)}`` and the module applies those
instead of drawing.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..blocks.transformer import dropout, promote
from .base import TabularData, TabularTransformation, tabular_transformation_registry


def _reserved(key: str) -> bool:
    """Batch keys that are no feature: session packing's ``segment_ids`` and
    the trainer's ``__``-prefixed side channels pass through untouched."""
    return key == "segment_ids" or key.startswith("__")


def swap_noise_mask(val: torch.Tensor, pad_mask: Optional[torch.Tensor],
                    pad_token: int = 0) -> torch.Tensor:
    """Where a feature may be swapped: the shared pad mask when it matches
    the feature's leading dims, else the feature's own non-pad values."""
    if pad_mask is not None and tuple(val.shape[: pad_mask.dim()]) == tuple(pad_mask.shape):
        return pad_mask
    if val.dim() == 3:
        return (val != pad_token).any(dim=-1)
    return val != pad_token


def swap_noise_draw(mask: torch.Tensor, replacement_prob: float,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One feature's draw, as the JAX package makes it: a random order of
    the valid positions (Gumbel scores, the others at -inf, sorted
    descending), a pick with replacement among the first ``num_valid`` of
    that order for every position, and a Bernoulli(``replacement_prob``)
    swap restricted to valid positions. Returns ``(src, swap)``: flat source
    indices (``mask.numel()``,) and the swap mask (``mask``'s shape)."""
    dev = mask.device
    flat = mask.reshape(-1)
    n = flat.numel()
    u = torch.rand(n, generator=generator, device=dev).clamp_min(torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    scores = torch.where(flat, gumbel, torch.full_like(gumbel, -float("inf")))
    order = torch.argsort(-scores)
    num_valid = flat.sum().clamp_min(1)
    pick = torch.randint(0, n, (n,), generator=generator, device=dev) % num_valid
    src = order[pick]
    swap = (torch.rand(mask.shape, generator=generator, device=dev) < replacement_prob) & mask
    return src, swap


def swap_noise_apply(val: torch.Tensor, src: torch.Tensor, swap: torch.Tensor) -> torch.Tensor:
    """Replace ``val`` at ``swap`` by the values at ``src`` (flat indices
    over ``swap``'s positions; a 3-D value moves its trailing vector)."""
    flat = val.reshape(-1, val.shape[-1]) if val.dim() == swap.dim() + 1 else val.reshape(-1)
    replaced = flat[src].reshape(val.shape)
    if val.dim() == swap.dim() + 1:
        swap = swap[..., None]
    return val.where(~swap, replaced)


@tabular_transformation_registry.register("stochastic-swap-noise", "ssn")
class StochasticSwapNoise(TabularTransformation):
    """Replace each feature value with a random other (non-pad) value of the
    same feature with probability ``replacement_prob``; training only."""

    def __init__(self, pad_token: int = 0, replacement_prob: float = 0.1):
        super().__init__()
        self.pad_token = pad_token
        self.replacement_prob = replacement_prob
        # {feature: (src, swap)} given by a caller, applied instead of a draw
        self.draws: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None

    def draw(self, inputs: TabularData, pad_mask: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """``{feature: (src, swap)}`` for every feature of ``inputs``, in
        their order, from ``generator``."""
        return {key: swap_noise_draw(swap_noise_mask(val, pad_mask, self.pad_token),
                                     self.replacement_prob, generator)
                for key, val in inputs.items() if not _reserved(key)}

    def forward(self, inputs, training=False, pad_mask=None, generator=None):
        if not training:
            return inputs
        draws = self.draws if self.draws is not None else self.draw(inputs, pad_mask, generator)
        return {key: val if _reserved(key) else swap_noise_apply(val, *draws[key])
                for key, val in inputs.items()}


@tabular_transformation_registry.register("layer-norm")
class TabularLayerNorm(TabularTransformation):
    """One LayerNorm (``eps`` 1e-6, flax's) per float feature over its last
    dim; features whose last dim is 1 pass through. The norms are built for
    the block's feature sizes and named ``ln_{feature}``."""

    def __init__(self, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.keys: Tuple[str, ...] = ()

    def build(self, sizes, stage):
        if sizes is None:
            raise NotImplementedError(
                "layer-norm as a pre transformation (on the raw input columns) is not ported"
            )
        for key, dim in sizes().items():
            if dim > 1:
                if "." in key:
                    raise ValueError(f"feature name {key!r}: a '.' cannot name a module")
                self.add_module(f"ln_{key}", nn.LayerNorm(dim, eps=self.eps))
                self.keys += (key,)

    def forward(self, inputs, training=False, pad_mask=None, generator=None):
        out = {}
        for key, val in inputs.items():
            if key in self.keys and val.is_floating_point():
                # a bf16 lookup is normalised in f32, as flax promotes it
                ln = getattr(self, f"ln_{key}")
                out[key] = ln(promote(val, ln.weight))
            else:
                out[key] = val
        return out


@tabular_transformation_registry.register("dropout")
class TabularDropout(TabularTransformation):
    """Inverted dropout on every float feature, drawn from the generator."""

    def __init__(self, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate

    def forward(self, inputs, training=False, pad_mask=None, generator=None):
        return {k: dropout(v, self.dropout_rate, training, generator)
                if v.is_floating_point() else v
                for k, v in inputs.items()}
