"""Tabular core: the dict-of-tensors ("TabularData") compute model.

Counterpart of ``transformers4rec_tpu/tabular/base.py``. Blocks are
``nn.Module``s that take and return ``{name: tensor}``, with the pipeline
``pre → compute → merge_with → post → aggregation``; aggregations are
stateless callables turning the dict into one tensor. ``output_size`` is
analytic from the schema, as in the JAX package.

Transformations (``pre``, ``post``) are given by registered name, as an
instance, or as a list of either. A block keeps them flat, each registered
under the name flax gives a module created inside the block's scope:
``{ClassName}_{i}``, counted per class, ``pre`` before ``post``. The
per-feature weights of ``TabularLayerNorm`` are built from the block's
feature sizes, so ``convert.params_from_jax`` carries them by their JAX
path (``TabularLayerNorm_0/ln_{feature}``). (flax names a lone instance
given as ``pre=`` or ``post=`` after that field instead: such a layer
norm's JAX weights need their path renamed before loading.)
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Union

import torch
from torch import nn

from ..schema import Schema
from ..utils.registry import Registry

TabularData = Dict[str, torch.Tensor]

tabular_aggregation_registry: Registry = Registry("tabular_aggregation")
tabular_transformation_registry: Registry = Registry("tabular_transformation")


class TabularAggregation:
    """Stateless dict→tensor reduction. Subclasses registered by name."""

    def __call__(self, inputs: TabularData) -> torch.Tensor:
        raise NotImplementedError

    def output_size(self, input_sizes: Dict[str, int]) -> int:
        """Final feature dim given per-feature dims."""
        raise NotImplementedError

    @staticmethod
    def _expand_non_sequential(inputs: TabularData) -> TabularData:
        """Broadcast (B, D) features to (B, S, D) when mixed with sequential ones."""
        ndims = {v.dim() for v in inputs.values()}
        if ndims == {2, 3}:
            seq_len = next(v.shape[1] for v in inputs.values() if v.dim() == 3)
            return {
                k: (v[:, None, :].expand(v.shape[0], seq_len, v.shape[1])
                    if v.dim() == 2 else v)
                for k, v in inputs.items()
            }
        return inputs


def parse_aggregation(agg, schema: Optional[Schema] = None) -> Optional[TabularAggregation]:
    if agg is None or isinstance(agg, TabularAggregation):
        return agg
    cls = tabular_aggregation_registry.parse(agg)
    try:
        return cls(schema=schema)
    except TypeError:
        return cls()


class TabularTransformation(nn.Module):
    """dict→dict transformation; random draws come from ``generator``.

    ``build(sizes, stage)`` is called once by the owning block: ``sizes``
    returns the per-feature sizes the transformation will see (``None`` for
    ``pre``, whose raw input columns have no analytic size); transformations
    with per-feature weights create them there."""

    def build(self, sizes: Optional[Callable[[], Dict[str, int]]], stage: str) -> None:
        pass

    def forward(self, inputs: TabularData, training: bool = False,
                pad_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> TabularData:
        raise NotImplementedError


class SequentialTransformation(TabularTransformation):
    """Chain transformations in order."""

    def __init__(self, transformations: Sequence[TabularTransformation] = ()):
        super().__init__()
        self.transformations = nn.ModuleList(transformations)

    def build(self, sizes, stage):
        for t in self.transformations:
            t.build(sizes, stage)

    def forward(self, inputs, training=False, pad_mask=None, generator=None):
        for t in self.transformations:
            inputs = t(inputs, training=training, pad_mask=pad_mask, generator=generator)
        return inputs


def parse_transformation(t, **kwargs):
    """str | instance | sequence → one transformation (a chain for a sequence)."""
    if t is None:
        return None
    if isinstance(t, (list, tuple)):
        return SequentialTransformation([parse_transformation(x, **kwargs) for x in t])
    if isinstance(t, str):
        return tabular_transformation_registry.parse(t)(**kwargs)
    return t


def _leaves(t) -> List[TabularTransformation]:
    if isinstance(t, SequentialTransformation):
        return [leaf for child in t.transformations for leaf in _leaves(child)]
    return [t]


class FilterFeatures:
    """Keep (or, with ``exclude``, drop) a set of keys of a TabularData dict.
    ``pop`` is accepted and does nothing: inputs are never mutated."""

    def __init__(self, to_include: Sequence[str], pop: bool = False, exclude: bool = False):
        self.to_include = list(to_include)
        self.pop = pop
        self.exclude = exclude

    def __call__(self, inputs: TabularData) -> TabularData:
        if self.exclude:
            return {k: v for k, v in inputs.items() if k not in self.to_include}
        return {k: v for k, v in inputs.items() if k in self.to_include}


class TabularBlock(nn.Module):
    """Base for blocks taking and producing TabularData, with the
    ``pre → compute → merge_with → post → aggregation`` pipeline.

    Subclasses implement ``compute(inputs, training, pad_mask, generator)
    -> TabularData`` and ``feature_sizes() -> Dict[str, int]`` (per-feature
    output dims). A subclass with sub-modules passes no ``pre``/``post`` to
    this constructor and calls ``set_transformations(pre, post)`` once they
    exist (a ``post`` layer norm is built from ``feature_sizes()``)."""

    def __init__(self, pre=None, post=None, aggregation=None,
                 schema: Optional[Schema] = None):
        super().__init__()
        self.aggregation = aggregation
        self.schema = schema
        self._pre_names: List[str] = []
        self._post_names: List[str] = []
        if pre is not None or post is not None:
            self.set_transformations(pre, post)

    def set_transformations(self, pre=None, post=None) -> None:
        """Register ``pre`` and ``post`` under flax's names for them."""
        for name in self._pre_names + self._post_names:
            delattr(self, name)
        self._pre_names, self._post_names = [], []
        counts: Dict[str, int] = {}
        for stage, spec, names in (("pre", pre, self._pre_names),
                                   ("post", post, self._post_names)):
            parsed = parse_transformation(spec)
            if parsed is None:
                continue
            for leaf in _leaves(parsed):
                cls = type(leaf).__name__
                name = f"{cls}_{counts.get(cls, 0)}"
                counts[cls] = counts.get(cls, 0) + 1
                leaf.build(self.feature_sizes if stage == "post" else None, stage)
                self.add_module(name, leaf)
                names.append(name)

    def _transform(self, names: List[str], inputs: TabularData, training: bool,
                   pad_mask, generator) -> TabularData:
        for name in names:
            inputs = getattr(self, name)(inputs, training=training, pad_mask=pad_mask,
                                         generator=generator)
        return inputs

    def compute(self, inputs: TabularData, training: bool = False, pad_mask=None,
                generator: Optional[torch.Generator] = None) -> TabularData:
        return inputs

    def feature_sizes(self) -> Dict[str, int]:
        raise NotImplementedError

    def output_size(self) -> int:
        """Aggregated feature dim (analytic)."""
        sizes = self.feature_sizes()
        agg = parse_aggregation(self.aggregation, self.schema)
        if agg is None:
            return sum(sizes.values())
        return agg.output_size(sizes)

    def forward(self, inputs: TabularData, training: bool = False,
                pad_mask: Optional[torch.Tensor] = None,
                merge_with: Optional[Union["TabularBlock", List["TabularBlock"]]] = None,
                aggregation=None, generator: Optional[torch.Generator] = None):
        inputs = self._transform(self._pre_names, inputs, training, pad_mask, generator)
        outputs = self.compute(inputs, training=training, pad_mask=pad_mask, generator=generator)
        if merge_with is not None:
            # a copy: the default compute() returns the caller's dict itself
            outputs = dict(outputs)
            for block in merge_with if isinstance(merge_with, list) else [merge_with]:
                merged = block(inputs, training=training, pad_mask=pad_mask, generator=generator)
                if not isinstance(merged, dict):
                    raise ValueError(f"merge_with block {block!r} returned an aggregated "
                                     "tensor: merged blocks must return TabularData "
                                     "(unset their aggregation)")
                outputs.update(merged)
        outputs = self._transform(self._post_names, outputs, training, pad_mask, generator)
        agg = parse_aggregation(aggregation or self.aggregation, self.schema)
        if agg is not None:
            return agg(outputs)
        return outputs


class MergeTabular(TabularBlock):
    """Run several tabular blocks on the same inputs and merge their output
    dicts; each child gets the pad mask and the generator too."""

    def __init__(self, to_merge: Sequence[TabularBlock] = (), pre=None, post=None,
                 aggregation=None, schema: Optional[Schema] = None):
        super().__init__(aggregation=aggregation, schema=schema)
        self.to_merge = nn.ModuleList(to_merge)
        self.set_transformations(pre, post)

    def compute(self, inputs, training=False, pad_mask=None, generator=None):
        out: TabularData = {}
        for block in self.to_merge:
            out.update(block(inputs, training=training, pad_mask=pad_mask, generator=generator))
        return out

    def feature_sizes(self) -> Dict[str, int]:
        sizes: Dict[str, int] = {}
        for block in self.to_merge:
            sizes.update(block.feature_sizes())
        return sizes


class AsTabular(nn.Module):
    """Wrap a plain tensor back into TabularData under ``output_name``."""

    def __init__(self, output_name: str = "output"):
        super().__init__()
        self.output_name = output_name

    def forward(self, inputs: torch.Tensor, **kwargs) -> TabularData:
        return {self.output_name: inputs}
