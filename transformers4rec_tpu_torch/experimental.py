"""Experimental blocks.

Counterpart of ``transformers4rec_tpu/experimental.py``:
``PostContextFusion``, a Latent-Cross style fusion of a context
representation into the sequential module's output just before the
prediction tasks (Beutel et al.).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .blocks.transformer import Linear, init_dense_

FUSIONS = ("concat", "elementwise-mul", "elementwise-sum")


class PostContextFusion(nn.Module):
    """Fuse a context representation into the sequential module's output.

    ``sequential_module``: a block returning ``(hidden (B, S, D), info)``
    (e.g. a ``SequentialBlock`` of an input module and a transformer) or a
    tensor. ``post_context_module``: a block over the same inputs returning
    (B, C) or (B, S, C) context, or ``(hidden, info)`` whose hidden is taken
    (a sequence input module with an aggregation); a dict (a block without
    one) raises. A (B, C) context is broadcast over the S positions.
    ``fusion_aggregation``: ``"elementwise-mul"`` (``seq * (1 + ctx)``) and
    ``"elementwise-sum"`` (``seq + ctx``) first project the context to D
    through ``context_projection`` (a Dense, flax's initialiser and name);
    ``"concat"`` appends it (D + C wide). Returns ``(fused, info)`` when the
    sequential module gives an info, else the fused tensor."""

    def __init__(self, sequential_module: nn.Module, post_context_module: nn.Module,
                 fusion_aggregation: str = "elementwise-mul"):
        super().__init__()
        if fusion_aggregation not in FUSIONS:
            raise ValueError(f"The aggregation {fusion_aggregation} is not supported; "
                             f"use one of {list(FUSIONS)}")
        self.sequential_module = sequential_module
        self.post_context_module = post_context_module
        self.fusion_aggregation = fusion_aggregation
        if fusion_aggregation.startswith("elementwise"):
            self.context_projection = Linear(post_context_module.output_size(),
                                             sequential_module.output_size())

    @property
    def blocks(self):
        """The sequential module's blocks, so that a ``Head`` whose body this
        is finds its input module (``Head.input_module``, the first)."""
        return self.sequential_module.blocks

    def _init_weights(self, generator: torch.Generator) -> None:
        if self.fusion_aggregation.startswith("elementwise"):
            init_dense_(self.context_projection, generator)

    def output_size(self) -> int:
        seq_dim = self.sequential_module.output_size()
        if self.fusion_aggregation == "concat":
            return seq_dim + self.post_context_module.output_size()
        return seq_dim

    def forward(self, inputs, training: bool = False, testing: bool = False,
                generator: Optional[torch.Generator] = None, **kwargs):
        """``kwargs`` (``pad_mask``, ``masking_info``, ...) go to the
        sequential module; both modules draw from ``generator``."""
        seq_out = self.sequential_module(inputs, training=training, testing=testing,
                                         generator=generator, **kwargs)
        seq_rep, info = seq_out if isinstance(seq_out, tuple) else (seq_out, None)
        ctx = self.post_context_module(inputs, training=training, generator=generator)
        if isinstance(ctx, tuple):  # (hidden, info) from a sequence input block
            ctx = ctx[0]
        if isinstance(ctx, dict):
            raise ValueError("post_context_module must aggregate to a single array "
                             "(set aggregation='concat' on the block)")
        if ctx.dim() == 2:
            ctx = ctx[:, None, :].expand(ctx.shape[0], seq_rep.shape[1], ctx.shape[-1])
        if self.fusion_aggregation == "concat":
            out = torch.cat([seq_rep, ctx], dim=-1)
        else:
            ctx = self.context_projection(ctx)
            out = seq_rep * (1.0 + ctx) if self.fusion_aggregation == "elementwise-mul" \
                else seq_rep + ctx
        return (out, info) if info is not None else out
