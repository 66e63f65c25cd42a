"""Block composition: SequentialBlock and TransformerBlock.

Counterpart of ``transformers4rec_tpu/blocks/base.py``. Shape propagation is
analytic through ``output_size()``; the sequential pipeline threads
``(hidden, MaskingInfo)`` explicitly.

Not ported yet: ``Block``, ``MLPBlock`` and ``RNNBlock``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..config.transformer import T4RecConfig
from ..masking import MaskingInfo

class TransformerBlock(nn.Module):
    """Adapter from the tabular-sequence pipeline into the unified encoder.
    Accepts a ``T4RecConfig`` or a prebuilt ``TransformerEncoder``."""

    def __init__(self, transformer: Union[T4RecConfig, nn.Module]):
        super().__init__()
        if isinstance(transformer, T4RecConfig):
            transformer = transformer.to_encoder()
        self._d_model = transformer.d_model
        self.encoder = transformer

    def output_size(self) -> int:
        return self._d_model

    def forward(
        self,
        inputs: Union[torch.Tensor, Tuple[torch.Tensor, Optional[MaskingInfo]]],
        pad_mask: Optional[torch.Tensor] = None,
        training: bool = False,
        testing: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        info: Optional[MaskingInfo] = None
        if isinstance(inputs, tuple):
            inputs, info = inputs
        perm_mask = info.perm_mask if info is not None else None
        segment_ids = info.segment_ids if info is not None else None
        if info is not None and info.pad_mask is not None:
            # the scheme's pad mask tracks the MLM inference [MASK] extension
            pad_mask = info.pad_mask
        return self.encoder(
            inputs, pad_mask=pad_mask, perm_mask=perm_mask,
            segment_ids=segment_ids, training=training, generator=generator,
        )


class SequentialBlock(nn.Module):
    """Chain blocks, threading ``(hidden, MaskingInfo)`` through. The input
    module (TabularSequenceFeatures) returns a tuple; downstream blocks get
    the tensor plus the side-channel info."""

    def __init__(self, blocks: Sequence[nn.Module] = ()):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)

    def output_size(self) -> int:
        for block in reversed(self.blocks):
            size = getattr(block, "output_size", None)
            if size is not None:
                out = size() if callable(size) else size
                if out:
                    return out
        raise ValueError("No block in this SequentialBlock declares an output size")

    def forward(self, inputs, training: bool = False, testing: bool = False,
                pad_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                masking_info: Optional[MaskingInfo] = None):
        """``generator`` feeds every random draw of a training forward (the
        mask, then dropout); ``masking_info`` hands the input module a ready
        mask instead of a drawn one."""
        x = inputs
        info: Optional[MaskingInfo] = None
        for i, block in enumerate(self.blocks):
            if isinstance(block, TransformerBlock):
                x = block((x, info), pad_mask=pad_mask, training=training, testing=testing,
                          generator=generator)
            elif i == 0:
                x = block(x, training=training, testing=testing, generator=generator,
                          masking_info=masking_info)
            else:
                x = block(x, training=training, testing=testing)
            if isinstance(x, tuple):
                x, maybe_info = x
                if maybe_info is not None:
                    info = maybe_info
        return x, info
