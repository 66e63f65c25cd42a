"""Block composition: SequentialBlock, TransformerBlock, MLPBlock, RNNBlock
and Block.

Counterpart of ``transformers4rec_tpu/blocks/base.py``. Shape propagation is
analytic through ``output_size()``; the sequential pipeline threads
``(hidden, MaskingInfo)`` explicitly.

``check_masking_compat`` holds the arch against the masking scheme where
``TransformerBlock`` resolves a config, as in the JAX package.

``MLPBlock`` is Dense → activation → LayerNorm (flax's, eps 1e-6, with
``use_norm``) → dropout per layer, its weights ``dense_{i}`` and
``norm_{i}`` as in the JAX package; ``Head.from_body(extra_blocks=...)``
puts it between the input module and the transformer.

``RNNBlock`` is the GRU4Rec-style recurrent body: ``num_layers`` GRU or LSTM
layers of ``units``, each one single-layer ``nn.GRU``/``nn.LSTM``
(``batch_first``) named as flax names it (``gru_{i}``, ``lstm_{i}``),
dropout between layers drawn from the forward's generator. Flax's cells
carry fewer biases than torch's: the GRU has no bias on the recurrent
reset and update gates (``b_hr = b_hz = 0``; ``b_hn`` stays inside
``r * (...)``, as in torch), the LSTM none on the input side
(``b_ih = 0``). Those parts of torch's biases start at zero and a gradient
hook keeps them there, so every layer computes flax's cell. A
``SequentialBlock`` refuses packed rows before an ``RNNBlock``: the
recurrence would carry state from one packed session into the next.
``Block`` wraps any module with a declared output size.
"""

from __future__ import annotations

import inspect
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..config.transformer import T4RecConfig
from ..masking import MaskingInfo
from .transformer import ACTIVATIONS
from .transformer import LayerNorm, Linear, _lecun_normal_, dropout, init_dense_, promote

# which masking schemes each architecture supports
_DEFAULT_MASKING = ("clm", "mlm", "rtd", "plm")
MASKING_COMPAT = {
    "bert": ("mlm", "rtd"),
    "roberta": ("mlm", "rtd"),
    "electra": ("mlm", "rtd"),
    "albert": ("mlm", "rtd"),
    "gpt2": ("clm",),
    "transfoxl": ("clm",),
    "longformer": ("clm", "mlm", "rtd"),
    "reformer": ("clm", "mlm", "rtd"),
    "xlnet": _DEFAULT_MASKING,
}

_MASKING_ALIASES = {"causal": "clm", "masked": "mlm", "permutation": "plm", "replacement": "rtd"}


def check_masking_compat(arch: str, masking_name: Optional[str]) -> None:
    if masking_name is None:
        return
    key = _MASKING_ALIASES.get(masking_name.lower(), masking_name.lower())
    allowed = MASKING_COMPAT.get(arch.lower(), _DEFAULT_MASKING)
    if key not in allowed:
        raise ValueError(
            f"{arch} is not supported with masking scheme {masking_name!r}; "
            f"allowed: {allowed}"
        )


class MLPBlock(nn.Module):
    """Stacked Dense (+ activation, + LayerNorm, + dropout) over the last
    axis; dropout draws from the forward's generator."""

    def __init__(self, dimensions: Sequence[int], activation: str = "relu",
                 use_norm: bool = False, dropout: float = 0.0, input_dim: Optional[int] = None):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; known: {sorted(ACTIVATIONS)}")
        self.dimensions = tuple(dimensions)
        self.activation = activation
        self.use_norm = use_norm
        self.dropout = dropout
        self.input_dim: Optional[int] = None
        if input_dim is not None:
            self.build(input_dim)

    def build(self, input_dim: int) -> None:
        """Create the layers for inputs ``input_dim`` wide (``Head.from_body``
        calls it with the width of the block before)."""
        if self.input_dim is not None:
            if self.input_dim != input_dim:
                raise ValueError(f"MLPBlock built for {self.input_dim} inputs, given {input_dim}")
            return
        self.input_dim = input_dim
        for i, dim in enumerate(self.dimensions):
            self.add_module(f"dense_{i}", Linear(input_dim, dim))
            if self.use_norm:
                self.add_module(f"norm_{i}", LayerNorm(dim, 1e-6))
            input_dim = dim

    def output_size(self) -> int:
        return self.dimensions[-1]

    def _init_weights(self, generator: torch.Generator) -> None:
        for i in range(len(self.dimensions)):
            init_dense_(getattr(self, f"dense_{i}"), generator)

    def forward(self, x: torch.Tensor, training: bool = False, testing: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.input_dim is None:
            raise ValueError("MLPBlock has no layers yet: build(input_dim) it first")
        act = ACTIVATIONS[self.activation]
        for i in range(len(self.dimensions)):
            dense = getattr(self, f"dense_{i}")
            x = act(dense(x))
            if self.use_norm:
                x = getattr(self, f"norm_{i}")(x)
            x = dropout(x, self.dropout, training, generator)
        return x


class Block(nn.Module):
    """Any module with a declared output size; the train/eval flag reaches
    it when its ``forward`` takes ``training``."""

    def __init__(self, module: nn.Module, output_dim: int):
        super().__init__()
        self.module = module
        self.output_dim = output_dim
        params = inspect.signature(module.forward).parameters
        self._takes_training = "training" in params or any(
            p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())

    def output_size(self) -> int:
        return self.output_dim

    def forward(self, inputs, training: bool = False, testing: bool = False, generator=None):
        if self._takes_training:
            return self.module(inputs, training=training)
        return self.module(inputs)


class _KeepZero:
    """A gradient hook that zeroes the first ``n`` entries of a bias's
    gradient: the part flax's cell does not have stays at its zero."""

    def __init__(self, n: int):
        self.n = n

    def __call__(self, grad: torch.Tensor) -> torch.Tensor:
        out = grad.clone()
        out[:self.n] = 0
        return out


def _widened(rnn: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """One GRU or LSTM layer on ``x`` with its weights cast up to ``x``'s
    type at the call, exactly: weights in a narrower type than the input
    (``export_model(weights_dtype="bfloat16")``) meet an f32 activation, and
    flax's cells then compute in the promotion of the two, f32. ``nn.GRU``
    and ``nn.LSTM`` take one type only."""
    weights = [p.to(x.dtype) for p in (rnn.weight_ih_l0, rnn.weight_hh_l0, rnn.bias_ih_l0,
                                       rnn.bias_hh_l0)]
    h = x.new_zeros(1, x.shape[0], rnn.hidden_size)
    args = (weights, True, 1, 0.0, rnn.training, False, True)
    if isinstance(rnn, nn.GRU):
        return torch.gru(x, h, *args)[0]
    return torch.lstm(x, (h, h), *args)[0]


class RNNBlock(nn.Module):
    """Recurrent body: ``num_layers`` GRU or LSTM layers, (B, S, D) →
    (B, S, units), left to right (causal by construction: CLM is its
    scheme). ``input_dim`` is the width of the block before;
    ``Head.from_body(extra_blocks=...)`` builds it when not given."""

    def __init__(self, units: int = 64, cell_type: str = "gru", num_layers: int = 1,
                 dropout: float = 0.0, input_dim: Optional[int] = None):
        super().__init__()
        if cell_type not in ("gru", "lstm"):
            raise ValueError(f"unknown cell_type {cell_type!r}")
        self.units = units
        self.cell_type = cell_type
        self.num_layers = num_layers
        self.dropout = dropout
        self.input_dim: Optional[int] = None
        if input_dim is not None:
            self.build(input_dim)

    def build(self, input_dim: int) -> None:
        """Create the layers for inputs ``input_dim`` wide."""
        if self.input_dim is not None:
            if self.input_dim != input_dim:
                raise ValueError(f"RNNBlock built for {self.input_dim} inputs, given {input_dim}")
            return
        self.input_dim = input_dim
        cls = nn.GRU if self.cell_type == "gru" else nn.LSTM
        for i in range(self.num_layers):
            rnn = cls(input_dim if i == 0 else self.units, self.units, batch_first=True)
            # GRU: no recurrent bias on r and z; LSTM: no input-side bias
            zero, n = ((rnn.bias_hh_l0, 2 * self.units) if self.cell_type == "gru"
                       else (rnn.bias_ih_l0, 4 * self.units))
            with torch.no_grad():
                zero[:n] = 0
            zero.register_hook(_KeepZero(n))
            self.add_module(f"{self.cell_type}_{i}", rnn)

    def layers(self) -> list:
        return [getattr(self, f"{self.cell_type}_{i}") for i in range(self.num_layers)]

    def output_size(self) -> int:
        return self.units

    def _init_weights(self, generator: torch.Generator) -> None:
        """flax's cells: lecun-normal input kernels, orthogonal recurrent
        kernels (each gate's its own), zero biases."""
        for rnn in self.layers():
            _lecun_normal_(rnn.weight_ih_l0, rnn.input_size, generator)
            for gate in rnn.weight_hh_l0.split(self.units):
                nn.init.orthogonal_(gate, generator=generator)
            nn.init.zeros_(rnn.bias_ih_l0)
            nn.init.zeros_(rnn.bias_hh_l0)

    def forward(self, x: torch.Tensor, training: bool = False, testing: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.input_dim is None:
            raise ValueError("RNNBlock has no layers yet: build(input_dim) it first")
        for i, rnn in enumerate(self.layers()):
            # cuDNN keeps what its backward needs only in training mode; a
            # single-layer GRU or LSTM has no dropout, so the flag changes
            # nothing else
            rnn.training = torch.is_grad_enabled()
            x = promote(x, rnn.weight_ih_l0)
            x = rnn(x)[0] if rnn.weight_ih_l0.dtype == x.dtype else _widened(rnn, x)
            if i < self.num_layers - 1:
                x = dropout(x, self.dropout, training, generator)
        return x


class TransformerBlock(nn.Module):
    """Adapter from the tabular-sequence pipeline into the unified encoder.
    Accepts a ``T4RecConfig`` or a prebuilt ``TransformerEncoder``;
    ``masking`` names the input module's scheme, for the compat check and
    for the encoder (PLM turns on XLNet's two streams)."""

    def __init__(self, transformer: Union[T4RecConfig, nn.Module],
                 masking: Optional[str] = None):
        super().__init__()
        if isinstance(transformer, T4RecConfig):
            check_masking_compat(transformer.arch, masking or transformer.masking)
            transformer = transformer.to_encoder(masking)
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
                masking_info: Optional[MaskingInfo] = None,
                sparse_rows=None):
        """``generator`` feeds every random draw of a training forward (the
        mask, then dropout); ``masking_info`` hands the input module a ready
        mask instead of a drawn one, ``sparse_rows`` the sparse step's
        pre-gathered table rows (``ops.sparse_update.GatheredRows``)."""
        x = inputs
        info: Optional[MaskingInfo] = None
        for i, block in enumerate(self.blocks):
            if isinstance(block, TransformerBlock):
                x = block((x, info), pad_mask=pad_mask, training=training, testing=testing,
                          generator=generator)
            elif i == 0:
                x = block(x, training=training, testing=testing, generator=generator,
                          masking_info=masking_info, sparse_rows=sparse_rows)
            else:
                if isinstance(block, RNNBlock) and info is not None \
                        and info.segment_ids is not None:
                    raise ValueError(
                        "RNNBlock does not support packed sessions (segment_ids present): "
                        "left-to-right recurrence would leak state across session "
                        "boundaries. Train RNN bodies with pack_sessions=False.")
                x = block(x, training=training, testing=testing, generator=generator)
            if isinstance(x, tuple):
                x, maybe_info = x
                if maybe_info is not None:
                    info = maybe_info
        return x, info
