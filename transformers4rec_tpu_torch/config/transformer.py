"""Transformer architecture configs with a unified ``build()`` API.

Counterpart of ``transformers4rec_tpu/config/transformer.py``: every config
resolves to the keyword arguments of the ONE unified ``TransformerEncoder``
(blocks/transformer.py); per-arch differences are capability flags.
Encoder archs keep ``total_seq_length += 2`` headroom for the MLM inference
[MASK] extension.

Ported: ``T4RecConfig``, ``_register`` and ``XLNetConfig``. The other eight
archs are not ported yet, and ``to_encoder`` raises ``NotImplementedError``
for a capability flag the encoder does not carry yet. ``two_stream`` stays
inert without a ``perm_mask`` (MLM gives none), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..utils.registry import Registry

transformer_registry: Registry = Registry("transformer")


@dataclasses.dataclass
class T4RecConfig:
    """Architecture-agnostic transformer config. ``to_encoder()`` builds the
    unified body; ``to_model(input_module, *tasks, device=...)`` a full model."""

    d_model: int = 64
    n_head: int = 4
    n_layer: int = 2
    total_seq_length: int = 20
    d_ff: int = 0
    hidden_act: str = "gelu"
    dropout: float = 0.1
    attn_dropout: float = 0.0
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.01
    # capability flags
    causal: bool = False
    pos_encoding: str = "learned_absolute"
    share_layers: bool = False
    local_window: Optional[int] = None
    two_stream: bool = False
    attn_layers: Optional[tuple] = None
    axial_pos_shape: Optional[tuple] = None
    axial_pos_embds_dim: Optional[tuple] = None
    lsh_num_buckets: int = 8
    lsh_num_hashes: int = 2
    lsh_chunk_size: int = 8
    norm_first: bool = True
    embed_layer_norm: bool = False
    remat: bool = False
    mem_len: int = 0
    masking: Optional[str] = None
    dtype: Any = None  # float32 when None, the only type ported

    arch: str = "generic"

    @classmethod
    def build(cls, d_model, n_head, n_layer, total_seq_length, **kwargs):
        return cls(
            d_model=d_model, n_head=n_head, n_layer=n_layer,
            total_seq_length=total_seq_length, **kwargs,
        )

    def to_encoder(self):
        from ..blocks.transformer import TransformerEncoder

        unported = {
            "hidden_act": self.hidden_act != "gelu",
            "pos_encoding": self.pos_encoding not in ("relative_bias", "none"),
            "share_layers": self.share_layers,
            "attn_layers": self.attn_layers is not None,
            "axial_pos_shape": self.axial_pos_shape is not None,
            "norm_first": not self.norm_first,
            "embed_layer_norm": self.embed_layer_norm,
            "remat": self.remat,
            "mem_len": bool(self.mem_len),
            "dtype": self.dtype is not None,
        }
        if any(unported.values()):
            raise NotImplementedError(
                f"{self.arch}: not ported yet: {[k for k, v in unported.items() if v]}"
            )
        return TransformerEncoder(
            d_model=self.d_model, n_head=self.n_head, n_layer=self.n_layer,
            d_ff=self.d_ff, layer_norm_eps=self.layer_norm_eps, causal=self.causal,
            pos_encoding=self.pos_encoding, local_window=self.local_window,
            dropout=self.dropout, attn_dropout=self.attn_dropout,
        )

    def to_model(self, input_module, *tasks, device=None, seed: int = 0, **kwargs):
        """One-liner model factory: builds the model, initialises it from
        ``seed`` and places it on ``device`` (CUDA unless ``"cpu"``)."""
        from ..model.base import Head, Model
        from ..model.prediction_task import NextItemPredictionTask

        if not tasks:
            tasks = (NextItemPredictionTask(weight_tying=True),)
        head = Head.from_body(
            input_module=input_module, transformer=self, tasks=list(tasks), **kwargs
        )
        return Model(heads=(head,), device=device, seed=seed)


def _register(name: str, **defaults):
    @transformer_registry.register(name)
    @dataclasses.dataclass
    class _Config(T4RecConfig):
        arch: str = name

        @classmethod
        def build(cls, d_model, n_head, n_layer, total_seq_length, **kwargs):
            merged = {**defaults, **kwargs}
            pad = merged.pop("_seq_headroom", 0)
            # reference arg names for a local window; a window covering the
            # whole (headroom-padded) sequence is dense attention
            for alias in ("attention_window", "local_attn_chunk_length"):
                if alias in merged:
                    win = merged.pop(alias)
                    merged["local_window"] = (
                        None if win is None or win >= total_seq_length + pad
                        else int(win)
                    )
            merged.pop("axial_pos_shape_first_dim", None)
            return cls(
                d_model=d_model, n_head=n_head, n_layer=n_layer,
                total_seq_length=total_seq_length + pad, **merged,
            )

    _Config.__name__ = f"{name.capitalize()}ConfigImpl"
    return _Config


# Encoder (bidirectional) archs get +2 seq headroom for the MLM inference
# [MASK] extension.
XLNetConfig = _register(
    "xlnet", causal=False, pos_encoding="relative_bias", two_stream=True,
    masking="plm", _seq_headroom=2,
)
