"""Transformer architecture configs with a unified ``build()`` API.

Counterpart of ``transformers4rec_tpu/config/transformer.py``: every config
resolves to the keyword arguments of the ONE unified ``TransformerEncoder``
(blocks/transformer.py); per-arch differences are capability flags.
Encoder archs keep ``total_seq_length += 2`` headroom for the MLM inference
[MASK] extension.

The registry holds the JAX registry's nine names with its defaults: XLNet
(relative bias, two streams under PLM), GPT-2 (causal, learned absolute
positions), the BERT family (BERT, RoBERTa, ELECTRA, ALBERT with shared
layers, Longformer with a local window of 8: post-LN with an embedding
LayerNorm and the erf GELU), TransfoXL (causal with the relative bias) and
Reformer (alternating local and LSH layers, axial positions).
``dtype`` is the encoder's compute type (``None`` or float32, or bfloat16;
the strings ``"float32"`` and ``"bfloat16"`` name them too; float16 and
anything else raise ``NotImplementedError``): the parameters stay float32
and the encoder returns float32. ``remat`` recomputes each layer's forward in
the backward. ``two_stream`` takes effect for the scheme that gives a
``perm_mask`` (PLM): ``to_encoder(masking="plm")`` builds the encoder with
its query stream (and the stream's learned start vector), as the JAX
package creates that parameter only when a ``perm_mask`` arrives.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..utils.registry import Registry

transformer_registry: Registry = Registry("transformer")

_COMPUTE_DTYPES = {None: torch.float32, torch.float32: torch.float32, "float32": torch.float32,
                   torch.bfloat16: torch.bfloat16, "bfloat16": torch.bfloat16}


def compute_dtype(dtype) -> torch.dtype:
    """The encoder's compute type for a config's ``dtype``: float32 for
    ``None``, float32 and ``"float32"``, bfloat16 for bfloat16 and
    ``"bfloat16"``. Any other type (float16 among them) raises
    ``NotImplementedError``: the flash kernels have no other form."""
    try:
        return _COMPUTE_DTYPES[dtype]
    except (KeyError, TypeError):
        raise NotImplementedError(
            f"compute dtype {dtype!r} is not ported: the encoder computes in float32 or "
            "bfloat16") from None


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
    dtype: Any = None  # the encoder's compute type; float32 when None

    arch: str = "generic"

    def __post_init__(self):
        compute_dtype(self.dtype)  # float16 and the rest raise here

    @classmethod
    def build(cls, d_model, n_head, n_layer, total_seq_length, **kwargs):
        return cls(
            d_model=d_model, n_head=n_head, n_layer=n_layer,
            total_seq_length=total_seq_length, **kwargs,
        )

    def to_encoder(self, masking: Optional[str] = None):
        """The unified encoder; ``masking`` names the scheme it is built
        for, whose ``perm_mask`` (PLM) turns ``two_stream`` on."""
        from ..blocks.transformer import TransformerEncoder

        return TransformerEncoder(
            d_model=self.d_model, n_head=self.n_head, n_layer=self.n_layer,
            d_ff=self.d_ff, layer_norm_eps=self.layer_norm_eps, causal=self.causal,
            pos_encoding=self.pos_encoding, local_window=self.local_window,
            dropout=self.dropout, attn_dropout=self.attn_dropout,
            max_position=max(self.total_seq_length, 8),
            two_stream=self.two_stream and masking in ("plm", "permutation"),
            activation=self.hidden_act, norm_first=self.norm_first,
            embed_layer_norm=self.embed_layer_norm, share_layers=self.share_layers,
            mem_len=self.mem_len,
            axial_pos_shape=(tuple(self.axial_pos_shape)
                             if self.axial_pos_shape is not None else None),
            axial_pos_embds_dim=(tuple(self.axial_pos_embds_dim)
                                 if self.axial_pos_embds_dim is not None else None),
            attn_layers=tuple(self.attn_layers) if self.attn_layers is not None else None,
            lsh_num_buckets=self.lsh_num_buckets, lsh_num_hashes=self.lsh_num_hashes,
            lsh_chunk_size=self.lsh_chunk_size,
            remat=self.remat, dtype=self.dtype,
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
# the BERT family: post-LN, the embedding LayerNorm and the erf GELU, layer
# for layer the HF models the reference wraps
_BERT_FAMILY = dict(
    causal=False, norm_first=False, embed_layer_norm=True,
    hidden_act="gelu_exact", _seq_headroom=2,
)
BertConfig = _register("bert", masking="mlm", **_BERT_FAMILY)
RobertaConfig = _register("roberta", masking="mlm", **_BERT_FAMILY)
ElectraConfig = _register("electra", masking="rtd", **_BERT_FAMILY)
AlbertConfig = _register("albert", share_layers=True, masking="mlm", **_BERT_FAMILY)
LongformerConfig = _register("longformer", local_window=8, masking="mlm", **_BERT_FAMILY)


@transformer_registry.register("reformer")
@dataclasses.dataclass
class ReformerConfig(T4RecConfig):
    """Reformer: alternating local/LSH attention layers and axial factorised
    positions, built as the JAX package builds them (the reference's
    ``attn_layers=["local", "lsh"] * (n_layer // 2)`` when n_layer > 2, else
    ``["local"]``; ``axial_pos_shape=[first_dim, total / first_dim]`` with
    half/half embedding widths; the LSH chunk and bucket count scaled with
    the sequence)."""

    arch: str = "reformer"

    @classmethod
    def build(cls, d_model, n_head, n_layer, total_seq_length,
              axial_pos_shape_first_dim=4, **kwargs):
        pad = 2  # MLM inference [MASK] headroom like the other encoder archs
        merged = {"causal": False, "masking": "mlm", "local_window": 8}
        merged.update(kwargs)
        for alias in ("attention_window", "local_attn_chunk_length"):
            if alias in merged:
                win = merged.pop(alias)
                merged["local_window"] = (
                    None if win is None or win >= total_seq_length + pad else int(win)
                )
        max_pos = max(total_seq_length + pad, 8)
        # the LSH chunk: HF's 64 from S = 128 on, else the local window
        if merged.get("lsh_chunk_size") is None:
            if max_pos >= 128:
                merged["lsh_chunk_size"] = 64
            elif merged["local_window"] is not None:
                merged["lsh_chunk_size"] = int(merged["local_window"])
            else:
                merged.pop("lsh_chunk_size", None)
        chunk = merged.get("lsh_chunk_size", cls.lsh_chunk_size)
        if merged.get("lsh_num_buckets") is None:
            # 2·ceil(S/chunk), even by construction
            merged["lsh_num_buckets"] = min(max(4, 2 * (-(-max_pos // max(chunk, 1)))), 512)
        merged.setdefault("pos_encoding", "axial")
        if merged["pos_encoding"] == "axial":
            d1 = int(axial_pos_shape_first_dim)
            merged.setdefault("axial_pos_shape", (d1, -(-max_pos // d1)))
            merged.setdefault("axial_pos_embds_dim", (d_model // 2, d_model - d_model // 2))
        if "attn_layers" not in merged:
            merged["attn_layers"] = (
                tuple(("local", "lsh")[i % 2] for i in range(n_layer))
                if n_layer > 2 else ("local",) * n_layer
            )
        return cls(
            d_model=d_model, n_head=n_head, n_layer=n_layer,
            total_seq_length=total_seq_length + pad, **merged,
        )


GPT2Config = _register("gpt2", causal=True, masking="clm")
TransfoXLConfig = _register("transfoxl", causal=True, pos_encoding="relative_bias",
                            masking="clm")
