"""The unified transformer body, on the path the XLNet config takes.

Counterpart of ``transformers4rec_tpu/blocks/transformer.py``: one encoder
whose per-arch differences are config flags. All masking folds into ONE
additive attention bias computed once per forward and shared by the layers.

Ported: bidirectional or causal attention, the T5-style relative position
bias, an optional local window, pre-LN layers with the tanh GELU and a
final LayerNorm, in float32, and dropout in training (on the embeddings, the
attention probabilities, the feed-forward's hidden layer and both residual
branches, where the JAX package applies it), drawn from an explicit
``torch.Generator``. Attention runs on the dense path
(``MultiHeadAttention``): the JAX package switches to its flash kernel only
at S >= 128, and the paths ported here run at S <= 21. Not ported yet:
two-stream attention (``perm_mask``), session packing
(``segment_ids``), the post-LN BERT family (embedding LayerNorm, erf
GELU), learned absolute and axial positions, segment memory, shared
layers, per-layer attention patterns, LSH attention and the flash kernels;
``T4RecConfig.to_encoder`` raises ``NotImplementedError`` for them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e9


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default Dense kernel init: truncated normal, variance 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout with the draw taken from ``generator`` (on x's
    device). The identity when not training or p == 0: no draw is made."""
    if not training or p <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


def make_attention_bias(
    pad_mask: Optional[torch.Tensor],
    seq_len: int,
    causal: bool = False,
    local_window: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> torch.Tensor:
    """Compose the masking variants into one additive (B|1, 1, S, S) bias.

    pad_mask: (B, S) bool — True at valid (non-pad) positions.
    local_window: each query attends keys within ±window.
    """
    if pad_mask is not None:
        device = pad_mask.device
    bias = torch.zeros((1, 1, seq_len, seq_len), dtype=dtype, device=device)
    pos = torch.arange(seq_len, device=device)
    if causal:
        bias = bias.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    if pad_mask is not None:
        key_bias = torch.where(pad_mask, 0.0, NEG_INF).to(dtype)
        bias = bias + key_bias[:, None, None, :]
    if local_window is not None:
        far = (pos[None, :] - pos[:, None]).abs() > local_window
        bias = bias + torch.where(far, NEG_INF, 0.0).to(dtype)
    return bias


class RelativePositionBias(nn.Module):
    """T5-style bucketed per-head relative position bias: a learned
    (buckets, heads) table read at the bucket of each key − query distance."""

    def __init__(self, num_heads: int, num_buckets: int = 32, max_distance: int = 128,
                 bidirectional: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        self.bidirectional = bidirectional
        self.rel_bias = nn.Parameter(torch.empty(num_buckets, num_heads))

    def _init_weights(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.rel_bias, 0.0, 0.02, generator=generator)

    @staticmethod
    def _bucket(relative_position: torch.Tensor, bidirectional: bool, num_buckets: int,
                max_distance: int) -> torch.Tensor:
        # float32 throughout, as the JAX package computes it: a log taken in
        # another precision moves bucket edges
        ret = torch.zeros_like(relative_position)
        n = -relative_position
        if bidirectional:
            num_buckets //= 2
            ret = ret + (n < 0).long() * num_buckets
            n = n.abs()
        else:
            n = n.clamp_min(0)
        max_exact = num_buckets // 2
        is_small = n < max_exact
        log_ratio = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32))
        val_large = max_exact + (
            torch.log(n.float() / max_exact + 1e-6) / log_ratio * (num_buckets - max_exact)
        ).to(torch.int32).long()
        val_large = val_large.clamp_max(num_buckets - 1)
        return ret + torch.where(is_small, n, val_large)

    def forward(self, seq_len: int) -> torch.Tensor:
        pos = torch.arange(seq_len, device=self.rel_bias.device)
        rel = pos[None, :] - pos[:, None]  # key - query
        buckets = self._bucket(rel, self.bidirectional, self.num_buckets, self.max_distance)
        bias = self.rel_bias[buckets]  # (S, S, H)
        return bias.permute(2, 0, 1)[None]  # (1, H, S, S)


class MultiHeadAttention(nn.Module):
    """Standard multi-head attention with an additive bias (dense path)."""

    def __init__(self, d_model: int, n_head: int, dropout: float = 0.0):
        super().__init__()
        self.d_model, self.n_head, self.dropout = d_model, n_head, dropout
        self.q = nn.Linear(d_model, d_model)
        self.k = nn.Linear(d_model, d_model)
        self.v = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def _init_weights(self, generator: torch.Generator) -> None:
        for lin in (self.q, self.k, self.v, self.out):
            nn.init.xavier_uniform_(lin.weight, generator=generator)
            nn.init.zeros_(lin.bias)

    def forward(self, query_in: torch.Tensor, kv_in: torch.Tensor, bias: torch.Tensor,
                training: bool = False, generator=None) -> torch.Tensor:
        B, Sq, _ = query_in.shape
        Sk = kv_in.shape[1]
        H, Dh = self.n_head, self.d_model // self.n_head
        q = self.q(query_in).view(B, Sq, H, Dh)
        k = self.k(kv_in).view(B, Sk, H, Dh)
        v = self.v(kv_in).view(B, Sk, H, Dh)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * Dh ** -0.5 + bias
        probs = torch.softmax(logits, dim=-1)
        # fully blocked query rows (every key masked) output 0, not the
        # uniform-softmax average
        row_ok = (bias > NEG_INF / 2).any(dim=-1, keepdim=True)
        probs = probs * row_ok.to(probs.dtype)
        probs = dropout(probs, self.dropout, training, generator)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out(ctx.reshape(B, Sq, H * Dh))


class TransformerLayer(nn.Module):
    """One pre-LN transformer layer (the XLNet/GPT-2 form): attention and a
    feed-forward block with the tanh GELU (flax's default ``nn.gelu``), each
    on a LayerNorm of its input and added back to it."""

    def __init__(self, d_model: int, n_head: int, d_ff: int, layer_norm_eps: float = 1e-12,
                 dropout: float = 0.0, attn_dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.attn = MultiHeadAttention(d_model, n_head, attn_dropout)
        self.ln1 = nn.LayerNorm(d_model, eps=layer_norm_eps)
        self.ln2 = nn.LayerNorm(d_model, eps=layer_norm_eps)
        self.ffn_in = nn.Linear(d_model, d_ff)
        self.ffn_out = nn.Linear(d_ff, d_model)

    def _init_weights(self, generator: torch.Generator) -> None:
        for lin in (self.ffn_in, self.ffn_out):
            _lecun_normal_(lin.weight, lin.in_features, generator)
            nn.init.zeros_(lin.bias)

    def forward(self, hidden: torch.Tensor, bias: torch.Tensor, training: bool = False,
                generator=None) -> torch.Tensor:
        def drop(t):
            return dropout(t, self.dropout, training, generator)

        x = self.ln1(hidden)
        hidden = hidden + drop(self.attn(x, x, bias, training, generator))
        h = drop(F.gelu(self.ffn_in(self.ln2(hidden)), approximate="tanh"))
        return hidden + drop(self.ffn_out(h))


class TransformerEncoder(nn.Module):
    """The unified body: ``forward(inputs_embeds, pad_mask) → (B, S, d_model)``."""

    def __init__(
        self,
        d_model: int,
        n_head: int,
        n_layer: int,
        d_ff: int = 0,
        layer_norm_eps: float = 1e-12,
        causal: bool = False,
        pos_encoding: str = "relative_bias",
        local_window: Optional[int] = None,
        dropout: float = 0.1,
        attn_dropout: float = 0.0,
    ):
        super().__init__()
        if pos_encoding not in ("relative_bias", "none"):
            raise NotImplementedError(f"pos_encoding={pos_encoding!r} is not ported yet")
        self.d_model, self.n_head, self.n_layer = d_model, n_head, n_layer
        self.causal = causal
        self.local_window = local_window
        self.dropout = dropout
        d_ff = d_ff or 4 * d_model
        self.layers = nn.ModuleList(
            TransformerLayer(d_model, n_head, d_ff, layer_norm_eps, dropout, attn_dropout)
            for _ in range(n_layer)
        )
        self.rel_pos = (
            RelativePositionBias(n_head, bidirectional=not causal)
            if pos_encoding == "relative_bias" else None
        )
        self.ln_f = nn.LayerNorm(d_model, eps=layer_norm_eps)

    def forward(
        self,
        inputs_embeds: torch.Tensor,
        pad_mask: Optional[torch.Tensor] = None,
        perm_mask: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
        training: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if perm_mask is not None:
            raise NotImplementedError("two-stream attention (perm_mask) is not ported yet")
        if segment_ids is not None:
            raise NotImplementedError("session packing (segment_ids) is not ported yet")
        S = inputs_embeds.shape[1]
        hidden = inputs_embeds.float()
        bias = make_attention_bias(
            pad_mask, S, causal=self.causal, local_window=self.local_window,
            device=hidden.device,
        )
        if self.rel_pos is not None:
            bias = bias + self.rel_pos(S)
        hidden = dropout(hidden, self.dropout, training, generator)
        for layer in self.layers:
            hidden = layer(hidden, bias, training, generator)
        return self.ln_f(hidden)
