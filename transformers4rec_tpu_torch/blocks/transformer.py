"""The unified transformer body and its per-arch flags.

Counterpart of ``transformers4rec_tpu/blocks/transformer.py``: one encoder
whose per-arch differences are config flags. All masking folds into ONE
additive attention bias computed once per forward and shared by the layers.

Ported: bidirectional or causal attention, the T5-style relative position
bias, learned absolute positions, an optional local window, in float32,
and dropout in training (on the embeddings, the attention probabilities,
the feed-forward's hidden layer and both residual branches, where the JAX
package applies it), drawn from an explicit ``torch.Generator``. Layers are
pre-LN with a final LayerNorm (``norm_first=True``: XLNet, GPT-2,
TransfoXL) or post-LN without one (the BERT family: residual, then
LayerNorm), optionally with a LayerNorm on the embeddings after the
position add (``embed_layer_norm``); the feed-forward's activation is taken
by flax's name (``gelu`` is the tanh form) or ``gelu_exact`` (the erf form
of HF's BERT). ``share_layers`` (ALBERT) runs one layer, ``layer_shared``,
``n_layer`` times. Segment memory (TransfoXL/XLNet ``mem_len``): given
``mems`` (``init_mems``), each layer's keys and values take the cached,
detached inputs of that layer at positions −M..−1, valid where
``mems["pad"]`` is true; ``return_mems=True`` also returns the next
segment's memory.

Below S = 128, whenever attention dropout is drawn, and whenever memory is
given, ``MultiHeadAttention`` takes the dense path over the composed
(B|1, 1|H, S, M+S) bias; otherwise it takes ``ops.attention.flash_attention``
(kernels K5 and K6), which applies the causal mask and the padding inside
the kernel and reads only the local window, the perm mask and the relative
bias as a tensor. With a learned relative bias the fused forward runs and
the backward goes through the dense f32 function, which yields the bias
gradient. XLNet's two-stream attention (PLM): given a ``perm_mask``, an
encoder built with ``two_stream`` runs a second, query stream beside the
content stream. It starts from a learned vector (``query_stream_init``),
attends the content stream's keys and values through the same attention
and feed-forward weights under its own bias, which also hides each
position from itself, and is what the encoder returns.

Session packing: given ``segment_ids`` (B, S) (0 at padding, 1..n for the
sessions packed into a row), a block-diagonal restriction joins the perm
mask's channel of the bias (a (B, 1, S, S) bias of the flash kernels), and
learned or axial positions restart at each segment's start, so a packed
session sees the positions it would see alone. XLNet's two streams still
key on the scheme's own perm mask, not the merged one.

Reformer: axial positions (``pos_encoding="axial"``: position p embeds as
``axial_pos_0[p // d2] ++ axial_pos_1[p % d2]`` for ``axial_pos_shape``
(d1, d2)) and a per-layer attention pattern (``attn_layers``, each entry
``"dense"``, ``"local"`` (the local window) or ``"lsh"``). An LSH layer
(``LSHSelfAttention``: a shared query/key projection, ``ops.lsh_attention``)
builds no (S, S) bias; the windowed and dense layers share one bias, or one
flash context, per window. LSH layers refuse what bucket-sorted chunks
cannot carry, as the JAX package does: a perm mask or two streams,
``segment_ids``, segment memory and the relative bias.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention, use_flash
from ..ops.lsh_attention import draw_rotations, lsh_attention

NEG_INF = -1e9


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default Dense kernel init: truncated normal, variance 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def promote(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x`` in the type a flax module computes in: the promotion of its
    input's type and its parameters' (a bf16 table's lookup meets f32
    weights as f32, an exact upcast; an f32 input is returned as it is)."""
    return x.to(torch.promote_types(x.dtype, weight.dtype))


def init_dense_(lin: nn.Linear, generator: torch.Generator) -> None:
    """A Linear as flax initialises a Dense: lecun-normal kernel, zero bias."""
    _lecun_normal_(lin.weight, lin.in_features, generator)
    if lin.bias is not None:
        nn.init.zeros_(lin.bias)


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
    perm_mask: Optional[torch.Tensor] = None,
    local_window: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    query_stream: bool = False,
    device=None,
    mem_len: int = 0,
    mem_pad: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Compose the masking variants into one additive (B|1, 1, S, M+S) bias.

    pad_mask: (B, S) bool — True at valid (non-pad) positions.
    perm_mask: (B, S, S) — 1 where query i must NOT attend key j.
    local_window: each query attends keys within ±window.
    query_stream: the two-stream attention's query stream, which also may not
        attend its own position.
    mem_len / mem_pad: segment memory, M cached keys at positions −M..−1,
        valid where ``mem_pad`` (B, M) is True (all valid when not given).
    """
    if pad_mask is not None:
        device = pad_mask.device
    elif mem_pad is not None:
        device = mem_pad.device
    bias = torch.zeros((1, 1, seq_len, mem_len + seq_len), dtype=dtype, device=device)
    q_pos = torch.arange(seq_len, device=device)
    k_pos = torch.arange(-mem_len, seq_len, device=device)
    if causal:
        bias = bias.masked_fill(k_pos[None, :] > q_pos[:, None], NEG_INF)
    keys_ok = pad_mask
    if mem_len and (pad_mask is not None or mem_pad is not None):
        B = (pad_mask if pad_mask is not None else mem_pad).shape[0]
        mp = mem_pad if mem_pad is not None else torch.ones(
            (B, mem_len), dtype=torch.bool, device=device)
        cur = pad_mask if pad_mask is not None else torch.ones(
            (B, seq_len), dtype=torch.bool, device=device)
        keys_ok = torch.cat([mp, cur], dim=1)
    if keys_ok is not None:
        key_bias = torch.where(keys_ok, 0.0, NEG_INF).to(dtype)
        bias = bias + key_bias[:, None, None, :]
    extra = make_extra_bias(seq_len, perm_mask, local_window, query_stream, dtype, device,
                            mem_len=mem_len)
    if extra is not None:
        bias = bias + extra
    return bias


def make_extra_bias(
    seq_len: int,
    perm_mask: Optional[torch.Tensor] = None,
    local_window: Optional[int] = None,
    query_stream: bool = False,
    dtype: torch.dtype = torch.float32,
    device=None,
    mem_len: int = 0,
) -> Optional[torch.Tensor]:
    """The additive components that are neither causal nor padding (the
    perm mask and the local window), or None: (B|1, 1, S, M+S). Kept apart so
    that the flash kernel can apply causal and padding itself and read a
    bias only when one exists. The content stream may always see its own
    position, the query stream never; the perm mask restricts the current
    segment only, so both streams see every memory key."""
    if perm_mask is not None:
        device = perm_mask.device
    extra = None
    if local_window is not None:
        q_pos = torch.arange(seq_len, device=device)
        k_pos = torch.arange(-mem_len, seq_len, device=device)
        far = (k_pos[None, :] - q_pos[:, None]).abs() > local_window
        extra = torch.where(far, NEG_INF, 0.0).to(dtype)[None, None]
    if perm_mask is not None:
        eye = torch.eye(seq_len, dtype=torch.bool, device=device)[None]
        block = perm_mask.bool()
        block = block | eye if query_stream else block & ~eye
        if mem_len:
            block = torch.cat([block.new_zeros((*block.shape[:2], mem_len)), block], dim=2)
        perm_bias = torch.where(block, NEG_INF, 0.0).to(dtype)[:, None]
        extra = perm_bias if extra is None else extra + perm_bias
    return extra


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
        # zeros until ``_init_weights`` draws it: a lone encoder is finite
        self.rel_bias = nn.Parameter(torch.zeros(num_buckets, num_heads))

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

    def forward(self, seq_len: int, mem_len: int = 0) -> torch.Tensor:
        dev = self.rel_bias.device
        q_pos = torch.arange(seq_len, device=dev)
        k_pos = torch.arange(-mem_len, seq_len, device=dev)  # memory keys sit in the past
        rel = k_pos[None, :] - q_pos[:, None]  # key - query
        buckets = self._bucket(rel, self.bidirectional, self.num_buckets, self.max_distance)
        bias = self.rel_bias[buckets]  # (S, M+S, H)
        return bias.permute(2, 0, 1)[None]  # (1, H, S, M+S)


class MultiHeadAttention(nn.Module):
    """Standard multi-head attention with an additive bias. ``causal`` lets
    the flash kernel apply the causal mask itself. Returns ``(out, (k, v))``:
    the two-stream query stream attends the content stream's k and v
    (``shared_kv``)."""

    def __init__(self, d_model: int, n_head: int, dropout: float = 0.0, causal: bool = False):
        super().__init__()
        self.d_model, self.n_head, self.dropout = d_model, n_head, dropout
        self.causal = causal
        self.q = nn.Linear(d_model, d_model)
        self.k = nn.Linear(d_model, d_model)
        self.v = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def _init_weights(self, generator: torch.Generator) -> None:
        for lin in (self.q, self.k, self.v, self.out):
            nn.init.xavier_uniform_(lin.weight, generator=generator)
            nn.init.zeros_(lin.bias)

    def forward(self, query_in: torch.Tensor, kv_in: torch.Tensor,
                bias: Optional[torch.Tensor], training: bool = False, generator=None,
                flash_ctx: Optional[tuple] = None, shared_kv: Optional[tuple] = None):
        """``bias`` is the composed additive bias of the dense path (not
        needed when the flash path is taken); ``flash_ctx`` is ``(extra_bias,
        pad_mask, bias_grad)`` and selects the flash path, None the dense
        one: the encoder decides (``use_flash``), once for all its layers."""
        B, Sq, _ = query_in.shape
        Sk = kv_in.shape[1]
        H, Dh = self.n_head, self.d_model // self.n_head
        q = self.q(query_in).view(B, Sq, H, Dh)
        if shared_kv is not None:
            k, v = shared_kv
        else:
            k = self.k(kv_in).view(B, Sk, H, Dh)
            v = self.v(kv_in).view(B, Sk, H, Dh)
        if flash_ctx is not None:
            # the fused kernels for long sequences: causal and padding are
            # applied inside, only the perm mask, the local window and the
            # relative bias are read as a tensor. bias_grad is set when the bias carries the
            # learned relative positions: the backward then takes the dense
            # route that yields the bias gradient
            extra_bias, pad_mask, bias_grad = flash_ctx
            ctx = flash_attention(q, k, v, bias=extra_bias, pad_mask=pad_mask,
                                  causal=self.causal, bias_grad=bias_grad)
            return self.out(ctx.reshape(B, Sq, H * Dh)), (k, v)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * Dh ** -0.5 + bias
        probs = torch.softmax(logits, dim=-1)
        # fully blocked query rows (every key masked) output 0, not the
        # uniform-softmax average
        row_ok = (bias > NEG_INF / 2).any(dim=-1, keepdim=True)
        probs = probs * row_ok.to(probs.dtype)
        probs = dropout(probs, self.dropout, training, generator)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out(ctx.reshape(B, Sq, H * Dh)), (k, v)


class LSHSelfAttention(nn.Module):
    """Reformer's LSH attention: one projection for queries and keys (the
    hash compares them in one space), values and an output projection as
    usual, and dropout on the context (the probabilities live in the
    sorted chunks). The rotations of the hash are an untrained buffer,
    drawn from ``seed`` (``ops.lsh_attention.draw_rotations``); they live
    in the ``state_dict``, so a saved model keeps its buckets."""

    def __init__(self, d_model: int, n_head: int, dropout: float = 0.0, causal: bool = False,
                 num_buckets: int = 8, num_hashes: int = 2, chunk_size: int = 8, seed: int = 0):
        super().__init__()
        self.d_model, self.n_head, self.dropout = d_model, n_head, dropout
        self.causal = causal
        self.chunk_size = chunk_size
        self.qk = nn.Linear(d_model, d_model)
        self.v = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)
        self.register_buffer(
            "rotations", draw_rotations(d_model // n_head, num_hashes, num_buckets, seed))

    def _init_weights(self, generator: torch.Generator) -> None:
        for lin in (self.qk, self.v, self.out):
            nn.init.xavier_uniform_(lin.weight, generator=generator)
            nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor], training: bool = False,
                generator=None) -> torch.Tensor:
        B, S, _ = x.shape
        H, Dh = self.n_head, self.d_model // self.n_head
        ctx = lsh_attention(self.qk(x).view(B, S, H, Dh), self.v(x).view(B, S, H, Dh),
                            self.rotations, pad_mask=pad_mask, causal=self.causal,
                            chunk_size=self.chunk_size)
        ctx = dropout(ctx, self.dropout, training, generator)
        return self.out(ctx.reshape(B, S, H * Dh))


# flax.linen's activations by name (``nn.gelu`` is the tanh approximation)
ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "silu": F.silu,
    "swish": F.silu,
    "elu": F.elu,
    "leaky_relu": F.leaky_relu,
    "softplus": F.softplus,
}
# the layer's activations: flax's, and the erf GELU of HF's BERT family
LAYER_ACTIVATIONS = {**ACTIVATIONS, "gelu_exact": F.gelu}


class TransformerLayer(nn.Module):
    """One transformer layer: attention and a feed-forward block. Pre-LN
    (``norm_first``, the XLNet/GPT-2 form: each block on a LayerNorm of its
    input, added back to it) or post-LN (the BERT form: ``ln1(h + attn)``,
    then ``ln2(h + ffn(h))``). Given a query stream, the same attention and
    feed-forward weights run it after the content stream, on the content
    stream's keys and values. Given ``mem`` (B, M, D), the cached inputs of
    this layer, the keys and values also cover them (dense path).
    ``attn_type="lsh"`` runs ``LSHSelfAttention`` in place of the dense
    attention: it takes the padding mask and no bias."""

    def __init__(self, d_model: int, n_head: int, d_ff: int, layer_norm_eps: float = 1e-12,
                 dropout: float = 0.0, attn_dropout: float = 0.0, causal: bool = False,
                 activation: str = "gelu", norm_first: bool = True, attn_type: str = "dense",
                 lsh_num_buckets: int = 8, lsh_num_hashes: int = 2, lsh_chunk_size: int = 8,
                 lsh_seed: int = 0):
        super().__init__()
        if activation not in LAYER_ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; "
                             f"known: {sorted(LAYER_ACTIVATIONS)}")
        self.dropout = dropout
        self.activation = activation
        self.norm_first = norm_first
        self.attn_type = attn_type
        if attn_type == "lsh":
            self.attn = LSHSelfAttention(d_model, n_head, attn_dropout, causal,
                                         lsh_num_buckets, lsh_num_hashes, lsh_chunk_size,
                                         lsh_seed)
        else:
            self.attn = MultiHeadAttention(d_model, n_head, attn_dropout, causal)
        self.ln1 = nn.LayerNorm(d_model, eps=layer_norm_eps)
        self.ln2 = nn.LayerNorm(d_model, eps=layer_norm_eps)
        self.ffn_in = nn.Linear(d_model, d_ff)
        self.ffn_out = nn.Linear(d_ff, d_model)

    def _init_weights(self, generator: torch.Generator) -> None:
        for lin in (self.ffn_in, self.ffn_out):
            _lecun_normal_(lin.weight, lin.in_features, generator)
            nn.init.zeros_(lin.bias)

    def forward(self, hidden: torch.Tensor, bias: Optional[torch.Tensor],
                training: bool = False, generator=None,
                flash_ctx: Optional[tuple] = None,
                query_hidden: Optional[torch.Tensor] = None,
                query_bias: Optional[torch.Tensor] = None,
                query_flash_ctx: Optional[tuple] = None,
                mem: Optional[torch.Tensor] = None,
                pad_mask: Optional[torch.Tensor] = None):
        """``(hidden, query_hidden)``; the second is None without a query
        stream. Dropout draws: the content stream's, then the query
        stream's. ``pad_mask`` is read by an LSH layer only."""
        act = LAYER_ACTIVATIONS[self.activation]

        def drop(t):
            return dropout(t, self.dropout, training, generator)

        def ffn(t):
            return self.ffn_out(drop(act(self.ffn_in(t))))

        def blocks(t, ctx):
            if self.norm_first:
                t = t + drop(ctx)
                return t + drop(ffn(self.ln2(t)))
            t = self.ln1(t + drop(ctx))
            return self.ln2(t + drop(ffn(t)))

        x = self.ln1(hidden) if self.norm_first else hidden
        if self.attn_type == "lsh":
            if mem is not None or query_hidden is not None:
                raise NotImplementedError("LSH layers do not support mem_len or two-stream")
            return blocks(hidden, self.attn(x, pad_mask, training, generator)), None
        kv_x = x
        if mem is not None:
            # LayerNorm is positionwise: ln1 of the memory rows is the rows'
            # ln1. The memory path is dense.
            kv_x = torch.cat([self.ln1(mem) if self.norm_first else mem, x], dim=1)
            flash_ctx = query_flash_ctx = None
        ctx, kv = self.attn(x, kv_x, bias, training, generator, flash_ctx)
        hidden = blocks(hidden, ctx)
        if query_hidden is not None:
            qx = self.ln1(query_hidden) if self.norm_first else query_hidden
            q_ctx, _ = self.attn(qx, kv_x, query_bias, training, generator, query_flash_ctx,
                                 shared_kv=kv)
            query_hidden = blocks(query_hidden, q_ctx)
        return hidden, query_hidden


class TransformerEncoder(nn.Module):
    """The unified body: ``forward(inputs_embeds, pad_mask, perm_mask) → (B, S,
    d_model)``, the query stream's states when two streams run (``two_stream``
    and a ``perm_mask``); with ``return_mems`` the pair ``(states, mems)``."""

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
        max_position: int = 512,
        two_stream: bool = False,
        activation: str = "gelu",
        norm_first: bool = True,
        embed_layer_norm: bool = False,
        share_layers: bool = False,
        mem_len: int = 0,
        axial_pos_shape: Optional[tuple] = None,
        axial_pos_embds_dim: Optional[tuple] = None,
        attn_layers: Optional[tuple] = None,
        lsh_num_buckets: int = 8,
        lsh_num_hashes: int = 2,
        lsh_chunk_size: int = 8,
    ):
        super().__init__()
        if pos_encoding not in ("relative_bias", "learned_absolute", "axial", "none"):
            raise ValueError(f"unknown pos_encoding {pos_encoding!r}")
        self.d_model, self.n_head, self.n_layer = d_model, n_head, n_layer
        self.causal = causal
        self.pos_encoding = pos_encoding
        self.max_position = max_position
        self.local_window = local_window
        self.dropout = dropout
        self.attn_dropout = attn_dropout
        self.norm_first = norm_first
        self.share_layers = share_layers
        self.mem_len = mem_len
        d_ff = d_ff or 4 * d_model
        if attn_layers is not None:
            attn_layers = tuple(attn_layers)
            if len(attn_layers) != n_layer:
                raise ValueError(f"attn_layers has {len(attn_layers)} entries for "
                                 f"n_layer={n_layer}")
            bad = set(attn_layers) - {"dense", "local", "lsh"}
            if bad:
                raise ValueError(f"unknown attn_layers entries: {sorted(bad)}")
            if share_layers and len(set(attn_layers)) > 1:
                raise ValueError("share_layers requires a uniform attn_layers pattern")
        self.attn_layers = attn_layers
        # the attention of each layer: ("lsh", None) or ("win", its window)
        if attn_layers is None:
            self.plan = [("win", local_window)] * n_layer
        else:
            self.plan = [("lsh", None) if t == "lsh"
                         else ("win", local_window if t == "local" else None)
                         for t in attn_layers]

        def layer(attn_type="dense", seed=0):
            return TransformerLayer(d_model, n_head, d_ff, layer_norm_eps, dropout, attn_dropout,
                                    causal, activation, norm_first, attn_type, lsh_num_buckets,
                                    lsh_num_hashes, lsh_chunk_size, seed)

        if share_layers:
            # ALBERT: one layer run n_layer times, under flax's name
            self.layer_shared = layer("lsh" if self.plan[0][0] == "lsh" else "dense")
        else:
            # an LSH layer's rotations are drawn from its index
            self.layers = nn.ModuleList(
                layer("lsh" if kind == "lsh" else "dense", seed=i)
                for i, (kind, _) in enumerate(self.plan))
        if pos_encoding == "learned_absolute":
            # zeros until ``_init_weights`` draws them (``Model`` does)
            self.position_embedding = nn.Parameter(torch.zeros(max_position, d_model))
        self.axial_pos_shape = axial_pos_shape
        if pos_encoding == "axial":
            if axial_pos_shape is None or axial_pos_embds_dim is None:
                raise ValueError("pos_encoding='axial' requires axial_pos_shape and "
                                 "axial_pos_embds_dim")
            d1, d2 = axial_pos_shape
            e1, e2 = axial_pos_embds_dim
            if d1 * d2 < max_position:
                raise ValueError(f"axial_pos_shape {tuple(axial_pos_shape)} covers {d1 * d2} "
                                 f"positions < max_position={max_position}")
            if e1 + e2 != d_model:
                raise ValueError(f"axial_pos_embds_dim {tuple(axial_pos_embds_dim)} must "
                                 f"sum to d_model={d_model}")
            self.axial_pos_0 = nn.Parameter(torch.zeros(d1, e1))
            self.axial_pos_1 = nn.Parameter(torch.zeros(d2, e2))
        self.rel_pos = (
            RelativePositionBias(n_head, bidirectional=not causal)
            if pos_encoding == "relative_bias" else None
        )
        if embed_layer_norm:
            self.ln_emb = nn.LayerNorm(d_model, eps=layer_norm_eps)
        self.embed_layer_norm = embed_layer_norm
        if norm_first:
            # pre-LN ends with a LayerNorm; post-LN normalised inside every layer
            self.ln_f = nn.LayerNorm(d_model, eps=layer_norm_eps)
        self.two_stream = two_stream
        if two_stream:
            # the query stream's state before the first layer, at every position
            self.query_stream_init = nn.Parameter(torch.zeros(d_model))

    def _init_weights(self, generator: torch.Generator) -> None:
        if self.pos_encoding == "learned_absolute":
            nn.init.normal_(self.position_embedding, 0.0, 0.02, generator=generator)
        if self.pos_encoding == "axial":
            nn.init.normal_(self.axial_pos_0, 0.0, 0.02, generator=generator)
            nn.init.normal_(self.axial_pos_1, 0.0, 0.02, generator=generator)
        if self.two_stream:
            nn.init.normal_(self.query_stream_init, 0.0, 0.02, generator=generator)

    def stack(self) -> list:
        """The layers in the order they run (the shared one n_layer times)."""
        return [self.layer_shared] * self.n_layer if self.share_layers else list(self.layers)

    def init_mems(self, batch_size: int, device=None) -> dict:
        """Empty segment memory: (L, B, M, D) cached layer inputs and a (B, M)
        validity mask, all False, so that the first segment runs as one
        without memory. Thread the returned dict through successive
        ``forward(..., mems=..., return_mems=True)`` calls."""
        device = device if device is not None else next(self.parameters()).device
        return {"states": torch.zeros((self.n_layer, batch_size, self.mem_len, self.d_model),
                                      device=device),
                "pad": torch.zeros((batch_size, self.mem_len), dtype=torch.bool, device=device)}

    def _positions(self, p: torch.Tensor) -> torch.Tensor:
        """The absolute position embeddings of the positions ``p``."""
        if self.pos_encoding == "axial":
            d2 = self.axial_pos_shape[1]
            return torch.cat([self.axial_pos_0[p // d2], self.axial_pos_1[p % d2]], dim=-1)
        return self.position_embedding[p]

    def _check_lsh(self, perm_mask, segment_ids, mems) -> None:
        """The JAX package's refusals for LSH layers: what bucket-sorted
        chunks cannot carry."""
        if perm_mask is not None or self.two_stream:
            raise NotImplementedError(
                "LSH attention layers do not support perm_mask / two-stream (PLM) — "
                "Reformer runs MLM")
        if segment_ids is not None:
            raise NotImplementedError(
                "session packing (segment_ids) is not supported with LSH attention layers: "
                "the block-diagonal restriction does not survive bucket-sorted chunking")
        if mems is not None or self.mem_len:
            raise NotImplementedError(
                "mem_len segment recurrence is not supported with LSH attention layers")
        if self.pos_encoding == "relative_bias":
            raise NotImplementedError(
                "relative_bias positions are not supported with LSH layers (per-pair "
                "biases do not survive chunking); Reformer uses axial absolute positions")

    def forward(
        self,
        inputs_embeds: torch.Tensor,
        pad_mask: Optional[torch.Tensor] = None,
        perm_mask: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
        training: bool = False,
        generator: Optional[torch.Generator] = None,
        mems: Optional[dict] = None,
        return_mems: bool = False,
    ):
        if any(kind == "lsh" for kind, _ in self.plan):
            self._check_lsh(perm_mask, segment_ids, mems)
        B, S = inputs_embeds.shape[:2]
        # two streams key on the scheme's perm mask, not the merged one below
        scheme_perm = perm_mask
        if segment_ids is not None:
            if mems is not None:
                raise NotImplementedError(
                    "segment_ids (session packing) cannot be combined with mem_len segment "
                    "recurrence")
            # session packing: no attention across segments, through the
            # perm mask's channel ("query i may not attend key j")
            seg_block = (segment_ids[:, :, None] != segment_ids[:, None, :]).float()
            perm_mask = seg_block if perm_mask is None else torch.maximum(perm_mask, seg_block)
        M = mems["states"].shape[2] if mems is not None else 0
        mem_pad = mems["pad"] if mems is not None else None
        hidden = inputs_embeds.float()
        abs_pos = None
        if self.pos_encoding in ("learned_absolute", "axial"):
            # loud guard: a longer batch would otherwise run off the table
            if S > self.max_position:
                raise ValueError(
                    f"sequence length {S} exceeds max_position={self.max_position}"
                )
            pos = torch.arange(S, device=hidden.device)
            if segment_ids is not None:
                # positions restart at each packed session's start
                is_start = torch.ones_like(segment_ids, dtype=torch.bool)
                is_start[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
                start = torch.where(is_start, pos, 0).cummax(dim=1).values
                abs_pos = self._positions(pos - start)
            else:
                abs_pos = self._positions(pos)[None]
            hidden = hidden + abs_pos
        rel_bias = self.rel_pos(S, M) if self.rel_pos is not None else None
        two_stream = self.two_stream and scheme_perm is not None
        if two_stream and self.attn_layers is not None:
            raise NotImplementedError(
                "two-stream (PLM) does not compose with per-layer attn_layers patterns")
        # the memory path is dense
        flash = use_flash(S, self.attn_dropout, training) and mems is None

        def biases(query_stream: bool, window: Optional[int]):
            """``(bias, flash_ctx)`` of one stream and window: the composed
            bias of the dense path, or the flash context, built once and
            handed to every layer of that window. There only the perm mask,
            the local window and the relative bias are a tensor; the kernel
            applies causal and padding itself."""
            if flash:
                extra = make_extra_bias(S, perm_mask, window, query_stream,
                                        device=hidden.device)
                if rel_bias is not None:
                    extra = rel_bias if extra is None else extra + rel_bias
                return None, (extra, pad_mask, rel_bias is not None)
            bias = make_attention_bias(
                pad_mask, S, causal=self.causal, perm_mask=perm_mask,
                local_window=window, query_stream=query_stream,
                device=hidden.device, mem_len=M, mem_pad=mem_pad,
            )
            return (bias if rel_bias is None else bias + rel_bias), None

        # LSH layers build no (S, S) bias; the others share one per window
        per_window = {w: biases(False, w) for kind, w in self.plan if kind == "win"}
        query_hidden = query_bias = query_flash_ctx = None
        if two_stream:
            query_hidden = self.query_stream_init.expand(B, S, self.d_model)
            if abs_pos is not None:
                query_hidden = query_hidden + abs_pos
            query_bias, query_flash_ctx = biases(True, self.local_window)
        if self.embed_layer_norm:
            hidden = self.ln_emb(hidden)
            if query_hidden is not None:
                query_hidden = self.ln_emb(query_hidden)
        hidden = dropout(hidden, self.dropout, training, generator)
        if query_hidden is not None:
            query_hidden = dropout(query_hidden, self.dropout, training, generator)
        collect = return_mems and self.mem_len > 0
        new_states = []
        for i, layer in enumerate(self.stack()):
            kind, window = self.plan[i]
            bias, flash_ctx = per_window[window] if kind == "win" else (None, None)
            mem = mems["states"][i] if mems is not None else None
            if collect:
                ext = hidden if mem is None else torch.cat([mem, hidden], dim=1)
                new_states.append(self._last(ext).detach())
            hidden, query_hidden = layer(hidden, bias, training, generator, flash_ctx,
                                         query_hidden, query_bias, query_flash_ctx, mem,
                                         pad_mask)
        out = query_hidden if query_hidden is not None else hidden
        if self.norm_first:
            out = self.ln_f(out)
        if not collect:
            return out
        cur_ok = pad_mask if pad_mask is not None else torch.ones(
            (B, S), dtype=torch.bool, device=out.device)
        ext_ok = cur_ok if mem_pad is None else torch.cat([mem_pad, cur_ok], dim=1)
        return out, {"states": torch.stack(new_states), "pad": self._last(ext_ok)}

    def _last(self, t: torch.Tensor) -> torch.Tensor:
        """The last ``mem_len`` positions of (B, T, ...) ``t``, left-padded
        with zeros (False) when T is shorter."""
        if t.shape[1] >= self.mem_len:
            return t[:, t.shape[1] - self.mem_len:]
        pad = t.new_zeros((t.shape[0], self.mem_len - t.shape[1], *t.shape[2:]))
        return torch.cat([pad, t], dim=1)
