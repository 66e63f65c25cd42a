"""Fused (flash-style) attention: forward K5 and backward K6a, K6b, K6c.

Counterpart of ``transformers4rec_tpu/ops/attention.py``.
``flash_attention(q, k, v, bias, pad_mask, causal, bias_grad)`` computes
``softmax(q·kᵀ·Dh^-½ + masks + bias)·v`` for ``(B, S, H, Dh)`` tensors by an
online softmax over key tiles, so the (S, S) probabilities never reach device
memory, and keeps only the output and the row logsumexp for a backward that
recomputes them tile by tile.

- ``flash_fwd`` (K5) → ``(out, lse)``;
- ``flash_bwd_fused`` (K6a) → ``(dq, dk, dv)`` from one recomputation, with
  per-key-tile partials of dq in device memory and a reduce;
- ``flash_bwd_dq`` (K6b) and ``flash_bwd_dkv`` (K6c): the same gradients from
  two passes and no partials. ``flash_backward`` takes K6a while the partials
  stay under ``BWD_DQ_PARTIAL_MAX_BYTES`` and K6b + K6c above it.

K5 is the registered operator ``t4r::flash_fwd`` (``flash_fwd_op``), so that
a ``torch.export`` program of the inference path holds it as a node which
runs the kernel on the card and the plain version on the CPU.
For CUDA tensors the four wrappers launch the hand-written kernels of
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` (and raise when they cannot;
K5 and K6a in one of two designs, ``mma.sync`` or ``wgmma``, by head dim:
``uses_wgmma``; K6b and K6c in one of two, streamed or ``mma.sync``:
``uses_split_stream``);
for CPU tensors they run ``flash_forward_plain``, ``flash_bwd_fused_plain``,
``flash_bwd_dq_plain`` and ``flash_bwd_dkv_plain`` (together:
``flash_backward_plain``), plain PyTorch versions of the same arithmetic.
Each wrapper counts its launches in ``<wrapper>.launches``, and those of
its bf16 form also in ``<wrapper>.bf16_launches``, those of its f16 form in
``<wrapper>.f16_launches``.

q, k, v and dO are float32, bfloat16 or float16, all four of one type (the
encoder's compute type), and the outputs out, dq, dk and dv are of that
type; lse, delta, the bias and K6a's dq partials are float32 in all three.
On the card each type has its own form of every kernel (``csrc/flash_fwd.cu``
and ``csrc/flash_bwd.cu`` built as they are, with ``-DT4R_FLASH_BF16`` as
the libraries ``flash_fwd_bf16`` and ``flash_bwd_bf16``, and with
``-DT4R_FLASH_F16`` as ``flash_fwd_f16`` and ``flash_bwd_f16``): the bf16
form reads bf16 as it is stored where the f32 form rounds its f32 loads,
the f16 form widens its f16 loads to f32 (exactly) and rounds them as the
f32 form does, and both round their f32 accumulators once to their type as
they write them. A type that the kernels do not take raises; nothing is
converted before a launch.

The arithmetic, as the reference's: q, k, v and dO are rounded to bf16 (the
identity on bf16 inputs; f16 goes through its exact f32 value), every
product accumulates in f32, the scale is applied in f32 after the product, P
is rounded to bf16 before P·v and Pᵀ·dO and dS before dS·k and dSᵀ·q. Masks
are finite: causal *replaces* a logit by ``NEG`` where key > query, padding
*adds* ``NEG``, the bias is *added*. A row whose running maximum never rose
above ``NEG / 2`` has no valid key: its output is 0 and its lse the sentinel
``-2·NEG``, so ``exp(logit − lse)`` is 0 in the backward. Key tiles wholly in
a query tile's future are skipped.

With ``bias_grad=True`` (a learned bias, e.g. the relative-position table)
the forward is K5 and the whole backward is autograd through
``reference_attention`` recomputed with f32 logits, which yields the bias
gradient; the kernels give the bias none.

``use_flash`` is the dispatch policy of ``MultiHeadAttention``: S ≥ 128 and
no attention dropout in training.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .build import raise_on_error

NEG = -1e9
LSE_MASKED = -2.0 * NEG
TILE = 64  # queries and keys per tile, in the kernels and the plain versions
# dq partials (key tiles × the bytes of dq) above which the backward takes the
# two-pass kernels instead of the fused one
BWD_DQ_PARTIAL_MAX_BYTES = 256 << 20
_MAX_DH = 128
# the head dims that take the Hopper (wgmma) kernels on the card
WGMMA_MIN_DH, WGMMA_MAX_DH = 33, 64
# the head dims that take the streamed designs of K6b and K6c, and the queries
# of K6b's blocks and the keys of K6c's
SPLIT_STREAM_MAX_DH, DQ_STREAM_QUERIES, DKV_STREAM_KEYS = 32, 128, 128


def reference_attention(q, k, v, bias=None, pad_mask=None, causal=False):
    """Dense attention with float32 logits and softmax: ``softmax(q·kᵀ·scale
    + composed bias)·v`` with the rows that have no valid key set to zero
    (what ``MultiHeadAttention`` computes on its dense path). When q is not
    float32 the probabilities are rounded to q's type (bf16 or f16, as the
    JAX package's ``reference_attention`` rounds them) before the product
    with v, whose sum is float32; the context is returned in q's type.
    Differentiable in q, k, v and bias."""
    B, S, H, Dh = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (Dh ** -0.5)
    total_bias = torch.zeros((1, 1, S, S), dtype=torch.float32, device=q.device)
    if bias is not None:
        total_bias = total_bias + bias.float()
    if causal:
        idx = torch.arange(S, device=q.device)
        total_bias = total_bias + torch.where(idx[None, :] > idx[:, None], NEG, 0.0)[None, None]
    if pad_mask is not None:
        total_bias = total_bias + torch.where(pad_mask[:, None, None, :], 0.0, NEG)
    probs = torch.softmax(logits + total_bias, dim=-1)
    row_ok = (total_bias > NEG / 2).any(dim=-1, keepdim=True)
    probs = probs * row_ok.to(probs.dtype)
    if q.dtype != torch.float32:
        probs = probs.to(q.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return ctx.to(q.dtype)


# ------------------------------------------------------------ plain versions
def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, Dh) → (B, H, S, Dh) float32 of the bf16-rounded values (an
    f16 value through its exact f32 value, as the kernels round it)."""
    return x.float().to(torch.bfloat16).float().permute(0, 2, 1, 3)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _tile_logits(qt, kt, r0: int, k0: int, scale: float, causal: bool, pad_add, bias):
    """The scaled and masked logits of query rows ``r0..`` against key
    columns ``k0..``: (B, H, R, C) f32. The one function the forward and all
    backward passes share."""
    R, C = qt.shape[2], kt.shape[2]
    logits = (qt @ kt.transpose(-1, -2)) * scale
    if causal:
        rows = torch.arange(r0, r0 + R, device=qt.device)[:, None]
        cols = torch.arange(k0, k0 + C, device=qt.device)[None, :]
        logits = torch.where(cols > rows, NEG, logits)
    if pad_add is not None:
        logits = logits + pad_add[:, None, None, k0:k0 + C]
    if bias is not None:
        logits = logits + bias[:, :, r0:r0 + R, k0:k0 + C]
    return logits


def _pad_add(pad_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if pad_mask is None else torch.where(pad_mask, 0.0, NEG).float()


def flash_forward_plain(q, k, v, bias=None, pad_mask=None, causal=False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K5: the online softmax over key tiles of ``TILE``.

    q, k, v (B, S, H, Dh); bias f32 (1|B, 1|H, S, S) or None; pad_mask (B, S)
    bool or None. Returns ``(out (B, S, H, Dh) in q's type, lse (B·H, S)
    f32)``. The kernel's key columns beyond S hold 2·NEG and add exact zeros;
    here they do not exist."""
    B, S, H, Dh = q.shape
    scale = Dh ** -0.5
    qh, kh, vh = _heads_first(q), _heads_first(k), _heads_first(v)
    pad_add = _pad_add(pad_mask)
    bias = None if bias is None else bias.float()
    m = torch.full((B, H, S), 2.0 * NEG, dtype=torch.float32, device=q.device)
    s = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, Dh), dtype=torch.float32, device=q.device)
    for k0 in range(0, S, TILE):
        k1 = min(k0 + TILE, S)
        r0 = k0 if causal else 0  # query tiles wholly before the key tile skip it
        logits = _tile_logits(qh[:, :, r0:], kh[:, :, k0:k1], r0, k0, scale, causal, pad_add,
                              bias)
        m_new = torch.maximum(m[:, :, r0:], logits.max(-1).values)
        corr = torch.exp(m[:, :, r0:] - m_new)
        p = torch.exp(logits - m_new[..., None])
        s[:, :, r0:] = s[:, :, r0:] * corr + p.sum(-1)
        m[:, :, r0:] = m_new
        acc[:, :, r0:] = acc[:, :, r0:] * corr[..., None] + _bf16(p) @ vh[:, :, k0:k1]
    row_ok = m > NEG / 2
    denom = torch.where(s > 0, s, 1.0)
    out = torch.where(row_ok[..., None], acc / denom[..., None], 0.0)
    lse = torch.where(row_ok, m + torch.log(denom), LSE_MASKED)
    return out.permute(0, 2, 1, 3).to(q.dtype).contiguous(), lse.reshape(B * H, S)


def _bwd_tile(qh, kh, vh, doh, lse, delta, r0, r1, k0, k1, scale, causal, pad_add, bias):
    """P and dS (both rounded to bf16) of query rows [r0, r1) against key
    columns [k0, k1): (B, H, R, C) each."""
    logits = _tile_logits(qh[:, :, r0:r1], kh[:, :, k0:k1], r0, k0, scale, causal, pad_add, bias)
    p = torch.exp(logits - lse[:, :, r0:r1, None])  # 0 on rows with no valid key
    dp = doh[:, :, r0:r1] @ vh[:, :, k0:k1].transpose(-1, -2)
    ds = p * (dp - delta[:, :, r0:r1, None])
    return _bf16(p), _bf16(ds)


def _bwd_plain_inputs(q, k, v, d_out, lse, delta, bias, pad_mask):
    B, S, H, _ = q.shape
    return (_heads_first(q), _heads_first(k), _heads_first(v), _heads_first(d_out),
            lse.reshape(B, H, S), delta.reshape(B, H, S), _pad_add(pad_mask),
            None if bias is None else bias.float())


def _from_heads_first(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, S, Dh) f32 → (B, S, H, Dh) in ``dtype``, rounded once."""
    return x.permute(0, 2, 1, 3).to(dtype).contiguous()


def _bwd_plain_key_major(q, k, v, d_out, lse, delta, bias, pad_mask, causal, with_dq: bool):
    """The loop of K6a and K6c: per key tile, over the query rows from the
    causal start. With ``with_dq`` (K6a) each key tile's dS·k is a partial of
    dq, and the partials are added in key-tile order, then scaled."""
    B, S, H, Dh = q.shape
    scale = Dh ** -0.5
    qh, kh, vh, doh, lse, delta, pad_add, bias = _bwd_plain_inputs(
        q, k, v, d_out, lse, delta, bias, pad_mask)
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    dq = torch.zeros_like(qh) if with_dq else None
    for k0 in range(0, S, TILE):
        k1 = min(k0 + TILE, S)
        r0 = k0 if causal else 0
        p, ds = _bwd_tile(qh, kh, vh, doh, lse, delta, r0, S, k0, k1, scale, causal, pad_add,
                          bias)
        dv[:, :, k0:k1] = p.transpose(-1, -2) @ doh[:, :, r0:]
        dk[:, :, k0:k1] = (ds.transpose(-1, -2) @ qh[:, :, r0:]) * scale
        if with_dq:
            dq[:, :, r0:] += ds @ kh[:, :, k0:k1]
    dk, dv = _from_heads_first(dk, q.dtype), _from_heads_first(dv, q.dtype)
    if with_dq:
        return _from_heads_first(dq * scale, q.dtype), dk, dv
    return dk, dv


def flash_bwd_fused_plain(q, k, v, d_out, lse, delta, bias=None, pad_mask=None, causal=False):
    """Plain PyTorch K6a → ``(dq, dk, dv)``."""
    return _bwd_plain_key_major(q, k, v, d_out, lse, delta, bias, pad_mask, causal, True)


def flash_bwd_dkv_plain(q, k, v, d_out, lse, delta, bias=None, pad_mask=None, causal=False):
    """Plain PyTorch K6c → ``(dk, dv)``."""
    return _bwd_plain_key_major(q, k, v, d_out, lse, delta, bias, pad_mask, causal, False)


def flash_bwd_dq_plain(q, k, v, d_out, lse, delta, bias=None, pad_mask=None, causal=False):
    """Plain PyTorch K6b → dq. The loop of K6b: per query tile, over the key tiles up to the causal
    end, dq summed tile by tile and scaled at the end."""
    B, S, H, Dh = q.shape
    scale = Dh ** -0.5
    qh, kh, vh, doh, lse, delta, pad_add, bias = _bwd_plain_inputs(
        q, k, v, d_out, lse, delta, bias, pad_mask)
    dq = torch.zeros_like(qh)
    for r0 in range(0, S, TILE):
        r1 = min(r0 + TILE, S)
        k_end = min(S, r0 + TILE) if causal else S
        for k0 in range(0, k_end, TILE):
            k1 = min(k0 + TILE, S)
            _, ds = _bwd_tile(qh, kh, vh, doh, lse, delta, r0, r1, k0, k1, scale, causal,
                              pad_add, bias)
            dq[:, :, r0:r1] += ds @ kh[:, :, k0:k1]
    return _from_heads_first(dq * scale, q.dtype)


def row_delta(d_out: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO ∘ O) in f32 from dO and the forward's O (either
    upcast), laid out as the lse: (B·H, S)."""
    B, S, H, _ = out.shape
    return (d_out.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(B * H, S).contiguous()


def flash_backward_plain(q, k, v, bias, pad_mask, causal, out, lse, d_out, fused: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward → ``(dq, dk, dv)``, each (B, S, H, Dh) in q's
    type: the arithmetic of K6a with ``fused`` and of K6b + K6c without. The two
    differ in the order of dq's sum only."""
    delta = row_delta(d_out, out)
    if fused:
        return flash_bwd_fused_plain(q, k, v, d_out, lse, delta, bias, pad_mask, causal)
    dq = flash_bwd_dq_plain(q, k, v, d_out, lse, delta, bias, pad_mask, causal)
    dk, dv = flash_bwd_dkv_plain(q, k, v, d_out, lse, delta, bias, pad_mask, causal)
    return dq, dk, dv


# --------------------------------------------------------------- the kernels
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = {
    # q k v pad bias | bias strides | out lse | B S H Dh causal | scale | wgmma | stream
    "flash_fwd": ("flash_fwd", [_P] * 5 + [_L] * 2 + [_P] * 2 + [_I] * 5 + [_F, _I, _P]),
    # q k v dO lse delta pad bias | strides | dq_part dq dk dv | ...
    "flash_bwd_fused": ("flash_bwd", [_P] * 8 + [_L] * 2 + [_P] * 4 + [_I] * 5 + [_F, _I, _P]),
    "flash_bwd_dq": ("flash_bwd", [_P] * 8 + [_L] * 2 + [_P] * 1 + [_I] * 5 + [_F, _I, _P]),
    "flash_bwd_dkv": ("flash_bwd", [_P] * 8 + [_L] * 2 + [_P] * 2 + [_I] * 5 + [_F, _I, _P]),
}


# each stored type's form of the kernels: its library's suffix and the
# type's code there (``t4r_flash_elem_kind``)
_FORMS = {torch.float32: ("", 0), torch.bfloat16: ("_bf16", 1), torch.float16: ("_f16", 2)}


def _entry(name: str, dtype: torch.dtype):
    """``(library, C function)`` of a kernel's form for ``dtype``, the
    function typed."""
    from .build import load

    source, argtypes = _ARGTYPES[name]
    suffix, kind = _FORMS[dtype]
    source += suffix
    lib = load(source)
    fn = getattr(lib, f"t4r_{name}")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, _I
        if lib.t4r_flash_tile_rows() != TILE:
            raise RuntimeError(f"{source}: the kernels' tile is not {TILE} rows")
        if lib.t4r_flash_elem_bytes() != dtype.itemsize or lib.t4r_flash_elem_kind() != kind:
            raise RuntimeError(f"{source}: not the form for {dtype}")
        if name in ("flash_bwd_dq", "flash_bwd_dkv") \
                and lib.t4r_flash_stream_max_dh() != SPLIT_STREAM_MAX_DH:
            raise RuntimeError(f"{source}: the streamed K6b and K6c are not for head dims up to "
                               f"{SPLIT_STREAM_MAX_DH}")
    return lib, fn


def _check_cuda_inputs(op: str, tensors: dict, rows: dict, bias, pad_mask):
    """Raise on what the kernels do not take; returns ``(bias strides in
    elements, pad mask as bytes | None)``. ``tensors`` are (B, S, H, Dh), all
    f32, all bf16 or all f16; ``rows`` (B·H, S) and the bias f32."""
    q = tensors["q"]
    if q.dtype not in _FORMS:
        raise TypeError(f"{op}: q is {q.dtype}; the kernels take float32, bfloat16 or "
                        "float16")
    if q.dim() != 4:
        raise ValueError(f"{op}: q must be (B, S, H, Dh), got {tuple(q.shape)}")
    B, S, H, Dh = q.shape
    if Dh % 4 or not 4 <= Dh <= _MAX_DH or min(B, S, H) < 1:
        raise ValueError(f"{op}: needs Dh a multiple of 4 in [4, {_MAX_DH}] and B, S, H >= 1, "
                         f"got {tuple(q.shape)}")
    named = {**tensors, **rows}
    if bias is not None:
        named["bias"] = bias
    if pad_mask is not None:
        named["pad_mask"] = pad_mask
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{op}: {name} is on {t.device}, q on {q.device}: expected one "
                             "CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
        want = (torch.bool if name == "pad_mask" else q.dtype if name in tensors
                else torch.float32)
        if t.dtype != want:
            raise TypeError(f"{op}: {name} is {t.dtype}, expected {want}")
    # four values a load: float4 (16 bytes) or four bf16 or f16 (8 bytes)
    align = 4 * q.element_size()
    for name, t in tensors.items():
        if t.shape != q.shape:
            raise ValueError(f"{op}: {name} is {tuple(t.shape)}, q {tuple(q.shape)}")
        if t.data_ptr() % align:
            raise ValueError(f"{op}: {name} must be {align}-byte aligned (loads of 4 values)")
    for name, t in rows.items():
        if t.shape != (B * H, S):
            raise ValueError(f"{op}: {name} must be (B*H, S), got {tuple(t.shape)}")
    if pad_mask is not None and pad_mask.shape != (B, S):
        raise ValueError(f"{op}: pad_mask must be (B, S), got {tuple(pad_mask.shape)}")
    strides = (0, 0)
    if bias is not None:
        if bias.dim() != 4 or bias.shape[0] not in (1, B) or bias.shape[1] not in (1, H) \
                or bias.shape[2:] != (S, S):
            raise ValueError(f"{op}: bias must be (1|B, 1|H, S, S), got {tuple(bias.shape)}")
        strides = (0 if bias.shape[0] == 1 else bias.shape[1] * S * S,
                   0 if bias.shape[1] == 1 else S * S)
    return strides, (None if pad_mask is None else pad_mask.view(torch.uint8))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(name: str, q: torch.Tensor, args_before, args_after, causal: bool,
            extra=()) -> None:
    """Call the C function of ``name``'s form for q's type on q's device and
    current stream."""
    lib, fn = _entry(name, q.dtype)
    B, S, H, Dh = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args_before, *args_after, B, S, H, Dh, int(causal), Dh ** -0.5, *extra, stream)
    raise_on_error(lib, err, name)


def _count(wrapper, q: torch.Tensor) -> None:
    """One launch of ``wrapper``'s kernel, in the form for q's type."""
    wrapper.launches += 1
    if q.dtype == torch.bfloat16:
        wrapper.bf16_launches += 1
    elif q.dtype == torch.float16:
        wrapper.f16_launches += 1


def uses_wgmma(head_dim: int) -> bool:
    """Which design of K5 and K6a a head dim takes on the card: the Hopper
    kernels (``wgmma`` from a ring of 128-row tiles, the head dim padded to
    64) from ``WGMMA_MIN_DH`` to ``WGMMA_MAX_DH``, the ``mma.sync`` kernels
    of 64-row tiles (the head dim padded to 16, 32, 64 or 128) elsewhere.
    Below 33 the ``mma.sync`` kernels are the faster at sessions of 256;
    above 64 K6a has no Hopper kernel (its consumers would not hold dk and
    dv of 128 values), and K5 takes the same design as K6a (``PERF.md`` §6
    has the times of both). Both designs keep dq partials of ``TILE``
    keys."""
    return WGMMA_MIN_DH <= head_dim <= WGMMA_MAX_DH


def uses_split_stream(head_dim: int) -> bool:
    """Which design both halves of the split backward, K6b and K6c, take on
    the card for a head dim: the streamed kernels (blocks of
    ``DQ_STREAM_QUERIES`` queries or ``DKV_STREAM_KEYS`` keys, a step's loads
    in flight during the step before, one row-major bf16 copy of each
    streamed tile, its transpose read by ``ldmatrix.trans``) up to
    ``SPLIT_STREAM_MAX_DH``, the ``mma.sync`` bodies above it (K6c's is the
    one K6a shares; ``PERF.md`` §6 has the times of both)."""
    return head_dim <= SPLIT_STREAM_MAX_DH


def dkv_block_order(heads: int, key_tiles: int) -> list:
    """``(batch·head, key tile)`` of each block of the streamed K6c in launch
    order (``flash_bwd_dkv_stream_kernel``'s mapping of ``blockIdx.x``): key
    tiles are the slow axis, the first (the longest under the causal mask)
    first, so that the short blocks fill the card's tail."""
    return [(block % heads, block // heads) for block in range(heads * key_tiles)]


def dq_block_order(heads: int, query_tiles: int) -> list:
    """``(batch·head, query tile)`` of each block of the streamed K6b in
    launch order (``flash_bwd_dq_stream_kernel``'s mapping of
    ``blockIdx.x``): query tiles are the slow axis, the last (the longest
    under the causal mask) first."""
    return [(block % heads, query_tiles - 1 - block // heads)
            for block in range(heads * query_tiles)]


def _flash_fwd_cuda(q, k, v, bias, pad_mask, causal, wgmma: Optional[bool] = None):
    """K5 on the card; ``wgmma`` picks the design (by default ``uses_wgmma``)."""
    strides, pad = _check_cuda_inputs("flash_fwd", {"q": q, "k": k, "v": v}, {}, bias, pad_mask)
    B, S, H, Dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    wgmma = uses_wgmma(Dh) if wgmma is None else wgmma
    _launch("flash_fwd", q,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(pad), _ptr(bias), *strides),
            (out.data_ptr(), lse.data_ptr()), causal, (int(wgmma),))
    _count(flash_fwd, q)
    return out, lse


def _bwd_cuda_args(op, q, k, v, d_out, lse, delta, bias, pad_mask):
    strides, pad = _check_cuda_inputs(op, {"q": q, "k": k, "v": v, "d_out": d_out},
                                      {"lse": lse, "delta": delta}, bias, pad_mask)
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), _ptr(pad), _ptr(bias), *strides)


def dq_partial_bytes(q: torch.Tensor) -> int:
    """Bytes of K6a's dq partials: (key tiles) × the f32 bytes of dq."""
    return -(-q.shape[1] // TILE) * q.numel() * 4


def _flash_bwd_fused_cuda(q, k, v, d_out, lse, delta, bias, pad_mask, causal,
                          wgmma: Optional[bool] = None):
    """K6a on the card; ``wgmma`` picks the design (by default
    ``uses_wgmma``; the Hopper design takes head dims up to 64)."""
    args = _bwd_cuda_args("flash_bwd_fused", q, k, v, d_out, lse, delta, bias, pad_mask)
    wgmma = uses_wgmma(q.shape[3]) if wgmma is None else wgmma
    # every element that the reduce reads is written by the kernel before it
    part = torch.empty(dq_partial_bytes(q) // 4, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    _launch("flash_bwd_fused", q, args,
            (part.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr()), causal,
            (int(wgmma),))
    _count(flash_bwd_fused, q)
    return dq, dk, dv


def _flash_bwd_dq_cuda(q, k, v, d_out, lse, delta, bias, pad_mask, causal,
                       streamed: Optional[bool] = None):
    """K6b on the card; ``streamed`` picks the design (by default
    ``uses_split_stream``; the streamed design takes head dims up to 32)."""
    args = _bwd_cuda_args("flash_bwd_dq", q, k, v, d_out, lse, delta, bias, pad_mask)
    streamed = uses_split_stream(q.shape[3]) if streamed is None else streamed
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", q, args, (dq.data_ptr(),), causal, (int(streamed),))
    _count(flash_bwd_dq, q)
    return dq


def _flash_bwd_dkv_cuda(q, k, v, d_out, lse, delta, bias, pad_mask, causal,
                        streamed: Optional[bool] = None):
    """K6c on the card; ``streamed`` picks the design (by default
    ``uses_split_stream``; the streamed design takes head dims up to 32)."""
    args = _bwd_cuda_args("flash_bwd_dkv", q, k, v, d_out, lse, delta, bias, pad_mask)
    streamed = uses_split_stream(q.shape[3]) if streamed is None else streamed
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    _launch("flash_bwd_dkv", q, args, (dk.data_ptr(), dv.data_ptr()), causal, (int(streamed),))
    _count(flash_bwd_dkv, q)
    return dk, dv


@torch.library.custom_op("t4r::flash_fwd", mutates_args=(), device_types="cpu")
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias: Optional[torch.Tensor], pad_mask: Optional[torch.Tensor],
                 causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 as the registered operator ``t4r::flash_fwd``, so that a
    ``torch.export`` program holds it as one node: on CPU tensors
    ``flash_forward_plain``, on CUDA tensors the kernel (or a raise)."""
    return flash_forward_plain(q, k, v, bias, pad_mask, causal)


@flash_fwd_op.register_kernel("cuda")
def _flash_fwd_op_cuda(q, k, v, bias, pad_mask, causal):
    return _flash_fwd_cuda(q, k, v, bias, pad_mask, causal)


@flash_fwd_op.register_fake
def _flash_fwd_op_fake(q, k, v, bias, pad_mask, causal):
    B, S, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B * H, S), dtype=torch.float32)


def flash_fwd(q, k, v, bias=None, pad_mask=None, causal=False):
    """K5: ``(out (B, S, H, Dh) in q's type, lse (B·H, S) f32)``. q, k, v
    (B, S, H, Dh) contiguous, all f32, all bf16 or all f16; bias f32
    (1|B, 1|H, S, S) or None; pad_mask (B, S) bool
    (True = a real key) or None. Goes through ``t4r::flash_fwd``: CUDA
    tensors launch the CUDA kernel (``flash_fwd.launches`` counts the
    launches); CPU tensors run ``flash_forward_plain``."""
    return flash_fwd_op(q, k, v, bias, pad_mask, bool(causal))


flash_fwd.launches = flash_fwd.bf16_launches = flash_fwd.f16_launches = 0


def flash_bwd_fused(q, k, v, d_out, lse, delta, bias=None, pad_mask=None, causal=False):
    """K6a: ``(dq, dk, dv)`` from one recomputation of P. ``lse`` is the
    forward's, ``delta`` is ``row_delta(d_out, out)``, both (B·H, S) f32.
    CUDA tensors launch the CUDA kernels (``flash_bwd_fused.launches`` counts
    the launches); CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return flash_bwd_fused_plain(q, k, v, d_out, lse, delta, bias, pad_mask, causal)
    return _flash_bwd_fused_cuda(q, k, v, d_out, lse, delta, bias, pad_mask, causal)


flash_bwd_fused.launches = flash_bwd_fused.bf16_launches = flash_bwd_fused.f16_launches = 0


def flash_bwd_dq(q, k, v, d_out, lse, delta, bias=None, pad_mask=None, causal=False):
    """K6b: dq alone. Arguments as ``flash_bwd_fused``; counts its launches
    in ``flash_bwd_dq.launches``."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, d_out, lse, delta, bias, pad_mask, causal)
    return _flash_bwd_dq_cuda(q, k, v, d_out, lse, delta, bias, pad_mask, causal)


flash_bwd_dq.launches = flash_bwd_dq.bf16_launches = flash_bwd_dq.f16_launches = 0


def flash_bwd_dkv(q, k, v, d_out, lse, delta, bias=None, pad_mask=None, causal=False):
    """K6c: ``(dk, dv)`` alone. Arguments as ``flash_bwd_fused``; counts its
    launches in ``flash_bwd_dkv.launches``."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, d_out, lse, delta, bias, pad_mask, causal)
    return _flash_bwd_dkv_cuda(q, k, v, d_out, lse, delta, bias, pad_mask, causal)


flash_bwd_dkv.launches = flash_bwd_dkv.bf16_launches = flash_bwd_dkv.f16_launches = 0


def flash_backward(q, k, v, bias, pad_mask, causal, out, lse, d_out):
    """``(dq, dk, dv)`` of the attention whose forward gave ``out`` and
    ``lse``: K6a while its dq partials fit under the cap, else K6b + K6c.
    ``d_out`` keeps its type (q's, for the kernels)."""
    d_out = d_out.contiguous()
    delta = row_delta(d_out, out)
    if dq_partial_bytes(q) <= BWD_DQ_PARTIAL_MAX_BYTES:
        return flash_bwd_fused(q, k, v, d_out, lse, delta, bias, pad_mask, causal)
    dq = flash_bwd_dq(q, k, v, d_out, lse, delta, bias, pad_mask, causal)
    dk, dv = flash_bwd_dkv(q, k, v, d_out, lse, delta, bias, pad_mask, causal)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Forward through ``flash_fwd``, backward through ``flash_backward`` (or,
    with ``bias_grad``, through autograd of ``reference_attention``). Only
    q, k, v, bias, pad_mask, the output and the row lse are kept."""

    @staticmethod
    def forward(ctx, q, k, v, bias, pad_mask, causal, bias_grad):
        out, lse = flash_fwd(q, k, v, bias, pad_mask, causal)
        ctx.save_for_backward(q, k, v, bias, pad_mask, out, lse)
        ctx.causal, ctx.bias_grad = causal, bias_grad
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, pad_mask, out, lse = ctx.saved_tensors
        if bias is not None and ctx.bias_grad:
            # a learned bias: the kernels emit no bias gradient, so all four
            # gradients come from the dense function (O(S²) memory, paid
            # only when the bias carries parameters)
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
                ref = reference_attention(*leaves, pad_mask=pad_mask, causal=ctx.causal)
                dq, dk, dv, dbias = torch.autograd.grad(ref, leaves, g)
            return dq, dk, dv, dbias, None, None, None
        dq, dk, dv = flash_backward(q, k, v, bias, pad_mask, ctx.causal, out, lse, g)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    pad_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    bias_grad: bool = False,
) -> torch.Tensor:
    """Fused attention. q, k, v: (B, S, H, Dh), of one type (on the card
    float32, bfloat16 or float16), passed to the kernels as they are; the output is in
    that type. ``bias`` (1|B, 1|H, S, S) additive (local window, relative
    positions); ``pad_mask`` (B, S) bool, True at valid keys; ``causal``
    applied inside the kernel.

    ``bias_grad``: True when ``bias`` carries learned parameters; the backward
    then recomputes the dense attention and returns the bias gradient.
    With False the fused backward runs and the bias gets no gradient, which
    is right only for a constant bias. The encoder sets the flag from its
    relative-bias configuration."""
    q, k, v = (t.contiguous() for t in (q, k, v))
    if bias is not None:
        bias = bias.float().contiguous()
    if pad_mask is not None:
        pad_mask = pad_mask.bool().contiguous()
    return FlashAttention.apply(q, k, v, bias, pad_mask, bool(causal), bool(bias_grad))


def use_flash(seq_len: int, attn_dropout: float, training: bool) -> bool:
    """Dispatch policy of ``MultiHeadAttention``: the fused path from S = 128
    on, unless attention dropout is drawn (the dense path applies it to the
    probabilities, which the fused path never forms)."""
    return seq_len >= 128 and not (training and attn_dropout > 0.0)
