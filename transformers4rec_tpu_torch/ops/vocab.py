"""Fused large-vocab evaluation op: softmax cross-entropy and label rank.

Counterpart of ``transformers4rec_tpu/ops/vocab.py:fused_ce_and_rank``.
Scoring (N, E) hidden states against a (V, E) item table in one pass over
the vocabulary gives, per row, the logsumexp, the 0-based rank of the label
(count of strictly greater logits) and, with label smoothing, the sum of
logits — without materialising the (N, V) logits.

``ce_rank`` is that pass. For CUDA tensors it launches the hand-written
kernel ``csrc/ce_rank.cu`` (and raises when it cannot); for CPU tensors it
runs ``ce_rank_plain``, the plain PyTorch version of the same arithmetic.
Both round x and W to bf16 and accumulate in f32, as the reference does.

Not ported yet: the training CE (``fused_softmax_ce``, kernels K1/K2),
``rank_counts``/``fused_label_rank`` (K4) and the streamed ``fused_topk``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG = -1e30
_MAX_E = 256


def ce_rank_plain(
    x: torch.Tensor,
    W: torch.Tensor,
    labels: torch.Tensor,
    ll: torch.Tensor,
    vocab_size: int,
    smooth: bool,
    chunk: int = 16384,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch K3: chunked f32 products of bf16-rounded inputs.

    Returns ``(lse (N,) f32, rank (N,) int32, zsum (N,) f32 or None)`` over
    the columns ``c < vocab_size``; the label's own column is never counted.
    """
    N = x.shape[0]
    dev = x.device
    xb = x.to(torch.bfloat16).float()
    labels = labels.long()
    m = torch.full((N,), NEG, dtype=torch.float32, device=dev)
    s = torch.zeros(N, dtype=torch.float32, device=dev)
    cnt = torch.zeros(N, dtype=torch.int32, device=dev)
    zs = torch.zeros(N, dtype=torch.float64, device=dev)
    for c0 in range(0, vocab_size, chunk):
        c1 = min(c0 + chunk, vocab_size)
        logits = xb @ W[c0:c1].to(torch.bfloat16).float().T  # (N, C) f32
        if smooth:
            zs += logits.double().sum(-1)
        m_new = torch.maximum(m, logits.max(-1).values)
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
        m = m_new
        col = torch.arange(c0, c1, device=dev)
        greater = (col[None, :] != labels[:, None]) & (logits > ll[:, None])
        cnt += greater.sum(-1).to(torch.int32)
    lse = m + torch.log(s)
    return lse, cnt, (zs.float() if smooth else None)


def _check_cuda_inputs(x, W, labels, ll, vocab_size):
    tensors = {"x": x, "W": W, "labels": labels, "ll": ll}
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"ce_rank: {name} is on {t.device}, expected a CUDA tensor")
        if t.device != x.device:
            raise ValueError(f"ce_rank: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"ce_rank: {name} must be contiguous")
    for name, t, dtype in (("x", x, torch.float32), ("W", W, torch.float32),
                           ("labels", labels, torch.int32), ("ll", ll, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"ce_rank: {name} is {t.dtype}, expected {dtype}")
    if x.dim() != 2 or W.dim() != 2 or x.shape[1] != W.shape[1]:
        raise ValueError(f"ce_rank: x {tuple(x.shape)} and W {tuple(W.shape)} do not match")
    N, E = x.shape
    if labels.shape != (N,) or ll.shape != (N,):
        raise ValueError("ce_rank: labels and ll must be (N,)")
    if N < 1 or E % 4 or not 4 <= E <= _MAX_E:
        raise ValueError(f"ce_rank: needs N >= 1 and E a multiple of 4 in [4, {_MAX_E}], "
                         f"got N={N}, E={E}")
    if not 1 <= vocab_size <= W.shape[0]:
        raise ValueError(f"ce_rank: vocab_size {vocab_size} outside [1, {W.shape[0]}]")
    if W.data_ptr() % 16:
        raise ValueError("ce_rank: W must be 16-byte aligned (float4 loads)")


def _ce_rank_lib() -> ctypes.CDLL:
    from .build import load

    lib = load("ce_rank")
    if not getattr(lib, "_t4r_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.t4r_ce_rank.argtypes = [p, p, p, p, i, i, i, i, i, p, p, p, p, p, p, p, i, p]
        lib.t4r_ce_rank.restype = i
        for fn in (lib.t4r_ce_rank_block_rows, lib.t4r_ce_rank_chunk_cols):
            fn.argtypes, fn.restype = [], i
        lib.t4r_cuda_error_string.argtypes = [i]
        lib.t4r_cuda_error_string.restype = ctypes.c_char_p
        lib._t4r_typed = True
    return lib


def _ce_rank_cuda(x, W, labels, ll, vocab_size, smooth):
    _check_cuda_inputs(x, W, labels, ll, vocab_size)
    lib = _ce_rank_lib()
    N, E = x.shape
    dev = x.device
    row_tiles = -(-N // lib.t4r_ce_rank_block_rows())
    nchunks = -(-vocab_size // lib.t4r_ce_rank_chunk_cols())
    # split the vocab across blocks so about two blocks land on every SM
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_split = -(-nchunks // max(1, (2 * sms) // row_tiles))
    splits = -(-nchunks // per_split)
    part_m = torch.empty((splits, N), dtype=torch.float32, device=dev)
    part_s = torch.empty((splits, N), dtype=torch.float32, device=dev)
    part_cnt = torch.empty((splits, N), dtype=torch.int32, device=dev)
    part_zs = torch.empty((splits, N) if smooth else (1,), dtype=torch.float64, device=dev)
    lse = torch.empty(N, dtype=torch.float32, device=dev)
    rank = torch.empty(N, dtype=torch.int32, device=dev)
    zsum = torch.empty(N if smooth else 1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.t4r_ce_rank(
            x.data_ptr(), W.data_ptr(), labels.data_ptr(), ll.data_ptr(),
            N, E, vocab_size, splits, per_split,
            part_m.data_ptr(), part_s.data_ptr(), part_cnt.data_ptr(), part_zs.data_ptr(),
            lse.data_ptr(), rank.data_ptr(), zsum.data_ptr(), int(smooth), stream,
        )
    if err != 0:
        msg = lib.t4r_cuda_error_string(err).decode()
        raise RuntimeError(f"ce_rank kernel launch failed: {msg} (cudaError {err})")
    ce_rank.launches += 1
    return lse, rank, (zsum if smooth else None)


def ce_rank(
    x: torch.Tensor,
    W: torch.Tensor,
    labels: torch.Tensor,
    ll: torch.Tensor,
    vocab_size: int,
    smooth: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """K3: ``(lse, rank, zsum | None)`` of ``bf16(x) @ bf16(W[:vocab_size]).T``.

    x (N, E) f32, W (Vp, E) f32, labels (N,) int32, ll (N,) f32 label logits.
    CUDA tensors launch the CUDA kernel (``ce_rank.launches`` counts the
    launches); CPU tensors run ``ce_rank_plain``.
    """
    if x.device.type == "cpu":
        return ce_rank_plain(x, W, labels, ll, vocab_size, smooth)
    return _ce_rank_cuda(x, W, labels, ll, vocab_size, smooth)


ce_rank.launches = 0


def label_logits(x: torch.Tensor, W: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """O(N·E) label logit: gather the label rows, dot in f32 over bf16 values
    (the reference's gather-dot, kept outside the kernel)."""
    xb = x.to(torch.bfloat16).float()
    rows = W[labels.long()].to(torch.bfloat16).float()
    return (xb * rows).sum(-1)


def fused_ce_and_rank(
    x: torch.Tensor,
    W: torch.Tensor,
    labels: torch.Tensor,
    weights: torch.Tensor,
    vocab_size: Optional[int] = None,
    label_smoothing: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted-mean CE **and** exact 0-based label ranks in one vocab pass
    (evaluation only). ``vocab_size`` bounds the true vocab when W carries
    padded rows. Returns ``(loss, ranks)``."""
    labels = labels.to(torch.int32)
    ll = label_logits(x, W, labels)
    V = W.shape[0] if vocab_size is None else int(vocab_size)
    eps = label_smoothing
    lse, rank, zs = ce_rank(x.float().contiguous(), W, labels.contiguous(), ll, V,
                            smooth=eps > 0)
    if eps:
        nll = lse - (1.0 - eps) * ll - (eps / V) * zs
    else:
        nll = lse - ll
    w = weights.float()
    loss = (nll * w).sum() / w.sum().clamp_min(1.0)
    return loss, rank
