"""Fused large-vocab ops: training cross-entropy, and evaluation CE with rank.

Counterpart of ``transformers4rec_tpu/ops/vocab.py``. Scoring (N, E) hidden
states against a (V, E) item table in one pass over the vocabulary, without
materialising the (N, V) logits:

- ``fused_softmax_ce`` (training): the weighted-mean softmax cross-entropy
  with a hand-written backward. Its forward is ``ce_fwd`` (per row the
  logsumexp, the label logit and, with label smoothing, the sum of logits)
  and its backward ``ce_bwd`` (``dx`` and ``dW`` from the recomputed
  softmax);
- ``fused_ce_and_rank`` (evaluation): the loss and the 0-based rank of the
  label (count of strictly greater logits), through ``ce_rank``.

For CUDA tensors ``ce_fwd``, ``ce_bwd`` and ``ce_rank`` launch the
hand-written kernels ``csrc/ce_fwd.cu``, ``csrc/ce_bwd.cu`` and
``csrc/ce_rank.cu`` (and raise when they cannot); for CPU tensors they run
``ce_fwd_plain``, ``ce_bwd_plain`` and ``ce_rank_plain``, the plain PyTorch
versions of the same arithmetic. All round x and W to bf16 and accumulate in
f32, as the reference does. Each wrapper counts its launches in
``<wrapper>.launches``.

Not ported yet: ``rank_counts``/``fused_label_rank`` (K4) and the streamed
``fused_topk``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

NEG = -1e30
_MAX_E = 256
_MAX_E_BWD = 128


def ce_fwd_plain(
    x: torch.Tensor,
    W: torch.Tensor,
    labels: torch.Tensor,
    vocab_size: int,
    smooth: bool,
    chunk: int = 16384,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch K1: chunked f32 products of bf16-rounded inputs.

    Returns ``(lse (N,), ll (N,), zsum (N,) or None)``, all f32, over the
    columns ``c < vocab_size``. ``ll`` is the logit at ``c == label``: 0 for
    a label outside ``[0, vocab_size)``.
    """
    N = x.shape[0]
    dev = x.device
    xb = x.to(torch.bfloat16).float()
    labels = labels.long()
    m = torch.full((N,), NEG, dtype=torch.float32, device=dev)
    s = torch.zeros(N, dtype=torch.float32, device=dev)
    ll = torch.zeros(N, dtype=torch.float32, device=dev)
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
        ll += torch.where(col[None, :] == labels[:, None], logits, 0.0).sum(-1)
    return m + torch.log(s), ll, (zs.float() if smooth else None)


def ce_bwd_plain(
    x: torch.Tensor,
    W: torch.Tensor,
    labels: torch.Tensor,
    lse: torch.Tensor,
    coef: torch.Tensor,
    vocab_size: int,
    eps: float = 0.0,
    eps_over_v: Optional[float] = None,
    chunk: int = 16384,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K2: per vocab chunk, recompute ``P = exp(logits − lse)``,
    form the residual ``(P − ε/V − (1−ε)·onehot)·coef``, round it to bf16 and
    take both products in f32. Returns ``(dx (N, E), dW (Vp, E))`` f32; rows
    of ``dW`` at and beyond ``vocab_size`` are zero."""
    dev = x.device
    eov = (eps / vocab_size if eps_over_v is None else eps_over_v) if eps else 0.0
    xb = x.to(torch.bfloat16).float()
    labels = labels.long()
    dx = torch.zeros(x.shape, dtype=torch.float32, device=dev)
    dW = torch.zeros(W.shape, dtype=torch.float32, device=dev)
    for c0 in range(0, vocab_size, chunk):
        c1 = min(c0 + chunk, vocab_size)
        Wc = W[c0:c1].to(torch.bfloat16).float()
        p = torch.exp(xb @ Wc.T - lse[:, None]) - eov
        col = torch.arange(c0, c1, device=dev)
        p = p - (1.0 - eps) * (col[None, :] == labels[:, None]).float()
        r = (p * coef[:, None]).to(torch.bfloat16).float()
        dW[c0:c1] = r.T @ xb
        dx += r @ Wc
    return dx, dW


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


def _check_cuda_inputs(op: str, x, W, vocab_size: int, max_e: int,
                       rows: Dict[str, Tuple[torch.Tensor, torch.dtype]]) -> None:
    """Raise on what the kernels do not take. ``rows`` are the (N,) tensors
    of the call, each with the type it must have."""
    tensors = {"x": (x, torch.float32), "W": (W, torch.float32), **rows}
    for name, (t, dtype) in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{op}: {name} is on {t.device}, expected a CUDA tensor")
        if t.device != x.device:
            raise ValueError(f"{op}: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
        if t.dtype != dtype:
            raise TypeError(f"{op}: {name} is {t.dtype}, expected {dtype}")
    if x.dim() != 2 or W.dim() != 2 or x.shape[1] != W.shape[1]:
        raise ValueError(f"{op}: x {tuple(x.shape)} and W {tuple(W.shape)} do not match")
    N, E = x.shape
    for name, (t, _) in rows.items():
        if t.shape != (N,):
            raise ValueError(f"{op}: {name} must be (N,), got {tuple(t.shape)}")
    if N < 1 or E % 4 or not 4 <= E <= max_e:
        raise ValueError(f"{op}: needs N >= 1 and E a multiple of 4 in [4, {max_e}], "
                         f"got N={N}, E={E}")
    if not 1 <= vocab_size <= W.shape[0]:
        raise ValueError(f"{op}: vocab_size {vocab_size} outside [1, {W.shape[0]}]")
    if W.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError(f"{op}: x and W must be 16-byte aligned (float4 loads)")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "ce_rank": [_P] * 4 + [_I] * 5 + [_P] * 7 + [_I, _P],
    "ce_fwd": [_P] * 3 + [_I] * 5 + [_P] * 7 + [_I, _P],
    "ce_bwd": [_P] * 5 + [_I] * 4 + [_F] * 2 + [_I] * 2 + [_P] * 4,
}


def _kernel_lib(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with its C functions typed."""
    from .build import load

    lib = load(name)
    if not getattr(lib, "_t4r_typed", False):
        entry = getattr(lib, f"t4r_{name}")
        entry.argtypes, entry.restype = _ARGTYPES[name], _I
        for fn in (getattr(lib, f"t4r_{name}_block_rows"), getattr(lib, f"t4r_{name}_chunk_cols")):
            fn.argtypes, fn.restype = [], _I
        lib.t4r_cuda_error_string.argtypes = [_I]
        lib.t4r_cuda_error_string.restype = ctypes.c_char_p
        lib._t4r_typed = True
    return lib


def _vocab_splits(lib: ctypes.CDLL, name: str, N: int, vocab_size: int, dev) -> Tuple[int, int]:
    """Split the vocab's chunks across blocks so that about two blocks land
    on every SM: ``(splits, chunks per split)``."""
    row_tiles = -(-N // getattr(lib, f"t4r_{name}_block_rows")())
    nchunks = -(-vocab_size // getattr(lib, f"t4r_{name}_chunk_cols")())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_split = -(-nchunks // max(1, (2 * sms) // row_tiles))
    return -(-nchunks // per_split), per_split


def _raise_on(err: int, lib: ctypes.CDLL, name: str) -> None:
    if err != 0:
        msg = lib.t4r_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {err})")


def _ce_rank_cuda(x, W, labels, ll, vocab_size, smooth):
    _check_cuda_inputs("ce_rank", x, W, vocab_size, _MAX_E,
                       {"labels": (labels, torch.int32), "ll": (ll, torch.float32)})
    lib = _kernel_lib("ce_rank")
    N, E = x.shape
    dev = x.device
    splits, per_split = _vocab_splits(lib, "ce_rank", N, vocab_size, dev)
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
    _raise_on(err, lib, "ce_rank")
    ce_rank.launches += 1
    return lse, rank, (zsum if smooth else None)


def _ce_fwd_cuda(x, W, labels, vocab_size, smooth):
    _check_cuda_inputs("ce_fwd", x, W, vocab_size, _MAX_E, {"labels": (labels, torch.int32)})
    lib = _kernel_lib("ce_fwd")
    N, E = x.shape
    dev = x.device
    splits, per_split = _vocab_splits(lib, "ce_fwd", N, vocab_size, dev)
    part = torch.empty((3, splits, N), dtype=torch.float32, device=dev)  # m, s, ll
    part_zs = torch.empty((splits, N) if smooth else (1,), dtype=torch.float64, device=dev)
    lse = torch.empty(N, dtype=torch.float32, device=dev)
    ll = torch.empty(N, dtype=torch.float32, device=dev)
    zsum = torch.empty(N if smooth else 1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.t4r_ce_fwd(
            x.data_ptr(), W.data_ptr(), labels.data_ptr(),
            N, E, vocab_size, splits, per_split,
            part[0].data_ptr(), part[1].data_ptr(), part[2].data_ptr(), part_zs.data_ptr(),
            lse.data_ptr(), ll.data_ptr(), zsum.data_ptr(), int(smooth), stream,
        )
    _raise_on(err, lib, "ce_fwd")
    ce_fwd.launches += 1
    return lse, ll, (zsum if smooth else None)


def _ce_bwd_cuda(x, W, labels, lse, coef, vocab_size, eps, eps_over_v):
    _check_cuda_inputs("ce_bwd", x, W, vocab_size, _MAX_E_BWD,
                       {"labels": (labels, torch.int32), "lse": (lse, torch.float32),
                        "coef": (coef, torch.float32)})
    lib = _kernel_lib("ce_bwd")
    N, E = x.shape
    dev = x.device
    eov = (eps / vocab_size if eps_over_v is None else eps_over_v) if eps else 0.0
    splits, per_split = _vocab_splits(lib, "ce_bwd", N, vocab_size, dev)
    # every element of the three buffers is written by the kernels
    part_dx = torch.empty((splits, N, E), dtype=torch.float32, device=dev)
    dx = torch.empty((N, E), dtype=torch.float32, device=dev)
    dW = torch.empty(W.shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.t4r_ce_bwd(
            x.data_ptr(), W.data_ptr(), labels.data_ptr(), lse.data_ptr(), coef.data_ptr(),
            N, E, vocab_size, W.shape[0], float(eps), float(eov), splits, per_split,
            part_dx.data_ptr(), dx.data_ptr(), dW.data_ptr(), stream,
        )
    _raise_on(err, lib, "ce_bwd")
    ce_bwd.launches += 1
    return dx, dW


def ce_fwd(
    x: torch.Tensor,
    W: torch.Tensor,
    labels: torch.Tensor,
    vocab_size: int,
    smooth: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """K1: ``(lse, ll, zsum | None)`` of ``bf16(x) @ bf16(W[:vocab_size]).T``.

    x (N, E) f32, W (Vp, E) f32, labels (N,) int32. CUDA tensors launch the
    CUDA kernel (``ce_fwd.launches`` counts the launches); CPU tensors run
    ``ce_fwd_plain``.
    """
    if x.device.type == "cpu":
        return ce_fwd_plain(x, W, labels, vocab_size, smooth)
    return _ce_fwd_cuda(x, W, labels, vocab_size, smooth)


ce_fwd.launches = 0


def ce_bwd(
    x: torch.Tensor,
    W: torch.Tensor,
    labels: torch.Tensor,
    lse: torch.Tensor,
    coef: torch.Tensor,
    vocab_size: int,
    eps: float = 0.0,
    eps_over_v: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: ``(dx (N, E), dW (Vp, E))`` of the cross-entropy whose forward
    gave ``lse``; ``coef`` (N,) f32 scales each row's residual. ``eps`` is
    the label smoothing; ``eps_over_v`` overrides its per-column share
    ``eps / vocab_size`` (a vocab-parallel caller passes the global one).
    CUDA tensors launch the CUDA kernels (``ce_bwd.launches`` counts the
    launches); CPU tensors run ``ce_bwd_plain``.
    """
    if x.device.type == "cpu":
        return ce_bwd_plain(x, W, labels, lse, coef, vocab_size, eps, eps_over_v)
    return _ce_bwd_cuda(x, W, labels, lse, coef, vocab_size, eps, eps_over_v)


ce_bwd.launches = 0


def _smoothed_nll(lse, ll, zs, eps: float, V: int) -> torch.Tensor:
    """Per-row loss: lse − (1−ε)·ll − (ε/V)·zsum (``torch.nn.CrossEntropyLoss``
    label-smoothing semantics)."""
    if eps:
        return lse - (1.0 - eps) * ll - (eps / V) * zs
    return lse - ll


class _FusedSoftmaxCE(torch.autograd.Function):
    """Forward through ``ce_fwd``, backward through ``ce_bwd``; nothing of
    size (N, V) is kept. Everything stays on the device: no host read in
    either direction."""

    @staticmethod
    def forward(ctx, x, W, labels, weights, vocab_size, label_smoothing):
        eps = float(label_smoothing)
        xf = x.float().contiguous()
        lse, ll, zs = ce_fwd(xf, W, labels, vocab_size, smooth=eps > 0)
        w = weights.float()
        wsum = w.sum().clamp_min(1.0)
        loss = (_smoothed_nll(lse, ll, zs, eps, vocab_size) * w).sum() / wsum
        ctx.save_for_backward(xf, W, labels, w, wsum, lse)
        ctx.vocab_size, ctx.eps = vocab_size, eps
        ctx.x_dtype = x.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        x, W, labels, w, wsum, lse = ctx.saved_tensors
        coef = (g * w / wsum).contiguous()  # (N,)
        dx, dW = ce_bwd(x, W, labels, lse, coef, ctx.vocab_size, ctx.eps)
        return dx.to(ctx.x_dtype), dW.to(W.dtype), None, None, None, None


def fused_softmax_ce(
    x: torch.Tensor,
    W: torch.Tensor,
    labels: torch.Tensor,
    weights: torch.Tensor,
    vocab_size: Optional[int] = None,
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """Weighted-mean CE of ``x @ W.T`` against ``labels`` without
    materialising the logits. x (N, E); W (Vp, E) f32; labels (N,) int;
    weights (N,) float. ``vocab_size`` bounds the true vocab when W carries
    padded rows: rows at and beyond it are left out of the softmax and get a
    zero gradient. ``weights`` and ``labels`` get no gradient: the weights
    are a validity mask."""
    V = W.shape[0] if vocab_size is None else int(vocab_size)
    if x.device.type != "cpu" and x.shape[-1] > _MAX_E_BWD:
        # the forward kernel takes E up to 256: refuse here, not in backward()
        raise ValueError(f"fused_softmax_ce: the backward kernel takes E up to {_MAX_E_BWD}, "
                         f"got {x.shape[-1]}")
    return _FusedSoftmaxCE.apply(x, W, labels.to(torch.int32).contiguous(),
                                 weights.detach(), V, label_smoothing)


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
