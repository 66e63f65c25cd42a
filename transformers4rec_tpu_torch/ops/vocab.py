"""Fused large-vocab ops: training cross-entropy, evaluation CE with rank,
label ranks and streamed top-k.

Counterpart of ``transformers4rec_tpu/ops/vocab.py``. Scoring (N, E) hidden
states against a (V, E) item table in one pass over the vocabulary, without
materialising the (N, V) logits:

- ``fused_softmax_ce`` (training): the weighted-mean softmax cross-entropy
  with a hand-written backward. Its forward is ``ce_fwd`` (per row the
  logsumexp, the label logit and, with label smoothing, the sum of logits)
  and its backward ``ce_bwd`` (``dx`` and ``dW`` from the recomputed
  softmax);
- ``fused_ce_and_rank`` (evaluation): the loss and the 0-based rank of the
  label (count of strictly greater logits), through ``ce_rank``;
- ``rank_counts``: per row the count of logits above a given label logit,
  and ``fused_label_rank`` (``ce_fwd`` for the label logit, then
  ``rank_counts``). The vocab-parallel evaluation
  (``parallel/sharded_embedding.py``) runs ``rank_counts`` per shard;
- ``fused_topk``: top-k by a chunked ``torch.matmul`` and a running
  ``torch.topk`` merge (no kernel of its own, as in the reference).

For CUDA tensors ``ce_fwd``, ``ce_bwd``, ``ce_rank`` and ``rank_counts``
launch the hand-written kernels ``csrc/ce_fwd.cu``, ``csrc/ce_bwd.cu``,
``csrc/ce_rank.cu`` and ``csrc/rank.cu`` (and raise when they cannot); for
CPU tensors they run ``ce_fwd_plain``, ``ce_bwd_plain``, ``ce_rank_plain``
and ``rank_counts_plain``, the plain PyTorch versions of the same
arithmetic. All round x and W to bf16 and accumulate in f32, as the
reference does, at any width E (a multiple of 4): past what the narrow
kernels hold whole they take the wide ones (``ce_plan``). Each wrapper counts
its launches in ``<wrapper>.launches``.

W may be stored as f32 or as bf16 (a bf16-stored table,
``embedding_table_dtype="bf16"``): the logits are the same, since both
round W to bf16, and the kernels read the bf16 table itself (no f32 copy
of it is made). ``ce_bwd`` returns dW in W's type: for a bf16 table the
f32 sum rounded once to bf16 (nearest even), as the reference's
``dW.astype(W.dtype)``. A CUDA W of any other type raises.

``vocab_size`` bounds the softmax when the table carries padding rows, and
may be 0 (a vocab-parallel shard wholly beyond the true vocab): every lse is
then -1e30 and every count 0. A label on a padding row (``vocab_size <=
label < rows``) is a fault of the caller that stays loud, as in the
reference: its label logit is the masked -1e30, so the loss is about 1e30,
and the backward still subtracts its one-hot. Labels outside the table
match no column; the evaluation's gathered label logit (``label_logits``) is
NaN for them, as the reference's, so their loss is NaN and their rank 0.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from .build import raise_on_error

NEG = -1e30


def _lse(m: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``m + log(s)``; -1e30 where no column was valid (``vocab_size`` 0), as
    the reference's masked logits give."""
    return torch.where(s > 0, m + torch.log(s), NEG)


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
    columns ``c < vocab_size``. ``ll`` is the logit at ``c == label``: the
    masked logit -1e30 for a label on a padding row, 0 for a label outside
    the table.
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
    ll = torch.where((labels >= vocab_size) & (labels < W.shape[0]), NEG, ll)
    return _lse(m, s), ll, (zs.float() if smooth else None)


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
    take both products in f32. Returns ``(dx (N, E) f32, dW (Vp, E))``, dW
    in W's type (the f32 sum rounded once). Rows of ``dW`` at and beyond
    ``vocab_size`` are zero, but for the one-hot of a label that stands on
    such a padding row."""
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
    # a label on a padding row: that column holds the one-hot and nothing else
    on_pad = (labels >= vocab_size) & (labels < W.shape[0])
    r = torch.where(on_pad, -(1.0 - eps) * coef, 0.0).to(torch.bfloat16).float()[:, None]
    rows = torch.where(on_pad, labels, 0)
    dW.index_add_(0, rows, r * xb)
    dx += r * W[rows].to(torch.bfloat16).float()
    return dx, dW.to(W.dtype)


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
    return _lse(m, s), cnt, (zs.float() if smooth else None)


TABLE_DTYPES = (torch.float32, torch.bfloat16)


def _check_cuda_inputs(op: str, x, W, vocab_size: int,
                       rows: Dict[str, Tuple[torch.Tensor, torch.dtype]]) -> None:
    """Raise on what the kernels do not take. ``rows`` are the (N,) tensors
    of the call, each with the type it must have. W is f32 or bf16."""
    if W.dtype not in TABLE_DTYPES:
        raise TypeError(f"{op}: W is {W.dtype}, expected torch.float32 or torch.bfloat16")
    tensors = {"x": (x, torch.float32), "W": (W, W.dtype), **rows}
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
    if N < 1 or E % 4 or E < 4:
        raise ValueError(f"{op}: needs N >= 1 and E a multiple of 4, at least 4, "
                         f"got N={N}, E={E}")
    if not 0 <= vocab_size <= W.shape[0]:
        raise ValueError(f"{op}: vocab_size {vocab_size} outside [0, {W.shape[0]}]")
    if W.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError(f"{op}: x and W must be 16-byte aligned (float4 loads)")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "ce_rank": [_P] * 4 + [_I] * 7 + [_P] * 7 + [_I, _P],
    "ce_fwd": [_P] * 3 + [_I] * 8 + [_P] * 7 + [_I, _P],
    "ce_bwd": [_P] * 3 + [_I] + [_P] * 3 + [_I] * 9 + [_F] * 2 + [_I] * 2 + [_P] * 5,
    "rank": [_P] * 4 + [_I] * 5 + [_P] * 3,
}
# K3 and K4 on tables wider than 256: K1's wide kernel with their epilogue,
# on the images (ximg, wimg, labels, ll, N, V, ek, resident, row_tiles,
# splits, chunks_per_split, partials..., outputs..., [smooth,] stream)
_WIDE_ARGTYPES = {
    "ce_rank": [_P] * 4 + [_I] * 7 + [_P] * 7 + [_I, _P],
    "rank": [_P] * 4 + [_I] * 7 + [_P] * 3,
}


def _kernel_lib(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with its C functions typed."""
    from .build import load

    lib = load(name)
    if not getattr(lib, "_t4r_typed", False):
        entry = getattr(lib, f"t4r_{name}")
        entry.argtypes, entry.restype = _ARGTYPES[name], _I
        if name in ("ce_rank", "rank"):  # the narrow kernel on a bf16-stored table
            bf16 = getattr(lib, f"t4r_{name}_bf16")
            bf16.argtypes, bf16.restype = _ARGTYPES[name], _I
        lib.t4r_image.argtypes = [_P] + [_I] * 4 + [_P, _I, _P]
        lib.t4r_image.restype = _I
        if name in _WIDE_ARGTYPES:  # K3 and K4: row tiles of CE_TILE too, chunks of their own width
            wide = getattr(lib, f"t4r_{name}_wide")
            wide.argtypes, wide.restype = _WIDE_ARGTYPES[name], _I
            for what in ("block_rows", "chunk_cols"):
                fn = getattr(lib, f"t4r_{name}_{what}")
                fn.argtypes, fn.restype = [], _I
                setattr(lib, f"t4r_{what}", fn)
            if lib.t4r_block_rows() != CE_TILE:
                raise RuntimeError(f"{name}: row tiles of {lib.t4r_block_rows()}, "
                                   f"the launch plan cuts {CE_TILE}")
        lib._t4r_typed = True
    return lib


# --------------------------------------------------- the vocab kernels' launch plan
CE_TILE = 128  # rows of x or of W in a tile of their bf16 images (csrc/hopper.cuh)
CE_SLAB = 64   # bf16 values in one 128-byte swizzled row of a tile
# the widest E each narrow kernel holds whole: K1, K3 and K4 up to four slabs,
# K2 up to two (csrc/ce_fwd.cu, ce_rank.cu, rank.cu; ce_bwd.cu)
NARROW_E, NARROW_E_BWD = 4 * CE_SLAB, 2 * CE_SLAB
# a wide forward keeps its x tile in shared memory up to 8 slabs (128 KB),
# beside a ring of at least 6 slots (csrc/ce_wide.cuh)
RESIDENT_SLABS = 8
# K3's narrow kernel streams the table into a ring of at least 4 slots a
# block, about 128 KB in flight on each SM (twice the slots of a bf16 table,
# whose slots are half the bytes), within the shared memory a block may ask
# for (csrc/ce_rank.cu: Slot, stream_smem; csrc/hopper.cuh: MAX_SMEM)
K3_CHUNK = 64
K3_MIN_STAGES, K3_IN_FLIGHT = 4, 128 << 10
MAX_SMEM = 232_448


@dataclass(frozen=True)
class CEPlan:
    """How a vocab kernel cuts one call into blocks, and the scratch it needs.

    Every kernel runs a block per (``tile_rows``-row tile of x, vocab split),
    each split a run of ``chunks_per_split`` consecutive chunks of
    ``chunk_cols`` vocab columns. K1 and K2 (128-row tiles and chunks) first
    round x and the table to bf16 into images of ``CE_TILE``-row tiles, each
    row padded with zeros to ``ek`` values; K2's dW pass runs a block per tile
    of the table (``table_tiles``). K3 and K4 take only the split, but for a
    ``wide`` table, where they run K1's wide kernel on the images too.

    ``wide``: E beyond what the narrow kernel holds whole (``NARROW_E``, or
    ``NARROW_E_BWD`` for K2). The wide kernels walk E in ``slabs`` slabs of 64
    per 128-column chunk; a wide forward keeps its x tile ``resident`` in
    shared memory up to ``RESIDENT_SLABS`` slabs and streams it with the
    table otherwise; a wide K2 streams both and runs ``e_splits`` blocks per
    tile, each owning 128 columns of dx or dW and recomputing the logits.

    ``stages`` and ``smem``: the ring slots and shared memory of a block of
    K3's narrow kernel (``streamed``), which streams the table as it is
    stored (f32 or bf16) into its ring; ``blocks_per_sm`` of them share an
    SM. 0 for every other kernel."""

    n: int
    e: int
    ek: int
    row_tiles: int
    chunks: int
    table_tiles: int
    splits: int
    chunks_per_split: int
    backward: bool
    wide: bool
    slabs: int
    e_splits: int
    resident: bool
    stages: int = 0
    smem: int = 0
    blocks_per_sm: int = 2

    def images(self, device) -> Dict[str, torch.Tensor]:
        """The bf16 images of x and of the table, uninitialised."""
        return {"ximg": torch.empty((self.row_tiles * CE_TILE, self.ek), dtype=torch.bfloat16,
                                    device=device),
                "wimg": torch.empty((self.table_tiles * CE_TILE, self.ek),
                                    dtype=torch.bfloat16, device=device)}

    def scratch(self, device, smooth: bool = False) -> Dict[str, torch.Tensor]:
        """K1's or K2's scratch, uninitialised (the kernels write every
        element): the images of x and of the table, and K2's row table
        (lse, coef, label per row) and per-split dx partials, or K1's (max,
        sum, label logit) f32 and zsum f64 per split and row."""
        out = self.images(device)
        if self.backward:
            out["info"] = torch.empty((self.row_tiles * CE_TILE, 4), dtype=torch.float32,
                                      device=device)
            out["part_dx"] = torch.empty((self.splits, self.n, self.e), dtype=torch.float32,
                                         device=device)
        else:
            out["part"] = torch.empty((3, self.splits, self.n), dtype=torch.float32,
                                      device=device)
            out["part_zs"] = torch.empty((self.splits, self.n) if smooth else (1,),
                                         dtype=torch.float64, device=device)
        return out


def k3_slot(e: int, bf16: bool = False) -> Tuple[int, int]:
    """``(rows, bytes)`` of a ring slot of K3's narrow kernel at width ``e``
    (``Slot`` in ``csrc/ce_rank.cu``): groups of 8 table rows, one bulk copy
    each, 8 groups (4 where e pads to 256); a group is followed by zeros, at
    least as many values as e lacks of its padding to 16 · KS values (16,
    32, 64, 128 or 256). Of f32 rows (``bf16`` False) a group then starts 16
    words more than a multiple of 32 after the last, so that the consumers'
    16-byte reads of two rows of neighbouring groups hit distinct banks; of
    bf16 rows 8 words more, for their 8-byte reads of four groups' rows."""
    ek = 16 if e <= 16 else 32 if e <= 32 else 64 if e <= 64 else 128 if e <= 128 else 256
    groups = 8 if ek <= 128 else 4
    if bf16:
        group_words = (4 * e + (ek - e) // 2 + 23) // 32 * 32 + 8
    else:
        group_words = 8 * e + -(-(ek - e) // 32) * 32 + 16
    return 8 * groups, groups * group_words * 4


def ce_plan(n: int, e: int, vocab_size: int, table_rows: int, sms: int, backward: bool,
            chunk_cols: int = CE_TILE, streamed: bool = False,
            table_bf16: bool = False) -> CEPlan:
    """The launch plan of a vocab kernel for ``n`` rows of width ``e``
    against a table of ``table_rows`` rows whose first ``vocab_size`` are the
    vocab, on a card with ``sms`` SMs: K1 (``backward=False``), K2, or with
    their narrow ``chunk_cols`` K3 and K4 (a wide K3 or K4 takes K1's
    128-column chunks).

    The vocab is split until about two blocks per SM exist: every row tile
    walks a split of the chunks, and the splits' partials stay within
    ``2 * sms * CE_TILE`` rows (or ``n`` rows, with one split). An empty vocab
    gets one empty split. ``ek`` is the width of the images: for the narrow
    kernels that of a ``wgmma`` operand that holds ``e`` (64, 128 or 256:
    one, two or four 64-value slabs), for a wide forward ``e`` rounded up to
    a slab, for a wide K2 to two slabs (its blocks own 128 columns each).
    K1's table image needs only the vocab's chunks; K2's dW pass covers every
    row of the table.

    ``streamed`` (K3's narrow kernel): each block also gets a ring of
    ``stages`` slots (``k3_slot``) and its ``smem`` bytes; two blocks share an
    SM where a ring of ``K3_MIN_STAGES`` slots fits twice, else one, and the
    vocab is split for that many blocks per SM, the slots chosen so that
    about ``K3_IN_FLIGHT`` bytes of the table are in flight on each SM; a
    bf16-stored table (``table_bf16``) has slots of half the bytes, so about
    twice as many."""
    wide = e > (NARROW_E_BWD if backward else NARROW_E)
    if wide:
        chunk_cols = CE_TILE
        step = 2 * CE_SLAB if backward else CE_SLAB
        ek = -(-e // step) * step
        slabs = -(-e // CE_SLAB)
    else:
        ek = 64 if e <= 64 else 128 if e <= 128 else 256
        slabs = ek // CE_SLAB
    stages = smem = 0
    blocks_per_sm = 2
    if streamed and not wide:
        slot = k3_slot(e, table_bf16)[1] + 16  # a slot and its two barriers
        blocks_per_sm = 2 if 2 * K3_MIN_STAGES * slot <= MAX_SMEM else 1
        stages = max(K3_MIN_STAGES, -(-K3_IN_FLIGHT // (blocks_per_sm * slot)))
        stages = min(stages, MAX_SMEM // blocks_per_sm // slot)
        smem = stages * slot
    row_tiles = -(-n // CE_TILE)
    chunks = -(-vocab_size // chunk_cols)
    per_split = -(-max(1, chunks) // max(1, (blocks_per_sm * sms) // row_tiles))
    table_tiles = -(-(table_rows if backward else vocab_size) // CE_TILE)
    return CEPlan(n=n, e=e, ek=ek, row_tiles=row_tiles, chunks=chunks, table_tiles=table_tiles,
                  splits=-(-max(1, chunks) // per_split), chunks_per_split=per_split,
                  backward=backward, wide=wide, slabs=slabs,
                  e_splits=ek // (2 * CE_SLAB) if wide and backward else 1,
                  resident=not wide or (not backward and slabs <= RESIDENT_SLABS),
                  stages=stages, smem=smem, blocks_per_sm=blocks_per_sm)


def swizzled_image_index(rows: int, ek: int) -> torch.Tensor:
    """Where element (r, e) of a (rows, ek) matrix lands in its bf16 image,
    as an index of bf16 values: ``image_offset`` of ``csrc/hopper.cuh``
    divided by 2. Rows are padded to whole tiles, so the result is
    (row tiles x ``CE_TILE``, ek) int64. Within a tile, slab ``e // 64``
    holds the tile's rows as 64 values (128 bytes) each, and the 16-byte
    piece ``j`` of row ``r`` sits at place ``j ^ (r % 8)``: the layout of
    TMA's 128-byte swizzle."""
    padded = -(-rows // CE_TILE) * CE_TILE
    r = torch.arange(padded)[:, None]
    col = torch.arange(ek)[None, :]
    rr, c64 = r % CE_TILE, col % CE_SLAB
    return ((r // CE_TILE) * CE_TILE * ek + (col // CE_SLAB) * CE_TILE * CE_SLAB
            + rr * CE_SLAB + ((c64 // 8) ^ (rr % 8)) * 8 + c64 % 8)


def _plan_for(x, W, vocab_size: int, backward: bool, chunk_cols: int = CE_TILE,
              streamed: bool = False) -> CEPlan:
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return ce_plan(x.shape[0], x.shape[1], vocab_size, W.shape[0], sms, backward, chunk_cols,
                   streamed, table_bf16=W.dtype == torch.bfloat16)


def _write_image(lib: ctypes.CDLL, src: torch.Tensor, rows: int, img: torch.Tensor,
                 stream: int) -> None:
    """Rounds the first ``rows`` rows of ``src`` (f32, or bf16: copied) into
    ``img``, its bf16 image (``to_image_kernel`` of ``csrc/hopper.cuh``)."""
    err = lib.t4r_image(src.data_ptr(), rows, img.shape[0], src.shape[1], img.shape[1],
                        img.data_ptr(), int(src.dtype == torch.bfloat16), stream)
    raise_on_error(lib, err, "image")


def _write_images(lib: ctypes.CDLL, x, W, table_rows: int, buf, stream) -> None:
    """The images of x and of the table's first ``table_rows`` rows, at the
    width of ``buf``'s images."""
    _write_image(lib, x, x.shape[0], buf["ximg"], stream)
    _write_image(lib, W, table_rows, buf["wimg"], stream)


def _ce_rank_cuda(x, W, labels, ll, vocab_size, smooth):
    _check_cuda_inputs("ce_rank", x, W, vocab_size,
                       {"labels": (labels, torch.int32), "ll": (ll, torch.float32)})
    lib = _kernel_lib("ce_rank")
    N, E = x.shape
    dev = x.device
    plan = _plan_for(x, W, vocab_size, False, lib.t4r_chunk_cols(), streamed=True)
    splits, per_split = plan.splits, plan.chunks_per_split
    part_m = torch.empty((splits, N), dtype=torch.float32, device=dev)
    part_s = torch.empty((splits, N), dtype=torch.float32, device=dev)
    part_cnt = torch.empty((splits, N), dtype=torch.int32, device=dev)
    part_zs = torch.empty((splits, N) if smooth else (1,), dtype=torch.float64, device=dev)
    lse = torch.empty(N, dtype=torch.float32, device=dev)
    rank = torch.empty(N, dtype=torch.int32, device=dev)
    zsum = torch.empty(N if smooth else 1, dtype=torch.float32, device=dev)
    outs = (part_m.data_ptr(), part_s.data_ptr(), part_cnt.data_ptr(), part_zs.data_ptr(),
            lse.data_ptr(), rank.data_ptr(), zsum.data_ptr(), int(smooth))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if plan.wide:  # K1's wide kernel with K3's epilogue, on the images
            buf = plan.images(dev)
            _write_images(lib, x, W, vocab_size, buf, stream)
            err = lib.t4r_ce_rank_wide(
                buf["ximg"].data_ptr(), buf["wimg"].data_ptr(), labels.data_ptr(),
                ll.data_ptr(), N, vocab_size, plan.ek, int(plan.resident), plan.row_tiles,
                splits, per_split, *outs, stream)
        else:
            entry = lib.t4r_ce_rank_bf16 if W.dtype == torch.bfloat16 else lib.t4r_ce_rank
            err = entry(
                x.data_ptr(), W.data_ptr(), labels.data_ptr(), ll.data_ptr(),
                N, E, vocab_size, splits, per_split, plan.stages, plan.smem, *outs, stream)
    raise_on_error(lib, err, "ce_rank")
    ce_rank.launches += 1
    return lse, rank, (zsum if smooth else None)


def _ce_fwd_cuda(x, W, labels, vocab_size, smooth):
    _check_cuda_inputs("ce_fwd", x, W, vocab_size, {"labels": (labels, torch.int32)})
    lib = _kernel_lib("ce_fwd")
    N = x.shape[0]
    dev = x.device
    plan = _plan_for(x, W, vocab_size, backward=False)
    buf = plan.scratch(dev, smooth)
    part = buf["part"]
    lse = torch.empty(N, dtype=torch.float32, device=dev)
    ll = torch.empty(N, dtype=torch.float32, device=dev)
    zsum = torch.empty(N if smooth else 1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _write_images(lib, x, W, vocab_size, buf, stream)
        err = lib.t4r_ce_fwd(
            buf["ximg"].data_ptr(), buf["wimg"].data_ptr(), labels.data_ptr(),
            N, vocab_size, W.shape[0], plan.ek, int(plan.resident), plan.row_tiles, plan.splits,
            plan.chunks_per_split, part[0].data_ptr(), part[1].data_ptr(), part[2].data_ptr(),
            buf["part_zs"].data_ptr(), lse.data_ptr(), ll.data_ptr(), zsum.data_ptr(),
            int(smooth), stream,
        )
    raise_on_error(lib, err, "ce_fwd")
    ce_fwd.launches += 1
    return lse, ll, (zsum if smooth else None)


def _ce_bwd_cuda(x, W, labels, lse, coef, vocab_size, eps, eps_over_v):
    _check_cuda_inputs("ce_bwd", x, W, vocab_size,
                       {"labels": (labels, torch.int32), "lse": (lse, torch.float32),
                        "coef": (coef, torch.float32)})
    lib = _kernel_lib("ce_bwd")
    N, E = x.shape
    dev = x.device
    eov = (eps / vocab_size if eps_over_v is None else eps_over_v) if eps else 0.0
    plan = _plan_for(x, W, vocab_size, backward=True)
    buf = plan.scratch(dev)
    # every element of these buffers is written by the kernels; dW in W's type
    dx = torch.empty((N, E), dtype=torch.float32, device=dev)
    dW = torch.empty(W.shape, dtype=W.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _write_images(lib, x, W, W.shape[0], buf, stream)
        err = lib.t4r_ce_bwd(
            buf["ximg"].data_ptr(), buf["wimg"].data_ptr(), W.data_ptr(),
            int(W.dtype == torch.bfloat16), labels.data_ptr(),
            lse.data_ptr(), coef.data_ptr(), N, E, vocab_size, W.shape[0], plan.ek,
            plan.slabs, plan.e_splits, plan.row_tiles, plan.table_tiles, float(eps), float(eov), plan.splits,
            plan.chunks_per_split, buf["info"].data_ptr(), buf["part_dx"].data_ptr(),
            dx.data_ptr(), dW.data_ptr(), stream,
        )
    raise_on_error(lib, err, "ce_bwd")
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

    x (N, E) f32, W (Vp, E) f32 or bf16, labels (N,) int32. CUDA tensors
    launch the CUDA kernel (``ce_fwd.launches`` counts the launches); CPU
    tensors run ``ce_fwd_plain``.
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
    """K2: ``(dx (N, E) f32, dW (Vp, E) in W's type)`` of the cross-entropy
    whose forward gave ``lse``; ``coef`` (N,) f32 scales each row's residual. ``eps`` is
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
        return dx.to(ctx.x_dtype), dW, None, None, None, None


def fused_softmax_ce(
    x: torch.Tensor,
    W: torch.Tensor,
    labels: torch.Tensor,
    weights: torch.Tensor,
    vocab_size: Optional[int] = None,
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """Weighted-mean CE of ``x @ W.T`` against ``labels`` without
    materialising the logits. x (N, E); W (Vp, E) f32 or bf16 (its gradient
    comes in its type); labels (N,) int;
    weights (N,) float. ``vocab_size`` bounds the true vocab when W carries
    padded rows: rows at and beyond it are left out of the softmax and get a
    zero gradient. ``weights`` and ``labels`` get no gradient: the weights
    are a validity mask."""
    V = W.shape[0] if vocab_size is None else int(vocab_size)
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

    x (N, E) f32, W (Vp, E) f32 or bf16, labels (N,) int32, ll (N,) f32
    label logits.
    CUDA tensors launch the CUDA kernel (``ce_rank.launches`` counts the
    launches); CPU tensors run ``ce_rank_plain``.
    """
    if x.device.type == "cpu":
        return ce_rank_plain(x, W, labels, ll, vocab_size, smooth)
    return _ce_rank_cuda(x, W, labels, ll, vocab_size, smooth)


ce_rank.launches = 0


def label_logits(x: torch.Tensor, W: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """O(N·E) label logit: gather the label rows, dot in f32 over bf16 values
    (the reference's gather-dot, kept outside the kernel). A label outside
    the table (``label >= rows`` or ``label < -rows``) gives NaN, as the
    reference's ``jnp.take`` fills it: the gather's index is clamped into the
    table, so neither device raises, and the result is replaced. A negative
    label in range counts from the table's end, as in the reference."""
    n_rows = W.shape[0]
    idx = labels.long()
    outside = (idx >= n_rows) | (idx < -n_rows)
    xb = x.to(torch.bfloat16).float()
    rows = W[idx.clamp(-n_rows, n_rows - 1)].to(torch.bfloat16).float()
    return torch.where(outside, float("nan"), (xb * rows).sum(-1))


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


def rank_counts_plain(
    x: torch.Tensor,
    W: torch.Tensor,
    ll: torch.Tensor,
    labels: torch.Tensor,
    vocab_size: int,
    chunk: int = 16384,
) -> torch.Tensor:
    """Plain PyTorch K4: chunked f32 products of bf16-rounded inputs. Returns
    the (N,) int32 count of columns ``c < vocab_size``, other than the row's
    own label, whose logit is strictly greater than ``ll``."""
    dev = x.device
    xb = x.to(torch.bfloat16).float()
    labels = labels.long()
    cnt = torch.zeros(x.shape[0], dtype=torch.int32, device=dev)
    for c0 in range(0, vocab_size, chunk):
        c1 = min(c0 + chunk, vocab_size)
        logits = xb @ W[c0:c1].to(torch.bfloat16).float().T  # (N, C) f32
        col = torch.arange(c0, c1, device=dev)
        greater = (col[None, :] != labels[:, None]) & (logits > ll[:, None])
        cnt += greater.sum(-1).to(torch.int32)
    return cnt


def _rank_cuda(x, W, ll, labels, vocab_size):
    _check_cuda_inputs("rank_counts", x, W, vocab_size,
                       {"labels": (labels, torch.int32), "ll": (ll, torch.float32)})
    lib = _kernel_lib("rank")
    N, E = x.shape
    dev = x.device
    plan = _plan_for(x, W, vocab_size, False, lib.t4r_chunk_cols(), streamed=True)
    splits, per_split = plan.splits, plan.chunks_per_split
    part_cnt = torch.empty((splits, N), dtype=torch.int32, device=dev)
    cnt = torch.empty(N, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if plan.wide:  # K1's wide kernel with K4's epilogue, on the images
            buf = plan.images(dev)
            _write_images(lib, x, W, vocab_size, buf, stream)
            err = lib.t4r_rank_wide(
                buf["ximg"].data_ptr(), buf["wimg"].data_ptr(), labels.data_ptr(),
                ll.data_ptr(), N, vocab_size, plan.ek, int(plan.resident), plan.row_tiles,
                splits, per_split, part_cnt.data_ptr(), cnt.data_ptr(), stream)
        else:
            entry = lib.t4r_rank_bf16 if W.dtype == torch.bfloat16 else lib.t4r_rank
            err = entry(
                x.data_ptr(), W.data_ptr(), labels.data_ptr(), ll.data_ptr(),
                N, E, vocab_size, splits, per_split,
                part_cnt.data_ptr(), cnt.data_ptr(), stream,
            )
    raise_on_error(lib, err, "rank")
    rank_counts.launches += 1
    return cnt


def rank_counts(
    x: torch.Tensor,
    W: torch.Tensor,
    ll: torch.Tensor,
    labels: torch.Tensor,
    vocab_size: Optional[int] = None,
) -> torch.Tensor:
    """K4: per row the int32 count of logits of ``bf16(x) @ bf16(W[:vocab_size]).T``
    strictly greater than the given label logit ``ll`` (N,) f32.

    The reference leaves no column out and relies on ``ll`` comparing
    bit-equal to its own product at the label's column. Here that column
    (``labels`` (N,) int32) is left out explicitly, which gives the
    reference's count whenever ``ll`` is the label's own logit, the only use
    there is. A label of -1 leaves nothing out: on a vocab-parallel shard
    ``ll`` then belongs to another shard's column. ``vocab_size`` is a host
    integer from 0 (the count is 0) to the table's rows. CUDA tensors launch
    the CUDA kernel (``rank_counts.launches`` counts the launches); CPU
    tensors run ``rank_counts_plain``.
    """
    V = W.shape[0] if vocab_size is None else int(vocab_size)
    if x.device.type == "cpu":
        return rank_counts_plain(x, W, ll, labels, V)
    return _rank_cuda(x, W, ll, labels, V)


rank_counts.launches = 0


def fused_label_rank(
    x: torch.Tensor,
    W: torch.Tensor,
    labels: torch.Tensor,
    vocab_size: Optional[int] = None,
) -> torch.Tensor:
    """Exact 0-based rank of each label's logit among the ``vocab_size``
    logits of its row (count of strictly greater logits), without (N, V)
    logits and without a sort: the label logit from ``ce_fwd``, the count
    from ``rank_counts``."""
    V = W.shape[0] if vocab_size is None else int(vocab_size)
    x = x.float().contiguous()
    labels = labels.to(torch.int32).contiguous()
    _, ll, _ = ce_fwd(x, W, labels, V)
    return rank_counts(x, W, ll, labels, V)


def fused_topk(
    x: torch.Tensor,
    W: torch.Tensor,
    k: int,
    chunk: int = 32768,
    vocab_size: Optional[int] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``x @ W[:vocab_size].T`` by a top-k per chunk of the vocab and
    a running merge: peak memory O(N·chunk), not O(N·V). Plain tensor code, as
    in the reference. ``compute_dtype`` is the type x and W are rounded to
    before the product (bf16: the training numerics; f32 matches the dense
    scoring path exactly); the products accumulate in f32. Returns
    ``(scores (N, k) f32, ids (N, k) int64)``; slots beyond the valid columns
    hold -1e30."""
    V = W.shape[0] if vocab_size is None else int(vocab_size)
    N = x.shape[0]
    dev = x.device
    xb = x.to(compute_dtype).float()
    best_s = torch.full((N, k), NEG, dtype=torch.float32, device=dev)
    best_i = torch.zeros((N, k), dtype=torch.int64, device=dev)
    for c0 in range(0, V, chunk):
        c1 = min(c0 + chunk, V)
        logits = xb @ W[c0:c1].to(compute_dtype).float().T
        s, i = torch.topk(logits, min(k, c1 - c0), dim=-1)
        cat_s = torch.cat([best_s, s], dim=1)
        cat_i = torch.cat([best_i, i + c0], dim=1)
        best_s, pos = torch.topk(cat_s, k, dim=-1)
        best_i = torch.gather(cat_i, 1, pos)
    return best_s, best_i
