"""LSH (locality-sensitive hashing) attention: Reformer's long-sequence op.

Counterpart of ``transformers4rec_tpu/ops/lsh_attention.py``, in plain
PyTorch (the JAX package writes it in plain ``jnp``; no TPU kernel).

- **Shared query/key, length-normalised keys**: ``k_j = qk_j / ||qk_j||``,
  queries as they are, logits scaled by Dh^-1/2. A query's own key gets a
  finite penalty (``SELF_PENALTY``), so a query alone in its bucket still
  returns its own value.
- **Angular LSH**: a vector's bucket is the argmax over ``[xR, -xR]`` for a
  fixed rotation R of shape (Dh, rounds, buckets / 2). The rotations are
  constants, not trained; the LSH layer holds them as a buffer
  (``draw_rotations`` draws them from a seed).
- **Sorted chunks**: per round, one argsort of ``bucket·Sp + position``
  (invalid positions sort last); each chunk of ``chunk_size`` queries
  attends its own chunk and the previous one (circularly, in sorted
  order); the rounds combine by a softmax over their log-sum-exps.

Below ``LSH_MIN_SEQ`` positions the exact dense form of the same
semantics (``lsh_reference``) runs instead: every bucket decision is moot
when a query may attend everything.

Types, as the JAX functions': the keys are normalised in ``qk``'s type by a
float32 norm, the hash projects in float32, both products accumulate in
float32 (the logits and the softmax are float32), and the output is
rounded once to ``v``'s type.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG = -1e9
# a query's own key: below any other key of its bucket, above the masked ones
SELF_PENALTY = -1e5
# below this sequence length the exact dense form runs
LSH_MIN_SEQ = 64


def draw_rotations(head_dim: int, num_hashes: int, num_buckets: int, seed: int) -> torch.Tensor:
    """The (head_dim, num_hashes, num_buckets // 2) float32 rotations of an
    LSH layer, drawn from a ``torch.Generator`` seeded with ``seed`` (the
    same on every device). ``num_buckets`` must be even."""
    if num_buckets % 2:
        raise ValueError(f"num_buckets must be even, got {num_buckets}")
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn((head_dim, num_hashes, num_buckets // 2), generator=gen)


def _normalize_keys(qk: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(qk.float(), dim=-1, keepdim=True).clamp_min(1e-6)
    return qk / norm.to(qk.dtype)


def hash_buckets(k_normed: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    """Angular LSH buckets: (B, S, H, Dh) normalised keys and (Dh, R, nb/2)
    rotations → (B, S, H, R) long in [0, nb)."""
    proj = torch.einsum("bshd,drn->bshrn", k_normed.float(), rotations.float())
    return torch.cat([proj, -proj], dim=-1).argmax(dim=-1)


def lsh_reference(qk: torch.Tensor, v: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                  causal: bool = False) -> torch.Tensor:
    """Exact O(S²) dense attention with LSH attention's semantics (shared
    QK, normalised keys, the finite self penalty): what the sorted path
    tends to as its chunks cover the sequence, and the path below
    ``LSH_MIN_SEQ``. Padded queries give zeros."""
    B, S, H, Dh = qk.shape
    k = _normalize_keys(qk)
    logits = torch.einsum("bqhd,bkhd->bhqk", qk.float(), k.float()) * (Dh ** -0.5)
    idx = torch.arange(S, device=qk.device)
    logits = logits + torch.where(idx[None, :] == idx[:, None], SELF_PENALTY, 0.0)
    if causal:
        logits = logits + torch.where(idx[None, :] > idx[:, None], NEG, 0.0)
    if pad_mask is not None:
        logits = logits + torch.where(pad_mask[:, None, None, :], 0.0, NEG)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v.float())
    if pad_mask is not None:
        out = out * pad_mask[:, :, None, None].to(out.dtype)
    return out.to(v.dtype)


def lsh_attention(qk: torch.Tensor, v: torch.Tensor, rotations: torch.Tensor,
                  pad_mask: Optional[torch.Tensor] = None, causal: bool = False,
                  chunk_size: int = 8, force_sorted: bool = False) -> torch.Tensor:
    """LSH attention over (B, S, H, Dh) shared query/keys and values with
    the (Dh, rounds, buckets / 2) ``rotations``; (B, S, H, Dh) context.
    ``force_sorted`` takes the sorted path below ``LSH_MIN_SEQ`` too."""
    B, S, H, Dh = qk.shape
    if not force_sorted and S < LSH_MIN_SEQ:
        return lsh_reference(qk, v, pad_mask=pad_mask, causal=causal)
    R = rotations.shape[1]
    num_buckets = 2 * rotations.shape[2]
    m = int(chunk_size)
    Sp = -(-S // m) * m
    valid = pad_mask if pad_mask is not None else torch.ones(
        (B, S), dtype=torch.bool, device=qk.device)
    if Sp != S:
        qk = torch.nn.functional.pad(qk, (0, 0, 0, 0, 0, Sp - S))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, Sp - S))
        valid = torch.nn.functional.pad(valid, (0, Sp - S))
    C = Sp // m

    k = _normalize_keys(qk)
    buckets = hash_buckets(k, rotations)  # (B, Sp, H, R)
    # invalid positions sort to the very end
    buckets = torch.where(valid[:, :, None, None], buckets, num_buckets)
    pos = torch.arange(Sp, device=qk.device)
    # (B, H, R, Sp); the keys are distinct, so the order is that of a
    # stable sort: positions in order within a bucket
    sidx = torch.argsort(buckets.permute(0, 2, 3, 1) * Sp + pos, dim=-1)

    def gather_rounds(x):  # (B, Sp, H, d) → (B, H, R, Sp, d)
        xb = x.permute(0, 2, 1, 3)[:, :, None].expand(B, H, R, Sp, x.shape[-1])
        return torch.take_along_dim(xb, sidx[..., None], dim=3)

    def chunk(x):  # (..., Sp, d) → (..., C, m, d)
        return x.reshape(*x.shape[:-2], C, m, x.shape[-1])

    qs, ks, vs = chunk(gather_rounds(qk)), chunk(gather_rounds(k)), chunk(gather_rounds(v))
    pos_c = sidx.reshape(B, H, R, C, m)  # each sorted slot's position
    valid_c = torch.take_along_dim(valid[:, None, None].expand(B, H, R, Sp), sidx,
                                   dim=-1).reshape(B, H, R, C, m)

    # keys: a chunk's own and the previous chunk's (circular)
    k_ext = torch.cat([ks, ks.roll(1, dims=-3)], dim=-2)
    v_ext = torch.cat([vs, vs.roll(1, dims=-3)], dim=-2)
    kpos = torch.cat([pos_c, pos_c.roll(1, dims=-2)], dim=-1)[..., None, :]
    kvalid = torch.cat([valid_c, valid_c.roll(1, dims=-2)], dim=-1)[..., None, :]
    qpos = pos_c[..., :, None]

    logits = torch.einsum("bhrcmd,bhrcnd->bhrcmn", qs.float(), k_ext.float()) * (Dh ** -0.5)
    logits = logits + torch.where(qpos == kpos, SELF_PENALTY, 0.0)
    if causal:
        logits = logits + torch.where(kpos > qpos, NEG, 0.0)
    logits = logits + torch.where(kvalid, 0.0, NEG)
    lse = torch.logsumexp(logits, dim=-1)  # (B, H, R, C, m)
    # a max-subtracted softmax, not exp(logits - lse): rows at the self
    # penalty's scale would lose probability mass to the subtraction
    o = torch.einsum("bhrcmn,bhrcnd->bhrcmd", torch.softmax(logits, dim=-1), v_ext.float())

    # back to the original positions
    inv = torch.argsort(sidx, dim=-1)
    o_orig = torch.take_along_dim(o.reshape(B, H, R, Sp, Dh), inv[..., None], dim=3)
    lse_orig = torch.take_along_dim(lse.reshape(B, H, R, Sp), inv, dim=3)
    # the rounds, weighted by a softmax over their log-sum-exps
    w = torch.softmax(lse_orig, dim=2)[..., None]
    out = (o_orig * w).sum(dim=2).permute(0, 2, 1, 3)[:, :S]  # (B, S, H, Dh)
    out = out * valid[:, :S, None, None].to(out.dtype)
    return out.to(v.dtype)
