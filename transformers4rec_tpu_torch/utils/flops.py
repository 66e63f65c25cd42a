"""Analytic FLOPs and device-memory bytes of the training step.

Counterpart of ``transformers4rec_tpu/utils/flops.py``: the same functions,
names and conventions, so that a step's counts are the JAX package's for
the same shapes; only the peaks are the card's. A benchmark divides the
counts by a measured step time for an ``mfu`` and a roofline share.

Conventions:

- a GEMM of (m, k) x (k, n) counts 2*m*k*n FLOPs;
- the backward of a GEMM is two GEMMs (dX, dW): 3x the forward's FLOPs for
  forward and backward through a dense layer;
- elementwise work (the softmax's exp, LayerNorm, optimizer arithmetic) is
  counted in ops apart: it never dominates the FLOP total, but can dominate
  the time (the CE kernels are bound by the exponentials);
- bytes are the least device-memory traffic of the streamed implementation
  (weights and tables read once a pass; activations taken as resident on
  chip at these sizes).

Peaks of one NVIDIA H100 SXM5 (NVIDIA's H100 data sheet, dense rates
without sparsity, at the 700 W power limit): 989 TFLOP/s in bf16 on the
tensor cores, 67 TFLOP/s in float32 outside them, 3.35 TB/s of HBM3. A card
set below 700 W (``nvidia-smi --query-gpu=power.limit``) runs slower under
load: state a share against these peaks with the card's power limit beside
it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

H100_PEAK_BF16_FLOPS = 989e12
H100_PEAK_F32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12


def encoder_step_flops(
    batch: int,
    seq: int,
    d_model: int,
    n_layer: int,
    n_head: int,
    d_ff: Optional[int] = None,
    fwd_bwd: bool = True,
) -> int:
    """Transformer encoder GEMM FLOPs for one step (forward, or forward and
    backward = 3x)."""
    d_ff = d_ff or 4 * d_model
    tokens = batch * seq
    qkvo = 4 * 2 * tokens * d_model * d_model
    # scores (B, H, S, S) and context: 2 GEMMs of (S, Dh) x (Dh, S) a head
    attn = 2 * 2 * batch * n_head * seq * seq * (d_model // n_head)
    ffn = 2 * 2 * tokens * d_model * d_ff
    per_layer = qkvo + attn + ffn
    total = n_layer * per_layer
    return total * (3 if fwd_bwd else 1)


def ce_step_flops(ce_rows: int, emb_dim: int, vocab: int,
                  fwd_bwd: bool = True) -> int:
    """Streamed full-softmax CE over the item vocabulary: one (M, E) x (E, V)
    GEMM forward; the backward adds dX (M, V) x (V, E) and dW (E, M) x (M, V)."""
    gemm = 2 * ce_rows * emb_dim * vocab
    return gemm * (3 if fwd_bwd else 1)


def ce_step_vpu_ops(ce_rows: int, vocab: int) -> int:
    """Elementwise ops on the (M, V) logits stream: exp and the running
    max and sum forward, the P - y residual backward; 6 ops a logit a pass,
    the JAX package's coefficient."""
    return 6 * ce_rows * vocab * 2  # forward and backward passes


def ce_step_hbm_bytes(ce_rows: int, emb_dim: int, vocab: int,
                      dtype_bytes: int = 4) -> int:
    """Least table traffic of the vocabulary-major streamed CE: W read once
    forward, once for dX, once for the dW accumulation, and dW written."""
    table = vocab * emb_dim * dtype_bytes
    return 4 * table


def table_optimizer_hbm_bytes(vocab: int, emb_dim: int,
                              dtype_bytes: int = 4) -> int:
    """Unfactored Adafactor on the (V, E) table: read W, v, g; write W, v."""
    return 5 * vocab * emb_dim * dtype_bytes


def projection_step_flops(batch: int, seq: int, d_model: int, emb_dim: int,
                          fwd_bwd: bool = True) -> int:
    """The weight-tying projection d_model -> emb_dim."""
    gemm = 2 * batch * seq * d_model * emb_dim
    return gemm * (3 if fwd_bwd else 1)


def mlm_budget_rows(batch: int, seq: int, p: float) -> int:
    """The ≥6σ CE-row budget of MLM training
    (``NextItemPredictionTask._budget_rows``)."""
    n = batch * seq
    m = int(n * p + 6.0 * math.sqrt(n * p * (1.0 - p))) + 8
    return min(m, n)


def xlnet_mlm_step_accounting(
    batch: int = 128,
    seq: int = 20,
    d_model: int = 192,
    n_layer: int = 3,
    n_head: int = 16,
    vocab: int = 390_008,
    emb_dim: int = 64,
    mlm_p: float = 0.3,
) -> Dict[str, float]:
    """One training step's accounting for the flagship (REES46 XLNet-MLM)."""
    m = mlm_budget_rows(batch, seq, mlm_p)
    enc = encoder_step_flops(batch, seq, d_model, n_layer, n_head)
    proj = projection_step_flops(batch, seq, d_model, emb_dim)
    ce = ce_step_flops(m, emb_dim, vocab)
    return {
        "ce_rows": m,
        "encoder_flops": enc,
        "projection_flops": proj,
        "ce_flops": ce,
        "total_flops": enc + proj + ce,
        "ce_vpu_ops": ce_step_vpu_ops(m, vocab),
        "ce_hbm_bytes": ce_step_hbm_bytes(m, emb_dim, vocab),
        "optimizer_hbm_bytes": table_optimizer_hbm_bytes(vocab, emb_dim),
    }


def mfu(total_flops_per_step: float, step_seconds: float,
        peak: float = H100_PEAK_BF16_FLOPS) -> float:
    """Model FLOPs utilisation: achieved model FLOP/s over the card's peak."""
    return total_flops_per_step / max(step_seconds, 1e-12) / peak
