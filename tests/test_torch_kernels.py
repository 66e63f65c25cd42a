"""The port's hand-written CUDA kernels against their plain PyTorch versions.

Every test here needs an NVIDIA card with ``nvcc`` and is marked ``cuda``;
on a machine without CUDA they skip. This file imports no JAX, so it runs
on the card without the JAX package's test setup:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances: lse and the label logit within 1e-5 relative and zsum within
1e-5 of max(|zsum|, sqrt(V)) (the kernel sums the same bf16-rounded products
in another order); ranks within 1 of the plain version's, since a logit
within an ulp of the label logit may fall on either side of it. The backward
kernel rounds its residual to bf16 before both products, as the plain
version does, but from an exponential of its own: dx and dW agree within
2e-2 of the plain result's largest magnitude and 1e-3 in relative Frobenius
norm.
"""

import math

import numpy as np
import pytest
import torch

from transformers4rec_tpu_torch.ops import vocab

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _inputs(n, e, rows, vocab_size, seed, dev):
    rng = np.random.default_rng(seed)
    W = rng.normal(0.0, 0.05, (rows, e)).astype(np.float32)
    labels = rng.integers(1, vocab_size, n).astype(np.int32)
    beta = rng.uniform(0.0, 12.0, (n, 1)).astype(np.float32)
    x = (beta * W[labels] + rng.normal(0.0, 1.0, (n, e))).astype(np.float32)
    x, W, labels = (torch.from_numpy(a).to(dev) for a in (x, W, labels))
    return x, W, labels, vocab.label_logits(x, W, labels)


@pytest.mark.parametrize("n,e,rows,vocab_size,smooth", [
    (1, 64, 1008, 1001, False),        # one row, a vocab bound inside a chunk
    (37, 16, 5000, 4999, True),        # N and V off every tile size
    (128, 64, 40_008, 40_001, False),  # the evaluation shape, narrower vocab
    (300, 256, 2056, 2050, True),      # widest E, three row tiles
])
def test_ce_rank_kernel_matches_plain(dev, n, e, rows, vocab_size, smooth):
    x, W, labels, ll = _inputs(n, e, rows, vocab_size, n + e, dev)
    before = vocab.ce_rank.launches
    lse, rank, zs = vocab.ce_rank(x, W, labels, ll, vocab_size, smooth=smooth)
    torch.cuda.synchronize()
    assert vocab.ce_rank.launches == before + 1
    lse_p, rank_p, zs_p = vocab.ce_rank_plain(x, W, labels, ll, vocab_size, smooth)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=0)
    assert rank.dtype == torch.int32
    assert int((rank.long() - rank_p.long()).abs().max()) <= 1
    if smooth:
        scale = zs_p.abs().clamp_min(math.sqrt(vocab_size))
        assert float(((zs - zs_p).abs() / scale).max()) <= 1e-5
    else:
        assert zs is None


def test_ce_rank_kernel_ignores_padded_rows(dev):
    x, W, labels, ll = _inputs(64, 64, 1024, 1000, 5, dev)
    want = vocab.ce_rank(x, W, labels, ll, 1000)
    W[1000:] = 1e4
    got = vocab.ce_rank(x, W, labels, ll, 1000)
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_fused_ce_and_rank_on_the_card_matches_the_cpu(dev):
    x, W, labels, _ = _inputs(200, 64, 3000, 2999, 6, dev)
    weights = (torch.arange(200, device=dev) % 5 != 0).float()
    got = vocab.fused_ce_and_rank(x, W, labels, weights, vocab_size=2999, label_smoothing=0.1)
    want = vocab.fused_ce_and_rank(x.cpu(), W.cpu(), labels.cpu(), weights.cpu(),
                                   vocab_size=2999, label_smoothing=0.1)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=0)
    assert int((got[1].cpu().long() - want[1].long()).abs().max()) <= 1


@pytest.mark.parametrize("bad", ["x_dtype", "labels_dtype", "strided_x", "e_not_mult4",
                                 "vocab_too_big", "cpu_ll"])
def test_ce_rank_kernel_rejects_what_it_does_not_take(dev, bad):
    x, W, labels, ll = _inputs(8, 64, 512, 500, 7, dev)
    if bad == "x_dtype":
        x = x.half()
    elif bad == "labels_dtype":
        labels = labels.long()
    elif bad == "strided_x":
        x = torch.cat([x, x], 1)[:, ::2]
    elif bad == "e_not_mult4":
        x, W = x[:, :62].contiguous(), W[:, :62].contiguous()
    elif bad == "cpu_ll":
        ll = ll.cpu()
    vocab_size = 513 if bad == "vocab_too_big" else 500
    with pytest.raises((TypeError, ValueError)):
        vocab.ce_rank(x, W, labels, ll, vocab_size)


# ------------------------------------------------------------------ K1 / K2
CE_SHAPES = [
    (1, 64, 1008, 1001, 0.0),        # one row, a vocab bound inside a chunk
    (37, 16, 5000, 4999, 0.1),       # N and V off every tile size, smoothing
    (300, 32, 2056, 2050, 0.0),      # three row tiles
    (915, 64, 40_008, 40_001, 0.0),  # the training shape, narrower vocab
    (200, 128, 3000, 2999, 0.1),     # the widest E the backward takes
    (5, 20, 40, 33, 0.1),            # a vocab inside one chunk, E off the k-step of 16
    (130, 100, 704, 640, 0.0),       # V a multiple of the chunk, a whole chunk of padded rows
    (64, 64, 512, 512, 0.1),         # no padded row at all
]


def _ce_inputs(n, e, rows, vocab_size, seed, dev):
    """As ``_inputs``, plus row weights with about 30% zeros and a few
    labels of -1 (with weight 0), as padded rows carry."""
    x, W, labels, _ = _inputs(n, e, rows, vocab_size, seed, dev)
    rng = np.random.default_rng(seed + 1)
    w = (rng.random(n) >= 0.3).astype(np.float32)
    pad = rng.random(n) < 0.05
    w[pad] = 0.0
    labels = torch.where(torch.from_numpy(pad).to(dev), torch.full_like(labels, -1), labels)
    return x, W, labels, torch.from_numpy(w).to(dev)


@pytest.mark.parametrize("n,e,rows,vocab_size,eps", CE_SHAPES)
def test_ce_fwd_kernel_matches_plain(dev, n, e, rows, vocab_size, eps):
    x, W, labels, _ = _ce_inputs(n, e, rows, vocab_size, n + e, dev)
    before = vocab.ce_fwd.launches
    lse, ll, zs = vocab.ce_fwd(x, W, labels, vocab_size, smooth=eps > 0)
    torch.cuda.synchronize()
    assert vocab.ce_fwd.launches == before + 1
    lse_p, ll_p, zs_p = vocab.ce_fwd_plain(x, W, labels, vocab_size, eps > 0)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(ll, ll_p, rtol=1e-5, atol=1e-6)
    assert bool((ll[labels < 0] == 0).all())
    if eps > 0:
        scale = zs_p.abs().clamp_min(math.sqrt(vocab_size))
        assert float(((zs - zs_p).abs() / scale).max()) <= 1e-5
    else:
        assert zs is None


def _assert_grad_close(got, want, what):
    assert torch.isfinite(got).all(), what
    peak = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-2 * peak, what
    assert float((got - want).norm() / want.norm()) <= 1e-3, what


@pytest.mark.parametrize("n,e,rows,vocab_size,eps", CE_SHAPES)
def test_ce_bwd_kernel_matches_plain(dev, n, e, rows, vocab_size, eps):
    x, W, labels, w = _ce_inputs(n, e, rows, vocab_size, n + e, dev)
    lse, _, _ = vocab.ce_fwd_plain(x, W, labels, vocab_size, False)
    coef = (w / w.sum().clamp_min(1.0)).contiguous()
    eov = 0.5 * eps / vocab_size if n == 37 else None  # an explicit share, once
    before = vocab.ce_bwd.launches
    dx, dW = vocab.ce_bwd(x, W, labels, lse, coef, vocab_size, eps, eov)
    torch.cuda.synchronize()
    assert vocab.ce_bwd.launches == before + 1
    dx_p, dW_p = vocab.ce_bwd_plain(x, W, labels, lse, coef, vocab_size, eps, eov)
    _assert_grad_close(dx, dx_p, "dx")
    _assert_grad_close(dW, dW_p, "dW")
    assert dW.shape == W.shape and bool((dW[vocab_size:] == 0).all())
    assert bool((dx[w == 0] == 0).all())


def test_ce_bwd_kernel_gives_the_same_bits_twice(dev):
    x, W, labels, w = _ce_inputs(300, 64, 5000, 4999, 3, dev)
    lse, _, _ = vocab.ce_fwd(x, W, labels, 4999)
    coef = (w / w.sum()).contiguous()
    first = vocab.ce_bwd(x, W, labels, lse, coef, 4999)
    second = vocab.ce_bwd(x, W, labels, lse, coef, 4999)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_fused_softmax_ce_on_the_card_matches_the_cpu(dev):
    x, W, labels, w = _ce_inputs(200, 64, 3000, 2999, 6, dev)
    got, want = [], []
    for xs, Ws, ls, ws, out in ((x, W, labels, w, got),
                                (x.cpu(), W.cpu(), labels.cpu(), w.cpu(), want)):
        xs, Ws = xs.clone().requires_grad_(), Ws.clone().requires_grad_()
        loss = vocab.fused_softmax_ce(xs, Ws, ls, ws, vocab_size=2999, label_smoothing=0.1)
        loss.backward()
        out += [loss.detach().cpu(), xs.grad.cpu(), Ws.grad.cpu()]
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    _assert_grad_close(got[1], want[1], "dx")
    _assert_grad_close(got[2], want[2], "dW")


def test_ce_bwd_kernel_rejects_what_it_does_not_take(dev):
    x, W, labels, w = _ce_inputs(8, 256, 512, 500, 7, dev)
    lse, _, _ = vocab.ce_fwd(x, W, labels, 500)  # the forward takes E = 256
    with pytest.raises(ValueError, match="E a multiple of 4"):
        vocab.ce_bwd(x, W, labels, lse, w, 500)
    with pytest.raises(TypeError):
        vocab.ce_fwd(x, W, labels.long(), 500)
