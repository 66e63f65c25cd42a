"""The port's hand-written CUDA kernels against their plain PyTorch versions.

Every test here needs an NVIDIA card with ``nvcc`` and is marked ``cuda``;
on a machine without CUDA they skip. This file imports no JAX, so it runs
on the card without the JAX package's test setup:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances: lse and the label logit within 1e-5 relative and zsum within
1e-5 of max(|zsum|, sqrt(V)) (the kernel sums the same bf16-rounded products
in another order); ranks within 1 of the plain version's, since a logit
within an ulp of the label logit may fall on either side of it (at the
thousands of rows of every-position evaluation: exact on 99% of the rows
and within 2 on all, as ``chip_smoke.py`` holds K3). The backward
kernel rounds its residual to bf16 before both products, as the plain
version does, but from an exponential of its own: dx and dW agree within
2e-2 of the plain result's largest magnitude and 1e-3 in relative Frobenius
norm. The rank kernel's counts are within 1 of the plain version's for the
same reason as K3's ranks. The Adafactor kernels repeat the plain version's
float32 arithmetic with fused multiply-adds, an approximate rsqrt (2 ulp) and
another order of the clip's sum: the moment within 1e-6 relative, the
parameter within 1e-5 of the largest update plus its own float32 spacing.
The attention kernels round P and dS to bf16 as their plain versions do, from
exponentials of their own: the output within 5e-3 and 1e-3 in relative
Frobenius norm, lse within 1e-4, gradients within 2e-2 of the peak and 1e-3
in relative Frobenius norm, and the same bits on a second call. Their bf16
forms (bf16 q, k, v, dO; bf16 out, dq, dk, dv) give the f32 forms' bits on
the same values, rounded once, in every design; against the plain versions
on bf16 inputs they are held as the f32 forms are, plus one bf16 spacing of
the value (the two sides round results that differ by the f32 noise above).
Their f16 forms likewise: the f32 forms' bits on the exact f32 images of the
f16 inputs, rounded once to f16, and within one f16 spacing plus the f32
tolerances of the plain versions; a CUDA f16 launch counts in
``f16_launches``.
"""

import math

import numpy as np
import pytest
import torch

from transformers4rec_tpu_torch.ops import attention as attn
from transformers4rec_tpu_torch.ops import fused_adafactor as fa
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


@pytest.mark.parametrize("n,e,vocab_size", [
    (77, 64, 16_955),     # N off a 16-row boundary; V off the chunk and the last split 1 chunk
    (128, 256, 16_955),   # the widest narrow E: 32-row slots, V off them too
    (130, 20, 33_001),    # two row tiles, E off every k-step
])
def test_streamed_ce_rank_kernel_matches_plain_at_its_edges(dev, n, e, vocab_size):
    """K3's streamed kernel where its ring meets the shapes' edges: partial
    slots and splits of uneven length (the last of them one chunk long on a
    132-SM card), against the plain version, with the same bits twice."""
    x, W, labels, ll = _inputs(n, e, vocab_size + 3, vocab_size, n + e + 1, dev)
    lib = vocab._kernel_lib("ce_rank")
    plan = vocab._stream_plan(lib, x, W, vocab_size)
    assert plan.stages >= vocab.K3_MIN_STAGES
    assert lib.t4r_ce_rank_smem(e, plan.stages) == plan.smem
    got = vocab.ce_rank(x, W, labels, ll, vocab_size, smooth=True)
    again = vocab.ce_rank(x, W, labels, ll, vocab_size, smooth=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    lse_p, rank_p, zs_p = vocab.ce_rank_plain(x, W, labels, ll, vocab_size, True)
    torch.testing.assert_close(got[0], lse_p, rtol=1e-5, atol=0)
    assert int((got[1].long() - rank_p.long()).abs().max()) <= 1
    scale = zs_p.abs().clamp_min(math.sqrt(vocab_size))
    assert float(((got[2] - zs_p).abs() / scale).max()) <= 1e-5


def test_streamed_ce_rank_kernel_gives_the_same_bits_twice_at_the_evaluation_shape(dev):
    x, W, labels, ll = _inputs(128, 64, 390_008, 390_001, 3, dev)
    first = vocab.ce_rank(x, W, labels, ll, 390_001)
    second = vocab.ce_rank(x, W, labels, ll, 390_001)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    lse_p, rank_p, _ = vocab.ce_rank_plain(x, W, labels, ll, 390_001, False)
    torch.testing.assert_close(first[0], lse_p, rtol=1e-5, atol=0)
    assert int((first[1].long() - rank_p.long()).abs().max()) <= 1


def test_ce_rank_kernel_refuses_a_ring_the_plan_would_not_give(dev):
    x, W, labels, ll = _inputs(8, 64, 512, 500, 7, dev)
    lib = vocab._kernel_lib("ce_rank")
    out = [torch.empty(8, device=dev) for _ in range(2)] + [
        torch.empty(8, dtype=torch.int32, device=dev), torch.empty(8, dtype=torch.float64,
                                                                     device=dev),
        torch.empty(8, device=dev), torch.empty(8, dtype=torch.int32, device=dev),
        torch.empty(8, device=dev)]
    ptrs = [t.data_ptr() for t in out]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for stages, smem in ((2, lib.t4r_ce_rank_smem(64, 2)), (4, lib.t4r_ce_rank_smem(64, 4) + 16),
                         (40, lib.t4r_ce_rank_smem(64, 40))):
        err = lib.t4r_ce_rank(x.data_ptr(), W.data_ptr(), labels.data_ptr(), ll.data_ptr(), 8,
                              64, 500, 1, 8, stages, smem, *ptrs, 0, stream)
        assert err != 0


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
    # N off the 64- and the 128-row tiles at every width the backward pads to 64
    (193, 4, 1000, 997, 0.1),
    (193, 20, 3000, 2990, 0.0),
    (193, 64, 2600, 2560, 0.1),      # V a multiple of the 128-column chunk
    (193, 128, 700, 650, 0.0),
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


@pytest.mark.parametrize("e", [132, 192, 256])
def test_ce_fwd_kernel_at_the_widest_e(dev, e):
    """E above 128 takes four slabs of 64 (132 and 192 padded with zeros)."""
    x, W, labels, _ = _ce_inputs(193, e, 3000, 2999, 8, dev)
    for smooth in (False, True):
        lse, ll, zs = vocab.ce_fwd(x, W, labels, 2999, smooth=smooth)
        lse_p, ll_p, zs_p = vocab.ce_fwd_plain(x, W, labels, 2999, smooth)
        torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=0)
        torch.testing.assert_close(ll, ll_p, rtol=1e-5, atol=1e-6)
        if smooth:
            scale = zs_p.abs().clamp_min(math.sqrt(2999))
            assert float(((zs - zs_p).abs() / scale).max()) <= 1e-5


@pytest.mark.parametrize("n", [915, 8192])
def test_ce_kernels_give_the_same_bits_twice_at_the_training_shapes(dev, n):
    """The flagship's loss rows (915) and the long-session path's (8,192)
    against the whole REES46 table."""
    x, W, labels, w = _ce_inputs(n, 64, 390_008, 390_001, n, dev)
    first = vocab.ce_fwd(x, W, labels, 390_001)
    second = vocab.ce_fwd(x, W, labels, 390_001)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    coef = (w / w.sum()).contiguous()
    dx, dW = vocab.ce_bwd(x, W, labels, first[0], coef, 390_001)
    dx2, dW2 = vocab.ce_bwd(x, W, labels, first[0], coef, 390_001)
    assert torch.equal(dx, dx2) and torch.equal(dW, dW2)
    assert torch.isfinite(dx).all() and torch.isfinite(dW).all()


@pytest.mark.parametrize("rows,e", [(1, 4), (130, 20), (300, 128), (129, 192)])
def test_images_are_laid_out_as_swizzled_image_index_says(dev, rows, e):
    """What ``to_image_kernel`` writes is bf16(src) at the places of the
    Python twin of its layout, and zeros in the padding."""
    src = torch.from_numpy(np.random.default_rng(rows).standard_normal((rows, e))
                           .astype(np.float32)).to(dev)
    plan = vocab.ce_plan(rows, e, rows, rows, 132, True)
    img = plan.scratch(dev)["ximg"]
    with torch.cuda.device(dev):
        vocab._write_image(vocab._kernel_lib("ce_fwd"), src, rows, img,
                           torch.cuda.current_stream(dev).cuda_stream)
    want = torch.zeros(img.shape, dtype=torch.bfloat16, device=dev)
    want[:rows, :e] = src.to(torch.bfloat16)
    idx = vocab.swizzled_image_index(rows, plan.ek).to(dev)
    assert torch.equal(img.flatten()[idx], want)


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
    x, W, labels, w = _ce_inputs(8, 64, 512, 500, 7, dev)
    lse, _, _ = vocab.ce_fwd(x, W, labels, 500)
    x, W = x[:, :62].contiguous(), W[:, :62].contiguous()
    with pytest.raises(ValueError, match="E a multiple of 4"):
        vocab.ce_bwd(x, W, labels, lse, w, 500)
    with pytest.raises(TypeError):
        vocab.ce_fwd(x, W, labels.long(), 500)


# ------------------------------------------------- labels on padding rows
@pytest.mark.parametrize("e", [64, 448])  # the narrow kernels, and the wide ones
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_a_label_on_a_padding_row_matches_plain_in_k1_k2_k3(dev, eps, e):
    """``vocab_size <= label < rows``: the masked label logit -1e30 in K1, the
    one-hot in K2's dx and on that row of dW; K3 takes the gathered logit."""
    n, rows, vocab_size = 300, 5000, 4930  # padding rows inside and beyond the last chunk
    x, W, labels, w = _ce_inputs(n, e, rows, vocab_size, 21, dev)
    labels[:4] = torch.tensor([4930, 4931, 4990, 4999], dtype=torch.int32, device=dev)
    w[:4] = 1.0
    lse, ll, zs = vocab.ce_fwd(x, W, labels, vocab_size, smooth=eps > 0)
    lse_p, ll_p, _ = vocab.ce_fwd_plain(x, W, labels, vocab_size, eps > 0)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=0)
    assert bool((ll[:4] == -1e30).all()) and bool((ll_p[:4] == -1e30).all())
    torch.testing.assert_close(ll[4:], ll_p[4:], rtol=1e-5, atol=1e-6)
    coef = (w / w.sum()).contiguous()
    dx, dW = vocab.ce_bwd(x, W, labels, lse_p, coef, vocab_size, eps)
    dx_p, dW_p = vocab.ce_bwd_plain(x, W, labels, lse_p, coef, vocab_size, eps)
    _assert_grad_close(dx, dx_p, "dx")
    _assert_grad_close(dW, dW_p, "dW")
    _assert_grad_close(dx[:4], dx_p[:4], "dx of the rows with a padding-row label")
    on_pad = labels[:4].long()
    torch.testing.assert_close(dW[on_pad], dW_p[on_pad], rtol=1e-6, atol=0)
    others = torch.ones(rows, dtype=torch.bool, device=dev)
    others[:vocab_size] = False
    others[on_pad] = False
    assert bool((dW[others] == 0).all())
    gathered = vocab.label_logits(x, W, labels)
    _, rank, _ = vocab.ce_rank(x, W, labels, gathered, vocab_size, smooth=eps > 0)
    _, rank_p, _ = vocab.ce_rank_plain(x, W, labels, gathered, vocab_size, eps > 0)
    assert int((rank.long() - rank_p.long()).abs().max()) <= 1


def test_an_empty_vocab_on_the_card(dev):
    x, W, _, _ = _inputs(70, 64, 512, 500, 22, dev)
    minus_one = torch.full((70,), -1, dtype=torch.int32, device=dev)
    zeros = torch.zeros(70, device=dev)
    lse, ll, _ = vocab.ce_fwd(x, W, minus_one, 0)
    assert bool((lse == -1e30).all()) and not bool(ll.any())
    lse3, rank, _ = vocab.ce_rank(x, W, minus_one, zeros, 0)
    assert bool((lse3 == -1e30).all()) and not bool(rank.any())
    assert not bool(vocab.rank_counts(x, W, zeros, minus_one, 0).any())
    dx, dW = vocab.ce_bwd(x, W, minus_one, zeros, torch.full((70,), 1 / 70, device=dev), 0)
    assert not bool(dx.any()) and not bool(dW.any())


# ---------------------------------------------------------------------- K4
@pytest.mark.parametrize("n,e,rows,vocab_size", [
    (1, 64, 1008, 1001),        # one row, a vocab bound inside a chunk
    (37, 16, 5000, 4999),       # N and V off every tile size
    (128, 64, 40_008, 40_001),  # the evaluation shape, narrower vocab
    (300, 256, 2056, 2050),     # widest E, three row tiles
    (130, 100, 704, 320),       # a shard's bound far below its rows
])
def test_rank_kernel_matches_plain(dev, n, e, rows, vocab_size):
    x, W, labels, ll = _inputs(n, e, rows, vocab_size, n + e, dev)
    labels[::3] = -1  # rows whose label another shard owns: nothing is left out
    before = vocab.rank_counts.launches
    cnt = vocab.rank_counts(x, W, ll, labels, vocab_size)
    torch.cuda.synchronize()
    assert vocab.rank_counts.launches == before + 1
    cnt_p = vocab.rank_counts_plain(x, W, ll, labels, vocab_size)
    assert cnt.dtype == torch.int32 and cnt.shape == (n,)
    assert int((cnt.long() - cnt_p.long()).abs().max()) <= 1
    assert torch.equal(cnt, vocab.rank_counts(x, W, ll, labels, vocab_size))


def test_fused_label_rank_on_the_card_gives_k3_ranks(dev):
    x, W, labels, ll = _inputs(128, 64, 40_008, 40_001, 9, dev)
    got = vocab.fused_label_rank(x, W, labels, vocab_size=40_001)
    _, want, _ = vocab.ce_rank(x, W, labels, ll, 40_001)
    assert int((got.long() - want.long()).abs().max()) <= 1
    assert float((got == want).float().mean()) >= 0.99


def test_rank_kernel_rejects_what_it_does_not_take(dev):
    x, W, labels, ll = _inputs(8, 64, 512, 500, 7, dev)
    with pytest.raises(TypeError):
        vocab.rank_counts(x, W, ll, labels.long(), 500)
    with pytest.raises(ValueError):
        vocab.rank_counts(x, W, ll, labels, 513)
    with pytest.raises(ValueError):
        vocab.rank_counts(x, W, ll.cpu(), labels, 500)


@pytest.mark.parametrize("table", ["f32", "bf16"])
@pytest.mark.parametrize("n,e,vocab_size", [
    (37, 64, 50),         # a vocab below one slot
    (77, 64, 16_955),     # V off the slot's rows; splits of uneven length
    (130, 4, 5_001),      # E off every k-step (bf16 rows of 8 bytes), two row tiles
    (200, 60, 33_001),    # bf16 rows of 120 bytes: the vocab's last 8 bytes by hand
    (129, 128, 20_001),   # N off the row tile
    (128, 256, 16_955),   # the widest narrow E: 32-row slots
])
def test_streamed_rank_kernel_matches_plain_at_its_edges(dev, n, e, vocab_size, table):
    """K4 where its streamed pass meets the shapes' edges, in both table
    forms, against the plain version, the same counts twice, with the
    plan's ring."""
    x, W, labels, ll = _inputs(n, e, vocab_size + 3, vocab_size, n + e + 2, dev)
    labels[::4] = -1
    if table == "bf16":
        W = W.to(torch.bfloat16)
        ll = vocab.label_logits(x, W, labels.clamp_min(0))
    lib = vocab._kernel_lib("rank")
    plan = vocab._stream_plan(lib, x, W, vocab_size)
    smem_of = lib.t4r_rank_smem_bf16 if table == "bf16" else lib.t4r_rank_smem
    assert plan.stages >= vocab.K3_MIN_STAGES and smem_of(e, plan.stages) == plan.smem
    assert (plan.splits > 1) == (vocab_size > vocab.K3_CHUNK)
    before = vocab.rank_counts.launches
    cnt = vocab.rank_counts(x, W, ll, labels, vocab_size)
    again = vocab.rank_counts(x, W, ll, labels, vocab_size)
    torch.cuda.synchronize()
    assert vocab.rank_counts.launches == before + 2
    assert cnt.dtype == torch.int32 and torch.equal(cnt, again)
    cnt_p = vocab.rank_counts_plain(x, W, ll, labels, vocab_size)
    assert int((cnt.long() - cnt_p.long()).abs().max()) <= 1


@pytest.mark.parametrize("table", ["f32", "bf16"])
def test_rank_kernel_gives_the_same_counts_twice_at_the_evaluation_shape(dev, table):
    x, W, labels, ll = _inputs(128, 64, 390_008, 390_001, 4, dev)
    if table == "bf16":
        W = W.to(torch.bfloat16)
        ll = vocab.label_logits(x, W, labels)
    first = vocab.rank_counts(x, W, ll, labels, 390_001)
    second = vocab.rank_counts(x, W, ll, labels, 390_001)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    cnt_p = vocab.rank_counts_plain(x, W, ll, labels, 390_001)
    assert int((first.long() - cnt_p.long()).abs().max()) <= 1
    assert float((first == cnt_p).float().mean()) >= 0.99


def test_rank_kernel_refuses_a_ring_the_plan_would_not_give(dev):
    x, W, labels, ll = _inputs(8, 64, 512, 500, 7, dev)
    lib = vocab._kernel_lib("rank")
    part, cnt = (torch.empty(8, dtype=torch.int32, device=dev) for _ in range(2))
    stream = torch.cuda.current_stream(dev).cuda_stream
    for stages, smem in ((2, lib.t4r_rank_smem(64, 2)), (4, lib.t4r_rank_smem(64, 4) + 16),
                         (40, lib.t4r_rank_smem(64, 40))):
        err = lib.t4r_rank(x.data_ptr(), W.data_ptr(), labels.data_ptr(), ll.data_ptr(), 8, 64,
                           500, 1, 8, stages, smem, part.data_ptr(), cnt.data_ptr(), stream)
        assert err != 0


@pytest.mark.parametrize("table", ["f32", "bf16"])
@pytest.mark.parametrize("e", [4, 64, 128, 256])
def test_the_rank_plan_is_sized_for_the_blocks_an_sm_holds(dev, e, table):
    """K4's plan at the evaluation shape: an SM holds at least its
    blocks_per_sm blocks of K4's pass at the plan's shared memory, and
    those blocks' rings hold the bytes the plan keeps in flight, in either
    table form."""
    dtype = torch.bfloat16 if table == "bf16" else torch.float32
    x = torch.empty(128, e, device=dev)
    W = torch.empty(1, e, dtype=dtype, device=dev).expand(390_008, e)
    lib = vocab._kernel_lib("rank")
    plan = vocab._stream_plan(lib, x, W, 390_001)
    assert lib.t4r_rank_blocks_per_sm(e, plan.smem, int(table == "bf16")) >= plan.blocks_per_sm
    assert vocab.K3_IN_FLIGHT <= plan.blocks_per_sm * plan.smem <= vocab.MAX_SMEM


@pytest.mark.parametrize("table", ["f32", "bf16"])
@pytest.mark.parametrize("e", [4, 64, 128, 256])
def test_the_ce_rank_plan_is_sized_for_the_blocks_an_sm_holds(dev, e, table):
    """K3's plan at the evaluation shape: an SM holds at least its
    blocks_per_sm blocks of K3's pass, with and without label smoothing, at
    the plan's shared memory, and those blocks' rings hold the bytes the
    plan keeps in flight, in either table form."""
    dtype = torch.bfloat16 if table == "bf16" else torch.float32
    x = torch.empty(128, e, device=dev)
    W = torch.empty(1, e, dtype=dtype, device=dev).expand(390_008, e)
    lib = vocab._kernel_lib("ce_rank")
    plan = vocab._stream_plan(lib, x, W, 390_001)
    assert lib.t4r_ce_rank_blocks_per_sm(e, plan.smem, int(table == "bf16")) >= plan.blocks_per_sm
    assert vocab.K3_IN_FLIGHT <= plan.blocks_per_sm * plan.smem <= vocab.MAX_SMEM


# ----------------------------------------------------------------- K7a / K7b
@pytest.mark.parametrize("rows,e,clip", [
    (4096, 64, 1.0),     # whole vectors
    (2051, 13, 1.0),     # a size off every vector width (numel mod 4 = 3)
    (2051, 13, None),    # no clip
    (40_008, 64, 1.0),   # more blocks than the grid holds at once
])
def test_adafactor_kernels_match_plain_over_three_steps(dev, rows, e, clip):
    rng = np.random.default_rng(rows + e)
    p0 = torch.from_numpy(rng.normal(0, 0.05, (rows, e)).astype(np.float32)).to(dev)
    p, v = p0.clone(), torch.zeros_like(p0)
    p_p, v_p = p0.clone(), torch.zeros_like(p0)
    for step, scale in enumerate((1e-2, 1.0, 30.0)):
        g = torch.from_numpy((rng.normal(0, 1, (rows, e)) * scale).astype(np.float32)).to(dev)
        decay = 1.0 - torch.full((), float(step + 1), device=dev) ** -0.8
        before_p = p_p.clone()
        a, b = fa.adafactor_pass_a.launches, fa.adafactor_pass_b.launches
        fa.adafactor_update(p, g, v, decay, 6.7e-4, clip, 1e-30)
        torch.cuda.synchronize()
        assert (fa.adafactor_pass_a.launches, fa.adafactor_pass_b.launches) == (a + 1, b + 1)
        fa.adafactor_update_plain(p_p, g, v_p, decay, 6.7e-4, clip, 1e-30)
        torch.testing.assert_close(v, v_p, rtol=1e-6, atol=0)
        update = float((p_p - before_p).abs().max())
        assert float((p - p_p).abs().max()) <= 1e-5 * update + 2.0 ** -23 * float(p_p.abs().max())
    assert float((p - p0).abs().max()) > 0


def test_adafactor_kernels_give_the_same_bits_twice(dev):
    rng = np.random.default_rng(5)
    p0 = torch.from_numpy(rng.normal(0, 0.05, (5003, 64)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(0, 3, (5003, 64)).astype(np.float32)).to(dev)
    v0 = torch.from_numpy(rng.random((5003, 64)).astype(np.float32)).to(dev)
    decay = torch.full((), 0.4, device=dev)
    runs = []
    for _ in range(2):
        p, v = p0.clone(), v0.clone()
        fa.adafactor_update(p, g, v, decay, 1e-3, 1.0, 1e-30)
        runs.append((p, v))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


def test_adafactor_kernels_reject_what_they_do_not_take(dev):
    p = torch.zeros(2048, 8, device=dev)
    decay = torch.full((), 0.5, device=dev)
    with pytest.raises(TypeError):
        fa.adafactor_update(p, p.clone(), p.clone().bfloat16(), decay, 1e-3)
    with pytest.raises(ValueError, match="contiguous"):
        fa.adafactor_update(p, torch.zeros(8, 2048, device=dev).T, p.clone(), decay, 1e-3)
    with pytest.raises(ValueError):
        fa.adafactor_update(p, p.clone().cpu(), p.clone(), decay, 1e-3)


def test_streamed_optimizer_step_on_the_card_matches_the_cpu(dev):
    """``FusedAdafactor(use_pallas=True)``: the kernels on the card against
    the plain version on the CPU, a non-contiguous gradient included."""
    rng = np.random.default_rng(6)
    p0 = rng.normal(0, 0.05, (2304, 64)).astype(np.float32)
    grads = [(rng.normal(0, 1, (64, 2304)) * s).astype(np.float32) for s in (1.0, 20.0)]
    results = []
    for device in (dev, torch.device("cpu")):
        p = torch.nn.Parameter(torch.from_numpy(p0.copy()).to(device))
        opt = fa.FusedAdafactor([p], lr=6.7e-4, use_pallas=True)
        for g in grads:
            p.grad = torch.from_numpy(g).to(device).T  # (2304, 64), not contiguous
            opt.step()
        results.append((p.detach().cpu(), opt.state[p]["v"].cpu()))
    (p_k, v_k), (p_c, v_c) = results
    torch.testing.assert_close(v_k, v_c, rtol=1e-6, atol=0)
    move = float((p_c - torch.from_numpy(p0)).abs().max())
    assert float((p_k - p_c).abs().max()) <= 1e-5 * move + 2.0 ** -23


# --------------------------------------------------------- K5 / K6a / K6b / K6c
FLASH_SHAPES = {
    # (B, S, H, Dh, causal, ragged, sessions wholly padded, bias planes)
    "one_tile": (2, 64, 2, 16, False, False, 0, None),
    "dh12_causal_ragged": (4, 256, 4, 12, True, True, 0, None),
    "off_the_tile_bias_1_H": (3, 333, 4, 32, False, True, 1, (1, 4)),
    "bias_B_1_causal": (2, 200, 2, 64, True, True, 0, (2, 1)),
    "bias_B_H": (2, 130, 3, 20, True, False, 0, (2, 3)),
    "bias_1_1_dh128": (2, 150, 2, 128, False, True, 0, (1, 1)),
    "long": (1, 1100, 2, 64, True, False, 0, None),
    # 64 tiles a side with the head dim padded from 12 to 16: the step at
    # S = 4,096, where the backward takes K6b and K6c
    "dh12_64_tiles": (1, 4096, 4, 12, True, True, 0, None),
    # each head dim of the two designs, causal with ragged padding and a
    # (1, H, S, S) bias, and plain
    "dh12_causal_ragged_bias_1_H": (3, 300, 4, 12, True, True, 1, (1, 4)),
    "dh12": (2, 256, 4, 12, False, False, 0, None),
    "dh64_causal_ragged_bias_1_H": (2, 333, 3, 64, True, True, 1, (1, 3)),
    "dh64": (2, 256, 2, 64, False, True, 0, None),
    "dh128_causal_ragged_bias_1_H": (2, 200, 2, 128, True, True, 0, (1, 2)),
    "dh128": (1, 384, 2, 128, False, False, 0, None),
    # a head's row of 72 bytes in bf16: 8-byte aligned, not 16 (wgmma design)
    "dh36_causal_ragged_bias_1_H": (2, 300, 3, 36, True, True, 1, (1, 3)),
}
# K5 and K6a in either design (wgmma: the Hopper kernels; the head dim is
# padded to 64 there, and K6a's takes head dims up to 64)
DESIGNS = {"mma_sync": False, "wgmma": True}


def _flash_inputs(shape, dev):
    B, S, H, Dh, causal, ragged, padded, planes = FLASH_SHAPES[shape]
    rng = np.random.default_rng(B * S + Dh)
    q, k, v, g = (torch.from_numpy(rng.normal(0, 1, (B, S, H, Dh)).astype(np.float32)).to(dev)
                  for _ in range(4))
    pad = None
    if ragged:
        lengths = rng.integers(2, S + 1, B)
        lengths[:padded] = 0
        pad = torch.from_numpy(np.arange(S)[None, :] < lengths[:, None]).to(dev)
    bias = None
    if planes is not None:
        bias = torch.from_numpy(rng.normal(0, 0.5, (*planes, S, S)).astype(np.float32)).to(dev)
    return q, k, v, g, bias, pad, causal


def _close_grad(got, want):
    err = (got - want).abs().max() / want.abs().max()
    return float(err) <= 2e-2 and float((got - want).norm() / want.norm()) <= 1e-3


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_forward_kernel_matches_plain(dev, shape, design):
    q, k, v, _, bias, pad, causal = _flash_inputs(shape, dev)
    before = attn.flash_fwd.launches
    out, lse = attn._flash_fwd_cuda(q, k, v, bias, pad, causal, wgmma=DESIGNS[design])
    again = attn._flash_fwd_cuda(q, k, v, bias, pad, causal, wgmma=DESIGNS[design])
    torch.cuda.synchronize()
    assert attn.flash_fwd.launches == before + 2
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    masked = _assert_forward_matches_plain(q, k, v, bias, pad, causal, out, lse)
    if FLASH_SHAPES[shape][6]:
        assert int(masked.sum()) >= q.shape[1] * q.shape[2]


def _assert_forward_matches_plain(q, k, v, bias, pad, causal, out, lse):
    """K5's output and lse against the plain version's; returns the mask of
    the rows with no valid key."""
    out_p, lse_p = attn.flash_forward_plain(q, k, v, bias, pad, causal)
    masked = lse_p == attn.LSE_MASKED
    assert float((out - out_p).abs().max()) <= 5e-3
    assert float((out - out_p).norm() / out_p.norm()) <= 1e-3
    assert torch.equal(lse[masked], lse_p[masked])
    assert float((lse - lse_p)[~masked].abs().max()) <= 1e-4
    B, S, H, _ = q.shape
    assert bool((out[masked.reshape(B, H, S).permute(0, 2, 1)] == 0).all())
    return masked


@pytest.mark.parametrize("shape,design", [
    (s, d) for s in FLASH_SHAPES for d in DESIGNS if d == "mma_sync" or FLASH_SHAPES[s][3] <= 64])
def test_flash_backward_kernels_match_plain(dev, shape, design):
    q, k, v, g, bias, pad, causal = _flash_inputs(shape, dev)
    out, lse = attn.flash_forward_plain(q, k, v, bias, pad, causal)
    delta = attn.row_delta(g, out)
    args = (q, k, v, g, lse, delta, bias, pad, causal)
    counts = (attn.flash_bwd_fused.launches, attn.flash_bwd_dq.launches,
              attn.flash_bwd_dkv.launches)
    fused = attn._flash_bwd_fused_cuda(*args, wgmma=DESIGNS[design])
    split = (attn.flash_bwd_dq(*args), *attn.flash_bwd_dkv(*args))
    again = (attn._flash_bwd_fused_cuda(*args, wgmma=DESIGNS[design])
             + (attn.flash_bwd_dq(*args), *attn.flash_bwd_dkv(*args)))
    # K6a's mma.sync design, held below to the same sums as K6b + K6c
    mma = attn._flash_bwd_fused_cuda(*args, wgmma=False) if DESIGNS[design] else fused
    torch.cuda.synchronize()
    assert (attn.flash_bwd_fused.launches, attn.flash_bwd_dq.launches,
            attn.flash_bwd_dkv.launches) == (counts[0] + 2 + (mma is not fused), counts[1] + 2,
                                             counts[2] + 2)
    assert all(torch.equal(a, b) for a, b in zip(fused + split, again))
    want_fused = attn.flash_backward_plain(q, k, v, bias, pad, causal, out, lse, g, True)
    want_split = attn.flash_backward_plain(q, k, v, bias, pad, causal, out, lse, g, False)
    for got, want in zip(fused + split, want_fused + want_split):
        assert torch.isfinite(got).all() and _close_grad(got, want)
    # K6a (mma.sync) against K6b + K6c: the same dk and dv, dq in another
    # order of sums
    assert float((mma[0] - split[0]).abs().max() / split[0].abs().max()) <= 1e-5
    for a, b in zip(mma[1:], split[1:]):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-6
    if attn.uses_split_stream(q.shape[3]):
        # K6c's mma.sync body, which the streamed design replaces here: the same sums
        old = attn._flash_bwd_dkv_cuda(*args, streamed=False)
        for a, b in zip(old, split[1:]):
            assert float((a - b).abs().max() / b.abs().max()) <= 1e-6


@pytest.mark.parametrize("shape", [s for s in FLASH_SHAPES
                                   if FLASH_SHAPES[s][3] <= attn.SPLIT_STREAM_MAX_DH])
def test_streamed_dq_gives_the_bits_of_the_mma_sync_body(dev, shape):
    """The streamed K6b against the mma.sync body it replaces at head dims
    up to 32: the same products, expressions and order of sums, so the same
    bits; skipped pairs are those whose P is exactly 0. Sessions wholly
    padded give dq = 0 exactly."""
    q, k, v, g, bias, pad, causal = _flash_inputs(shape, dev)
    out, lse = attn.flash_forward_plain(q, k, v, bias, pad, causal)
    args = (q, k, v, g, lse, attn.row_delta(g, out), bias, pad, causal)
    streamed = attn._flash_bwd_dq_cuda(*args, streamed=True)
    old = attn._flash_bwd_dq_cuda(*args, streamed=False)
    torch.cuda.synchronize()
    assert torch.equal(streamed, old)
    padded = FLASH_SHAPES[shape][6]
    if padded:
        assert bool((streamed[:padded] == 0).all())


def test_streamed_dkv_refuses_head_dims_above_32(dev):
    q = torch.zeros(1, 128, 2, 36, device=dev)
    rows = torch.zeros(2, 128, device=dev)
    with pytest.raises(RuntimeError):
        attn._flash_bwd_dkv_cuda(q, q, q, q, rows, rows, None, None, True, streamed=True)


def test_streamed_dq_refuses_head_dims_above_32(dev):
    q = torch.zeros(1, 128, 2, 36, device=dev)
    rows = torch.zeros(2, 128, device=dev)
    with pytest.raises(RuntimeError):
        attn._flash_bwd_dq_cuda(q, q, q, q, rows, rows, None, None, True, streamed=True)


def test_flash_attention_on_the_card_matches_the_cpu(dev):
    """Forward and gradients through the autograd function: the kernels on
    the card against the plain versions on the CPU, on both backward routes
    (the cap lowered for the second) and on the learned-bias route."""
    q, k, v, g, bias, pad, causal = _flash_inputs("bias_B_1_causal", dev)

    def run(device, bias_grad):
        leaves = [t.to(device).clone().requires_grad_() for t in (q, k, v, bias)]
        out = attn.flash_attention(*leaves, pad.to(device), causal, bias_grad=bias_grad)
        out.backward(g.to(device))
        return [out.detach().cpu()] + [None if t.grad is None else t.grad.cpu() for t in leaves]

    want = run("cpu", False)
    for cap in (attn.BWD_DQ_PARTIAL_MAX_BYTES, 1):
        old, attn.BWD_DQ_PARTIAL_MAX_BYTES = attn.BWD_DQ_PARTIAL_MAX_BYTES, cap
        try:
            got = run(dev, False)
        finally:
            attn.BWD_DQ_PARTIAL_MAX_BYTES = old
        assert float((got[0] - want[0]).abs().max()) <= 5e-3
        assert all(_close_grad(a, b) for a, b in zip(got[1:4], want[1:4]))
        assert got[4] is None and want[4] is None
    got, want = run(dev, True), run("cpu", True)
    assert all(_close_grad(a, b) for a, b in zip(got[1:], want[1:]))
    assert float(got[4].abs().max()) > 0


def _plm_bias(pad, H, seed):
    """XLNet-PLM's query-stream bias over batch and head: the port's PLM
    perm mask (a random factorisation order) on the first half of the
    sessions and every-position evaluation's causal one on the second (each
    session's first row and, past 64 items, whole 64 x 64 tiles blocked by
    the bias alone), plus a relative bias per head (normal, std 0.5)."""
    from transformers4rec_tpu_torch.blocks.transformer import make_extra_bias
    from transformers4rec_tpu_torch.masking import PermutationLanguageModeling

    B, S = pad.shape
    g = torch.Generator(device=pad.device).manual_seed(seed)
    plm = PermutationLanguageModeling(hidden_size=1, plm_probability=0.25, max_span_length=5,
                                      eval_on_last_item_seq_only=False)
    ids, half = pad.long(), B // 2
    perm = torch.cat([
        plm.compute_masked_targets(ids[:half], training=True, generator=g).perm_mask,
        plm.compute_masked_targets(ids[half:], testing=True).perm_mask])
    rel = torch.randn((1, H, S, S), generator=g, device=pad.device) * 0.5
    return (make_extra_bias(S, perm, None, query_stream=True) + rel).contiguous()


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("B,S,H,Dh", [(4, 256, 16, 12), (2, 384, 4, 32)])
def test_flash_forward_with_the_plm_bias_matches_plain(dev, B, S, H, Dh, design):
    """K5 with a (B, H, S, S) bias: rows that only the bias blocks give 0 and
    the sentinel lse, as the padding's do, and key tiles wholly blocked
    inside a session add nothing."""
    rng = np.random.default_rng(B * S + Dh)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (B, S, H, Dh)).astype(np.float32)).to(dev)
               for _ in range(3))
    lengths = rng.integers(2, S + 1, B)
    lengths[-1] = S
    pad = torch.from_numpy(np.arange(S)[None, :] < lengths[:, None]).to(dev)
    bias = _plm_bias(pad, H, B + S)
    blocked = (bias <= attn.NEG / 2) | ~pad[:, None, None, :]
    rows_blocked = blocked.all(-1) & pad[:, None, :]
    tiles = blocked[-1, :, :S // 64 * 64, :S // 64 * 64].reshape(H, S // 64, 64, S // 64, 64)
    assert int(rows_blocked.sum()) > 0 and bool(tiles.all(-1).all(-2).any())
    out, lse = attn._flash_fwd_cuda(q, k, v, bias, pad, False, wgmma=DESIGNS[design])
    again = attn._flash_fwd_cuda(q, k, v, bias, pad, False, wgmma=DESIGNS[design])
    torch.cuda.synchronize()
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    masked = _assert_forward_matches_plain(q, k, v, bias, pad, False, out, lse)
    assert bool(masked.reshape(B, H, S)[rows_blocked].all())


@pytest.mark.parametrize("n", [2560, 8192])  # every position of 128 x 20 and of 32 x 256
def test_ce_rank_kernel_at_the_every_position_rows(dev, n):
    """K3 at the rows of every-position evaluation over the flagship's
    table: lse within 1e-5 relative, ranks exact on 99% of the rows and
    within 2 on all (at this many rows a logit within an ulp of a label's
    falls on the other side more than once), the same bits twice."""
    x, W, labels, ll = _inputs(n, 64, 390_008, 390_001, n, dev)
    lse, rank, _ = vocab.ce_rank(x, W, labels, ll, 390_001)
    again = vocab.ce_rank(x, W, labels, ll, 390_001)
    torch.cuda.synchronize()
    assert torch.equal(lse, again[0]) and torch.equal(rank, again[1])
    lse_p, rank_p, _ = vocab.ce_rank_plain(x, W, labels, ll, 390_001, False)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=0)
    diff = (rank.long() - rank_p.long()).abs()
    assert float((diff == 0).float().mean()) >= 0.99 and int(diff.max()) <= 2


@pytest.mark.parametrize("n", [1280, 4096])  # packed evaluation: 128 x (20 // 2), 32 x (256 // 2)
def test_ce_rank_kernel_at_the_packed_evaluation_rows(dev, n):
    """K3 at the rows that packed evaluation ranks (at most S // 2 targets
    in a packed row), held as at the every-position rows."""
    x, W, labels, ll = _inputs(n, 64, 390_008, 390_001, n + 1, dev)
    lse, rank, _ = vocab.ce_rank(x, W, labels, ll, 390_001)
    again = vocab.ce_rank(x, W, labels, ll, 390_001)
    torch.cuda.synchronize()
    assert torch.equal(lse, again[0]) and torch.equal(rank, again[1])
    lse_p, rank_p, _ = vocab.ce_rank_plain(x, W, labels, ll, 390_001, False)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=0)
    diff = (rank.long() - rank_p.long()).abs()
    assert float((diff == 0).float().mean()) >= 0.99 and int(diff.max()) <= 2


def _segment_bias(B, S, seed, dev):
    """Rows of ``S`` packed from sessions of 2 to 20 items: the pad mask and
    the (B, 1, S, S) block-diagonal bias the encoder builds from their
    segment ids."""
    from transformers4rec_tpu_torch.blocks.transformer import make_extra_bias
    from transformers4rec_tpu_torch.data import pack_sessions

    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, 21, B * S // 8)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    seg = torch.from_numpy(pack_sessions(
        {"item_id__values": np.ones(offsets[-1], np.int64), "item_id__offsets": offsets},
        max_len=S, item_id_col="item_id", num_rows=B)["segment_ids"]).long().to(dev)
    return seg > 0, make_extra_bias(S, (seg[:, :, None] != seg[:, None, :]).float())


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Dh", [(4, 256, 16, 12), (2, 384, 4, 64)])
def test_flash_kernels_with_the_packed_segment_bias_match_plain(dev, B, S, H, Dh, causal,
                                                                  design):
    """K5 and K6a with packed rows' (B, 1, S, S) block-diagonal bias (key
    tiles wholly outside a query tile's segments add nothing), against their
    plain versions, with the same bits on a second call."""
    rng = np.random.default_rng(B * S + Dh + causal)
    q, k, v, g = (torch.from_numpy(rng.normal(0, 1, (B, S, H, Dh)).astype(np.float32)).to(dev)
                  for _ in range(4))
    pad, bias = _segment_bias(B, S, S + Dh, dev)
    assert bias.shape == (B, 1, S, S) and int((bias == 0).sum()) < B * S * S // 4
    wgmma = DESIGNS[design]
    out, lse = attn._flash_fwd_cuda(q, k, v, bias, pad, causal, wgmma=wgmma)
    again = attn._flash_fwd_cuda(q, k, v, bias, pad, causal, wgmma=wgmma)
    torch.cuda.synchronize()
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    _assert_forward_matches_plain(q, k, v, bias, pad, causal, out, lse)
    out_p, lse_p = attn.flash_forward_plain(q, k, v, bias, pad, causal)
    args = (q, k, v, g, lse_p, attn.row_delta(g, out_p), bias, pad, causal)
    fused = attn._flash_bwd_fused_cuda(*args, wgmma=wgmma)
    assert all(torch.equal(a, b)
               for a, b in zip(fused, attn._flash_bwd_fused_cuda(*args, wgmma=wgmma)))
    want = attn.flash_backward_plain(q, k, v, bias, pad, causal, out_p, lse_p, g, True)
    for got, w in zip(fused, want):
        assert torch.isfinite(got).all() and _close_grad(got, w)


@pytest.mark.parametrize("n,smooth", [(4, True), (128, False)])
def test_ce_rank_kernel_at_the_large_vocab_table(dev, n, smooth):
    """K3 over the 4,000,001-item table of the JAX benchmark's configuration
    4 (4,000,008 rows: about 264 vocab splits, row offsets up to 2.6e8
    values): lse within 1e-5 relative, ranks within 1 (2 with 128 rows, as
    at the every-position rows), zsum as above, the same bits twice."""
    vocab_size = 4_000_001
    rng = np.random.default_rng(n)
    W = torch.randn(4_000_008, 64, generator=torch.Generator().manual_seed(n)).mul_(0.05)
    labels = rng.integers(1, vocab_size, n).astype(np.int64)
    labels[0] = vocab_size - 1  # the last row of the vocab
    beta = torch.from_numpy(rng.uniform(0.0, 12.0, (n, 1)).astype(np.float32))
    x = beta * W[labels] + torch.from_numpy(rng.normal(0.0, 1.0, (n, 64)).astype(np.float32))
    x, W = x.to(dev), W.to(dev)
    labels = torch.from_numpy(labels.astype(np.int32)).to(dev)
    ll = vocab.label_logits(x, W, labels)
    lse, rank, zs = vocab.ce_rank(x, W, labels, ll, vocab_size, smooth=smooth)
    again = vocab.ce_rank(x, W, labels, ll, vocab_size, smooth=smooth)
    torch.cuda.synchronize()
    assert torch.equal(lse, again[0]) and torch.equal(rank, again[1])
    lse_p, rank_p, zs_p = vocab.ce_rank_plain(x, W, labels, ll, vocab_size, smooth)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=0)
    assert int((rank.long() - rank_p.long()).abs().max()) <= (1 if n < 100 else 2)
    if smooth:
        scale = zs_p.abs().clamp_min(math.sqrt(vocab_size))
        assert float(((zs - zs_p).abs() / scale).max()) <= 1e-5


@pytest.mark.parametrize("bad", ["dh_not_mult4", "dh_too_wide", "q_dtype", "strided_k",
                                 "bias_shape", "pad_dtype", "cpu_v", "lse_shape"])
def test_flash_kernels_reject_what_they_do_not_take(dev, bad):
    q = torch.zeros(2, 128, 2, 16, device=dev)
    k, v, g = q.clone(), q.clone(), q.clone()
    rows = torch.zeros(4, 128, device=dev)
    bias = pad = None
    if bad == "dh_not_mult4":
        q = k = v = g = torch.zeros(2, 128, 2, 14, device=dev)
    elif bad == "dh_too_wide":
        q = k = v = g = torch.zeros(2, 128, 2, 132, device=dev)
    elif bad == "q_dtype":
        q = q.half()
    elif bad == "strided_k":
        k = torch.zeros(2, 128, 2, 32, device=dev)[..., ::2]
    elif bad == "bias_shape":
        bias = torch.zeros(3, 2, 128, 128, device=dev)
    elif bad == "pad_dtype":
        pad = torch.ones(2, 128, device=dev)
    elif bad == "cpu_v":
        v = v.cpu()
    with pytest.raises((TypeError, ValueError)):
        if bad == "lse_shape":
            attn.flash_bwd_fused(q, k, v, g, rows[:, :64].contiguous(), rows, bias, pad)
        else:
            attn.flash_fwd(q, k, v, bias, pad)
            attn.flash_bwd_dq(q, k, v, g, rows, rows, bias, pad)


# ------------------------------------------------ the bf16 forms of K5 and K6
def _bf16_spacing(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (2^-7 of the power of two below)."""
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -120))) - 7)


def _close_bf16(got, want, atol, fro=1e-3):
    """bf16 ``got`` against the plain version's bf16 ``want``: within
    ``atol`` (a number, or ``"grad"``: 2e-2 of the peak) plus one bf16
    spacing of each value, and ``fro`` plus bf16's own rounding (2^-8) in
    relative Frobenius norm."""
    got, want = got.float(), want.float()
    if atol == "grad":
        atol = 2e-2 * float(want.abs().max())
    assert bool(((got - want).abs() <= atol + _bf16_spacing(want)).all())
    assert float((got - want).norm() / want.norm()) <= fro + 2.0 ** -8


def _bwd_designs(args, Dh):
    """Every design of K6a, K6b and K6c that takes head dim ``Dh``, run on
    ``args``: ``{name: (gradients)}``."""
    runs = {}
    for name, wgmma in DESIGNS.items():
        if not wgmma or Dh <= attn.WGMMA_MAX_DH:
            runs[f"fused_{name}"] = attn._flash_bwd_fused_cuda(*args, wgmma=wgmma)
    for streamed in (False, True) if Dh <= attn.SPLIT_STREAM_MAX_DH else (False,):
        runs[f"dq_streamed={streamed}"] = (attn._flash_bwd_dq_cuda(*args, streamed=streamed),)
        runs[f"dkv_streamed={streamed}"] = attn._flash_bwd_dkv_cuda(*args, streamed=streamed)
    return runs


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_forward_bf16_form_gives_the_f32_forms_bits(dev, shape, design):
    q, k, v, _, bias, pad, causal = _flash_inputs(shape, dev)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    before = attn.flash_fwd.launches
    out, lse = attn._flash_fwd_cuda(qb, kb, vb, bias, pad, causal, wgmma=DESIGNS[design])
    again = attn._flash_fwd_cuda(qb, kb, vb, bias, pad, causal, wgmma=DESIGNS[design])
    out32, lse32 = attn._flash_fwd_cuda(qb.float(), kb.float(), vb.float(), bias, pad, causal,
                                        wgmma=DESIGNS[design])
    torch.cuda.synchronize()
    assert attn.flash_fwd.launches == before + 3
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert torch.equal(out, out32.bfloat16()) and torch.equal(lse, lse32)
    out_p, lse_p = attn.flash_forward_plain(qb, kb, vb, bias, pad, causal)
    assert out_p.dtype == torch.bfloat16
    _close_bf16(out, out_p, 5e-3)
    masked = lse_p == attn.LSE_MASKED
    assert torch.equal(lse[masked], lse_p[masked])
    assert float((lse - lse_p)[~masked].abs().max()) <= 1e-4


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_backward_bf16_forms_give_the_f32_forms_bits(dev, shape):
    q, k, v, g, bias, pad, causal = _flash_inputs(shape, dev)
    qb, kb, vb, gb = (t.bfloat16() for t in (q, k, v, g))
    out_p, lse = attn.flash_forward_plain(qb, kb, vb, bias, pad, causal)
    delta = attn.row_delta(gb, out_p)
    args = (qb, kb, vb, gb, lse, delta, bias, pad, causal)
    Dh = q.shape[3]
    got = _bwd_designs(args, Dh)
    f32 = _bwd_designs((qb.float(), kb.float(), vb.float(), gb.float(), *args[4:]), Dh)
    torch.cuda.synchronize()
    want_fused = attn.flash_bwd_fused_plain(*args)
    want = {"fused": want_fused, "dq": want_fused[:1],
            "dkv": attn.flash_bwd_dkv_plain(*args)}
    for name, grads in got.items():
        assert all(t.dtype == torch.bfloat16 for t in grads), name
        assert all(torch.equal(a, b.bfloat16()) for a, b in zip(grads, f32[name])), name
        for a, b in zip(grads, want[name.split("_")[0]]):
            assert torch.isfinite(a.float()).all()
            _close_bf16(a, b, "grad")


def test_flash_bf16_forms_at_an_8_byte_aligned_start(dev):
    """bf16 tensors that start 8 bytes past a 16-byte boundary (a view into
    a larger buffer), at head dim 36 (a head's row is 72 bytes): each form
    gives what it gives on an aligned copy."""
    B, S, H, Dh = 2, 200, 3, 36
    n = B * S * H * Dh
    gen = torch.Generator(device=dev).manual_seed(7)
    bufs = [torch.randn(n + 4, generator=gen, device=dev).bfloat16() for _ in range(4)]
    q, k, v, g = (b[4:].view(B, S, H, Dh) for b in bufs)
    assert q.data_ptr() % 16 == 8
    pad = torch.ones(B, S, dtype=torch.bool, device=dev)
    pad[1, 150:] = False
    for wgmma in (False, True):
        out, lse = attn._flash_fwd_cuda(q, k, v, None, pad, True, wgmma=wgmma)
        want = attn._flash_fwd_cuda(*(t.clone() for t in (q, k, v)), None, pad, True,
                                    wgmma=wgmma)
        assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
        args = (q, k, v, g, lse, attn.row_delta(g, out), None, pad, True)
        copies = (*(t.clone() for t in (q, k, v, g)), *args[4:])
        for a, b in zip(attn._flash_bwd_fused_cuda(*args, wgmma=wgmma),
                        attn._flash_bwd_fused_cuda(*copies, wgmma=wgmma)):
            assert torch.equal(a, b)
    for a, b in zip((attn._flash_bwd_dq_cuda(*args), *attn._flash_bwd_dkv_cuda(*args)),
                    (attn._flash_bwd_dq_cuda(*copies), *attn._flash_bwd_dkv_cuda(*copies))):
        assert torch.equal(a, b)


def _f16_spacing(x: torch.Tensor) -> torch.Tensor:
    """The spacing of f16 values at |x| (2^-10 of the power of two below;
    2^-24 below the smallest normal)."""
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -14))) - 10)


def _close_f16(got, want, atol, fro=1e-3):
    """f16 ``got`` against the plain version's f16 ``want``, as
    ``_close_bf16`` holds bf16 (f16's own rounding 2^-11)."""
    got, want = got.float(), want.float()
    if atol == "grad":
        atol = 2e-2 * float(want.abs().max())
    assert bool(((got - want).abs() <= atol + _f16_spacing(want)).all())
    assert float((got - want).norm() / want.norm()) <= fro + 2.0 ** -11


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_forward_f16_form_gives_the_f32_forms_bits(dev, shape, design):
    q, k, v, _, bias, pad, causal = _flash_inputs(shape, dev)
    qh, kh, vh = (t.half() for t in (q, k, v))
    before = attn.flash_fwd.f16_launches
    out, lse = attn._flash_fwd_cuda(qh, kh, vh, bias, pad, causal, wgmma=DESIGNS[design])
    again = attn._flash_fwd_cuda(qh, kh, vh, bias, pad, causal, wgmma=DESIGNS[design])
    out32, lse32 = attn._flash_fwd_cuda(qh.float(), kh.float(), vh.float(), bias, pad, causal,
                                        wgmma=DESIGNS[design])
    torch.cuda.synchronize()
    assert attn.flash_fwd.f16_launches == before + 2
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert torch.equal(out, out32.half()) and torch.equal(lse, lse32)
    out_p, lse_p = attn.flash_forward_plain(qh, kh, vh, bias, pad, causal)
    assert out_p.dtype == torch.float16
    _close_f16(out, out_p, 5e-3)
    masked = lse_p == attn.LSE_MASKED
    assert torch.equal(lse[masked], lse_p[masked])
    assert float((lse - lse_p)[~masked].abs().max()) <= 1e-4


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_backward_f16_forms_give_the_f32_forms_bits(dev, shape):
    q, k, v, g, bias, pad, causal = _flash_inputs(shape, dev)
    qh, kh, vh, gh = (t.half() for t in (q, k, v, g))
    out_p, lse = attn.flash_forward_plain(qh, kh, vh, bias, pad, causal)
    delta = attn.row_delta(gh, out_p)
    args = (qh, kh, vh, gh, lse, delta, bias, pad, causal)
    Dh = q.shape[3]
    got = _bwd_designs(args, Dh)
    f32 = _bwd_designs((qh.float(), kh.float(), vh.float(), gh.float(), *args[4:]), Dh)
    torch.cuda.synchronize()
    want_fused = attn.flash_bwd_fused_plain(*args)
    want = {"fused": want_fused, "dq": want_fused[:1],
            "dkv": attn.flash_bwd_dkv_plain(*args)}
    for name, grads in got.items():
        assert all(t.dtype == torch.float16 for t in grads), name
        assert all(torch.equal(a, b.half()) for a, b in zip(grads, f32[name])), name
        for a, b in zip(grads, want[name.split("_")[0]]):
            assert torch.isfinite(a.float()).all()
            _close_f16(a, b, "grad")


def test_flash_attention_bf16_on_the_card_matches_the_cpu(dev):
    """bf16 q, k, v through the autograd function: output and gradients in
    bf16, the kernels against the plain versions on the CPU, on both backward
    routes and on the learned-bias route (reference_attention with the
    probabilities rounded to bf16)."""
    q, k, v, g, bias, pad, causal = _flash_inputs("bias_B_1_causal", dev)
    q, k, v, g = (t.bfloat16() for t in (q, k, v, g))

    def run(device, bias_grad):
        leaves = [t.to(device).clone().requires_grad_() for t in (q, k, v, bias)]
        out = attn.flash_attention(*leaves, pad.to(device), causal, bias_grad=bias_grad)
        out.backward(g.to(device))
        return [out.detach().cpu()] + [None if t.grad is None else t.grad.cpu() for t in leaves]

    want = run("cpu", False)
    for cap in (attn.BWD_DQ_PARTIAL_MAX_BYTES, 1):
        old, attn.BWD_DQ_PARTIAL_MAX_BYTES = attn.BWD_DQ_PARTIAL_MAX_BYTES, cap
        try:
            got = run(dev, False)
        finally:
            attn.BWD_DQ_PARTIAL_MAX_BYTES = old
        assert all(t.dtype == torch.bfloat16 for t in got[:4])
        _close_bf16(got[0], want[0], 5e-3)
        for a, b in zip(got[1:4], want[1:4]):
            _close_bf16(a, b, "grad")
        assert got[4] is None and want[4] is None
    got, want = run(dev, True), run("cpu", True)
    assert got[1].dtype == torch.bfloat16 and got[4].dtype == torch.float32
    for a, b in zip(got[1:], want[1:]):
        _close_bf16(a, b, "grad")


@pytest.mark.parametrize("bad", ["mixed_k", "f16", "f64", "bias_bf16", "lse_bf16"])
def test_flash_kernels_take_no_other_type(dev, bad):
    """A tensor of a type the kernels do not take raises on the card: it is
    not converted. ``f16``: f16 q with bf16 k and v (the kernels have an
    f16 form since float16 became a compute type, but one type for all
    four); ``f64``: a type with no form."""
    q = torch.zeros(2, 128, 2, 16, device=dev, dtype=torch.bfloat16)
    k, v, g = q.clone(), q.clone(), q.clone()
    rows = torch.zeros(4, 128, device=dev)
    bias = None
    if bad == "mixed_k":
        k = k.float()
    elif bad == "f16":
        q = q.half()
    elif bad == "f64":
        q, k, v, g = (t.double() for t in (q, k, v, g))
    elif bad == "bias_bf16":
        bias = torch.zeros(1, 1, 128, 128, device=dev, dtype=torch.bfloat16)
    elif bad == "lse_bf16":
        rows = rows.bfloat16()
    with pytest.raises(TypeError):
        if bad == "lse_bf16":
            attn.flash_bwd_fused(q, k, v, g, rows, rows)
        else:
            attn.flash_fwd(q, k, v, bias)


# -------------------------------------------------- wide item tables (E > 256)
# 192 trains through K2's wide passes and evaluates on the narrow K1, K3 and
# K4; 448 is the paper's tied width; 512 the widest resident x tile; 1,000 is
# off every slab and too wide for a resident x tile
WIDE_E = [192, 448, 512, 1000]


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("e", WIDE_E)
def test_wide_tables_k1_k2_k3_k4_match_plain(dev, e, smooth):
    """K1, K2, K3 and K4 against their plain versions at a width the narrow
    kernels do not hold whole, with the tolerances of the narrow ones, and the
    same bits from a second call of each."""
    n, rows, vocab_size = 300, 3000, 2999
    eps = 0.1 if smooth else 0.0
    x, W, labels, w = _ce_inputs(n, e, rows, vocab_size, e + int(smooth), dev)
    lse, ll, zs = vocab.ce_fwd(x, W, labels, vocab_size, smooth=smooth)
    lse_p, ll_p, zs_p = vocab.ce_fwd_plain(x, W, labels, vocab_size, smooth)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(ll, ll_p, rtol=1e-5, atol=1e-6)
    if smooth:
        scale = zs_p.abs().clamp_min(math.sqrt(vocab_size))
        assert float(((zs - zs_p).abs() / scale).max()) <= 1e-5
    coef = (w / w.sum()).contiguous()
    dx, dW = vocab.ce_bwd(x, W, labels, lse_p, coef, vocab_size, eps)
    dx_p, dW_p = vocab.ce_bwd_plain(x, W, labels, lse_p, coef, vocab_size, eps)
    _assert_grad_close(dx, dx_p, "dx")
    _assert_grad_close(dW, dW_p, "dW")
    assert bool((dW[vocab_size:] == 0).all()) and bool((dx[w == 0] == 0).all())
    gathered = vocab.label_logits(x, W, labels)
    lse3, rank, zs3 = vocab.ce_rank(x, W, labels, gathered, vocab_size, smooth=smooth)
    lse3_p, rank_p, zs3_p = vocab.ce_rank_plain(x, W, labels, gathered, vocab_size, smooth)
    torch.testing.assert_close(lse3, lse3_p, rtol=1e-5, atol=0)
    assert int((rank.long() - rank_p.long()).abs().max()) <= 1
    if smooth:
        assert float(((zs3 - zs3_p).abs() / scale).max()) <= 1e-5
    cnt = vocab.rank_counts(x, W, gathered, labels, vocab_size)
    cnt_p = vocab.rank_counts_plain(x, W, gathered, labels, vocab_size)
    assert int((cnt.long() - cnt_p.long()).abs().max()) <= 1
    again = (*vocab.ce_fwd(x, W, labels, vocab_size, smooth=smooth),
             *vocab.ce_bwd(x, W, labels, lse_p, coef, vocab_size, eps),
             *vocab.ce_rank(x, W, labels, gathered, vocab_size, smooth=smooth),
             vocab.rank_counts(x, W, gathered, labels, vocab_size))
    first = (lse, ll, zs, dx, dW, lse3, rank, zs3, cnt)
    for a, b in zip(first, again):
        assert (a is None and b is None) or torch.equal(a, b)


def test_wide_table_on_two_shards_matches_the_whole_table(dev):
    """The paper's width cut into two shards of one process: K1, K2 and K4
    per shard with ``eps_over_v``, merged, against the unsharded kernels."""
    from transformers4rec_tpu_torch.parallel import (
        shard_table, sharded_ce_and_rank, sharded_softmax_ce)

    n, rows, vocab_size, e, eps = 300, 4000, 3993, 448, 0.1
    x, W, labels, w = _ce_inputs(n, e, rows, vocab_size, 24, dev)
    labels = torch.where(labels < 0, torch.ones_like(labels), labels)
    xs = x.clone().requires_grad_()
    shards = [shard_table(W, i, 2).clone().requires_grad_() for i in range(2)]
    loss = sharded_softmax_ce(xs, shards, labels, w, None, vocab_size=vocab_size,
                              label_smoothing=eps)
    loss.backward()
    eval_loss, ranks = sharded_ce_and_rank(x, [t.detach() for t in shards], labels, w, None,
                                           vocab_size=vocab_size, label_smoothing=eps)
    xu, Wu = x.clone().requires_grad_(), W.clone().requires_grad_()
    want = vocab.fused_softmax_ce(xu, Wu, labels, w, vocab_size=vocab_size, label_smoothing=eps)
    want.backward()
    want_eval, want_ranks = vocab.fused_ce_and_rank(x, W, labels, w, vocab_size=vocab_size,
                                                    label_smoothing=eps)
    torch.testing.assert_close(loss.detach(), want.detach(), rtol=1e-5, atol=0)
    torch.testing.assert_close(eval_loss, want_eval, rtol=1e-5, atol=0)
    _assert_grad_close(xs.grad, xu.grad, "dx")
    _assert_grad_close(torch.cat([t.grad for t in shards]), Wu.grad, "dW")
    assert int((ranks.long() - want_ranks.long()).abs().max()) <= 1


# ------------------------------------------------------- bf16-stored tables
# A bf16 table is copied into K1's and K2's images as it is and read as it
# is by K3's ring and K4's loads: every product sees the bits the f32
# kernels see on the same values held as f32 (``W.float()``), so K1, K2's
# dx and K4 give those kernels' bits, K2's dW is their f32 sum rounded once
# to bf16 (nearest even, as ``Tensor.to``), and K3 its ranks exactly (its
# ring and so its splits may differ: lse and zsum within 1e-6). Against the
# plain versions the f32 tolerances hold, plus one bf16 rounding of dW.
BF16_SHAPES = [
    (915, 64, 40_008, 40_001, 0.0),  # the training shape, a narrower vocab
    (37, 4, 1003, 999, 0.1),         # E = 4: 8 bytes a row, an odd vocab (K3's tail copy)
    (193, 20, 3000, 2990, 0.0),      # E off the k-step of 16 and off 8
    (130, 132, 3000, 2999, 0.1),     # E = 132: K2 wide, K3's narrow ring with a tail copy
    (200, 192, 3000, 2999, 0.0),     # the flagship's d_model as the table width
    (300, 448, 3000, 2999, 0.1),     # the paper's width: every kernel wide
]


def _bf16_ulp(t):
    """The spacing of bf16 values at |t| (8 significant bits)."""
    e = torch.frexp(t.float().abs().clamp_min(2.0 ** -126)).exponent
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("n,e,rows,vocab_size,eps", BF16_SHAPES)
def test_bf16_tables_give_the_bits_of_the_f32_kernels_and_match_plain(dev, n, e, rows,
                                                                       vocab_size, eps):
    x, W, labels, w = _ce_inputs(n, e, rows, vocab_size, n + e + 3, dev)
    labels[:3] = torch.tensor([vocab_size, rows - 1, 1], dtype=torch.int32, device=dev)
    w[:3] = 1.0  # two labels on padding rows, weighted
    Wb = W.to(torch.bfloat16)
    Wf = Wb.float()
    smooth = eps > 0
    launches = (vocab.ce_fwd.launches, vocab.ce_bwd.launches, vocab.ce_rank.launches,
                vocab.rank_counts.launches)
    fwd = vocab.ce_fwd(x, Wb, labels, vocab_size, smooth=smooth)
    fwd_f = vocab.ce_fwd(x, Wf, labels, vocab_size, smooth=smooth)
    for a, b in zip(fwd, fwd_f):
        assert (a is None and b is None) or torch.equal(a, b)
    lse_p, ll_p, zs_p = vocab.ce_fwd_plain(x, Wb, labels, vocab_size, smooth)
    torch.testing.assert_close(fwd[0], lse_p, rtol=1e-5, atol=0)
    assert bool((fwd[1][:2] == -1e30).all())
    torch.testing.assert_close(fwd[1][2:], ll_p[2:], rtol=1e-5, atol=1e-6)
    coef = (w / w.sum()).contiguous()
    dx, dW = vocab.ce_bwd(x, Wb, labels, lse_p, coef, vocab_size, eps)
    dx_f, dW_f = vocab.ce_bwd(x, Wf, labels, lse_p, coef, vocab_size, eps)
    assert dW.dtype == torch.bfloat16 and dW.shape == Wb.shape
    assert torch.equal(dx, dx_f) and torch.equal(dW, dW_f.to(torch.bfloat16))
    dx_p, dW_p = vocab.ce_bwd_plain(x, Wb, labels, lse_p, coef, vocab_size, eps)
    dx_pf, dW_pf = vocab.ce_bwd_plain(x, Wf, labels, lse_p, coef, vocab_size, eps)
    assert dW_p.dtype == torch.bfloat16 and torch.equal(dW_p, dW_pf.to(torch.bfloat16))
    assert torch.equal(dx_p, dx_pf)
    _assert_grad_close(dx, dx_p, "dx")
    _assert_grad_close(dW_f, dW_pf, "dW before its rounding")
    assert float((dW.float() - dW_p.float()).norm() / dW_p.float().norm()) <= 1e-3 + 2.0 ** -8
    gathered = vocab.label_logits(x, Wb, labels)
    torch.testing.assert_close(gathered, vocab.label_logits(x, Wf, labels), rtol=0, atol=0)
    lse3, rank, zs3 = vocab.ce_rank(x, Wb, labels, gathered, vocab_size, smooth=smooth)
    lse3_f, rank_f, zs3_f = vocab.ce_rank(x, Wf, labels, gathered, vocab_size, smooth=smooth)
    assert torch.equal(rank, rank_f)
    torch.testing.assert_close(lse3, lse3_f, rtol=1e-6, atol=0)
    lse3_p, rank_p, zs3_p = vocab.ce_rank_plain(x, Wb, labels, gathered, vocab_size, smooth)
    torch.testing.assert_close(lse3, lse3_p, rtol=1e-5, atol=0)
    assert int((rank.long() - rank_p.long()).abs().max()) <= 1
    if smooth:
        scale = zs3_p.abs().clamp_min(math.sqrt(vocab_size))
        assert float(((zs3 - zs3_p).abs() / scale).max()) <= 1e-5
        assert float(((zs3 - zs3_f).abs() / scale).max()) <= 1e-6
    cnt = vocab.rank_counts(x, Wb, gathered, labels, vocab_size)
    assert torch.equal(cnt, vocab.rank_counts(x, Wf, gathered, labels, vocab_size))
    cnt_p = vocab.rank_counts_plain(x, Wb, gathered, labels, vocab_size)
    assert int((cnt.long() - cnt_p.long()).abs().max()) <= 1
    torch.cuda.synchronize()
    after = (vocab.ce_fwd.launches, vocab.ce_bwd.launches, vocab.ce_rank.launches,
             vocab.rank_counts.launches)
    assert after == tuple(c + 2 for c in launches)


@pytest.mark.parametrize("e", [4, 20, 64, 132, 256])
def test_the_bf16_ring_is_what_the_plan_gives(dev, e):
    """K3's ring on a bf16 table: the C formula of its shared memory is the
    plan's, about twice the f32 ring's slots fit (at least as many)."""
    lib = vocab._kernel_lib("ce_rank")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = vocab.ce_plan(128, e, 390_001, 390_008, sms, False, vocab.K3_CHUNK, streamed=True,
                         table_bf16=True)
    f32 = vocab.ce_plan(128, e, 390_001, 390_008, sms, False, vocab.K3_CHUNK, streamed=True)
    assert lib.t4r_ce_rank_smem_bf16(e, plan.stages) == plan.smem <= vocab.MAX_SMEM
    assert plan.stages >= f32.stages and plan.stages * plan.blocks_per_sm >= vocab.K3_MIN_STAGES


def test_an_empty_vocab_on_a_bf16_table(dev):
    x, W, _, _ = _inputs(70, 64, 512, 500, 22, dev)
    Wb = W.to(torch.bfloat16)
    minus_one = torch.full((70,), -1, dtype=torch.int32, device=dev)
    zeros = torch.zeros(70, device=dev)
    lse, ll, _ = vocab.ce_fwd(x, Wb, minus_one, 0)
    assert bool((lse == -1e30).all()) and not bool(ll.any())
    lse3, rank, _ = vocab.ce_rank(x, Wb, minus_one, zeros, 0)
    assert bool((lse3 == -1e30).all()) and not bool(rank.any())
    assert not bool(vocab.rank_counts(x, Wb, zeros, minus_one, 0).any())
    dx, dW = vocab.ce_bwd(x, Wb, minus_one, zeros, torch.full((70,), 1 / 70, device=dev), 0)
    assert dW.dtype == torch.bfloat16 and not bool(dx.any()) and not bool(dW.any())


def test_kernels_on_a_bf16_table_allocate_no_f32_copy_of_it(dev):
    """K1, K3, K4 and K7 on the flagship's bf16 table: the call's peak
    memory grows by less than one f32 copy of the table (Vp·E·4 bytes)."""
    rows, e, V = 390_008, 64, 390_001
    x, W, labels, ll = _inputs(128, e, rows, V, 31, dev)
    Wb = W.to(torch.bfloat16)
    del W
    g = (torch.randn(rows, e, device=dev) * 1e-3).to(torch.bfloat16)
    v = torch.zeros_like(Wb)
    decay = torch.full((), 0.5, device=dev)
    f32_copy = rows * e * 4
    calls = {
        "ce_fwd": lambda: vocab.ce_fwd(x, Wb, labels, V),
        "ce_rank": lambda: vocab.ce_rank(x, Wb, labels, ll, V),
        "rank_counts": lambda: vocab.rank_counts(x, Wb, ll, labels, V),
        "adafactor": lambda: fa.adafactor_update(Wb, g, v, decay, 1e-3),
    }
    for name, call in calls.items():
        call()  # built and warm
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = call()
        torch.cuda.synchronize()
        grown = torch.cuda.max_memory_allocated(dev) - base
        del out
        assert grown < f32_copy, (name, grown)


def _bf16_close(got, want, what, slack=None):
    """Within one bf16 spacing of ``want`` (plus ``slack`` per element)."""
    tol = _bf16_ulp(want) + (0.0 if slack is None else slack)
    assert bool(((got.float() - want.float()).abs() <= tol).all()), what


@pytest.mark.parametrize("rows,e,clip", [(4096, 64, 1.0), (2051, 13, 1.0), (40_008, 64, None)])
def test_adafactor_kernels_on_bf16_match_plain_over_three_steps(dev, rows, e, clip):
    """K7a and K7b on bf16 g, v and p against the plain passes on the same
    bf16 tensors. The kernels' rsqrt is approximate (2 f32 ulps) and their
    clip sum in another order: the moment within one bf16 spacing, the
    parameter within one spacing of itself and of its update."""
    rng = np.random.default_rng(rows + e)
    p0 = torch.from_numpy(rng.normal(0, 0.05, (rows, e)).astype(np.float32)).to(dev)
    p, v = p0.to(torch.bfloat16), torch.zeros(rows, e, dtype=torch.bfloat16, device=dev)
    p_p, v_p = p.clone(), v.clone()
    for step, scale in enumerate((1e-2, 1.0, 30.0)):
        g = torch.from_numpy((rng.normal(0, 1, (rows, e)) * scale).astype(np.float32))
        g = g.to(dev).to(torch.bfloat16)
        decay = 1.0 - torch.full((), float(step + 1), device=dev) ** -0.8
        before = p_p.clone()
        coef = fa.adafactor_pass_a(g, v, decay, 6.7e-4, clip, 1e-30)
        coef_p = fa.adafactor_pass_a_plain(g, v_p, decay, 6.7e-4, clip, 1e-30)
        torch.testing.assert_close(coef, coef_p, rtol=1e-5, atol=0)
        _bf16_close(v, v_p, "v")
        fa.adafactor_pass_b(p, g, v_p, coef_p)  # the same moment and coefficient
        fa.adafactor_pass_b_plain(p_p, g, v_p, coef_p)
        torch.cuda.synchronize()
        assert p.dtype == torch.bfloat16 and v.dtype == torch.bfloat16
        _bf16_close(p, p_p, "p", slack=_bf16_ulp(p_p - before))
        v.copy_(v_p)
    assert float((p_p.float() - p0.to(torch.bfloat16).float()).abs().max()) > 0


def test_streamed_optimizer_step_on_a_bf16_table_on_the_card_matches_the_cpu(dev):
    """``FusedAdafactor(use_pallas=True)`` on a bf16 parameter: K7a/K7b on
    the card against the plain passes on the CPU, two steps."""
    rng = np.random.default_rng(16)
    p0 = torch.from_numpy(rng.normal(0, 0.05, (2304, 64)).astype(np.float32)).to(torch.bfloat16)
    grads = [torch.from_numpy((rng.normal(0, 1, (2304, 64)) * s).astype(np.float32))
             .to(torch.bfloat16) for s in (1.0, 20.0)]
    results = []
    for device in (dev, torch.device("cpu")):
        p = torch.nn.Parameter(p0.clone().to(device))
        opt = fa.FusedAdafactor([p], lr=6.7e-4, use_pallas=True)
        a = fa.adafactor_pass_a.launches
        for g in grads:
            p.grad = g.to(device)
            opt.step()
        assert opt.state[p]["v"].dtype == torch.bfloat16
        if device.type == "cuda":
            assert fa.adafactor_pass_a.launches == a + 2
        results.append((p.detach().cpu(), opt.state[p]["v"].cpu()))
    (p_k, v_k), (p_c, v_c) = results
    assert p_k.dtype == torch.bfloat16
    _bf16_close(v_k, v_c, "v")
    move = (p_c.float() - p0.float()).abs()
    _bf16_close(p_k, p_c, "p", slack=2 * _bf16_ulp(move))


def test_kernels_refuse_a_table_of_another_type(dev):
    x, W, labels, ll = _inputs(8, 64, 512, 500, 7, dev)
    for bad in (W.half(), W.double()):
        with pytest.raises(TypeError):
            vocab.ce_fwd(x, bad, labels, 500)
        with pytest.raises(TypeError):
            vocab.ce_rank(x, bad, labels, ll, 500)
        with pytest.raises(TypeError):
            vocab.rank_counts(x, bad, ll, labels, 500)
    pb = torch.zeros(2048, 8, dtype=torch.bfloat16, device=dev)
    decay = torch.full((), 0.5, device=dev)
    with pytest.raises(TypeError):  # a bf16 table with an f32 gradient
        fa.adafactor_update(pb, pb.float(), pb.clone(), decay, 1e-3)
    with pytest.raises(TypeError):
        fa.adafactor_update(pb.half(), pb.half(), pb.half(), decay, 1e-3)


def test_the_sparse_rows_update_of_a_bf16_table_on_the_card_matches_the_cpu(dev):
    """``index_add_`` on a bf16 table with the padding slots' ``-0.0`` on row
    V − 1: untouched rows keep their bits, touched rows within one bf16
    spacing of the CPU's and one of their movement (the f32 step's last bits
    may differ: the card's ``pow``, ``sqrt`` and atomic sums against the
    CPU's)."""
    from transformers4rec_tpu_torch.ops.sparse_update import (
        sparse_rows_adafactor_init, sparse_rows_adafactor_update, sparse_rows_adam_init,
        sparse_rows_adam_update)

    rng = np.random.default_rng(17)
    V, E = 5000, 64
    table0 = torch.from_numpy(rng.normal(0, 0.05, (V, E)).astype(np.float32)).to(torch.bfloat16)
    ids = torch.from_numpy(rng.integers(1, V - 1, 700)).long()
    ids[:50] = ids[50:100]  # repeated ids
    # f32 row gradients, as the sparse step's buffer holds them: their sums over
    # repeated ids may differ in the last f32 bits (the card's atomics)
    grads = torch.from_numpy(rng.normal(0, 1e-2, (700, E)).astype(np.float32))
    for init, update in ((sparse_rows_adam_init, sparse_rows_adam_update),
                         (sparse_rows_adafactor_init, sparse_rows_adafactor_update)):
        out = []
        for device in (dev, torch.device("cpu")):
            table = table0.clone().to(device)
            state = init(table, moment_dtype=torch.bfloat16)
            for _ in range(2):
                update(table, state, ids.to(device), grads.to(device), 1e-2)
            out.append(table.cpu())
        touched = torch.zeros(V, dtype=torch.bool)
        touched[ids] = True
        assert out[0].dtype == torch.bfloat16
        assert torch.equal(out[0][~touched], table0[~touched])  # row V - 1 included
        _bf16_close(out[0][touched], out[1][touched], update.__name__,
                    slack=_bf16_ulp(out[1][touched].float() - table0[touched].float()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["dh12_causal_ragged", "off_the_tile_bias_1_H",
                                   "bias_B_1_causal"])
def test_the_registered_op_gives_the_direct_kernels_bits(dev, shape, dtype):
    """``t4r::flash_fwd`` on CUDA tensors launches K5 (one count a call) and
    gives ``_flash_fwd_cuda``'s bits; its fake gives the output's and lse's
    shapes and types without a launch."""
    q, k, v, _, bias, pad, causal = _flash_inputs(shape, dev)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    before = attn.flash_fwd.launches
    out, lse = torch.ops.t4r.flash_fwd(q, k, v, bias, pad, causal)
    want_out, want_lse = attn._flash_fwd_cuda(q, k, v, bias, pad, causal)
    torch.cuda.synchronize()
    assert attn.flash_fwd.launches == before + 2
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(t) if t is not None else None for t in (q, k, v, bias, pad)]
        f_out, f_lse = torch.ops.t4r.flash_fwd(*fake, causal)
    B, S, H, _ = q.shape
    assert (f_out.shape, f_out.dtype, f_out.device) == (q.shape, dtype, q.device)
    assert (f_lse.shape, f_lse.dtype) == ((B * H, S), torch.float32)
    assert attn.flash_fwd.launches == before + 2
