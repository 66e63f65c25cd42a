"""The port's training cross-entropy (K1 forward, K2 backward) against the
JAX package on the CPU.

Same inputs, made with numpy from a seed, go through the JAX
``fused_softmax_ce`` on its scan branch (``use_pallas=False``: how the JAX
tests run it on the CPU, since the CE ``pallas_call``s take no interpret
flag) and through the port's, whose wrappers take the plain PyTorch versions
for CPU tensors. Tolerances: the loss, lse, label logit and zsum within 1e-5
relative (both sum f32 products of bf16-rounded inputs, in other orders); dx
and dW within 1e-3 in relative Frobenius norm (both round the residual to
bf16 before the two products, from exponentials that differ in the last
bits, so single entries may land on neighbouring bf16 values).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transformers4rec_tpu.ops import vocab as jax_vocab

from transformers4rec_tpu_torch.model.losses import cross_entropy_with_logits
from transformers4rec_tpu_torch.ops import vocab

torch.set_num_threads(1)

E = 16
# (N, table rows, vocab_size, label smoothing, rows with label -1)
CASES = {
    "plain": (37, 1000, 1000, 0.0, False),
    "padded_table": (37, 1008, 1000, 0.0, False),
    "smoothing": (37, 1008, 1001, 0.1, False),
    "labels_minus_one": (64, 520, 513, 0.0, True),
    "n_off_the_tile": (131, 2000, 1999, 0.1, True),
}


def _inputs(case, seed=0):
    n, rows, vocab_size, eps, minus_one = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (n, E)).astype(np.float32)
    W = rng.normal(0.0, 0.3, (rows, E)).astype(np.float32)
    W[vocab_size:] = 50.0  # padded rows: any use of them would show
    labels = rng.integers(0, vocab_size, n).astype(np.int32)
    weights = (rng.random(n) > 0.3).astype(np.float32)  # about 30% of the rows weigh 0
    if minus_one:
        pad = rng.random(n) < 0.1
        labels[pad], weights[pad] = -1, 0.0
    assert 0 < weights.sum() < n
    return x, W, labels, weights, vocab_size, eps


def _rel_fro(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("case", CASES)
def test_ce_fwd_plain_matches_jax_scan(case):
    x, W, labels, _, vocab_size, eps = _inputs(case)
    want = jax_vocab._ce_fwd_scan(jnp.asarray(x), jnp.asarray(W), jnp.asarray(labels), 256,
                                  vocab_size, eps > 0)
    got = vocab.ce_fwd(torch.from_numpy(x), torch.from_numpy(W), torch.from_numpy(labels),
                       vocab_size, smooth=eps > 0)
    for name, g, w in zip(("lse", "ll", "zsum"), got, want):
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)
    assert (got[1].numpy()[labels < 0] == 0).all()


@pytest.mark.parametrize("case", CASES)
def test_ce_bwd_plain_matches_jax_scan(case):
    x, W, labels, weights, vocab_size, eps = _inputs(case, seed=1)
    lse = jax_vocab._ce_fwd_scan(jnp.asarray(x), jnp.asarray(W), jnp.asarray(labels), 256,
                                 vocab_size, False)[0]
    coef = (weights / weights.sum()).astype(np.float32)
    # an explicit ε/V, as a vocab-parallel caller passes the global one
    eov = 0.5 * eps / vocab_size if case == "n_off_the_tile" else None
    want_dx, want_dW = jax_vocab._ce_bwd_scan(
        jnp.asarray(x), jnp.asarray(W), jnp.asarray(labels), lse, jnp.asarray(coef), 256,
        vocab_size, eps, eov)
    got_dx, got_dW = vocab.ce_bwd(
        torch.from_numpy(x), torch.from_numpy(W), torch.from_numpy(labels),
        torch.from_numpy(np.array(lse)), torch.from_numpy(coef), vocab_size, eps, eov)
    assert _rel_fro(got_dx.numpy(), np.asarray(want_dx)) <= 1e-3
    assert got_dW.shape == W.shape
    assert _rel_fro(got_dW.numpy(), np.asarray(want_dW)) <= 1e-3
    assert (got_dW.numpy()[vocab_size:] == 0).all()
    assert (got_dx.numpy()[weights == 0] == 0).all()


@pytest.mark.parametrize("case", CASES)
def test_fused_softmax_ce_value_and_grads_match_jax(case):
    x, W, labels, weights, vocab_size, eps = _inputs(case, seed=2)

    def jax_loss(a, b):
        return jax_vocab.fused_softmax_ce(a, b, jnp.asarray(labels), jnp.asarray(weights),
                                          64, 256, False, vocab_size, eps)

    want, (want_dx, want_dW) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(W))
    xt = torch.from_numpy(x).requires_grad_()
    Wt = torch.from_numpy(W).requires_grad_()
    wt = torch.from_numpy(weights).requires_grad_()
    got = vocab.fused_softmax_ce(xt, Wt, torch.from_numpy(labels), wt,
                                 vocab_size=vocab_size, label_smoothing=eps)
    # an upstream gradient other than 1; a power of two, so the residual
    # rounds to bf16 at the same places as the reference's
    (2.0 * got).backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert _rel_fro(xt.grad.numpy() / 2.0, np.asarray(want_dx)) <= 1e-3
    assert _rel_fro(Wt.grad.numpy() / 2.0, np.asarray(want_dW)) <= 1e-3
    assert wt.grad is None  # the weights are a validity mask


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_fused_softmax_ce_matches_dense_cross_entropy(eps):
    """The fused op against ``losses.cross_entropy_with_logits`` on dense
    logits of the same bf16-rounded values, and against the JAX package's
    dense loss. The dense gradient keeps its residual in f32, so dx and dW
    agree within the bf16 rounding of the residual: 1e-2 relative Frobenius."""
    from transformers4rec_tpu.model.losses import cross_entropy_with_logits as jax_dense

    x, W, labels, weights, vocab_size, _ = _inputs("padded_table", seed=3)
    xb = torch.from_numpy(x).bfloat16().float().requires_grad_()
    Wb = torch.from_numpy(W).bfloat16().float().requires_grad_()
    lab = torch.from_numpy(labels)
    wt = torch.from_numpy(weights)
    dense = cross_entropy_with_logits(xb @ Wb[:vocab_size].T, lab, wt, label_smoothing=eps)
    dense.backward()
    want = jax_dense(jnp.asarray(xb.detach().numpy()) @ jnp.asarray(Wb.detach().numpy())[:vocab_size].T,
                     jnp.asarray(labels), jnp.asarray(weights), eps)
    np.testing.assert_allclose(float(dense.detach()), float(want), rtol=1e-5)

    xt = torch.from_numpy(x).requires_grad_()
    Wt = torch.from_numpy(W).requires_grad_()
    fused = vocab.fused_softmax_ce(xt, Wt, lab, wt, vocab_size=vocab_size, label_smoothing=eps)
    fused.backward()
    np.testing.assert_allclose(float(fused.detach()), float(dense.detach()), rtol=1e-5)
    assert _rel_fro(xt.grad.numpy(), xb.grad.numpy()) <= 1e-2
    assert _rel_fro(Wt.grad.numpy(), Wb.grad.numpy()) <= 1e-2


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    """A CPU tensor is the only way to the plain versions: for anything else
    the wrappers go to the kernel launchers (which raise without a card)."""
    called = []
    monkeypatch.setattr(vocab, "_ce_fwd_cuda", lambda *a: called.append("fwd") or (None,) * 3)
    monkeypatch.setattr(vocab, "_ce_bwd_cuda", lambda *a: called.append("bwd") or (None,) * 2)
    monkeypatch.setattr(vocab, "ce_fwd_plain", lambda *a: pytest.fail("plain forward"))
    monkeypatch.setattr(vocab, "ce_bwd_plain", lambda *a: pytest.fail("plain backward"))
    meta = torch.empty(4, 8, device="meta")
    vocab.ce_fwd(meta, meta, meta, 4)
    vocab.ce_bwd(meta, meta, meta, meta, meta, 4)
    assert called == ["fwd", "bwd"]
    assert vocab.ce_fwd.launches == 0 and vocab.ce_bwd.launches == 0
    # a table wider than the narrow kernels hold goes to the launchers too
    # (their wide kernels), never to the plain versions
    wide = torch.empty(4, 448, device="meta")
    vocab.ce_fwd(wide, wide, meta, 4)
    vocab.ce_bwd(wide, wide, meta, meta, meta, 4)
    assert called == ["fwd", "bwd", "fwd", "bwd"]


# ------------------------------------- the kernels' launch plan and image layout
SMS = 132  # an H100 SXM


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("vocab_size", [0, 33, 100_003, 390_001])
@pytest.mark.parametrize("n", [1, 915, 8192, 16384])
def test_ce_plan_covers_every_tile_and_chunk_once(n, vocab_size, backward):
    """Every row tile meets every vocab chunk in exactly one block, K2's dW
    pass has a block for every tile of the table, and the scratch stays
    within its cap: the images hold at most a tile of padding beyond x and
    the table, and the partials at most 2 * SMs * 128 rows (or N)."""
    e, table_rows = 64, vocab_size + 7
    plan = vocab.ce_plan(n, e, vocab_size, table_rows, SMS, backward)
    tile = vocab.CE_TILE
    assert (plan.row_tiles - 1) * tile < n <= plan.row_tiles * tile
    assert plan.chunks * tile >= vocab_size > (plan.chunks - 1) * tile
    # split s of a row pass takes chunks [s * cps, min((s + 1) * cps, chunks)),
    # as row_split in csrc/hopper.cuh cuts them
    cps = plan.chunks_per_split
    ranges = [(s * cps, min((s + 1) * cps, plan.chunks)) for s in range(plan.splits)]
    assert [c for begin, end in ranges for c in range(begin, end)] == list(range(plan.chunks))
    if plan.chunks:
        assert all(end > begin for begin, end in ranges)
    else:
        assert ranges == [(0, 0)]
    if backward:
        assert (plan.table_tiles - 1) * tile < table_rows <= plan.table_tiles * tile
    else:
        assert plan.table_tiles == plan.chunks
    assert plan.row_tiles * plan.splits <= max(2 * SMS, plan.row_tiles)
    assert plan.ek == 64
    # the buffers the wrappers allocate, on the meta device: the images hold
    # at most a tile of padding beyond x and the table, the partials at most
    # 2 * SMs * 128 rows (or N)
    scratch = plan.scratch("meta", smooth=True)
    cap_rows = n + tile - 1 + (table_rows if backward else vocab_size) + tile - 1
    image_bytes = scratch["ximg"].nbytes + scratch["wimg"].nbytes
    assert image_bytes <= cap_rows * plan.ek * 2
    per_row = (e * 4 + 16) if backward else 20
    partial_bytes = sum(t.nbytes for k, t in scratch.items() if k not in ("ximg", "wimg"))
    assert partial_bytes <= max(2 * SMS * tile, n) * per_row + tile * 16
    if backward:
        return
    # K3's narrow kernel: its 64-row chunks, each met once by every row tile,
    # about one or two blocks per SM, and a ring of at least 4 slots whose
    # blocks fit the card's shared memory side by side
    for e3 in (16, 64, 128, 256):
        k3 = vocab.ce_plan(n, e3, vocab_size, table_rows, SMS, False, vocab.K3_CHUNK,
                           streamed=True)
        assert k3.chunks * vocab.K3_CHUNK >= vocab_size > (k3.chunks - 1) * vocab.K3_CHUNK
        cps = k3.chunks_per_split
        ranges = [(s * cps, min((s + 1) * cps, k3.chunks)) for s in range(k3.splits)]
        assert [c for b, end in ranges for c in range(b, end)] == list(range(k3.chunks))
        assert all(end > b for b, end in ranges) or ranges == [(0, 0)]
        assert k3.row_tiles * k3.splits <= max(k3.blocks_per_sm * SMS, k3.row_tiles)
        rows, slot = vocab.k3_slot(e3)
        assert vocab.K3_CHUNK % rows == 0 and rows % 8 == 0 and slot >= rows * e3 * 4
        assert k3.stages >= vocab.K3_MIN_STAGES and k3.smem == k3.stages * (slot + 16)
        assert k3.blocks_per_sm * k3.smem <= vocab.MAX_SMEM
        assert k3.blocks_per_sm * k3.smem >= vocab.K3_IN_FLIGHT  # slots in flight on an SM


@pytest.mark.parametrize("blocks", [None, 1, 2])
@pytest.mark.parametrize("e", [64, 128, 256])
def test_both_table_forms_keep_the_same_bytes_in_flight(e, blocks):
    """The streamed ring that K3 and K4 share, at the evaluation shape: a
    bf16 table's slots have half an f32 slot's bytes, and the plan keeps
    about ``K3_IN_FLIGHT`` bytes of the table in flight on an SM in either
    form (more slots, or more blocks an SM where f32 fits fewer), within one
    slot of each other; for the blocks the shared memory holds (``None``)
    and for the blocks K3's and K4's pass may be built for."""
    flight, slots = {}, {}
    for bf16 in (False, True):
        plan = vocab.ce_plan(128, e, 390_001, 390_008, SMS, False, vocab.K3_CHUNK,
                             streamed=True, table_bf16=bf16, blocks_per_sm=blocks)
        slots[bf16] = vocab.k3_slot(e, bf16)[1]
        flight[bf16] = plan.blocks_per_sm * plan.stages * slots[bf16]
        assert flight[bf16] >= vocab.K3_IN_FLIGHT
        assert plan.blocks_per_sm * plan.smem <= vocab.MAX_SMEM
        if blocks is not None:
            assert plan.blocks_per_sm <= blocks
    assert 2 * slots[True] == slots[False]
    assert abs(flight[True] - flight[False]) <= slots[False]


@pytest.mark.parametrize("e,ek", [(4, 64), (20, 64), (64, 64), (100, 128), (132, 256),
                                  (192, 256), (256, 256)])
def test_ce_plan_pads_e_to_the_swizzle_width(e, ek):
    """E is padded to one, two or four slabs of 64: the forward kernel is
    built for no other width."""
    assert vocab.ce_plan(37, e, 1000, 1008, SMS, False).ek == ek


@pytest.mark.parametrize("rows,ek", [(1, 64), (130, 64), (300, 128), (128, 256),
                                     # the wide kernels' widths: E = 448 forward and
                                     # backward, 1,000 and 2,048
                                     (129, 448), (5, 512), (200, 1024), (128, 2048)])
def test_swizzled_image_index_is_a_permutation(rows, ek):
    """The image layout of the kernels (``image_offset`` in csrc/hopper.cuh)
    puts every element of the padded matrix at its own place, keeps each
    16-byte piece whole and inside its tile, slab and 128-byte row, and
    swizzles the pieces of a row by the row's place in its group of 8."""
    idx = vocab.swizzled_image_index(rows, ek)
    padded = -(-rows // 128) * 128
    assert idx.shape == (padded, ek)
    assert torch.equal(idx.flatten().sort().values, torch.arange(padded * ek))
    pieces = idx.reshape(padded, ek // 8, 8)
    assert torch.equal(pieces - pieces[..., :1], torch.arange(8).expand_as(pieces))
    r = torch.arange(padded)[:, None]
    j = torch.arange(ek // 8)[None, :]
    row_start = (r // 128) * 128 * ek + (j // 8) * 128 * 64 + (r % 128) * 64
    assert torch.equal(pieces[..., 0], row_start + ((j % 8) ^ (r % 8)) * 8)


# ------------------------------------------------ wide item tables (E > 256)
MAX_SMEM = 232448  # dynamic shared memory a block may ask for (csrc/hopper.cuh)


@pytest.mark.parametrize("kernel", ["k1", "k2", "k3", "k4"])
@pytest.mark.parametrize("e", [192, 448, 1000, 2048])
@pytest.mark.parametrize("n", [128, 915, 8192])
def test_ce_plan_takes_every_width(n, e, kernel):
    """The one launch plan at widths beyond the narrow kernels: K1, K3 and
    K4 past 256 and K2 past 128 take the wide kernels, whose images are E
    rounded up to one slab (forward) or two (K2, whose blocks own 128
    columns each), walked in ceil(E / 64) slabs, over 128-column chunks that
    the splits cover once; a resident x tile fits with a ring of 6 slots;
    the scratch stays within the narrow plan's cap."""
    backward = kernel == "k2"
    chunk_cols = 64 if kernel in ("k3", "k4") else vocab.CE_TILE  # the narrow K3/K4 chunk
    vocab_size, table_rows = 390_001, 390_008
    plan = vocab.ce_plan(n, e, vocab_size, table_rows, SMS, backward, chunk_cols)
    wide = e > (128 if backward else 256)
    assert plan.wide == wide
    assert plan.ek % 64 == 0 and plan.ek >= e and plan.slabs * 64 >= e
    if not wide:
        assert plan.ek == 256 and plan.slabs == 4 and plan.e_splits == 1 and plan.resident
    elif backward:
        assert plan.ek % 128 == 0 and plan.ek - e < 128 and plan.e_splits == plan.ek // 128
        assert plan.slabs == -(-e // 64) and not plan.resident
        # the dW pass writes every column of E once: 128 columns a block
        assert sorted(c for j in range(plan.e_splits) for c in range(128 * j, 128 * j + 128)
                      if c < e) == list(range(e))
    else:
        assert plan.ek - e < 64 and plan.slabs == plan.ek // 64 and plan.e_splits == 1
        assert plan.resident == (plan.slabs <= vocab.RESIDENT_SLABS)
    if wide:  # K1's 128-column chunks, whatever the narrow K3/K4 chunk
        assert plan.chunks * 128 >= vocab_size > (plan.chunks - 1) * 128
    cps = plan.chunks_per_split
    ranges = [(s * cps, min((s + 1) * cps, plan.chunks)) for s in range(plan.splits)]
    assert [c for b, end in ranges for c in range(b, end)] == list(range(plan.chunks))
    assert plan.row_tiles * plan.splits <= max(2 * SMS, plan.row_tiles)
    # a resident tile of RESIDENT_SLABS beside 6 slots of one slab, and 6
    # slots of K2's two slabs and row table, fit in a block's shared memory
    slab = 128 * 128
    assert 1024 + (vocab.RESIDENT_SLABS + 6) * slab + 8 * 13 <= MAX_SMEM
    assert 1024 + 6 * (2 * slab + 128 * 16) + 8 * 13 <= MAX_SMEM
    scratch = plan.scratch("meta", smooth=True)
    tile = vocab.CE_TILE
    cap_rows = n + tile - 1 + (table_rows if backward else vocab_size) + tile - 1
    image_bytes = scratch["ximg"].nbytes + scratch["wimg"].nbytes
    assert image_bytes <= cap_rows * plan.ek * 2
    per_row = (e * 4 + 16) if backward else 20
    partial_bytes = sum(t.nbytes for k, t in scratch.items() if k not in ("ximg", "wimg"))
    assert partial_bytes <= max(2 * SMS * tile, n) * per_row + tile * 16
    if backward:
        return
    # K3's narrow kernel: its 64-row chunks, each met once by every row tile,
    # about one or two blocks per SM, and a ring of at least 4 slots whose
    # blocks fit the card's shared memory side by side
    for e3 in (16, 64, 128, 256):
        k3 = vocab.ce_plan(n, e3, vocab_size, table_rows, SMS, False, vocab.K3_CHUNK,
                           streamed=True)
        assert k3.chunks * vocab.K3_CHUNK >= vocab_size > (k3.chunks - 1) * vocab.K3_CHUNK
        cps = k3.chunks_per_split
        ranges = [(s * cps, min((s + 1) * cps, k3.chunks)) for s in range(k3.splits)]
        assert [c for b, end in ranges for c in range(b, end)] == list(range(k3.chunks))
        assert all(end > b for b, end in ranges) or ranges == [(0, 0)]
        assert k3.row_tiles * k3.splits <= max(k3.blocks_per_sm * SMS, k3.row_tiles)
        rows, slot = vocab.k3_slot(e3)
        assert vocab.K3_CHUNK % rows == 0 and rows % 8 == 0 and slot >= rows * e3 * 4
        assert k3.stages >= vocab.K3_MIN_STAGES and k3.smem == k3.stages * (slot + 16)
        assert k3.blocks_per_sm * k3.smem <= vocab.MAX_SMEM
        assert k3.blocks_per_sm * k3.smem >= vocab.K3_IN_FLIGHT  # slots in flight on an SM


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_fused_softmax_ce_at_the_papers_width_matches_jax(eps):
    """E = 448, the paper's tied width: the port's plain K1/K2 (what a CPU
    tensor takes) against the JAX scan, loss and both gradients."""
    rng = np.random.default_rng(448)
    n, rows, vocab_size, e = 61, 1008, 1001, 448
    x = rng.normal(0.0, 1.0, (n, e)).astype(np.float32)
    W = rng.normal(0.0, 0.05, (rows, e)).astype(np.float32)
    labels = rng.integers(0, vocab_size, n).astype(np.int32)
    weights = (rng.random(n) > 0.3).astype(np.float32)

    def jax_loss(xx, ww):
        return jax_vocab.fused_softmax_ce(xx, ww, jnp.asarray(labels), jnp.asarray(weights),
                                          use_pallas=False, vocab_size=vocab_size,
                                          label_smoothing=eps)

    want, (want_dx, want_dW) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(W))
    xt, Wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(W).requires_grad_()
    got = vocab.fused_softmax_ce(xt, Wt, torch.from_numpy(labels), torch.from_numpy(weights),
                                 vocab_size=vocab_size, label_smoothing=eps)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert _rel_fro(xt.grad.numpy(), np.asarray(want_dx)) <= 1e-3
    assert _rel_fro(Wt.grad.numpy(), np.asarray(want_dW)) <= 1e-3
