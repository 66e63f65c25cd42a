"""The port's fused CE-and-rank pass (K3) against the JAX package on the CPU.

Same inputs, made with numpy from a seed, go through the JAX
``fused_ce_and_rank`` on its scan branch (``use_pallas=False``, how the JAX
tests run it on the CPU) and through the port's, whose wrapper takes the
plain PyTorch version for CPU tensors. Tolerances: the loss within 1e-5
relative (both sum f32 logits of bf16-rounded inputs, in other orders);
ranks exact (a logit would have to fall within an ulp of the label logit
to flip, which these inputs do not give).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transformers4rec_tpu.ops.vocab import fused_ce_and_rank as jax_fused_ce_and_rank

from transformers4rec_tpu_torch.ops import vocab

torch.set_num_threads(1)

N, E, ROWS, VOCAB = 37, 16, 1008, 1000


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (N, E)).astype(np.float32)
    W = rng.normal(0.0, 0.3, (ROWS, E)).astype(np.float32)
    labels = rng.integers(0, VOCAB, N).astype(np.int32)
    weights = (rng.random(N) > 0.2).astype(np.float32)  # some rows weigh 0
    return x, W, labels, weights


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_fused_ce_and_rank_matches_jax(eps):
    x, W, labels, weights = _inputs()
    assert 0 < weights.sum() < N
    want_loss, want_rank = jax_fused_ce_and_rank(
        jnp.asarray(x), jnp.asarray(W), jnp.asarray(labels), jnp.asarray(weights),
        use_pallas=False, vocab_size=VOCAB, label_smoothing=eps,
    )
    got_loss, got_rank = vocab.fused_ce_and_rank(
        torch.from_numpy(x), torch.from_numpy(W), torch.from_numpy(labels),
        torch.from_numpy(weights), vocab_size=VOCAB, label_smoothing=eps,
    )
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    assert got_rank.dtype == torch.int32
    np.testing.assert_array_equal(got_rank.numpy(), np.asarray(want_rank))


def test_ce_rank_plain_matches_dense_numpy():
    """lse, rank and zsum of the plain version against a dense float64
    computation on the same bf16-rounded values, chunked so that the vocab
    bound falls inside a chunk and the padded rows are never read."""
    x, W, labels, _ = _inputs(1)
    W[VOCAB:] = 1e6  # padded rows: any value they held would show
    xt, Wt = torch.from_numpy(x), torch.from_numpy(W)
    ll = vocab.label_logits(xt, Wt, torch.from_numpy(labels))
    lse, rank, zs = vocab.ce_rank_plain(xt, Wt, torch.from_numpy(labels), ll, VOCAB,
                                        smooth=True, chunk=300)
    xb = xt.to(torch.bfloat16).double().numpy()
    Wb = Wt[:VOCAB].to(torch.bfloat16).double().numpy()
    logits = xb @ Wb.T
    m = logits.max(-1)
    want_lse = m + np.log(np.exp(logits - m[:, None]).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-6)
    np.testing.assert_allclose(zs.numpy(), logits.sum(-1), rtol=1e-5, atol=1e-4)
    greater = logits > ll.double().numpy()[:, None]
    greater[np.arange(N), labels] = False  # the label's own column never counts
    np.testing.assert_array_equal(rank.numpy(), greater.sum(-1))


def test_label_logits_is_the_bf16_gather_dot():
    x, W, labels, _ = _inputs(2)
    got = vocab.label_logits(torch.from_numpy(x), torch.from_numpy(W), torch.from_numpy(labels))
    xb = torch.from_numpy(x).to(torch.bfloat16).double()
    rows = torch.from_numpy(W[labels]).to(torch.bfloat16).double()
    # an f32 sum of E products of size ~0.3: a few ulps of 1 at most
    np.testing.assert_allclose(got.numpy(), (xb * rows).sum(-1).numpy(), rtol=1e-6, atol=1e-6)


def test_ce_rank_takes_plain_version_only_for_cpu_tensors():
    x, W, labels, _ = _inputs(3)
    args = (torch.from_numpy(x), torch.from_numpy(W), torch.from_numpy(labels))
    ll = vocab.label_logits(*args)
    before = vocab.ce_rank.launches
    got = vocab.ce_rank(*args, ll, VOCAB, smooth=True)
    want = vocab.ce_rank_plain(*args, ll, VOCAB, True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert vocab.ce_rank.launches == before  # no kernel ran
    # the kernel path refuses CPU tensors instead of falling back
    with pytest.raises(ValueError, match="CUDA"):
        vocab._ce_rank_cuda(*args, ll, VOCAB, False)


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_a_label_outside_the_table_gives_the_reference_loss_and_rank(eps):
    """A label at or beyond the table's rows (never produced by the loaders):
    the reference's ``jnp.take`` fills the gathered row with NaN, so that
    row's loss is NaN and its rank 0, and nothing raises. The port's gather
    clamps its index into the table and gives the same; a negative label in
    range counts from the table's end in both."""
    x, W, labels, weights = _inputs(4)
    labels[:4] = [ROWS, ROWS + 5, 10 * ROWS, -(ROWS + 1)]
    labels[4] = -1  # the table's last row in both packages
    weights[:5] = [1.0, 0.0, 1.0, 1.0, 1.0]
    per_row = []
    for keep in (slice(None), slice(4, None)):  # with the rows at fault, and without
        args = (x[keep], W, labels[keep], weights[keep])
        want_loss, want_rank = jax_fused_ce_and_rank(
            *(jnp.asarray(a) for a in args), use_pallas=False, vocab_size=VOCAB,
            label_smoothing=eps)
        got_loss, got_rank = vocab.fused_ce_and_rank(
            *(torch.from_numpy(a) for a in args), vocab_size=VOCAB, label_smoothing=eps)
        np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5, equal_nan=True)
        np.testing.assert_array_equal(got_rank.numpy(), np.asarray(want_rank))
        per_row.append((float(got_loss), got_rank.numpy()))
    assert np.isnan(per_row[0][0]) and np.isfinite(per_row[1][0])
    assert (per_row[0][1][:4] == 0).all()
    ll = vocab.label_logits(torch.from_numpy(x), torch.from_numpy(W), torch.from_numpy(labels))
    assert torch.isnan(ll[:4]).all() and torch.isfinite(ll[4:]).all()
