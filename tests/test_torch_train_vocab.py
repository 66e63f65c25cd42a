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
    # wider than the backward kernel takes: refused before anything is launched
    wide = torch.empty(4, 256, device="meta")
    with pytest.raises(ValueError, match="E up to 128"):
        vocab.fused_softmax_ce(wide, wide, meta[:, 0], meta[:, 0])
    assert called == ["fwd", "bwd"]
