"""The encoder's float16 compute type: the port against the JAX package on
the CPU.

The same encoders, weights and inputs as ``test_torch_compute_dtype.py``
(d_model 32, 2 heads, 2 layers, dropout 0, XLA's
``xla_allow_excess_precision`` off on the JAX side), built in both packages
with ``dtype`` float16. Every Linear, LayerNorm output, GELU step, residual
sum and the attention's probabilities and context round to f16 where they
rounded to bf16; the attention biases stay float32 in both packages (so
-1e9 stays finite; in f16 it would be -inf, and a row with no valid key
would turn into NaN), and the encoder returns float32.

f16 keeps 10 bits of mantissa where bf16 keeps 7, so the two packages land
nearer each other than in bf16: outputs are held within ``OUT_REL`` = 2e-3
and gradients within ``GRAD_REL`` = 1e-2 in relative Frobenius norm
(measured: outputs 4e-4 to 5e-4, the worst gradient 2.7e-3; BERT's output
bit for bit). As in bf16, a port that ignored ``dtype`` could pass that
alone, so each dense case also asserts that the port's f16 first layer
output is ``CLOSER`` = 3 times nearer JAX's f16 one than the port's f32
first layer output is (measured: 4.0 to 6.3, and exact for BERT).

- Dense at S = 8: XLNet's relative bias, GPT-2's causal mask, the BERT
  family's post-LN layers, XLNet's two streams (PLM), Reformer's local and
  LSH layers.
- Flash at S = 128 (fixture ``jax_flash``: the JAX Pallas kernels in
  interpret mode, the port's plain versions): GPT-2, and XLNet's learned
  bias, whose backward goes through ``reference_attention`` with the
  probabilities rounded to f16 (q's type), as the JAX package rounds them.
- The flash plain versions on f16 q, k, v and dO against the JAX kernels:
  out, dq, dk and dv come back f16 in both, within one f16 spacing plus
  the f32 tests' tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transformers4rec_tpu.ops import attention as jax_attn

from test_torch_clm import jax_flash  # noqa: F401  (a fixture)
from test_torch_compute_dtype import JAX_TYPES, ZERO_GRADIENT, Pair, _rel_fro
from transformers4rec_tpu_torch import flagship
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.ops import attention as attn

torch.set_num_threads(1)

F16 = torch.float16
JAX_TYPES.setdefault(F16, jnp.float16)
OUT_REL, GRAD_REL = 2e-3, 1e-2
# the f16 port's distance to JAX's f16 first layer, times this, is below the f32 port's
CLOSER = 3.0


def _held(got_out, got, want_out, want):
    assert got_out.dtype == np.float32 and np.isfinite(got_out).all()
    assert set(got) == set(want)
    assert _rel_fro(got_out, want_out) <= OUT_REL
    for name in want:
        assert np.isfinite(got[name]).all(), name
        if not name.endswith(ZERO_GRADIENT):
            assert _rel_fro(got[name], want[name]) <= GRAD_REL, name


@pytest.mark.parametrize("arch,plm,kw", [
    ("xlnet", False, {}),
    ("gpt2", False, {}),
    ("bert", False, {}),
    ("xlnet", True, {}),
    ("reformer", False, {"attn_layers": ("local", "lsh"), "local_window": 2}),
])
def test_f16_encoder_matches_jax_on_the_dense_path(arch, plm, kw, monkeypatch):
    pair = Pair(arch, 8, plm=plm, **kw)
    monkeypatch.setattr(attn, "flash_fwd", None)  # the dense path: no flash call
    want_out, want, want_first = pair.run_jax(F16)
    got_out, got, got_first = pair.run_port(F16)
    _held(got_out, got, want_out, want)
    near = _rel_fro(got_first, want_first)
    far = _rel_fro(pair.run_port(None)[2], want_first)
    assert CLOSER * near <= far, (near, far)


def test_f16_encoder_keeps_its_types():
    """Parameters f32, every Linear and LayerNorm computing in f16, the
    residual stream f16, the output f32; the row of the batch that is all
    padding gives finite values (the masks stay f32)."""
    pair = Pair("gpt2", 8)
    tenc = pair.port(F16)
    assert tenc.compute_dtype == F16
    assert all(p.dtype == torch.float32 for p in tenc.parameters())
    seen = {}
    hooks = [m.register_forward_hook(lambda m, i, o, name=name: seen.setdefault(
        name, (i[0].dtype, o.dtype if torch.is_tensor(o) else o[0].dtype)) and None)
        for name, m in tenc.named_modules() if name.endswith(("ffn_in", "ln1", "attn", "ln_f"))
        or name == "layers.0"]
    out = tenc(torch.from_numpy(pair.x), pad_mask=torch.from_numpy(pair.pad))
    for h in hooks:
        h.remove()
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert not pair.pad[-1].any()  # the row without a valid key
    assert seen["layers.0"] == (F16, F16)
    assert seen["layers.0.ffn_in"] == (F16, F16)
    assert seen["layers.0.ln1"] == (F16, F16)
    assert seen["layers.0.attn"][1] == F16
    assert seen["ln_f"] == (F16, F16)


@pytest.mark.parametrize("arch", ["gpt2", "xlnet"])
def test_f16_encoder_matches_jax_on_the_flash_path(arch, jax_flash, monkeypatch):  # noqa: F811
    pair = Pair(arch, 128)
    taken = []
    real = attn.FlashAttention.apply
    monkeypatch.setattr(attn.FlashAttention, "apply",
                        lambda *a: taken.append(a[:3]) or real(*a))
    want_out, want, _ = pair.run_jax(F16)
    got_out, got, _ = pair.run_port(F16)
    # both packages took the flash path in every layer, on f16 q, k, v
    assert len(jax_flash) >= 2 and len(taken) == 2
    assert all(t.dtype == F16 for qkv in taken for t in qkv)
    _held(got_out, got, want_out, want)
    if arch == "xlnet":  # the learned bias's gradient, through reference_attention
        assert np.abs(got["rel_pos.rel_bias"]).max() > 0


def test_reference_attention_rounds_the_probabilities_to_f16():
    """The learned bias's backward: the port's ``reference_attention`` on f16
    q, k, v against the JAX package's, values and the four gradients."""
    B, S, Hh, Dh = 2, 12, 2, 8
    rng = np.random.default_rng(4)
    q, k, v, g = (rng.normal(0, 1, (B, S, Hh, Dh)).astype(np.float16) for _ in range(4))
    bias = rng.normal(0, 0.5, (1, Hh, S, S)).astype(np.float32)
    pad = np.arange(S)[None, :] < np.array([S, 5])[:, None]

    def jfn(q_, k_, v_, b_):
        return jax_attn.reference_attention(q_, k_, v_, b_, jnp.asarray(pad), True)

    want_out, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v, bias)))
    want = [want_out, *vjp(jnp.asarray(g))]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    out = attn.reference_attention(*leaves, pad_mask=torch.from_numpy(pad), causal=True)
    got = [out, *torch.autograd.grad(out, leaves, torch.from_numpy(g))]
    assert out.dtype == F16 and want_out.dtype == jnp.float16
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        a, b = a.detach().float().numpy(), np.asarray(b, np.float32)
        assert _rel_fro(a, b) <= 2e-3, name


def test_flash_plain_versions_on_f16_match_the_jax_kernels():
    """K5's and K6a's plain versions on f16 q, k, v, dO against the JAX
    Pallas kernels in interpret mode: both return f16 (the inputs rounded
    to bf16 as they are loaded, the f32 results rounded once to f16);
    within one f16 spacing of each value plus the f32 tests' tolerances."""
    B, S, Hh, Dh = 2, 130, 2, 16
    rng = np.random.default_rng(3)
    q, k, v, g = (rng.normal(0, 1, (B, S, Hh, Dh)).astype(np.float16) for _ in range(4))
    pad = np.arange(S)[None, :] < np.array([S, 77])[:, None]
    bias = rng.normal(0, 0.5, (1, Hh, S, S)).astype(np.float32)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))

    def jfn(q_, k_, v_):
        return jax_attn.flash_attention(q_, k_, v_, jnp.asarray(bias), jnp.asarray(pad), True,
                                        128, 128, True, False)

    want_out, vjp = jax.vjp(jfn, jq, jk, jv)
    want = [want_out, *vjp(jg)]
    assert all(w.dtype == jnp.float16 for w in want)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    tbias, tpad = torch.from_numpy(bias), torch.from_numpy(pad)
    out, lse = attn.flash_forward_plain(tq, tk, tv, tbias, tpad, True)
    for fused in (True, False):
        got = [out, *attn.flash_backward_plain(tq, tk, tv, tbias, tpad, True, out, lse, tg,
                                               fused)]
        for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
            assert a.dtype == F16, name
            a, b = a.float().numpy(), np.asarray(b, np.float32)
            spacing = np.exp2(np.floor(np.log2(np.maximum(np.abs(b), 2.0 ** -14))) - 10)
            atol = 5e-3 if name == "out" else 2e-2 * np.abs(b).max()
            assert (np.abs(a - b) <= atol + spacing).all(), name
            assert _rel_fro(a, b) <= 5e-3, name


def test_flash_plain_versions_round_f16_as_the_f32_form_does():
    """The f16 form's arithmetic is the f32 form's on the exact f32 image of
    the f16 inputs, its results rounded once to f16: the plain versions give
    those bits (what ``chip_smoke.py`` asks of the kernels)."""
    B, S, Hh, Dh = 2, 70, 2, 8
    rng = np.random.default_rng(5)
    q, k, v, g = (torch.from_numpy(rng.normal(0, 1, (B, S, Hh, Dh)).astype(np.float16))
                  for _ in range(4))
    pad = torch.from_numpy(np.arange(S)[None, :] < np.array([S, 0])[:, None])
    out, lse = attn.flash_forward_plain(q, k, v, None, pad, True)
    out32, lse32 = attn.flash_forward_plain(q.float(), k.float(), v.float(), None, pad, True)
    assert torch.equal(out, out32.to(F16)) and torch.equal(lse, lse32)
    assert (out[1] == 0).all()  # the session with no valid key
    delta = attn.row_delta(g, out32)
    got = attn.flash_bwd_fused_plain(q, k, v, g, lse, delta, None, pad, True)
    want = attn.flash_bwd_fused_plain(q.float(), k.float(), v.float(), g.float(), lse, delta,
                                      None, pad, True)
    assert all(a.dtype == F16 and torch.equal(a, b.to(F16)) for a, b in zip(got, want))


def test_flagship_takes_float16_with_and_without_remat():
    """``build_model`` and ``build_trainer`` pass ``dtype=torch.float16`` (and
    ``remat``) to the encoder; the parameters stay float32, and the trainer
    takes finite steps."""
    small = dict(num_items=50, d_model=16, n_layer=1, n_head=2, seq=6, scheme="clm")
    for remat in (False, True):
        model = flagship.build_model("cpu", **small, dtype=F16, remat=remat)
        encoder = model.heads[0].body.blocks[1].encoder
        assert encoder.compute_dtype == F16 and encoder.remat == remat
        assert {p.dtype for p in model.parameters()} == {torch.float32}
    data = synthetic_data(flagship.schema(50, 6), num_rows=8, max_session_length=6, seed=1)
    trainer = flagship.build_trainer("cpu", train_dataset=data, batch=4, dropout=0.0, **small,
                                     dtype=F16, remat=True)
    assert trainer.model.heads[0].body.blocks[1].encoder.compute_dtype == F16
    trainer.args.max_steps, trainer.args.logging_steps = 2, 1
    trainer.train()
    reads = [h["loss"] for h in trainer.state.log_history if "loss" in h]
    assert len(reads) == 2 and np.isfinite(reads).all()
