"""Per-layer rematerialisation (``remat=True``) and a small model at bf16
with remat, on the CPU.

- The port with ``remat=True`` against itself without it, dropout 0.1 on,
  from one generator seed: the loss, every gradient (and the input's) and
  the generator's final state bit for bit, on the dense path (XLNet), the
  flash path (GPT-2 at S = 128), shared layers (ALBERT), two streams
  (XLNet-PLM) and segment memory (Transformer-XL), in bf16 and in f32. The
  recompute runs each layer's forward a second time in the backward
  (counted), and replays its dropout draws from the generator's state at
  the layer's entry: a recompute that drew afresh would give other masks
  and other gradients, and would leave the generator elsewhere.
- The port with ``remat=True`` against the JAX encoder with ``remat=True``
  (``nn.remat`` of every layer), dropout off, in f32: outputs
  within 1e-5 and gradients within 1e-4 in relative Frobenius norm, as the
  f32 encoder tests hold them.
- Small models end to end at bf16 with ``remat=True`` (XLNet-MLM at S = 20,
  GPT-2-CLM at S = 128 on the flash path, XLNet-PLM at S = 20), built by
  ``flagship.build_model(dtype=, remat=)`` and loaded with
  ``convert.params_from_jax`` from a JAX model built with both flags (no new
  name rule): one training step with the JAX draw's mask (the loss within
  1e-3 relative, the item table's and every dense weight's gradient within
  8e-2 in relative Frobenius norm, measured up to 4.6e-2: the last flash
  layer's q and k gradients sum 512 rows of dq that each package rounds to
  bf16 on its own), evaluation (the loss within 1e-3 relative, metrics
  within 2e-2) and top-k scores within 3e-2. The JAX side runs ``literal``
  (``test_torch_compute_dtype.py``). At S = 128 the JAX model is built without ``remat``:
  ``nn.remat`` traces the flash context's ``bias_grad`` flag, which the JAX
  ``flash_attention`` takes as a static argument, and raises; remat changes
  none of its values.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import transformers4rec_tpu as jtr
from transformers4rec_tpu.data.synthetic import synthetic_ecommerce_data_schema as jax_schema_fn
from transformers4rec_tpu.masking import CausalLanguageModeling as JaxCLM
from transformers4rec_tpu.masking import MaskedLanguageModeling as JaxMLM
from transformers4rec_tpu.masking import PermutationLanguageModeling as JaxPLM

from test_torch_clm import jax_flash  # noqa: F401  (a fixture)
from test_torch_compute_dtype import (
    BF16, ZERO_GRADIENT, Pair, _inputs, _perturbed, _rel_fro, literal)
from transformers4rec_tpu_torch import convert, flagship
from transformers4rec_tpu_torch.blocks import transformer as tblocks
from transformers4rec_tpu_torch.config.transformer import transformer_registry
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.ops import attention as attn

torch.set_num_threads(1)

D, H, L = 32, 2, 2


# --------------------------------------------------- remat against no remat
def _port_encoder(arch, S, remat, dtype, plm=False, **kw):
    tenc = transformer_registry.parse(arch).build(
        d_model=D, n_head=H, n_layer=L, total_seq_length=S, dropout=0.1, dtype=dtype,
        remat=remat, **kw).to_encoder(masking="plm" if plm else None)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in tenc.modules():
            if hasattr(m, "_init_weights"):
                m._init_weights(gen)
    return tenc


def _step(tenc, S, plm, mems):
    """One training forward and backward from generator seed 3: the loss,
    the gradients (the input's under ``"x"``), the generator's state and the
    number of layer forwards in the step (after the memory's segment)."""
    x, pad, perm = _inputs(S, perm=plm)
    w = torch.from_numpy(np.random.default_rng(8).normal(size=x.shape).astype(np.float32))
    gen = torch.Generator().manual_seed(3)
    kw = {}
    if mems:
        with torch.no_grad():  # a first segment gives the memory
            _, kw["mems"] = tenc(torch.from_numpy(x), pad_mask=torch.from_numpy(pad),
                                 training=True, generator=gen, mems=tenc.init_mems(3),
                                 return_mems=True)
        kw["return_mems"] = True
    calls = []
    hooks = [layer.register_forward_pre_hook(lambda m, a: calls.append(1))
             for layer in set(tenc.stack())]
    xt = torch.from_numpy(x).requires_grad_()
    out = tenc(xt, pad_mask=torch.from_numpy(pad),
               perm_mask=None if perm is None else torch.from_numpy(perm), training=True,
               generator=gen, **kw)
    out = out[0] if mems else out
    loss = (out.float() * w).sum()
    loss.backward()
    for h in hooks:
        h.remove()
    grads = {n: p.grad.clone() for n, p in tenc.named_parameters() if p.grad is not None}
    grads["x"] = xt.grad.clone()
    return loss.detach(), grads, gen.get_state(), len(calls)


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("arch,S,plm,kw", [
    ("xlnet", 8, False, {}),
    ("gpt2", 128, False, {}),
    ("albert", 8, False, {}),
    ("xlnet", 8, True, {}),
    ("transfoxl", 6, False, {"mem_len": 4}),
])
def test_remat_gives_the_bits_of_a_step_without_it(arch, S, plm, kw, dtype, monkeypatch):
    forwards = []
    real = attn.flash_fwd
    monkeypatch.setattr(attn, "flash_fwd", lambda *a: forwards.append(1) or real(*a))
    mems = "mem_len" in kw
    want = _step(_port_encoder(arch, S, False, dtype, plm, **kw), S, plm, mems)
    flash_plain = len(forwards)
    got = _step(_port_encoder(arch, S, True, dtype, plm, **kw), S, plm, mems)
    assert torch.equal(got[0], want[0])
    assert got[1].keys() == want[1].keys()
    for name in want[1]:
        assert torch.equal(got[1][name], want[1][name]), name
    assert torch.equal(got[2], want[2])  # the generator stands where it stood
    # each layer ran again in the backward (ALBERT's one layer n_layer times)
    assert (want[3], got[3]) == (L, 2 * L)
    if S >= 128:  # and so did its flash forward
        assert (flash_plain, len(forwards) - flash_plain) == (L, 2 * L)


def test_remat_without_replay_would_differ(monkeypatch):
    """The check above has teeth: a recompute that draws its masks afresh
    from the generator (no replay) gives other gradients and leaves the
    generator elsewhere; so dropout is drawn in these steps."""
    want = _step(_port_encoder("xlnet", 8, False, BF16), 8, False, False)

    def no_replay(layer, generator, *args):
        return torch.utils.checkpoint.checkpoint(layer, *args, use_reentrant=False,
                                                 preserve_rng_state=False)

    monkeypatch.setattr(tblocks, "rematerialised", no_replay)
    got = _step(_port_encoder("xlnet", 8, True, BF16), 8, False, False)
    assert torch.equal(got[0], want[0])  # the forward is the same
    assert not all(torch.equal(got[1][n], want[1][n]) for n in want[1])
    assert not torch.equal(got[2], want[2])


# --------------------------------------------------- remat against JAX remat
@pytest.mark.parametrize("arch,plm", [("xlnet", False), ("albert", False), ("xlnet", True)])
def test_remat_encoder_matches_jax_remat_in_f32(arch, plm):
    pair = Pair(arch, 8, plm=plm, remat=True)
    want_out, want, _ = pair.run_jax(torch.float32)
    got_out, got, _ = pair.run_port(torch.float32)
    assert pair.port(torch.float32).remat
    assert _rel_fro(got_out, want_out) <= 1e-5
    for name in want:
        if not name.endswith(ZERO_GRADIENT):
            assert _rel_fro(got[name], want[name]) <= 1e-4, name


# ------------------------------------------------------------ small models
V, S_MODEL, LONG = 1000, 20, 128
PLM_KW = {"plm_probability": flagship.PLM_PROBABILITY,
          "max_span_length": flagship.PLM_MAX_SPAN_LENGTH}
SCHEMES = {"mlm": ("xlnet", {"mlm_probability": 0.3}), "clm": ("gpt2", {}),
           "plm": ("xlnet", PLM_KW)}


def _batch(S, seed, rows=8):
    return synthetic_data(flagship.schema(V, S), num_rows=rows, max_session_length=S, seed=seed)


def _model_pair(scheme, S):
    """The JAX model built with ``dtype=bfloat16, remat=True`` (no remat
    at S = 128) and the port's flagship model built with both, the JAX
    weights loaded strictly by the existing name rules."""
    arch, kw = SCHEMES[scheme]
    schema = jax_schema_fn(num_items=V, num_categories=flagship.NUM_CATEGORIES,
                           max_session_length=S)
    im = jtr.TabularSequenceFeatures.from_schema(schema, d_output=D, masking=scheme,
                                                 aggregation="concat", masking_kwargs=kw)
    # JAX's remat traces the flash context's static bias_grad flag and raises
    cfg = jtr.transformer_registry.parse(arch).build(
        d_model=D, n_head=H, n_layer=L, total_seq_length=S, dropout=0.0, dtype=jnp.bfloat16,
        remat=S < 128)
    jmodel = cfg.to_model(im, jtr.NextItemPredictionTask(weight_tying=True))
    key = jax.random.PRNGKey(0)
    init = {k: jnp.asarray(v) for k, v in _batch(S, 0, rows=4).items()}
    params = jax.jit(lambda b: jmodel.init({"params": key, "masking": key, "dropout": key}, b,
                                           targets=b, training=True))(init)
    params = _perturbed(params)
    tmodel = flagship.build_model("cpu", num_items=V, d_model=D, n_layer=L, n_head=H, seq=S,
                                  seed=1, dropout=0.0, scheme=scheme, dtype=BF16, remat=True)
    encoder = tmodel.heads[0].body.blocks[1].encoder
    assert encoder.compute_dtype == BF16 and encoder.remat
    tmodel.load_state_dict(convert.params_from_jax(params))  # strict, no new rule
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    return jmodel, params, tmodel


def _masking_info(scheme, batch, monkeypatch):
    """The JAX draw of ``batch``'s mask, given to the JAX model (patched) and
    as the port's ``masking_info``."""
    ids = jnp.asarray(batch["item_id"])
    key = jax.random.PRNGKey(4)
    extra = {}
    if scheme == "clm":
        info = JaxCLM(hidden_size=D).compute_masked_targets(key, ids, training=True)
        extra["input_schema"] = np.asarray(info.input_schema)
        return convert.masking_info_from_jax(np.asarray(info.targets), np.asarray(info.mask),
                                             np.asarray(info.pad_mask), **extra)
    cls, kw = (JaxMLM, SCHEMES["mlm"][1]) if scheme == "mlm" else (JaxPLM, PLM_KW)
    info = cls(hidden_size=D, **kw).compute_masked_targets(key, ids, training=True)
    original = cls.compute_masked_targets

    def fixed(self, rng, item_ids, training=False, testing=False, segment_ids=None):
        if not training:
            return original(self, rng, item_ids, training, testing, segment_ids)
        return info

    monkeypatch.setattr(cls, "compute_masked_targets", fixed)
    if scheme == "plm":
        extra["perm_mask"] = np.asarray(info.perm_mask)
    return convert.masking_info_from_jax(np.asarray(info.targets), np.asarray(info.mask),
                                         np.asarray(info.pad_mask), **extra)


@pytest.mark.parametrize("scheme,S", [("mlm", S_MODEL), ("clm", LONG), ("plm", S_MODEL)])
def test_a_bf16_remat_model_trains_evaluates_and_ranks_as_jax(scheme, S, jax_flash,  # noqa: F811
                                                              monkeypatch):
    jmodel, params, tmodel = _model_pair(scheme, S)
    batch = _batch(S, 11)
    tinfo = _masking_info(scheme, batch, monkeypatch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rngs = {"masking": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}

    def loss_fn(p):
        return jmodel.apply(p, jb, targets=jb, training=True, compute_metrics=False,
                            rngs=rngs)[0]

    want_loss, want_grads = literal(jax.value_and_grad(loss_fn), params)
    want = convert.params_from_jax(jax.tree.map(np.asarray, want_grads))
    forwards = []
    real = attn.flash_fwd
    monkeypatch.setattr(attn, "flash_fwd", lambda *a: forwards.append(a[0].dtype) or real(*a))
    tb = tmodel._as_dense(batch)
    loss, _ = tmodel(tb, targets=tb, training=True, masking_info=tinfo,
                     generator=torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-3)
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name] is not None and got[name].dtype == torch.float32, name
        if not name.endswith(ZERO_GRADIENT):
            assert _rel_fro(got[name].numpy(), w.numpy()) <= 8e-2, name
    assert float(got["heads.0.body.blocks.0.categorical_module.tables.item_id"].abs().max()) > 0
    # bf16 q, k, v on the flash path; under remat its forward runs again in
    # the backward
    assert forwards == ([BF16] * 2 * L if scheme == "clm" else [])
    # evaluation and top-k
    loader = [_batch(S, 7, rows=6), _batch(S, 8, rows=6)]
    want_eval, got_eval = jmodel.evaluate(loader, params), tmodel.evaluate(loader)
    assert want_eval.keys() == got_eval.keys()
    np.testing.assert_allclose(got_eval["eval_loss"], want_eval["eval_loss"], rtol=1e-3)
    for k in want_eval:
        np.testing.assert_allclose(got_eval[k], want_eval[k], atol=2e-2, err_msg=k)
    small = _batch(S, 5, rows=6)
    want_s, _ = jax.jit(lambda p, b: jmodel.apply(p, b, top_k=10))(
        params, {k: jnp.asarray(v) for k, v in small.items()})
    with torch.inference_mode():
        got_s, _ = tmodel(tmodel._as_dense(small), top_k=10)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=3e-2, rtol=0)


