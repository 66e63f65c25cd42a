"""Causal language modelling with GPT-2 on long sessions: the port against
the JAX package on the CPU.

``CausalLanguageModeling`` is deterministic, so its three branches are held
against the JAX class directly. A small GPT-2-CLM model (V=300, d=32, 2
layers, 2 heads) is built in both packages with the same weights
(``convert.params_from_jax``). At S = 20 both take the dense f32 attention:
1e-5. At S = 128 the port takes its flash path (the plain versions on the
CPU); the JAX package would take its dense path on a CPU, so for these tests
its ``use_flash`` and ``flash_attention`` are patched to run the Pallas
kernels in interpret mode with 128-row blocks, as
``tests/test_attention_kernel.py`` runs them. Both sides then round q, k, v,
P and dS to bf16 at the same places: hidden states within 2e-3, the loss
within 1e-4 relative, every gradient within 5e-3 in relative Frobenius norm
(a rounding that flips in one layer moves the layers above it), evaluation
metrics equal, top-k scores within 2e-3.
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
from transformers4rec_tpu.masking import _predict_all as jax_predict_all
from transformers4rec_tpu.ops import attention as jax_attn

from transformers4rec_tpu_torch import GPT2Config, convert, flagship
from transformers4rec_tpu_torch.blocks import TransformerBlock, check_masking_compat
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.masking import (
    CausalLanguageModeling,
    _predict_all,
    masking_registry,
)
from transformers4rec_tpu_torch.ops import attention as attn

torch.set_num_threads(1)

V, D, L, H, LONG = 300, 32, 2, 2, 128
# a key bias shifts every logit of a query alike and the softmax ignores it:
# its gradient is rounding noise around zero in both packages
ZERO_GRADIENT = "attn.k.bias"


@pytest.fixture
def jax_flash(monkeypatch):
    """Make the JAX model take its flash kernels on the CPU, in interpret
    mode, where the port takes its flash path."""
    real = jax_attn.flash_attention
    calls = []

    def interpreted(q, k, v, bias=None, pad_mask=None, causal=False, bias_grad=False):
        calls.append(q.shape)
        return real(q, k, v, bias, pad_mask, causal, 128, 128, True, bias_grad)

    monkeypatch.setattr(jax_attn, "flash_attention", interpreted)
    monkeypatch.setattr(jax_attn, "use_flash", attn.use_flash)
    return calls


def _ids(seed, rows, S, padding_idx=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, S + 1, rows)
    lengths[0] = S  # one full session
    ids = rng.integers(1, V, (rows, S))
    ids[ids == padding_idx] = padding_idx + 1
    return np.where(np.arange(S)[None, :] < lengths[:, None], ids, padding_idx).astype(np.int64)


# ------------------------------------------------------------------ masking
@pytest.mark.parametrize("padding_idx", [0, 7])
def test_predict_all_matches_jax(padding_idx):
    ids = _ids(0, 6, 10, padding_idx)
    want_l, want_m = jax_predict_all(jnp.asarray(ids), padding_idx)
    got_l, got_m = _predict_all(torch.from_numpy(ids), padding_idx)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


@pytest.mark.parametrize("padding_idx", [0, 7])
@pytest.mark.parametrize("mode,flags", [
    ("training", {}),
    ("training", {"train_on_last_item_seq_only": True}),
    ("testing", {}),
    ("testing", {"eval_on_last_item_seq_only": False}),
    ("inference", {}),
])
def test_clm_branches_match_jax(mode, flags, padding_idx):
    rng = np.random.default_rng(1)
    ids = _ids(2, 6, 10, padding_idx)
    emb = rng.normal(size=(6, 10, D)).astype(np.float32)
    mask_emb = rng.normal(size=(D,)).astype(np.float32)
    kw = dict(training=mode == "training", testing=mode == "testing")
    jm = JaxCLM(hidden_size=D, padding_idx=padding_idx, **flags)
    want_x, want = jm.apply({"params": {"masked_item_embedding": jnp.asarray(mask_emb)}},
                            jnp.asarray(emb), jnp.asarray(ids), **kw,
                            rngs={"masking": jax.random.PRNGKey(0)})
    tm = CausalLanguageModeling(hidden_size=D, padding_idx=padding_idx, **flags)
    with torch.no_grad():
        tm.masked_item_embedding.copy_(torch.from_numpy(mask_emb))
        got_x, got = tm(torch.from_numpy(emb), torch.from_numpy(ids), **kw)
    for f in ("targets", "mask", "input_schema", "pad_mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    if mode == "testing" and not flags:
        assert (got.mask.sum(1) == 1).all()  # the last target only
        assert not torch.equal(got.input_schema, got.mask)
    # a mask carried over from the JAX class replaces the computation
    carried = convert.masking_info_from_jax(np.asarray(want.targets), np.asarray(want.mask),
                                            np.asarray(want.pad_mask),
                                            input_schema=np.asarray(want.input_schema))
    with torch.no_grad():
        again_x, again = tm(torch.from_numpy(emb), torch.from_numpy(ids), **kw,
                            masking_info=carried)
    assert again is carried
    np.testing.assert_array_equal(again_x.numpy(), np.asarray(want_x))


def test_clm_is_registered_under_both_names_and_rejects_segment_ids():
    assert masking_registry.parse("clm") is masking_registry.parse("causal")
    assert masking_registry.parse("clm") is CausalLanguageModeling
    tm = CausalLanguageModeling(hidden_size=4)
    with pytest.raises(NotImplementedError):
        tm(torch.zeros(1, 3, 4), torch.ones(1, 3, dtype=torch.long), training=True,
           segment_ids=torch.ones(1, 3, dtype=torch.long))


def test_masking_info_from_jax_defaults_the_input_schema_to_the_mask():
    mask = np.array([[True, False]])
    info = convert.masking_info_from_jax(np.array([[3, 0]]), mask, mask)
    assert info.input_schema is info.mask
    other = convert.masking_info_from_jax(np.array([[3, 0]]), mask, mask,
                                          input_schema=np.array([[True, True]]))
    assert other.input_schema.tolist() == [[True, True]] and other.mask.tolist() == [[True, False]]


# ------------------------------------------------------------------ encoder
def _encoder_pair(S):
    jenc = jtr.transformer_registry.parse("gpt2").build(
        d_model=D, n_head=H, n_layer=L, total_seq_length=S, dropout=0.0).to_encoder()
    rng = np.random.default_rng(5)
    x = rng.normal(0.0, 1.0, (3, S, D)).astype(np.float32)
    pad = np.arange(S)[None, :] < np.array([S, S // 3, 0])[:, None]  # the last row all padding
    params = jax.tree.map(np.asarray, jenc.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                jnp.asarray(pad)))
    tenc = GPT2Config.build(d_model=D, n_head=H, n_layer=L, total_seq_length=S,
                            dropout=0.0).to_encoder()
    tenc.load_state_dict(convert.params_from_jax(params))
    return jenc, params, tenc, x, pad


def test_gpt2_encoder_matches_jax_on_short_sessions():
    jenc, params, tenc, x, pad = _encoder_pair(20)
    assert tenc.position_embedding.shape == (20, D) and tenc.causal and tenc.rel_pos is None
    want = np.asarray(jenc.apply(params, jnp.asarray(x), jnp.asarray(pad)))
    before = attn.flash_fwd.launches
    with torch.no_grad():
        got = tenc(torch.from_numpy(x), pad_mask=torch.from_numpy(pad)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert attn.flash_fwd.launches == before


def test_gpt2_encoder_matches_jax_on_long_sessions(jax_flash, monkeypatch):
    jenc, params, tenc, x, pad = _encoder_pair(LONG)
    want = np.asarray(jenc.apply(params, jnp.asarray(x), jnp.asarray(pad)))
    # the JAX side took its kernels too (at init and at apply)
    assert len(jax_flash) >= L and set(jax_flash) == {(3, LONG, H, D // H)}
    taken = []
    real = attn.FlashAttention.apply
    monkeypatch.setattr(attn.FlashAttention, "apply",
                        lambda *a: taken.append(a[3:]) or real(*a))
    with torch.no_grad():
        got = tenc(torch.from_numpy(x), pad_mask=torch.from_numpy(pad)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)
    # the flash path, once per layer: no bias, the pad mask, causal, no bias gradient
    assert len(taken) == L
    assert all(b is None and p is not None and c is True and bg is False
               for b, p, c, bg in taken)
    # against the port's own dense f32 path: bf16 noise only
    monkeypatch.setattr("transformers4rec_tpu_torch.blocks.transformer.use_flash",
                        lambda *a: False)
    with torch.no_grad():
        dense = tenc(torch.from_numpy(x), pad_mask=torch.from_numpy(pad)).numpy()
    assert len(taken) == L
    np.testing.assert_allclose(got, dense, atol=3e-2, rtol=5e-2)


def test_a_session_longer_than_the_position_table_raises():
    tenc = GPT2Config.build(d_model=D, n_head=H, n_layer=1, total_seq_length=20).to_encoder()
    assert tenc.max_position == 20
    with pytest.raises(ValueError, match="exceeds max_position=20"):
        tenc(torch.zeros(1, 21, D))
    assert GPT2Config.build(D, H, 1, 4).to_encoder().max_position == 8


def test_masking_compat_is_checked_where_the_body_is_built():
    check_masking_compat("gpt2", "clm")
    check_masking_compat("gpt2", "causal")
    check_masking_compat("xlnet", "mlm")
    check_masking_compat("bert", None)
    with pytest.raises(ValueError, match="bert is not supported with masking scheme 'clm'"):
        check_masking_compat("bert", "clm")
    cfg = GPT2Config.build(D, H, 1, 8)
    with pytest.raises(ValueError, match="gpt2 is not supported"):
        TransformerBlock(cfg, masking="mlm")
    # Head.from_body hands the scheme's name over
    from transformers4rec_tpu_torch.features import TabularSequenceFeatures
    im = TabularSequenceFeatures.from_schema(flagship.schema(50, 8), d_output=D, masking="mlm",
                                             aggregation="concat")
    with pytest.raises(ValueError, match="gpt2 is not supported"):
        cfg.to_model(im, device="cpu")


# -------------------------------------------------------------------- model
def _jax_model(S, scheme="clm"):
    schema = jax_schema_fn(num_items=V, num_categories=flagship.NUM_CATEGORIES,
                           max_session_length=S)
    arch, kw = {"clm": ("gpt2", {}), "mlm": ("xlnet", {"mlm_probability": 0.3})}[scheme]
    im = jtr.TabularSequenceFeatures.from_schema(schema, d_output=D, masking=scheme,
                                                 aggregation="concat", masking_kwargs=kw)
    cfg = jtr.transformer_registry.parse(arch).build(
        d_model=D, n_head=H, n_layer=L, total_seq_length=S, dropout=0.0)
    return cfg.to_model(im, jtr.NextItemPredictionTask(weight_tying=True))


def _batch(S, seed, rows=4):
    return synthetic_data(flagship.schema(V, S), num_rows=rows, max_session_length=S, seed=seed)


def _pair(S, scheme="clm"):
    jmodel = _jax_model(S, scheme)
    init_batch = {k: jnp.asarray(v) for k, v in _batch(S, 0).items()}
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), init_batch)
    tmodel = flagship.build_model("cpu", num_items=V, d_model=D, n_layer=L, n_head=H, seq=S,
                                  seed=1, dropout=0.0, scheme=scheme)
    tmodel.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def long_pair():
    return _pair(LONG)


def _rel_fro(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _compare_training_step(jmodel, params, tmodel, batch, tinfo, loss_rtol, grad_tol):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rngs = {"masking": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}

    def loss_fn(p):
        return jmodel.apply(p, jb, targets=jb, training=True, compute_metrics=False,
                            rngs=rngs)[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = convert.params_from_jax(jax.tree.map(np.asarray, want_grads))
    tb = tmodel._as_dense(batch)
    tmodel.zero_grad(set_to_none=True)
    loss, _ = tmodel(tb, targets=tb, training=True, masking_info=tinfo)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=loss_rtol)
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name] is not None, name
        if name.endswith(ZERO_GRADIENT):
            continue
        assert _rel_fro(got[name].numpy(), w.numpy()) <= grad_tol, name
    return got


def test_clm_model_on_short_sessions_matches_jax_in_f32():
    """S = 20: the dense attention path and no flash kernel in either package."""
    jmodel, params, tmodel = _pair(20)
    before = attn.flash_fwd.launches
    got = _compare_training_step(jmodel, params, tmodel, _batch(20, 3, rows=8), None,
                                 loss_rtol=1e-5, grad_tol=1e-3)
    assert float(got["heads.0.body.blocks.1.encoder.position_embedding"].abs().max()) > 0
    assert attn.flash_fwd.launches == before


def test_clm_training_step_on_long_sessions_matches_jax(long_pair, jax_flash):
    jmodel, params, tmodel = long_pair
    batch = _batch(LONG, 11)
    ids = jnp.asarray(batch["item_id"])
    info = JaxCLM(hidden_size=D).compute_masked_targets(jax.random.PRNGKey(0), ids,
                                                       training=True)
    tinfo = convert.masking_info_from_jax(np.asarray(info.targets), np.asarray(info.mask),
                                          np.asarray(info.pad_mask),
                                          input_schema=np.asarray(info.input_schema))
    got = _compare_training_step(jmodel, params, tmodel, batch, tinfo,
                                 loss_rtol=1e-4, grad_tol=5e-3)
    assert float(got["heads.0.body.blocks.1.encoder.layers.0.attn.q.weight"].abs().max()) > 0
    # CLM sets no loss-row budget: every position is a row of the CE
    assert tmodel.heads[0].tasks[0]._budget_rows(4 * LONG) is None


def test_clm_evaluate_on_long_sessions_matches_jax(long_pair, jax_flash):
    jmodel, params, tmodel = long_pair
    loader = [_batch(LONG, 7, rows=6), _batch(LONG, 8, rows=5)]
    want = jmodel.evaluate(loader, params)
    got = tmodel.evaluate(loader)
    assert want.keys() == got.keys()
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=1e-4)
    for k in want:
        if k != "eval_loss":
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


def test_clm_inference_topk_on_long_sessions_matches_jax(long_pair, jax_flash):
    jmodel, params, tmodel = long_pair
    batch = _batch(LONG, 5, rows=6)
    want_s, want_i = jax.jit(lambda p, b: jmodel.apply(p, b, top_k=10))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        got_s, got_i = tmodel(tmodel._as_dense(batch), top_k=10)
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=2e-3, rtol=0)
    gaps = np.abs(np.diff(want_s, axis=1)) > 4e-3
    clear = np.ones_like(want_i, dtype=bool)
    clear[:, :-1] &= gaps
    clear[:, 1:] &= gaps
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got_i.numpy()[clear], want_i[clear])


def test_xlnet_mlm_on_long_sessions_takes_the_bias_gradient_route(jax_flash, monkeypatch):
    """XLNet at S = 128: the flash forward with the learned relative bias and
    the dense backward that yields its gradient, in both packages."""
    jmodel, params, tmodel = _pair(LONG, "mlm")
    batch = _batch(LONG, 13)
    info = JaxMLM(hidden_size=D, mlm_probability=0.3).compute_masked_targets(
        jax.random.PRNGKey(3), jnp.asarray(batch["item_id"]), training=True)
    monkeypatch.setattr(JaxMLM, "compute_masked_targets", lambda self, *a, **kw: info)
    tinfo = convert.masking_info_from_jax(np.asarray(info.targets), np.asarray(info.mask),
                                          np.asarray(info.pad_mask))
    taken = []
    real = attn.FlashAttention.apply
    monkeypatch.setattr(attn.FlashAttention, "apply",
                        lambda *a: taken.append(a[3:]) or real(*a))
    got = _compare_training_step(jmodel, params, tmodel, batch, tinfo,
                                 loss_rtol=1e-4, grad_tol=5e-3)
    assert len(taken) == L
    assert all(b is not None and b.shape == (1, H, LONG, LONG) and c is False and bg is True
               for b, _, c, bg in taken)
    rel = got["heads.0.body.blocks.1.encoder.rel_pos.rel_bias"]
    assert float(rel.abs().max()) > 0


def test_flagship_clm_trains_two_steps_with_a_falling_loss():
    assert flagship.LONG_SEQ == 256 and flagship.LONG_BATCH == 32
    trainer = flagship.build_trainer("cpu", scheme="clm", num_items=V, d_model=D, n_layer=L,
                                     n_head=H, seq=LONG, batch=4, dropout=0.0)
    assert trainer.args.max_sequence_length == LONG
    assert trainer.args.per_device_train_batch_size == 4
    batch = _batch(LONG, 21)
    trainer._train_dataloader = [batch, batch]
    trainer.args.max_steps, trainer.args.logging_steps = 2, 1
    before = attn.flash_fwd.launches
    trainer.train()
    reads = [h["loss"] for h in trainer.state.log_history if "loss" in h]
    assert len(reads) == 2 and np.isfinite(reads).all() and reads[1] < reads[0]
    assert attn.flash_fwd.launches == before  # CPU tensors launch nothing
    with pytest.raises(ValueError, match="scheme must be one of"):
        flagship.build_model("cpu", scheme="rtd")
    model = flagship.build_clm_model("cpu", num_items=V, d_model=D, n_layer=1, n_head=H, seq=8)
    assert isinstance(model.heads[0].input_module.masking, CausalLanguageModeling)


def test_flagship_xlnet_at_its_own_length_stays_off_the_flash_path(monkeypatch):
    monkeypatch.setattr(attn.FlashAttention, "apply",
                        lambda *a: pytest.fail("flash attention at S = 20"))
    model = flagship.build_model("cpu", num_items=V, d_model=D, n_layer=1, n_head=H)
    batch = synthetic_data(flagship.schema(V), num_rows=4, max_session_length=flagship.SEQ,
                           seed=2)
    tb = model._as_dense(batch)
    loss, _ = model(tb, targets=tb, training=True, generator=torch.Generator().manual_seed(0))
    loss.backward()
    model.evaluate([batch])
    with torch.inference_mode():
        model(tb, top_k=5)  # 21 positions with the [MASK] extension
