"""The BERT family, ELECTRA's RTD scheme and TransfoXL of the port against
the JAX package on the CPU.

- every registered arch: the registry holds the JAX registry's nine names;
  each new arch's encoder (post-LN with the embedding LayerNorm and the erf
  GELU, ALBERT's shared layer, Longformer's local window, TransfoXL's causal
  relative bias) loads the JAX weights strictly and matches the JAX encoder,
  forward and gradients, on the dense path at S = 8 and on the flash path at
  S = 128 (fixture ``jax_flash``: the JAX kernels in interpret mode);
- mirrors of the JAX package's ``tests/test_transformer.py``: ALBERT's
  parameter count, every registered arch's forward, segment memory (the
  recurrence equals the full causal forward, empty memory changes nothing,
  two-stream XLNet with memory, ``mem_len`` reaches the encoder), and the
  recurrence against the JAX encoder's;
- a small model trained one step per scheme, against the JAX model with the
  same weights: ALBERT-MLM and ELECTRA-RTD with the JAX draw's mask, and
  TransfoXL-CLM; each then evaluates one batch alike;
- the RTD helpers: the JAX helpers' outputs given the same noise, and, on the
  port's own draws, replacement only where masked, labels true exactly where
  the id changed, batch sampling only of non-pad ids;
- ``check_masking_compat`` accepts and refuses what the JAX package does.

Tolerances: encoder outputs 1e-5 absolute and gradients 1e-4 in relative
Frobenius norm on the dense path. On the flash path both packages round q,
k, v, P and dS to bf16, and a rounding that lands on the other side in one
package moves every layer above it: outputs are held to 1e-3 in relative
Frobenius norm and 1e-2 per entry, gradients to 5e-3, as the two-stream
flash test of ``test_torch_plm.py`` holds them (measured here: outputs
1.1e-4 to 1.8e-4, at most 4.1e-3 per entry, gradients at most 1.8e-3). The
BERT, RoBERTa and ELECTRA encoders are one configuration (the registry
test holds them equal), so both paths run BERT's for the three; ALBERT's
shared layer is held on the dense path and in a model step, its attention
being BERT's. Model steps: the loss within 1e-5 relative, as
``test_torch_wide_table.py`` holds it, each gradient within 1e-4 (the
CE's residual is rounded to bf16 in both), the evaluation loss within
1e-4 and the metrics within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import transformers4rec_tpu as jtr
from transformers4rec_tpu.blocks.base import MASKING_COMPAT as JAX_COMPAT
from transformers4rec_tpu.blocks.base import check_masking_compat as jax_compat
from transformers4rec_tpu.data.synthetic import synthetic_ecommerce_data_schema as jax_schema_fn
from transformers4rec_tpu.masking import MaskedLanguageModeling as JaxMLM
from transformers4rec_tpu.masking import ReplacementLanguageModeling as JaxRTD

from test_torch_clm import jax_flash  # noqa: F401  (a fixture)
from transformers4rec_tpu_torch import (
    NextItemPredictionTask,
    TabularSequenceFeatures,
    convert,
    flagship,
    transformer_registry,
)
from transformers4rec_tpu_torch.blocks.base import check_masking_compat
from transformers4rec_tpu_torch.blocks.transformer import TransformerEncoder
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.masking import (
    MaskedLanguageModeling,
    ReplacementLanguageModeling,
    masking_registry,
)
from transformers4rec_tpu_torch.ops import attention as attn

torch.set_num_threads(1)

D, H, L = 32, 2, 2
V, S_MODEL, ROWS = 300, 8, 16
NEW_ARCHS = ("bert", "roberta", "electra", "albert", "longformer", "transfoxl")
# a key bias shifts every logit of a query alike and the softmax ignores it:
# its gradient is rounding noise around zero in both packages
ZERO_GRADIENT = "attn.k.bias"


def _rel_fro(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _init(enc: TransformerEncoder) -> TransformerEncoder:
    """A lone encoder's weights drawn as ``Model`` draws them."""
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in enc.modules():
            if hasattr(m, "_init_weights"):
                m._init_weights(gen)
    return enc


def _perturbed(params, seed=9):
    """The JAX init with its LayerNorms moved off (1, 0) and the relative-bias
    table scaled up, so that every weight matters."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        names = [getattr(k, "key", "") for k in path]
        if names[-1] in ("scale", "bias") and any(n.startswith("ln") for n in names):
            return leaf + rng.normal(0.0, 0.1, leaf.shape).astype(leaf.dtype)
        if names[-1] == "rel_bias":
            return leaf * 50
        return leaf

    return jax.tree_util.tree_map_with_path(move, jax.tree.map(np.asarray, params))


def _encoder_pair(arch, S, rows=3, **kw):
    rng = np.random.default_rng(5)
    x = rng.normal(0.0, 1.0, (rows, S, D)).astype(np.float32)
    pad = np.arange(S)[None, :] < np.array([S, S // 3, 0])[:rows, None]  # a row all padding
    jenc = jtr.transformer_registry.parse(arch).build(
        d_model=D, n_head=H, n_layer=L, total_seq_length=S, dropout=0.0, **kw).to_encoder()
    params = _perturbed(jenc.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(pad)))
    tenc = transformer_registry.parse(arch).build(
        d_model=D, n_head=H, n_layer=L, total_seq_length=S, dropout=0.0, **kw).to_encoder()
    tenc.load_state_dict(convert.params_from_jax(params))  # strict
    # and back: every leaf of the JAX tree found, every weight used
    back = convert.params_to_jax(tenc.state_dict(), params)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    return jenc, params, tenc, x, pad


def _encoder_grads(jenc, params, tenc, x, pad):
    """Outputs and the gradients of a fixed projection of them in both
    packages, the input's gradient under ``"x"``."""
    w = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)

    def loss(p, xx):
        return (jenc.apply(p, xx, jnp.asarray(pad)) * w).sum()

    want_out = np.asarray(jax.jit(jenc.apply)(params, jnp.asarray(x), jnp.asarray(pad)))
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    want = {k: v.numpy() for k, v in convert.params_from_jax(jax.tree.map(np.asarray, gp)).items()}
    want["x"] = np.asarray(gx)
    xt = torch.from_numpy(x).requires_grad_()
    out = tenc(xt, pad_mask=torch.from_numpy(pad))
    (out * torch.from_numpy(w)).sum().backward()
    got = {n: p.grad.numpy() for n, p in tenc.named_parameters()}
    got["x"] = xt.grad.numpy()
    assert set(got) == set(want)
    return out.detach().numpy(), want_out, got, want


# ------------------------------------------------------------------ registry
def test_the_registry_holds_the_jax_names_and_reformer_says_what_is_missing():
    assert sorted(transformer_registry.keys()) == sorted(jtr.transformer_registry.keys())
    for arch in NEW_ARCHS:
        tcfg = transformer_registry.parse(arch).build(32, 2, 2, 20)
        jcfg = jtr.transformer_registry.parse(arch).build(32, 2, 2, 20)
        kw = jcfg.encoder_kwargs()
        enc = tcfg.to_encoder()
        assert (tcfg.total_seq_length, tcfg.masking) == (jcfg.total_seq_length, jcfg.masking)
        assert (enc.norm_first, enc.embed_layer_norm, enc.share_layers, enc.local_window,
                enc.causal, enc.pos_encoding, enc.max_position) == (
            kw["norm_first"], kw["embed_layer_norm"], kw["share_layers"], kw["local_window"],
            kw["causal"], kw["pos_encoding"], kw["max_position"]), arch
        assert enc.stack()[0].activation == kw["activation"]
    # the BERT family's three plain members are one configuration
    configs = {a: vars(transformer_registry.parse(a).build(32, 2, 2, 20))
               for a in ("bert", "roberta", "electra")}
    for c in configs.values():
        c.pop("arch"), c.pop("masking")
    assert configs["bert"] == configs["roberta"] == configs["electra"]
    rcfg = transformer_registry.parse("reformer").build(32, 2, 4, 20)
    assert rcfg.attn_layers == jtr.transformer_registry.parse("reformer").build(
        32, 2, 4, 20).attn_layers
    with pytest.raises(NotImplementedError, match="attn_layers.*axial_pos_shape"):
        rcfg.to_encoder()


# ------------------------------------------------------------------ encoders
@pytest.mark.parametrize("arch", ("bert", "albert", "longformer", "transfoxl"))
def test_encoder_matches_jax_on_the_dense_path(arch):
    jenc, params, tenc, x, pad = _encoder_pair(arch, 8)
    before = attn.flash_fwd.launches
    got_out, want_out, got, want = _encoder_grads(jenc, params, tenc, x, pad)
    assert attn.flash_fwd.launches == before
    np.testing.assert_allclose(got_out, want_out, atol=1e-5, rtol=0)
    for name in want:
        if not name.endswith(ZERO_GRADIENT):
            assert _rel_fro(got[name], want[name]) <= 1e-4, name


@pytest.mark.parametrize("arch", ("bert", "longformer", "transfoxl"))
def test_encoder_matches_jax_on_the_flash_path(arch, jax_flash, monkeypatch):  # noqa: F811
    jenc, params, tenc, x, pad = _encoder_pair(arch, 128)
    taken = []
    real = attn.FlashAttention.apply
    monkeypatch.setattr(attn.FlashAttention, "apply",
                        lambda *a: taken.append(a[3:]) or real(*a))
    got_out, want_out, got, want = _encoder_grads(jenc, params, tenc, x, pad)
    assert len(jax_flash) >= L and len(taken) == L
    window = tenc.local_window is not None
    rel = tenc.rel_pos is not None
    for bias, _, causal, bias_grad in taken:
        # Longformer reads its window as a (1, 1, S, S) bias, TransfoXL its
        # relative bias (1, H, S, S) with the dense backward; the BERT family
        # reads no bias
        want_shape = (1, H, 128, 128) if rel else (1, 1, 128, 128) if window else None
        assert (None if bias is None else tuple(bias.shape)) == want_shape
        assert causal is tenc.causal and bias_grad is rel
    assert _rel_fro(got_out, want_out) <= 1e-3
    np.testing.assert_allclose(got_out, want_out, atol=1e-2, rtol=0)
    for name in want:
        if not name.endswith(ZERO_GRADIENT):
            assert _rel_fro(got[name], want[name]) <= 5e-3, name


def test_albert_shares_one_layer_and_its_gradient_sums_its_uses():
    shared = _init(TransformerEncoder(D, 4, 4, dropout=0.0, share_layers=True))
    unshared = _init(TransformerEncoder(D, 4, 4, dropout=0.0))
    n_shared = sum(p.numel() for p in shared.parameters())
    n_unshared = sum(p.numel() for p in unshared.parameters())
    assert n_shared < n_unshared
    # the JAX package's count
    jenc = jtr.TransformerEncoder(d_model=D, n_head=4, n_layer=4, dropout=0.0,
                                  share_layers=True, pos_encoding="relative_bias")
    jcount = sum(a.size for a in jax.tree_util.tree_leaves(
        jax.eval_shape(jenc.init, jax.random.PRNGKey(0), jnp.ones((1, 4, D)))))
    assert n_shared == jcount
    assert not any(k.startswith("layers.") for k in shared.state_dict())
    # the same weights in every layer of the unshared encoder: the same
    # output, and the shared layer's gradient is the sum over its uses
    layer_sd = shared.layer_shared.state_dict()
    for layer in unshared.layers:
        layer.load_state_dict(layer_sd)
    unshared.rel_pos.load_state_dict(shared.rel_pos.state_dict())
    unshared.ln_f.load_state_dict(shared.ln_f.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 6, D)).astype(np.float32))
    outs = [enc(x).sum() for enc in (shared, unshared)]
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-6, atol=1e-5)
    for o in outs:
        o.backward()
    for name, p in shared.layer_shared.named_parameters():
        total = sum(dict(layer.named_parameters())[name].grad for layer in unshared.layers)
        torch.testing.assert_close(p.grad, total, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", sorted(jtr.transformer_registry.keys()))
def test_every_registered_arch_runs_forward(arch):
    cfg = transformer_registry.parse(arch).build(d_model=32, n_head=2, n_layer=1,
                                                 total_seq_length=10)
    if arch == "reformer":
        with pytest.raises(NotImplementedError, match="reformer: not ported yet"):
            cfg.to_encoder()
        return
    # a lone encoder, its weights not drawn by a Model: finite all the same
    out = cfg.to_encoder()(torch.ones(2, 10, 32), pad_mask=torch.ones(2, 10, dtype=torch.bool))
    assert out.shape == (2, 10, 32) and torch.isfinite(out).all()


# ------------------------------------------------------------ segment memory
def _mem_encoder(**kw):
    return _init(TransformerEncoder(**{**dict(d_model=32, n_head=4, n_layer=2, dropout=0.0),
                                       **kw}))


def test_mem_recurrence_matches_the_full_causal_forward():
    S, half = 16, 8
    enc = _mem_encoder(causal=True, pos_encoding="relative_bias", mem_len=half, n_layer=3)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, S, 32)).astype(np.float32))
    with torch.no_grad():
        enc.rel_pos.rel_bias.mul_(50)
        full = enc(x)
        out1, mems = enc(x[:, :half], mems=enc.init_mems(2), return_mems=True)
        out2, _ = enc(x[:, half:], mems=mems, return_mems=True)
    torch.testing.assert_close(out1, full[:, :half], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out2, full[:, half:], rtol=1e-4, atol=1e-5)


def test_empty_mems_change_nothing_and_the_cache_is_detached():
    enc = _mem_encoder(causal=True, pos_encoding="relative_bias", mem_len=4)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 6, 32)).astype(np.float32))
    x.requires_grad_()
    plain = enc(x)
    with_zero, mems = enc(x, mems=enc.init_mems(2), return_mems=True)
    torch.testing.assert_close(with_zero, plain, rtol=1e-5, atol=1e-6)
    # the last mem_len layer inputs, all valid, cut from the graph
    assert mems["states"].shape == (2, 2, 4, 32) and bool(mems["pad"].all())
    assert not mems["states"].requires_grad
    torch.testing.assert_close(mems["states"][0], x[:, 2:].detach())
    # a short segment is left-padded with invalid slots
    _, short = enc(x[:, :3], return_mems=True)
    assert short["pad"].tolist() == [[False, True, True, True]] * 2


def test_mem_recurrence_two_stream_xlnet():
    B, S = 2, 8
    enc = _mem_encoder(pos_encoding="relative_bias", two_stream=True, mem_len=S)
    with torch.no_grad():
        enc.query_stream_init.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(B, S, 32)).astype(np.float32))
    perm = torch.zeros(B, S, S)
    with torch.no_grad():
        out1, mems = enc(x, perm_mask=perm, mems=enc.init_mems(B), return_mems=True)
        out2, _ = enc(x, perm_mask=perm, mems=mems, return_mems=True)
    assert out2.shape == (B, S, 32)
    # the second segment used the memory
    assert float((out2 - out1).abs().max()) > 1e-4


def test_config_mem_len_plumbs_to_encoder():
    cfg = transformer_registry.parse("transfoxl").build(d_model=32, n_head=4, n_layer=2,
                                                        total_seq_length=20, mem_len=16)
    assert cfg.to_encoder().mem_len == 16


def test_mem_recurrence_matches_jax():
    """Two segments through both packages' encoders with the same weights:
    outputs and the carried memory agree, with padding in both segments."""
    B, S, M = 3, 6, 4
    kw = dict(d_model=32, n_head=4, n_layer=2, dropout=0.0, causal=True,
              pos_encoding="relative_bias", mem_len=M)
    jenc = jtr.TransformerEncoder(**kw)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, B, S, 32)).astype(np.float32)
    pad = np.arange(S)[None, :] < np.array([S, 4, 1])[:, None]
    params = _perturbed(jax.jit(lambda xx: jenc.init(
        jax.random.PRNGKey(0), xx, jnp.asarray(pad), mems=jenc.init_mems(B),
        return_mems=True))(jnp.asarray(x[0])))
    tenc = TransformerEncoder(**kw)
    tenc.load_state_dict(convert.params_from_jax(params))
    apply = jax.jit(lambda p, xx, m: jenc.apply(p, xx, jnp.asarray(pad), mems=m,
                                                return_mems=True))
    jm, tm = jenc.init_mems(B), tenc.init_mems(B)
    for seg in range(2):
        want, jm = apply(params, jnp.asarray(x[seg]), jm)
        with torch.no_grad():
            got, tm = tenc(torch.from_numpy(x[seg]), pad_mask=torch.from_numpy(pad), mems=tm,
                           return_mems=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tm["states"].numpy(), np.asarray(jm["states"]), atol=1e-5)
        np.testing.assert_array_equal(tm["pad"].numpy(), np.asarray(jm["pad"]))
    with pytest.raises(NotImplementedError, match="mem_len"):
        tenc(torch.from_numpy(x[0]), segment_ids=torch.ones(B, S, dtype=torch.long),
             mems=tm)


# --------------------------------------------------------------------- models
def _model_pair(arch, masking, masking_kwargs):
    schema = jax_schema_fn(num_items=V, num_categories=flagship.NUM_CATEGORIES,
                           max_session_length=S_MODEL)
    jim = jtr.TabularSequenceFeatures.from_schema(
        schema, d_output=D, masking=masking, aggregation="concat", masking_kwargs=masking_kwargs)
    jcfg = jtr.transformer_registry.parse(arch).build(d_model=D, n_head=H, n_layer=L,
                                                      total_seq_length=S_MODEL, dropout=0.0)
    jmodel = jcfg.to_model(jim, jtr.NextItemPredictionTask(weight_tying=True))
    init = {k: jnp.asarray(v) for k, v in _batch(0, rows=4).items()}
    params = _perturbed(jax.jit(jmodel.init)(jax.random.PRNGKey(0), init))
    tim = TabularSequenceFeatures.from_schema(
        flagship.schema(V, S_MODEL), d_output=D, masking=masking, aggregation="concat",
        masking_kwargs=masking_kwargs)
    tcfg = transformer_registry.parse(arch).build(d_model=D, n_head=H, n_layer=L,
                                                  total_seq_length=S_MODEL, dropout=0.0)
    tmodel = tcfg.to_model(tim, NextItemPredictionTask(weight_tying=True), device="cpu")
    tmodel.load_state_dict(convert.params_from_jax(params))  # strict
    # the other way: the port's weights fill the JAX tree, every leaf found
    back = convert.params_to_jax(tmodel.state_dict(), params)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    return jmodel, params, tmodel


def _batch(seed, rows=ROWS):
    return synthetic_data(flagship.schema(V, S_MODEL), num_rows=rows,
                          max_session_length=S_MODEL, seed=seed)


@pytest.mark.parametrize("arch,masking", [("albert", "mlm"), ("electra", "rtd"),
                                          ("transfoxl", "clm")])
def test_a_training_step_and_an_evaluation_match_jax(arch, masking, monkeypatch):
    kwargs = {} if masking == "clm" else {"mlm_probability": 0.3}
    jmodel, params, tmodel = _model_pair(arch, masking, kwargs)
    batch = _batch(11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = tmodel._as_dense(batch)
    tinfo = None
    if masking != "clm":
        # the JAX draw's mask, given to both (RTD masks as MLM does)
        info = JaxMLM.compute_masked_targets(JaxMLM(hidden_size=D, mlm_probability=0.3),
                                             jax.random.PRNGKey(3),
                                             jnp.asarray(batch["item_id"]), training=True)
        original = JaxMLM.compute_masked_targets

        def jax_masks(self, rng, item_ids, training=False, testing=False, segment_ids=None):
            if not training:
                return original(self, rng, item_ids, training, testing, segment_ids)
            return info

        monkeypatch.setattr(JaxMLM, "compute_masked_targets", jax_masks)
        tinfo = convert.masking_info_from_jax(np.asarray(info.targets), np.asarray(info.mask),
                                              np.asarray(info.pad_mask))
    rngs = {"masking": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    want_loss, want_grads = jax.jit(jax.value_and_grad(lambda p: jmodel.apply(
        p, jb, targets=jb, training=True, compute_metrics=False, rngs=rngs)[0]))(params)
    want = convert.params_from_jax(jax.tree.map(np.asarray, want_grads))
    loss, _ = tmodel(tb, targets=tb, training=True, masking_info=tinfo)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    got = dict(tmodel.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        if not name.endswith(ZERO_GRADIENT):
            assert _rel_fro(p.grad.numpy(), want[name].numpy()) <= 1e-4, name
    if arch == "albert":
        assert any(".layer_shared." in n for n in got)

    loader = [_batch(7), _batch(8, rows=9)]
    want_eval, got_eval = jmodel.evaluate(loader, params), tmodel.evaluate(loader)
    assert want_eval.keys() == got_eval.keys()
    np.testing.assert_allclose(got_eval["eval_loss"], want_eval["eval_loss"], rtol=1e-4)
    for k in want_eval:
        if k != "eval_loss":
            np.testing.assert_allclose(got_eval[k], want_eval[k], atol=1e-6, err_msg=k)


def test_flagship_takes_an_arch_in_place_of_the_schemes():
    model = flagship.build_model("cpu", num_items=V, d_model=16, n_layer=2, n_head=2, seq=8,
                                 arch="albert")
    enc = model.heads[0].body.blocks[1].encoder
    assert enc.share_layers and not enc.norm_first and enc.embed_layer_norm
    assert model.heads[0].tasks[0].budget_target_prob == flagship.MLM_PROBABILITY
    clm = flagship.build_model("cpu", num_items=V, d_model=16, n_layer=1, n_head=2, seq=8,
                               scheme="clm", arch="transfoxl")
    enc = clm.heads[0].body.blocks[1].encoder
    assert enc.causal and enc.rel_pos is not None and not enc.rel_pos.bidirectional
    with pytest.raises(ValueError, match="transfoxl is not supported with masking scheme"):
        flagship.build_model("cpu", num_items=V, d_model=16, n_layer=1, n_head=2, seq=8,
                             arch="transfoxl")


# ----------------------------------------------------------------------- RTD
def _ids(seed, rows=8, seq=10):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, seq + 1, rows)
    ids = rng.integers(1, 50, (rows, seq))
    return np.where(np.arange(seq)[None, :] < lengths[:, None], ids, 0).astype(np.int64)


def test_rtd_is_registered_and_masks_as_mlm():
    assert masking_registry.parse("rtd") is masking_registry.parse("replacement") \
        is ReplacementLanguageModeling
    rtd = ReplacementLanguageModeling(hidden_size=4, mlm_probability=0.3,
                                      sample_from_batch=True)
    mlm = MaskedLanguageModeling(hidden_size=4, mlm_probability=0.3)
    ids = torch.from_numpy(_ids(0))
    for kw in (dict(training=True), dict(testing=True), {}):
        a = rtd.compute_masked_targets(ids, generator=torch.Generator().manual_seed(1), **kw)
        b = mlm.compute_masked_targets(ids, generator=torch.Generator().manual_seed(1), **kw)
        assert torch.equal(a.targets, b.targets) and torch.equal(a.pad_mask, b.pad_mask)


@pytest.mark.parametrize("from_batch", [False, True])
def test_rtd_helpers_match_jax_given_the_same_noise(from_batch):
    ids = _ids(1)
    targets = np.where(np.random.default_rng(2).uniform(size=ids.shape) < 0.4, ids, 0)
    logits = np.random.default_rng(3).normal(0.0, 3.0, ids.shape + (50,)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jrtd = JaxRTD(hidden_size=4, sample_from_batch=from_batch)
    want = jrtd.get_fake_tokens(key, jnp.asarray(ids), jnp.asarray(targets),
                                jnp.asarray(logits))
    if from_batch:
        cum = np.cumsum(ids.reshape(-1) != 0)
        draw = jax.random.randint(key, (ids.size,), 1, max(int(cum[-1]), 1) + 1)
    else:
        draw = jax.random.uniform(key, logits.shape, dtype=jnp.float32)
    trtd = ReplacementLanguageModeling(hidden_size=4, sample_from_batch=from_batch)
    got = trtd.get_fake_tokens(torch.from_numpy(ids), torch.from_numpy(targets),
                               torch.from_numpy(logits), draw=torch.from_numpy(np.array(draw)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("from_batch", [False, True])
def test_rtd_draws_keep_their_invariants(from_batch):
    rtd = ReplacementLanguageModeling(hidden_size=4, sample_from_batch=from_batch)
    for seed in range(20):
        ids = torch.from_numpy(_ids(seed))
        targets = torch.where(torch.rand(ids.shape, generator=torch.Generator().manual_seed(seed))
                              < 0.4, ids, 0)
        logits = torch.randn(ids.shape + (50,), generator=torch.Generator().manual_seed(seed))
        corrupted, labels, samples = rtd.get_fake_tokens(
            ids, targets, logits, generator=torch.Generator().manual_seed(seed))
        masked = targets != 0
        assert torch.equal(corrupted[~masked], ids[~masked])  # replaced only where masked
        assert torch.equal(labels, (corrupted != ids) & masked)  # true exactly where changed
        assert torch.equal(corrupted[masked], samples[masked].to(ids.dtype))
        if from_batch:
            assert set(samples.flatten().tolist()) <= set(ids[ids != 0].tolist())
    # a peaked generator is followed: every sample is its mode
    peaked = torch.full((2, 3, 50), -10.0)
    peaked[..., 7] = 10.0
    assert (ReplacementLanguageModeling.sample_from_softmax(
        peaked, torch.Generator().manual_seed(0)) == 7).all()


# ------------------------------------------------------------ masking compat
def test_masking_compat_matches_jax_for_every_pair():
    schemes = ("clm", "mlm", "plm", "rtd", "causal", "masked", "permutation", "replacement")
    for arch in sorted(JAX_COMPAT) + ["generic"]:
        for scheme in schemes:
            try:
                jax_compat(arch, scheme)
            except ValueError:
                with pytest.raises(ValueError, match="not supported with masking"):
                    check_masking_compat(arch, scheme)
            else:
                check_masking_compat(arch, scheme)
    check_masking_compat("electra", "rtd")
    with pytest.raises(ValueError):
        check_masking_compat("transfoxl", "mlm")
