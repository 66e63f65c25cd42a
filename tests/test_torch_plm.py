"""XLNet's permutation language modelling (PLM) with two-stream attention:
the port against the JAX package on the CPU.

The span sampler and the factorisation order draw from a ``torch.Generator``
where the JAX package draws from its PRNG, so the port's sampler is held to
invariants and to the JAX sampler's masked fraction and number of spans on
the same sessions (within 3σ over 4,096 rows). Everything downstream is held
to the JAX functions on the JAX draw (``convert.masking_info_from_jax``
carries its ``perm_mask``):

- both streams' attention biases, bit for bit (0 / -1e9 tensors);
- the two-stream encoder: dense f32 at S = 8 (outputs and gradients within
  1e-5 relative), flash at S = 128 (the JAX side runs its Pallas kernels in
  interpret mode, fixture ``jax_flash`` of ``test_torch_clm.py``; outputs
  within 2e-3 and gradients within 5e-3 in relative Frobenius norm, single
  outputs within 1e-2: two streams in two layers carry each other's bf16
  roundings);
- a small XLNet-PLM model (about 1,000 items, d_model 32, 2 layers, 2 heads,
  sessions of 20, dropout 0): one training step (the loss within 1e-5
  relative, every gradient within 1e-3 in relative Frobenius norm: the CE's
  residual is rounded to bf16 in both), last-item evaluation (loss 1e-4,
  metrics 1e-6) and top-k;
- the information flow of HF's XLNet under the reference's ``perm_mask``
  (the JAX package's ``tests/test_hf_golden.py``, for the port's encoder).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import transformers4rec_tpu as jtr
from transformers4rec_tpu.blocks.transformer import make_attention_bias as jax_bias
from transformers4rec_tpu.blocks.transformer import make_extra_bias as jax_extra_bias
from transformers4rec_tpu.data.synthetic import synthetic_ecommerce_data_schema as jax_schema_fn
from transformers4rec_tpu.masking import PermutationLanguageModeling as JaxPLM

from test_torch_clm import jax_flash  # noqa: F401  (a fixture)
from transformers4rec_tpu_torch import XLNetConfig, convert, flagship
from transformers4rec_tpu_torch.blocks.transformer import make_attention_bias, make_extra_bias
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.masking import PermutationLanguageModeling, masking_registry
from transformers4rec_tpu_torch.ops import attention as attn

torch.set_num_threads(1)

V, D, L, H, S = 1000, 32, 2, 2, 20
PLM_KW = {"plm_probability": flagship.PLM_PROBABILITY,
          "max_span_length": flagship.PLM_MAX_SPAN_LENGTH}
# a key bias shifts every logit of a query alike and the softmax ignores it:
# its gradient is rounding noise around zero in both packages
ZERO_GRADIENT = "attn.k.bias"


def _ids(seed, rows, seq, min_len=2):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(min_len, seq + 1, rows)
    lengths[0] = seq
    ids = rng.integers(1, V, (rows, seq))
    return np.where(np.arange(seq)[None, :] < lengths[:, None], ids, 0).astype(np.int64)


def _jax_draw(ids, seed=0, **kw):
    plm = JaxPLM(hidden_size=D, **{**PLM_KW, **kw})
    return plm.compute_masked_targets(jax.random.PRNGKey(seed), jnp.asarray(ids), training=True)


def _rel_fro(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _runs(mask):
    """Lengths of the maximal runs of True in each row."""
    out = []
    for row in mask:
        n = 0
        for m in list(row) + [False]:
            if m:
                n += 1
            elif n:
                out.append(n)
                n = 0
    return out


# ------------------------------------------------------------------ masking
def test_plm_is_registered_under_both_names_and_rejects_segment_ids():
    assert masking_registry.parse("plm") is masking_registry.parse("permutation")
    assert masking_registry.parse("plm") is PermutationLanguageModeling
    tm = PermutationLanguageModeling(hidden_size=4)
    # packed rows train and evaluate (tests/test_torch_packing.py); serving
    # refuses them, as the JAX package does
    with pytest.raises(NotImplementedError, match="unpacked"):
        tm(torch.zeros(1, 3, 4), torch.ones(1, 3, dtype=torch.long),
           segment_ids=torch.ones(1, 3, dtype=torch.long))


def test_the_sampler_keeps_its_invariants_and_the_jax_samplers_rates():
    rows = 4096
    ids = _ids(1, rows, S)
    non_pad = ids != 0
    tm = PermutationLanguageModeling(hidden_size=D, **PLM_KW)
    info = tm.compute_masked_targets(torch.from_numpy(ids), training=True,
                                     generator=torch.Generator().manual_seed(0))
    mask, perm = info.mask.numpy(), info.perm_mask.numpy()
    np.testing.assert_array_equal(info.targets.numpy(), np.where(mask, ids, 0))
    assert info.input_schema is info.mask
    np.testing.assert_array_equal(info.pad_mask.numpy(), non_pad)
    # spans inside each session, at least one masked and one unmasked item a row
    assert not (mask & ~non_pad).any()
    assert mask.any(1).all() and (non_pad & ~mask).any(1).all()
    # the perm mask: a masked key is hidden from every position at or after it
    # in one order of the row's masked items; unmasked keys from no one
    assert not perm[~np.broadcast_to(mask[:, None, :], perm.shape)].any()
    assert set(np.unique(perm)) <= {0.0, 1.0}
    for b in range(64):
        m = np.where(mask[b])[0]
        sub = perm[b][np.ix_(m, m)]
        assert np.diag(sub).all()
        off = ~np.eye(len(m), dtype=bool)
        assert ((sub + sub.T)[off] == 1).all()  # exactly one of each pair sees the other
        # the keys a masked item may see, counted, are its place in the order
        assert sorted((1 - sub).sum(1).astype(int)) == list(range(len(m)))
        u = np.where(non_pad[b] & ~mask[b])[0]
        np.testing.assert_array_equal(perm[b][u], np.broadcast_to(mask[b], (len(u), S)))
    # a span's items stay inside its segment: a run is at most two spans
    assert max(_runs(mask)) <= 2 * flagship.PLM_MAX_SPAN_LENGTH
    # the masked fraction and the number of spans, against the JAX sampler
    want = np.asarray(_jax_draw(ids).mask)
    for stat in (lambda m: m.sum(1), lambda m: np.array([len(_runs(r[None])) for r in m])):
        a, b = stat(mask).astype(float), stat(want).astype(float)
        sigma = np.sqrt((a.var() + b.var()) / rows)
        assert abs(a.mean() - b.mean()) < 3 * sigma, (a.mean(), b.mean(), sigma)


def test_permute_all_masks_every_item_but_one():
    ids = _ids(2, 64, S, min_len=3)
    tm = PermutationLanguageModeling(hidden_size=D, permute_all=True)
    info = tm.compute_masked_targets(torch.from_numpy(ids), training=True,
                                     generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(info.mask.sum(1).numpy(), (ids != 0).sum(1) - 1)


@pytest.mark.parametrize("last_only", [True, False])
@pytest.mark.parametrize("testing", [True, False])
def test_evaluation_and_inference_branches_match_jax(last_only, testing):
    ids = _ids(3, 6, S)
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(6, S, D)).astype(np.float32)
    mask_emb = rng.normal(size=(D,)).astype(np.float32)
    jm = JaxPLM(hidden_size=D, eval_on_last_item_seq_only=last_only, **PLM_KW)
    want_x, want = jm.apply({"params": {"masked_item_embedding": jnp.asarray(mask_emb)}},
                            jnp.asarray(emb), jnp.asarray(ids), testing=testing)
    tm = PermutationLanguageModeling(hidden_size=D, eval_on_last_item_seq_only=last_only,
                                     **PLM_KW)
    with torch.no_grad():
        tm.masked_item_embedding.copy_(torch.from_numpy(mask_emb))
        got_x, got = tm(torch.from_numpy(emb), torch.from_numpy(ids), testing=testing)
    for f in ("targets", "mask", "input_schema", "pad_mask", "perm_mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))


@pytest.mark.parametrize("query_stream", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_both_streams_biases_match_jax(query_stream, causal):
    ids = _ids(5, 7, S)
    info = _jax_draw(ids, seed=2)
    pad, perm = ids != 0, np.array(info.perm_mask)
    want = jax_bias(jnp.asarray(pad), S, causal=causal, perm_mask=jnp.asarray(perm),
                    local_window=3, query_stream=query_stream)
    got = make_attention_bias(torch.from_numpy(pad), S, causal=causal,
                              perm_mask=torch.from_numpy(perm), local_window=3,
                              query_stream=query_stream)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_x = jax_extra_bias(S, jnp.asarray(perm), None, query_stream=query_stream)
    got_x = make_extra_bias(S, torch.from_numpy(perm), None, query_stream=query_stream)
    assert got_x.shape == (7, 1, S, S)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    # the streams differ on the diagonal only
    other = make_extra_bias(S, torch.from_numpy(perm), None, query_stream=not query_stream)
    differ = (got_x != other)[:, 0]
    assert differ.any() and not (differ & ~torch.eye(S, dtype=torch.bool)).any()


# ------------------------------------------------------------------ encoder
def _encoder_pair(seq, rows, scale=50.0):
    ids = _ids(6, rows, seq)
    info = _jax_draw(ids, seed=3)
    x = np.random.default_rng(7).normal(0.0, 1.0, (rows, seq, D)).astype(np.float32)
    pad, perm = ids != 0, np.array(info.perm_mask)
    jenc = jtr.XLNetConfig.build(d_model=D, n_head=H, n_layer=L, total_seq_length=seq,
                                 dropout=0.0).to_encoder()
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(pad),
                       jnp.asarray(perm))
    params = jax.tree.map(np.asarray, params)
    # the rel-bias table starts at N(0, 0.02): scaled up, the bias matters
    params["params"]["rel_pos"]["rel_bias"] = params["params"]["rel_pos"]["rel_bias"] * scale
    tenc = XLNetConfig.build(d_model=D, n_head=H, n_layer=L, total_seq_length=seq,
                             dropout=0.0).to_encoder(masking="plm")
    assert tenc.two_stream
    tenc.load_state_dict(convert.params_from_jax(params))
    return jenc, params, tenc, x, pad, perm


def _encoder_grads(jenc, params, tenc, x, pad, perm):
    """Outputs and the gradients of a fixed projection of them, in both
    packages: ``(got_out, want_out, got_grads, want_grads)``, the input's
    gradient under ``"x"``."""
    w = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)

    def loss(p, xx):
        return (jenc.apply(p, xx, jnp.asarray(pad), jnp.asarray(perm)) * w).sum()

    want_out = np.asarray(jax.jit(jenc.apply)(params, jnp.asarray(x), jnp.asarray(pad),
                                              jnp.asarray(perm)))
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    want = {k: v.numpy() for k, v in convert.params_from_jax(jax.tree.map(np.asarray, gp)).items()}
    want["x"] = np.asarray(gx)
    xt = torch.from_numpy(x).requires_grad_()
    out = tenc(xt, pad_mask=torch.from_numpy(pad), perm_mask=torch.from_numpy(perm))
    (out * torch.from_numpy(w)).sum().backward()
    got = {n: p.grad.numpy() for n, p in tenc.named_parameters()}
    got["x"] = xt.grad.numpy()
    assert set(got) == set(want)
    return out.detach().numpy(), want_out, got, want


def test_two_stream_encoder_matches_jax_in_f32():
    jenc, params, tenc, x, pad, perm = _encoder_pair(8, 5)
    before = attn.flash_fwd.launches
    got_out, want_out, got, want = _encoder_grads(jenc, params, tenc, x, pad, perm)
    assert attn.flash_fwd.launches == before
    np.testing.assert_allclose(got_out, want_out, atol=1e-5, rtol=1e-5)
    for name in want:
        if name.endswith(ZERO_GRADIENT):
            continue
        assert _rel_fro(got[name], want[name]) <= 1e-5, name
    assert np.abs(got["query_stream_init"]).max() > 0
    # the query stream's output is not the content stream's
    tenc.two_stream = False
    with torch.no_grad():
        content = tenc(torch.from_numpy(x), pad_mask=torch.from_numpy(pad),
                       perm_mask=torch.from_numpy(perm)).numpy()
    assert np.abs(content - got_out).max() > 1e-2


def test_two_stream_encoder_matches_jax_on_the_flash_path(jax_flash, monkeypatch):  # noqa: F811
    jenc, params, tenc, x, pad, perm = _encoder_pair(128, 3)
    taken = []
    real = attn.FlashAttention.apply
    monkeypatch.setattr(attn.FlashAttention, "apply",
                        lambda *a: taken.append(a[3:]) or real(*a))
    got_out, want_out, got, want = _encoder_grads(jenc, params, tenc, x, pad, perm)
    # both packages took the flash path: each stream of each layer, with the
    # perm mask and the relative bias as one (B, H, S, S) tensor and its
    # gradient through the dense backward
    assert len(jax_flash) >= 2 * L
    assert len(taken) == 2 * L
    assert all(b.shape == (3, H, 128, 128) and c is False and bg is True
               for b, _, c, bg in taken)
    # a bf16 rounding of P that lands on the other side in one stream moves
    # every layer above it: the whole output is held to the attention tests'
    # 2e-3 in relative Frobenius norm, single entries to 1e-2
    assert _rel_fro(got_out, want_out) <= 2e-3
    np.testing.assert_allclose(got_out, want_out, atol=1e-2, rtol=0)
    for name in want:
        if name.endswith(ZERO_GRADIENT):
            continue
        assert _rel_fro(got[name], want[name]) <= 5e-3, name


# -------------------------------------------------------------------- model
def _batch(seed, rows=16, seq=S):
    return synthetic_data(flagship.schema(V, seq), num_rows=rows, max_session_length=seq,
                          seed=seed)


@pytest.fixture(scope="module")
def pair():
    schema = jax_schema_fn(num_items=V, num_categories=flagship.NUM_CATEGORIES,
                           max_session_length=S)
    im = jtr.TabularSequenceFeatures.from_schema(schema, d_output=D, masking="plm",
                                                 aggregation="concat", masking_kwargs=PLM_KW)
    cfg = jtr.XLNetConfig.build(d_model=D, n_head=H, n_layer=L, total_seq_length=S, dropout=0.0)
    jmodel = cfg.to_model(im, jtr.NextItemPredictionTask(weight_tying=True))
    init_batch = {k: jnp.asarray(v) for k, v in _batch(0, rows=4).items()}
    # initialised in training, as the JAX trainer does: PLM reads its [MASK]
    # embedding only there
    key = jax.random.PRNGKey(0)
    params = jax.jit(lambda b: jmodel.init({"params": key, "masking": key, "dropout": key}, b,
                                           targets=b, training=True))(init_batch)
    params = jax.tree.map(np.asarray, params)
    # scale the rel-bias tables up so they matter
    enc = params["params"]["heads_0"]["body"]["blocks_1"]["TransformerEncoder_0"]
    enc["rel_pos"]["rel_bias"] = enc["rel_pos"]["rel_bias"] * 50
    tmodel = flagship.build_model("cpu", num_items=V, d_model=D, n_layer=L, n_head=H,
                                  seed=1, dropout=0.0, scheme="plm")
    tmodel.load_state_dict(convert.params_from_jax(params))
    return jmodel, params, tmodel


def test_the_flagship_plm_scheme_is_xlnet_with_two_streams_and_no_budget(pair):
    _, params, tmodel = pair
    masking = tmodel.heads[0].input_module.masking
    assert isinstance(masking, PermutationLanguageModeling)
    assert (masking.plm_probability, masking.max_span_length, masking.permute_all) == (
        0.25, 5, False)
    encoder = tmodel.heads[0].body.blocks[1].encoder
    assert encoder.two_stream and encoder.query_stream_init.shape == (D,)
    # PLM gets no loss-row budget: every one of the B*S positions is a CE row
    task = tmodel.heads[0].tasks[0]
    assert task.budget_target_prob is None and task._budget_rows(128 * 20) is None
    # XLNet under MLM builds no query stream (the JAX tree has no such weight)
    mlm = flagship.build_model("cpu", num_items=V, d_model=D, n_layer=1, n_head=H)
    assert not mlm.heads[0].body.blocks[1].encoder.two_stream
    assert not any("query_stream" in n for n, _ in mlm.named_parameters())


def test_one_plm_training_step_matches_jax(pair, monkeypatch):
    jmodel, params, tmodel = pair
    batch = _batch(11)
    info = _jax_draw(np.asarray(batch["item_id"]), seed=4)
    original = JaxPLM.compute_masked_targets

    def jax_masks(self, rng, item_ids, training=False, testing=False, segment_ids=None):
        if not training:
            return original(self, rng, item_ids, training, testing, segment_ids)
        return info

    monkeypatch.setattr(JaxPLM, "compute_masked_targets", jax_masks)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rngs = {"masking": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}

    def loss_fn(p):
        return jmodel.apply(p, jb, targets=jb, training=True, compute_metrics=False,
                            rngs=rngs)[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = convert.params_from_jax(jax.tree.map(np.asarray, want_grads))
    tinfo = convert.masking_info_from_jax(np.asarray(info.targets), np.asarray(info.mask),
                                          np.asarray(info.pad_mask),
                                          perm_mask=np.asarray(info.perm_mask))
    tmodel.zero_grad(set_to_none=True)
    tb = tmodel._as_dense(batch)
    loss, outs = tmodel(tb, targets=tb, training=True, masking_info=tinfo)
    loss.backward()
    # every position is a row of the CE
    assert outs["next-item"].labels.shape == (16 * S,)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(got) == set(want) and all(g is not None for g in got.values())
    for name in ("heads.0.body.blocks.1.encoder.query_stream_init",
                 "heads.0.body.blocks.1.encoder.rel_pos.rel_bias",
                 "heads.0.body.blocks.0.categorical_module.tables.item_id"):
        assert float(got[name].abs().max()) > 0, name
    for name in sorted(want):
        if name.endswith(ZERO_GRADIENT):
            continue
        assert _rel_fro(got[name].numpy(), want[name].numpy()) <= 1e-3, name
    tmodel.zero_grad(set_to_none=True)


def test_plm_last_item_evaluation_and_topk_match_jax(pair):
    jmodel, params, tmodel = pair
    loader = [_batch(7), _batch(8, rows=9)]
    want = jmodel.evaluate(loader, params)
    got = tmodel.evaluate(loader)
    assert want.keys() == got.keys()
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=1e-4)
    for k in want:
        if k != "eval_loss":
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    batch = _batch(5, rows=6)
    want_s, want_i = jax.jit(lambda p, b: jmodel.apply(p, b, top_k=10))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        got_s, got_i = tmodel(tmodel._as_dense(batch), top_k=10)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_the_plm_trainer_takes_two_steps_with_a_falling_loss():
    trainer = flagship.build_trainer("cpu", scheme="plm", num_items=V, d_model=D, n_layer=L,
                                     n_head=H, batch=8, dropout=0.0)
    assert trainer.args.max_sequence_length == S and trainer.args.per_device_train_batch_size == 8
    batch = _batch(21, rows=8)
    trainer._train_dataloader = [batch, batch]
    trainer.args.max_steps, trainer.args.logging_steps = 2, 1
    trainer.train()
    reads = [h["loss"] for h in trainer.state.log_history if "loss" in h]
    assert len(reads) == 2 and np.isfinite(reads).all() and reads[1] < reads[0]


# --------------------------------------------- information flow against HF
def _reference_plm_perm_mask(rng, seq, mask_labels):
    """perm_mask by the reference's factorisation-order formula:
    perm_mask[i, j] = (idx[i] <= idx[j]) & masked[j], positions not masked
    pinned to index -1."""
    perm_index = rng.permutation(seq).astype(np.int64)
    perm_index[~mask_labels] = -1
    return ((perm_index[:, None] <= perm_index[None, :]) & mask_labels[None, :]).astype(
        np.float32)


def _dependency_matrix(forward, x, tol=1e-3):
    """dep[t, p]: does output position t depend on input position p? The
    perturbation is a random direction (a constant shift would sit in
    LayerNorm's null space)."""
    base = forward(x)
    seq = x.shape[1]
    noise_rng = np.random.default_rng(99)
    dep = np.zeros((seq, seq), bool)
    for p in range(seq):
        xp = x.copy()
        xp[0, p] += noise_rng.normal(size=x.shape[-1]).astype(np.float32) * 3.0
        dep[:, p] = np.abs(forward(xp) - base).max(axis=-1)[0] > tol
    return dep


def test_plm_two_stream_information_flow_matches_hf_xlnet():
    transformers = pytest.importorskip("transformers")
    Dg, Hg, Lg, Sg = 32, 2, 2, 8
    rng = np.random.default_rng(3)
    mask_labels = np.zeros(Sg, bool)
    mask_labels[[2, 5, 6]] = True
    perm = _reference_plm_perm_mask(rng, Sg, mask_labels)
    x = rng.normal(size=(1, Sg, Dg)).astype(np.float32)

    torch.manual_seed(0)
    hf = transformers.XLNetModel(transformers.XLNetConfig(
        vocab_size=1, d_model=Dg, n_layer=Lg, n_head=Hg, d_inner=4 * Dg, dropout=0.0,
        attn_type="bi", bi_data=False, mem_len=None))
    hf.eval()

    def hf_forward(xnp):
        with torch.no_grad():
            return hf(inputs_embeds=torch.from_numpy(xnp), perm_mask=torch.from_numpy(perm)[None],
                      target_mapping=torch.eye(Sg)[None]).last_hidden_state.numpy()

    enc = XLNetConfig.build(d_model=Dg, n_head=Hg, n_layer=Lg, total_seq_length=Sg,
                            dropout=0.0).to_encoder(masking="plm")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for module in enc.modules():
            init = getattr(module, "_init_weights", None)
            if init is not None:
                init(gen)
    enc.eval()

    def our_forward(xnp):
        with torch.no_grad():
            return enc(torch.from_numpy(xnp), perm_mask=torch.from_numpy(perm)[None]).numpy()

    hf_dep, our_dep = _dependency_matrix(hf_forward, x), _dependency_matrix(our_forward, x)
    # the loss reads only the masked positions' query-stream outputs
    masked = np.where(mask_labels)[0]
    np.testing.assert_array_equal(our_dep[masked], hf_dep[masked])
    for t in masked:
        # a masked target never sees its own content, nor a masked position
        # later in the factorisation order
        assert not our_dep[t, t] and not hf_dep[t, t]
        assert not our_dep[t][mask_labels & (perm[t] > 0)].any()
    assert our_dep[masked][:, ~mask_labels].any()
