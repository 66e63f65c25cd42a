"""Reformer in the port against the JAX package on the CPU: LSH attention
(``ops/lsh_attention.py``), axial positions and the per-layer pattern.

The JAX package draws an LSH layer's rotations with its PRNG from the
layer's index; the port holds them as a buffer drawn from a
``torch.Generator``. Every comparison here computes the JAX rotations with
JAX and hands them to the port (``convert.params_from_jax(...,
lsh_rotations=...)`` for a whole model or encoder).

- ``lsh_reference`` and the sorted-chunk path against the JAX functions
  (causal or not, padded, one chunk or several, a sequence off the chunk
  size): the hash buckets agree except where float32 summation order can
  flip an argmax, and every such flip must be a near tie (the top two of
  ``[xR, -xR]`` within 1e-5); the outputs agree within 1e-5 on every batch
  row that no flip touches;
- the sorted path equals the dense path when one chunk covers the
  sequence, and the short-sequence dispatch is the dense path itself;
- axial positions are ``axial_pos_0[p // d2] ++ axial_pos_1[p % d2]``;
  ``ReformerConfig.build`` gives the JAX config field for field;
- the Reformer encoder (local and LSH layers in turn, axial positions) at
  S = 22 (the dense LSH path) and S = 100 (sorted, chunks of 16): outputs
  within 1e-5, gradients within 1e-4 in relative Frobenius norm; a
  Reformer-MLM model's training step with the JAX draw's mask (loss 1e-5
  relative, gradients 1e-4) and its evaluation (loss 1e-4, metrics 1e-6);
- every refusal of the JAX encoder raises in the port, and the rotations
  ride in the ``state_dict`` (``Model.save``/``load`` keep them).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import transformers4rec_tpu as jtr
from transformers4rec_tpu.data.synthetic import synthetic_ecommerce_data_schema as jax_schema_fn
from transformers4rec_tpu.masking import MaskedLanguageModeling as JaxMLM
from transformers4rec_tpu.ops import lsh_attention as jlsh

from transformers4rec_tpu_torch import (
    NextItemPredictionTask,
    TabularSequenceFeatures,
    convert,
    flagship,
    transformer_registry,
)
from transformers4rec_tpu_torch.blocks.transformer import TransformerEncoder
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.ops import lsh_attention as tlsh

torch.set_num_threads(1)

D, H = 32, 2
TIE_MARGIN = 1e-5


def _rel_fro(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _jax_rotations(seed, dh, hashes, buckets):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (dh, hashes, buckets // 2),
                                        dtype=jnp.float32))


def _flips(qk, rot, seed):
    """Rows (batch index) whose buckets differ between the packages, after
    asserting that every differing bucket is a near tie."""
    k = np.asarray(jlsh._normalize_keys(jnp.asarray(qk)))
    want = np.asarray(jlsh._hash_buckets(jnp.asarray(k), 2 * rot.shape[2], rot.shape[1], seed))
    got = tlsh.hash_buckets(tlsh._normalize_keys(torch.from_numpy(qk)),
                            torch.from_numpy(rot)).numpy()
    diff = got != want
    if diff.any():
        proj = np.einsum("bshd,drn->bshrn", k.astype(np.float64), rot.astype(np.float64))
        both = np.sort(np.concatenate([proj, -proj], -1), -1)
        gap = both[..., -1] - both[..., -2]
        assert (gap[diff] <= TIE_MARGIN).all(), gap[diff]
    return set(np.nonzero(diff)[0].tolist())


@pytest.mark.parametrize("S,chunk,causal,pad,force", [
    (20, 8, False, True, False),    # the dense form below LSH_MIN_SEQ
    (20, 8, True, False, False),
    (100, 16, False, True, False),  # sorted, 7 chunks, off the chunk size
    (128, 16, True, True, False),
    (37, 8, True, True, True),      # sorted below LSH_MIN_SEQ
])
def test_lsh_attention_matches_jax(S, chunk, causal, pad, force):
    rng = np.random.default_rng(S + chunk)
    B, Dh, R, nb, seed = 3, 8, 2, 6, 3
    qk = rng.normal(size=(B, S, H, Dh)).astype(np.float32)
    v = rng.normal(size=(B, S, H, Dh)).astype(np.float32)
    pm = (np.arange(S)[None] < np.array([S, S - 13, 5])[:, None]) if pad else None
    rot = _jax_rotations(seed, Dh, R, nb)
    flipped = _flips(qk, rot, seed)
    want = np.asarray(jlsh.lsh_attention(
        jnp.asarray(qk), jnp.asarray(v), None if pm is None else jnp.asarray(pm), causal=causal,
        num_buckets=nb, num_hashes=R, chunk_size=chunk, seed=seed, force_sorted=force))
    got = tlsh.lsh_attention(torch.from_numpy(qk), torch.from_numpy(v), torch.from_numpy(rot),
                             None if pm is None else torch.from_numpy(pm), causal=causal,
                             chunk_size=chunk, force_sorted=force).numpy()
    rows = [b for b in range(B) if b not in flipped]
    assert rows
    np.testing.assert_allclose(got[rows], want[rows], atol=1e-5, rtol=0)
    ref = tlsh.lsh_reference(torch.from_numpy(qk), torch.from_numpy(v),
                             None if pm is None else torch.from_numpy(pm), causal).numpy()
    want_ref = np.asarray(jlsh.lsh_reference(jnp.asarray(qk), jnp.asarray(v),
                                             None if pm is None else jnp.asarray(pm), causal))
    np.testing.assert_allclose(ref, want_ref, atol=1e-5, rtol=0)
    if S < tlsh.LSH_MIN_SEQ and not force:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("causal", [False, True])
def test_sorted_path_equals_dense_when_one_chunk_covers_the_sequence(causal):
    rng = np.random.default_rng(2)
    S = 16
    qk = torch.from_numpy(rng.normal(size=(2, S, H, 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, S, H, 8)).astype(np.float32))
    pad = torch.from_numpy(rng.random((2, S)) > 0.25)
    rot = tlsh.draw_rotations(8, 3, 4, seed=0)
    got = tlsh.lsh_attention(qk, v, rot, pad, causal, chunk_size=S, force_sorted=True)
    torch.testing.assert_close(got, tlsh.lsh_reference(qk, v, pad, causal), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="even"):
        tlsh.draw_rotations(8, 2, 7, seed=0)


def test_axial_positions_and_the_config():
    enc = TransformerEncoder(d_model=D, n_head=H, n_layer=0, dropout=0.0, norm_first=False,
                             pos_encoding="axial", max_position=22, axial_pos_shape=(4, 6),
                             axial_pos_embds_dim=(12, 20))
    with torch.no_grad():
        enc.axial_pos_0.normal_(generator=torch.Generator().manual_seed(0))
        enc.axial_pos_1.normal_(generator=torch.Generator().manual_seed(1))
        out = enc(torch.zeros(1, 22, D))[0]
    p = torch.arange(22)
    torch.testing.assert_close(out, torch.cat([enc.axial_pos_0[p // 6], enc.axial_pos_1[p % 6]],
                                              -1), rtol=0, atol=0)
    for args, kw in [((64, 4, 4, 20), {}), ((64, 4, 2, 20), {}), ((64, 4, 3, 2048), {}),
                     ((32, 2, 4, 256), {}), ((64, 4, 4, 2048), {"lsh_chunk_size": 32,
                                                                 "lsh_num_buckets": 16}),
                     ((48, 4, 4, 20), {"local_attn_chunk_length": 4,
                                       "axial_pos_shape_first_dim": 2})]:
        got = vars(transformer_registry.parse("reformer").build(*args, **kw))
        want = vars(jtr.transformer_registry.parse("reformer").build(*args, **kw))
        assert got == want, args


def _encoder_pair(S, **kw):
    L = 4
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, S, D)).astype(np.float32)
    pad = np.arange(S)[None] < np.array([S, S // 3, 2])[:, None]
    build = dict(d_model=D, n_head=H, n_layer=L, total_seq_length=S - 2, dropout=0.0, **kw)
    jcfg = jtr.transformer_registry.parse("reformer").build(**build)
    jenc = jcfg.to_encoder()
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(pad))
    # every weight off its init, so that each one matters
    noise = np.random.default_rng(1)
    params = jax.tree.map(lambda a: np.asarray(a) + noise.normal(0, 0.05, a.shape).astype(
        np.float32), params)
    rots = {f"layer_{i}": _jax_rotations(i, D // H, jcfg.lsh_num_hashes, jcfg.lsh_num_buckets)
            for i in range(L)}
    tenc = transformer_registry.parse("reformer").build(**build).to_encoder()
    tenc.load_state_dict(convert.params_from_jax(params, lsh_rotations=rots))  # strict
    assert convert.params_to_jax(tenc.state_dict(), params).keys() == params.keys()
    return jenc, params, tenc, x, pad


@pytest.mark.parametrize("S,kw", [(22, {}), (100, {"lsh_chunk_size": 16,
                                                   "lsh_num_buckets": 6})])
def test_reformer_encoder_matches_jax(S, kw):
    jenc, params, tenc, x, pad = _encoder_pair(S, **kw)
    assert [layer.attn_type for layer in tenc.stack()] == ["dense", "lsh", "dense", "lsh"]
    w = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)

    def loss(p, xx):
        return (jenc.apply(p, xx, jnp.asarray(pad)) * w).sum()

    want_out = np.asarray(jenc.apply(params, jnp.asarray(x), jnp.asarray(pad)))
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tenc(xt, pad_mask=torch.from_numpy(pad))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=1e-5, rtol=0)
    want = convert.params_from_jax(jax.tree.map(np.asarray, gp))
    for name, p in tenc.named_parameters():
        if not name.endswith("attn.k.bias"):
            assert _rel_fro(p.grad.numpy(), want[name].numpy()) <= 1e-4, name
    assert _rel_fro(xt.grad.numpy(), np.asarray(gx)) <= 1e-4


def test_reformer_model_step_and_evaluation_match_jax(monkeypatch, tmp_path):
    V, S = 300, 20
    schema = jax_schema_fn(num_items=V, num_categories=flagship.NUM_CATEGORIES,
                           max_session_length=S)
    build = dict(d_model=D, n_head=H, n_layer=3, total_seq_length=S, dropout=0.0)
    jcfg = jtr.transformer_registry.parse("reformer").build(**build)
    jmodel = jcfg.to_model(jtr.TabularSequenceFeatures.from_schema(
        schema, d_output=D, masking="mlm", aggregation="concat",
        masking_kwargs={"mlm_probability": 0.3}), jtr.NextItemPredictionTask(weight_tying=True))
    batch = synthetic_data(flagship.schema(V, S), num_rows=16, max_session_length=S, seed=11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb))
    rots = {"layer_1": _jax_rotations(1, D // H, jcfg.lsh_num_hashes, jcfg.lsh_num_buckets)}
    tmodel = transformer_registry.parse("reformer").build(**build).to_model(
        TabularSequenceFeatures.from_schema(flagship.schema(V, S), d_output=D, masking="mlm",
                                            aggregation="concat",
                                            masking_kwargs={"mlm_probability": 0.3}),
        NextItemPredictionTask(weight_tying=True), device="cpu")
    tmodel.load_state_dict(convert.params_from_jax(params, lsh_rotations=rots))
    info = JaxMLM.compute_masked_targets(JaxMLM(hidden_size=D, mlm_probability=0.3),
                                         jax.random.PRNGKey(3), jb["item_id"], training=True)
    original = JaxMLM.compute_masked_targets

    def jax_masks(self, rng, item_ids, training=False, testing=False, segment_ids=None):
        return info if training else original(self, rng, item_ids, training, testing,
                                              segment_ids)

    monkeypatch.setattr(JaxMLM, "compute_masked_targets", jax_masks)
    rngs = {"masking": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    want_loss, want_grads = jax.jit(jax.value_and_grad(lambda p: jmodel.apply(
        p, jb, targets=jb, training=True, compute_metrics=False, rngs=rngs)[0]))(params)
    want = convert.params_from_jax(jax.tree.map(np.asarray, want_grads))
    tb = tmodel._as_dense(batch)
    loss, _ = tmodel(tb, targets=tb, training=True, masking_info=convert.masking_info_from_jax(
        np.asarray(info.targets), np.asarray(info.mask), np.asarray(info.pad_mask)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for name, p in tmodel.named_parameters():
        if not name.endswith("attn.k.bias"):
            assert _rel_fro(p.grad.numpy(), want[name].numpy()) <= 1e-4, name
    loader = [synthetic_data(flagship.schema(V, S), num_rows=16, max_session_length=S, seed=7)]
    want_eval, got_eval = jmodel.evaluate(loader, params), tmodel.evaluate(loader)
    np.testing.assert_allclose(got_eval["eval_loss"], want_eval["eval_loss"], rtol=1e-4)
    for k in want_eval:
        if k != "eval_loss":
            np.testing.assert_allclose(got_eval[k], want_eval[k], atol=1e-6, err_msg=k)
    # the rotations are in the state dict: a saved model keeps its buckets
    name = "heads.0.body.blocks.1.encoder.layers.1.attn.rotations"
    np.testing.assert_array_equal(tmodel.state_dict()[name].numpy(), rots["layer_1"])
    tmodel.save(str(tmp_path))
    other = transformer_registry.parse("reformer").build(**build).to_model(
        TabularSequenceFeatures.from_schema(flagship.schema(V, S), d_output=D, masking="mlm",
                                            aggregation="concat"),
        NextItemPredictionTask(weight_tying=True), device="cpu", seed=5)
    assert not torch.equal(other.state_dict()[name], tmodel.state_dict()[name])
    other.load(str(tmp_path))
    assert torch.equal(other.state_dict()[name], tmodel.state_dict()[name])


def test_lsh_refusals_match_jax():
    B, S = 1, 8
    x = torch.zeros(B, S, 16)
    pad = torch.ones(B, S, dtype=torch.bool)

    def mk(**kw):
        return TransformerEncoder(d_model=16, n_head=2, n_layer=2, dropout=0.0, **kw)

    lsh2 = dict(attn_layers=("lsh", "lsh"), pos_encoding="none")
    with pytest.raises(NotImplementedError, match="packing"):
        mk(**lsh2)(x, pad, segment_ids=torch.ones(B, S, dtype=torch.long))
    with pytest.raises(NotImplementedError, match="perm_mask|two-stream"):
        mk(**lsh2)(x, pad, perm_mask=torch.zeros(B, S, S))
    with pytest.raises(NotImplementedError, match="two-stream"):
        mk(two_stream=True, **lsh2)(x, pad)
    with pytest.raises(NotImplementedError, match="mem_len"):
        mk(mem_len=4, **lsh2)(x, pad)
    with pytest.raises(NotImplementedError, match="relative_bias"):
        mk(attn_layers=("lsh", "lsh"), pos_encoding="relative_bias")(x, pad)
    with pytest.raises(NotImplementedError, match="two-stream"):
        mk(attn_layers=("local", "local"), two_stream=True,
           pos_encoding="none")(x, pad, perm_mask=torch.zeros(B, S, S))
    with pytest.raises(ValueError, match="entries"):
        mk(attn_layers=("local",), pos_encoding="none")
    with pytest.raises(ValueError, match="entries"):
        mk(attn_layers=("local", "global"), pos_encoding="none")
    with pytest.raises(ValueError, match="uniform"):
        mk(attn_layers=("local", "lsh"), pos_encoding="none", share_layers=True)
    with pytest.raises(ValueError, match="axial_pos_shape"):
        mk(pos_encoding="axial", max_position=8)
    with pytest.raises(ValueError, match="covers"):
        mk(pos_encoding="axial", max_position=12, axial_pos_shape=(2, 4),
           axial_pos_embds_dim=(8, 8))
    with pytest.raises(ValueError, match="sum to d_model"):
        mk(pos_encoding="axial", max_position=8, axial_pos_shape=(2, 4),
           axial_pos_embds_dim=(8, 4))
    with pytest.raises(ValueError, match="max_position"):
        mk(pos_encoding="axial", max_position=8, axial_pos_shape=(2, 4),
           axial_pos_embds_dim=(8, 8))(torch.zeros(1, 12, 16))
    # a uniform pattern of LSH layers may share one layer, seeded 0
    shared = mk(share_layers=True, **lsh2)
    assert shared.layer_shared.attn_type == "lsh"
    torch.testing.assert_close(shared.layer_shared.attn.rotations,
                               tlsh.draw_rotations(8, 2, 8, seed=0))
