"""The port's tabular transformations, pipeline and aggregations against the
JAX package on the CPU.

- swap noise: the JAX draw, replayed here with the JAX module's own keys
  (``make_rng("augment")`` inside a probe module at the same place), fed
  through the port's ``swap_noise_apply`` gives the JAX module's output bit
  for bit; the port's own draw holds the invariants (no pad position is a
  source or a target, reserved keys pass, ``p = 0`` and evaluation are the
  identity, the swapped share lies within 3σ of ``p`` over 4,096
  positions), and the MLM labels are the ids before the noise;
- the per-feature LayerNorm within 1e-5 relative Frobenius norm, with the
  JAX weights through ``convert.params_from_jax``; dropout by its
  invariants;
- the ``pre → compute → merge_with → post → aggregation`` pipeline within
  1e-5;
- each aggregation with its ``output_size``, within 1e-5.

Inputs come from numpy seeds.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformers4rec_tpu as jtr
from transformers4rec_tpu.data.synthetic import synthetic_ecommerce_data_schema as jax_schema_fn
from transformers4rec_tpu.tabular import aggregation as jagg  # noqa: F401  (registers)
from transformers4rec_tpu.tabular.base import MergeTabular as JaxMerge
from transformers4rec_tpu.tabular.base import parse_aggregation as jax_parse_aggregation
from transformers4rec_tpu.tabular.transformations import StochasticSwapNoise as JaxSSN
from transformers4rec_tpu.tabular.transformations import TabularLayerNorm as JaxLN

import transformers4rec_tpu_torch as ttr
from transformers4rec_tpu_torch import convert, flagship
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.tabular import (
    MergeTabular,
    StochasticSwapNoise,
    TabularDropout,
    TabularLayerNorm,
    parse_aggregation,
    swap_noise_apply,
    swap_noise_draw,
)
from transformers4rec_tpu_torch.tabular.transformations import swap_noise_mask

torch.set_num_threads(1)

FWD_RTOL = 1e-5  # forward outputs, relative Frobenius norm


def _rel_fro(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _noise_inputs(seed, B=6, S=7, D=5):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, S + 1, B)
    pad = np.arange(S)[None, :] < lengths[:, None]
    ids = np.where(pad, rng.integers(1, 50, (B, S)), 0).astype(np.int32)
    cont = np.where(pad, rng.normal(size=(B, S)), 0.0).astype(np.float32)
    emb = np.where(pad[..., None], rng.normal(size=(B, S, D)), 0.0).astype(np.float32)
    # a (B, D) context feature: its mask comes from its own values
    ctx = np.where(rng.random((B, D)) < 0.7, rng.integers(1, 9, (B, D)), 0).astype(np.int32)
    seg = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    return {"item_id": ids, "price": cont, "vec": emb, "ctx": ctx, "segment_ids": seg,
            "__neg_ids__": ids.copy()}, pad


class _AugmentKey(fnn.Module):
    """Returns the key ``make_rng("augment")`` gives a module at the root."""

    @fnn.compact
    def __call__(self):
        return self.make_rng("augment")


def _jax_draws(key, inputs, pad_mask, p, pad_token=0):
    """The draws of JAX's StochasticSwapNoise, key for key."""
    rng = _AugmentKey().apply({}, rngs={"augment": key})
    out = {}
    for name, val in inputs.items():
        if name == "segment_ids" or name.startswith("__"):
            continue
        rng, k1, k2, k3 = jax.random.split(rng, 4)
        if pad_mask is not None and val.shape[: pad_mask.ndim] == pad_mask.shape:
            mask = pad_mask
        elif val.ndim == 3:
            mask = (val != pad_token).any(axis=-1)
        else:
            mask = val != pad_token
        n = mask.size
        mflat = mask.reshape(-1)
        scores = jnp.where(mflat, jax.random.gumbel(k1, (n,)), -jnp.inf)
        order = jnp.argsort(-scores)
        pick = jax.random.randint(k2, (n,), 0, n) % jnp.maximum(mflat.sum(), 1)
        swap = jax.random.bernoulli(k3, p, mask.shape) & mask
        out[name] = (np.asarray(order[pick]), np.asarray(swap))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_the_jax_draw_through_the_ports_apply_gives_the_jax_output(seed):
    inputs, pad = _noise_inputs(seed)
    p = 0.5
    key = jax.random.PRNGKey(seed)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    want = JaxSSN(replacement_prob=p).apply({}, jin, training=True, pad_mask=jnp.asarray(pad),
                                            rngs={"augment": key})
    draws = _jax_draws(key, jin, jnp.asarray(pad), p)
    swapped = 0
    for name, val in inputs.items():
        if name in draws:
            src, swap = (torch.from_numpy(a.copy()) for a in draws[name])
            got = swap_noise_apply(torch.from_numpy(val), src.long(), swap)
            swapped += int(swap.sum())
        else:
            got = torch.from_numpy(val)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[name]), err_msg=name)
    assert swapped > 0
    # the module applies draws it is given, the reserved keys untouched
    module = StochasticSwapNoise(replacement_prob=p)
    module.draws = {k: (torch.from_numpy(s.copy()).long(), torch.from_numpy(w.copy()))
                    for k, (s, w) in draws.items()}
    got = module({k: torch.from_numpy(v) for k, v in inputs.items()}, training=True,
                 pad_mask=torch.from_numpy(pad))
    for name in inputs:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)


def test_the_ports_draw_keeps_the_invariants():
    inputs, pad = _noise_inputs(5, B=64, S=64)
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    tpad = torch.from_numpy(pad)
    gen = torch.Generator().manual_seed(0)
    module = StochasticSwapNoise(replacement_prob=0.1)
    draws = module.draw(tin, tpad, gen)
    assert set(draws) == {"item_id", "price", "vec", "ctx"}
    for name, (src, swap) in draws.items():
        mask = swap_noise_mask(tin[name], tpad)
        flat = mask.reshape(-1)
        assert bool(flat[src].all()), f"{name}: a pad position is a source"
        assert not bool((swap & ~mask).any()), f"{name}: a pad position is a target"
    # the swapped share of the valid positions: within 3 sigma of p
    src, swap = swap_noise_draw(torch.ones(4096, dtype=torch.bool), 0.1,
                                torch.Generator().manual_seed(1))
    share = float(swap.float().mean())
    assert abs(share - 0.1) <= 3 * (0.1 * 0.9 / 4096) ** 0.5, share
    assert int(src.min()) >= 0 and int(src.max()) < 4096
    out = module(tin, training=True, pad_mask=tpad, generator=gen)
    for name in ("segment_ids", "__neg_ids__"):
        assert torch.equal(out[name], tin[name])
    # pad positions keep their value
    assert bool((out["item_id"][~tpad] == 0).all())
    # evaluation and p = 0 are the identity
    for m, training in ((module, False), (StochasticSwapNoise(replacement_prob=0.0), True)):
        same = m(tin, training=training, pad_mask=tpad, generator=gen)
        assert all(torch.equal(same[k], tin[k]) for k in tin)


def test_the_mlm_labels_are_the_ids_before_the_noise():
    schema = flagship.schema(40, 10)
    im = ttr.TabularSequenceFeatures.from_schema(
        schema, d_output=16, masking="mlm", aggregation="concat",
        masking_kwargs={"mlm_probability": 0.5}, pre=[StochasticSwapNoise(replacement_prob=1.0)])
    ttr.Model([ttr.Head.from_body(im, ttr.XLNetConfig.build(16, 2, 1, 10))], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_data(schema, num_rows=32, max_session_length=10, seed=3).items()}
    ids = batch["item_id"].long()
    noise = im.StochasticSwapNoise_0
    noise.draws = noise.draw(batch, ids != 0, torch.Generator().manual_seed(2))
    assert int(noise.draws["item_id"][1].sum()) > 0
    _, info = im(batch, training=True, generator=torch.Generator().manual_seed(4))
    assert torch.equal(info.item_ids, ids)
    assert torch.equal(info.targets[info.mask], ids[info.mask])
    # while the embeddings saw the swapped ids: the same hidden states come
    # from the swapped batch given as it is (no swap drawn), the same mask
    hidden, _ = im(batch, training=True, generator=torch.Generator().manual_seed(4))
    swapped = noise(batch, training=True)
    assert not torch.equal(swapped["item_id"], batch["item_id"])
    noise.draws = {k: (src, torch.zeros_like(swap)) for k, (src, swap) in noise.draws.items()}
    again, _ = im(swapped, training=True, generator=torch.Generator().manual_seed(4))
    assert torch.equal(hidden, again)


def test_layer_norm_matches_jax_per_feature():
    rng = np.random.default_rng(7)
    feats = {"a": rng.normal(size=(3, 4, 6)).astype(np.float32),
             "b": rng.normal(size=(3, 4, 2)).astype(np.float32) * 5 + 1,
             "c": rng.normal(size=(3, 4, 1)).astype(np.float32),
             "d": rng.integers(0, 5, (3, 4, 3)).astype(np.int32)}
    jin = {k: jnp.asarray(v) for k, v in feats.items()}
    params = JaxLN().init(jax.random.PRNGKey(0), jin)
    params = jax.tree.map(lambda x: x + jax.random.normal(jax.random.PRNGKey(1), x.shape),
                          params)
    want = JaxLN().apply(params, jin)
    module = TabularLayerNorm()
    module.build(lambda: {"a": 6, "b": 2, "c": 1}, "post")
    module.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, params)))
    assert module.eps == 1e-6 and sorted(module.keys) == ["a", "b"]
    got = module({k: torch.from_numpy(v) for k, v in feats.items()})
    for k in feats:
        assert _rel_fro(got[k].detach().numpy(), want[k]) <= FWD_RTOL, k
    assert np.array_equal(got["c"].numpy(), feats["c"]) and np.array_equal(got["d"].numpy(),
                                                                          feats["d"])
    with pytest.raises(NotImplementedError):
        TabularLayerNorm().build(None, "pre")


def test_dropout_keeps_its_invariants():
    x = torch.ones(64, 64)
    ids = torch.arange(10)
    drop = TabularDropout(dropout_rate=0.25)
    out = drop({"x": x, "ids": ids}, training=True, generator=torch.Generator().manual_seed(0))
    kept = out["x"] != 0
    assert torch.allclose(out["x"][kept], torch.full_like(out["x"][kept], 1 / 0.75))
    share = 1 - float(kept.float().mean())
    assert abs(share - 0.25) <= 3 * (0.25 * 0.75 / x.numel()) ** 0.5
    assert torch.equal(out["ids"], ids)
    for m, training in ((drop, False), (TabularDropout(), True)):
        assert torch.equal(m({"x": x}, training=training)["x"], x)


def test_the_pipeline_pre_compute_merge_post_aggregation_matches_jax():
    """A non-sequential TabularFeatures with ``post`` LayerNorm, merged
    with a continuous block, through the concat aggregation; ``pre``
    dropout at rate 0 and swap noise outside training are identities."""
    jschema = jax_schema_fn(num_items=30, num_categories=flagship.NUM_CATEGORIES,
                            max_session_length=5)
    tschema = flagship.schema(30, 5)
    kw = dict(embedding_dim_default=4, pre=["dropout", "ssn"], post="layer-norm")
    jm = jtr.TabularFeatures.from_schema(jschema, continuous_tags=(), **kw)
    tm = ttr.TabularFeatures.from_schema(tschema, continuous_tags=(), **kw)
    jcont = jtr.ContinuousFeatures.from_schema(jschema)
    tcont = ttr.ContinuousFeatures.from_schema(tschema)
    rng = np.random.default_rng(3)
    batch = {"item_id": rng.integers(1, 31, (5,)).astype(np.int64),
             "category": rng.integers(1, flagship.NUM_CATEGORIES + 1, (5,)).astype(np.int64),
             "item_recency": rng.random(5).astype(np.float32),
             "weekday_sin": rng.random(5).astype(np.float32)}
    jin = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jm.init(jax.random.PRNGKey(0), jin)
    params = jax.tree.map(lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(2), x.shape),
                          params)
    # flax calls no unbound block as ``merge_with``: the JAX side merges the
    # continuous block's dict itself (its features are 1 wide, which the
    # layer norm passes), then concatenates
    want = jax_parse_aggregation("concat")({**jm.apply(params, jin), **jcont.apply({}, jin)})
    sd = convert.params_from_jax(jax.tree.map(np.asarray, params))
    assert any(k.startswith("TabularLayerNorm_0.ln_") for k in sd)
    tm.load_state_dict(sd)
    assert tm._pre_names == ["TabularDropout_0", "StochasticSwapNoise_0"]
    got = tm({k: torch.from_numpy(v) for k, v in batch.items()}, merge_with=tcont,
             aggregation="concat")
    assert got.shape == want.shape
    assert _rel_fro(got.detach().numpy(), want) <= FWD_RTOL
    # MergeTabular of the two gives the same dict
    merged = MergeTabular([tm, tcont])({k: torch.from_numpy(v) for k, v in batch.items()})
    jmerged = JaxMerge(to_merge=(jm, jcont)).apply(
        {"params": {"to_merge_0": params["params"]}}, jin)
    assert sorted(merged) == sorted(jmerged)
    for k in merged:
        assert _rel_fro(merged[k].detach().numpy(), jmerged[k]) <= FWD_RTOL, k


AGGREGATIONS = ["concat", "stack", "element-wise-sum", "element-wise-sum-item-multi"]


@pytest.mark.parametrize("name", AGGREGATIONS)
def test_each_aggregation_and_its_output_size_match_jax(name):
    jschema = jax_schema_fn(num_items=30, num_categories=flagship.NUM_CATEGORIES,
                            max_session_length=5)
    tschema = flagship.schema(30, 5)
    rng = np.random.default_rng(len(name))
    feats = {"item_id": rng.normal(size=(3, 5, 4)), "category": rng.normal(size=(3, 5, 4)),
             "weekday_sin": rng.normal(size=(3, 4))}
    feats = {k: v.astype(np.float32) for k, v in feats.items()}
    jagg_ = jax_parse_aggregation(name, jschema)
    tagg = parse_aggregation(name, tschema)
    want = jagg_({k: jnp.asarray(v) for k, v in feats.items()})
    got = tagg({k: torch.from_numpy(v) for k, v in feats.items()})
    assert got.shape == want.shape
    assert _rel_fro(got.numpy(), want) <= FWD_RTOL
    sizes = {k: v.shape[-1] for k, v in feats.items()}
    assert tagg.output_size(sizes) == jagg_.output_size(sizes)
    assert tagg.output_size(sizes) == got.shape[-1]
    if name != "concat":
        with pytest.raises(ValueError):
            tagg.output_size({"item_id": 4, "category": 3})
