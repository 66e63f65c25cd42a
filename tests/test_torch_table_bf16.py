"""bf16-stored tables (``embedding_table_dtype="bf16"``) of the port against
the JAX package on the CPU.

The JAX trainer casts every 2-D parameter whose flax path ends in
``_table`` to bfloat16 after its init; here the same weights, made by the
JAX ``init`` from a seed and cast by that rule, go to the port through
``convert.params_from_jax`` (bf16 leaves become ``torch.bfloat16`` with the
same bits) into a model whose tables ``trainer.cast_tables_`` made bf16.
The JAX masking is patched to return one draw, which the port is given
through ``masking_info=``. Sizes are small: 300 items, d_model 32, one
layer, sessions of 10, dropout 0.

Tolerances, each with its reason:

- The plain vocab functions on a bf16 W against the JAX scans: lse and the
  label logit within 1e-5 relative (f32 sums of the same bf16 products in
  another order); ranks and counts the JAX paths' or one less (the same
  products compared with the same label logit, but the JAX count also
  takes the label's own column where its scan's product lies above the
  gather-dot's label logit). dW is a bf16 rounding of an f32 sum over the
  rows:
  bit for bit with one row (a single product, no sum); with many, within
  one bf16 spacing (the two sums may fall on either side of a rounding)
  plus 1e-5 of dW's largest magnitude (an element summed from terms of
  either sign keeps the f32 sums' error of terms that large).
- A training step: the loss within 2e-5 relative, dense gradients within
  5e-3 and the tables' within 1e-2 in relative Frobenius norm. The CE
  rounds its input x to bf16, which turns the f32 noise of the two
  encoders (about 1e-6) into flips of one bf16 spacing of a few elements of
  x (3 of 5,120 in the sum case), each moving the loss by up to 1e-5 and
  the residual of its row; given the JAX side's x, the port's CE gives the
  JAX loss within 1e-7, and with f32 tables the same models agree within
  1e-6. A table's gradient is bf16 in both (the CE's dW rounded once plus
  the lookup's, summed in bf16; flax's LayerNorm converts its bf16 input to
  f32 twice, so JAX rounds two cotangents where the port rounds one): its
  own roundings add up to 2^-8 relative.
- Adafactor on a bf16 table (both arms): the update's f32 arithmetic in
  another order (the clip's sum of squares), then two roundings to bf16;
  each element within one bf16 spacing of the JAX parameter and of the
  moment.
- The sparse arms on a bf16 table: each tensor's movement within 1e-3 in
  relative Frobenius norm, as ``tests/test_torch_sparse_step.py`` holds the
  f32 table, plus for a bf16 table one bf16 spacing of its values (the
  update rounds to it); the rows' moments within 2^-8 (their gradients are
  bf16 in both, one rounding apart where the f32 sums fall on either side).
"""

import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

import transformers4rec_tpu as jtr
from transformers4rec_tpu.data.synthetic import synthetic_ecommerce_data_schema as jax_schema_fn
from transformers4rec_tpu.masking import masking_registry as jax_masking_registry
from transformers4rec_tpu.ops import vocab as jvocab
from transformers4rec_tpu.ops.fused_adafactor import fused_adafactor

import transformers4rec_tpu_torch as ttr
from transformers4rec_tpu_torch import convert, flagship
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.ops import vocab
from transformers4rec_tpu_torch.ops.fused_adafactor import (
    FusedAdafactor,
    adafactor_pass_a_plain,
)
from transformers4rec_tpu_torch.serving import InferenceRunner, export_model
from transformers4rec_tpu_torch.trainer import (
    T4RecTrainingArguments,
    Trainer,
    cast_tables_,
    table_param_names,
)

torch.set_num_threads(1)

V, D, H, L, S, B = 300, 32, 2, 1, 10, 8
LR = 6.7e-4
ZERO_GRADIENT = "attn.k.bias"  # the softmax ignores it: rounding noise in both


def _rel_fro(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _bf16_ulp(a):
    """The spacing of bf16 values at |a| (8 significant bits), as f64."""
    a = np.abs(np.asarray(a, np.float64))
    return np.ldexp(1.0, np.frexp(np.maximum(a, 2.0 ** -126))[1] - 8)


def _within_ulps(got, want, ulps, what, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bad = np.abs(got - want) > ulps * _bf16_ulp(want) + atol
    assert not bad.any(), f"{what}: {int(bad.sum())} of {bad.size} beyond {ulps} bf16 spacing"


def _jax_cast(params):
    """The JAX trainer's cast (``trainer.py``: ``_init_params``)."""
    return jax.tree_util.tree_map_with_path(
        lambda p, leaf: leaf.astype(jnp.bfloat16)
        if (jax.tree_util.keystr(p).endswith("_table']") and leaf.ndim == 2) else leaf,
        params)


def _f(t):
    return t.detach().float().numpy()


# --------------------------------------------------------------- models
CASES = {
    # the flagship's inputs: two tables and two continuous columns concatenated
    # (the concat promotes to f32), the tied table through K1 and K2
    "flagship": dict(im=dict(aggregation="concat"), task=dict(weight_tying=True)),
    # soft embeddings of the continuous columns (their tables are cast too),
    # a per-feature LayerNorm on the bf16 lookups, an untied output layer
    "soft_layer_norm_untied": dict(
        im=dict(aggregation="concat", continuous_soft_embeddings=True,
                soft_embedding_cardinality_default=5, soft_embedding_dim_default=3,
                post="layer-norm"),
        task=dict(weight_tying=False, target_dim=V + 1)),
    # two bf16 lookups summed (bf16 in both packages) and then projected
    "sum_of_lookups": dict(im=dict(aggregation="sum", continuous_tags=()),
                           task=dict(weight_tying=True)),
}


def _batch(seed, rows=B):
    return synthetic_data(flagship.schema(V, S), num_rows=rows, max_session_length=S, seed=seed)


def _pair(case, sampled=False):
    """The JAX model with its init cast as the JAX trainer casts it, and the
    port's model with its tables cast, loaded with those weights."""
    kw = CASES[case]
    task = dict(kw["task"], **(dict(sampled_softmax=True, max_n_samples=64) if sampled else {}))
    jschema = jax_schema_fn(num_items=V, num_categories=flagship.NUM_CATEGORIES,
                            max_session_length=S)
    jim = jtr.TabularSequenceFeatures.from_schema(
        jschema, d_output=D, masking="mlm", masking_kwargs={"mlm_probability": 0.3},
        **kw["im"])
    jmodel = jtr.XLNetConfig.build(d_model=D, n_head=H, n_layer=L, total_seq_length=S,
                                   dropout=0.0).to_model(jim, jtr.NextItemPredictionTask(**task))
    init = {k: jnp.asarray(v) for k, v in _batch(0, rows=4).items()}
    rngs = {k: jax.random.PRNGKey(i) for i, k in
            enumerate(("params", "masking", "dropout", "sampling", "augment"))}
    params = jax.jit(lambda b: _jax_cast(jmodel.init(rngs, b, training=True)))(init)
    params = jax.tree.map(np.asarray, params)
    tim = ttr.TabularSequenceFeatures.from_schema(
        flagship.schema(V, S), d_output=D, masking="mlm",
        masking_kwargs={"mlm_probability": 0.3}, **kw["im"])
    tmodel = ttr.XLNetConfig.build(d_model=D, n_head=H, n_layer=L, total_seq_length=S,
                                   dropout=0.0).to_model(
        tim, ttr.NextItemPredictionTask(**task), device="cpu")
    cast_tables_(tmodel, torch.bfloat16)
    tmodel.load_state_dict(convert.params_from_jax(params))  # strict
    return jmodel, params, tmodel


def _jax_cast_set(params):
    """The port's names of the leaves the JAX trainer casts."""
    tree = params["params"] if set(params) == {"params"} else params
    names = convert._port_names(tree)
    return {names[path][0] for path in names
            if np.asarray(convert._get(tree, path)).dtype == ml_dtypes.bfloat16}


def _patch_jax_mask(batch, monkeypatch, seed=3):
    """The JAX draw of the mask, returned by the JAX masking in training;
    the port's ``MaskingInfo`` of it."""
    jcls = jax_masking_registry.parse("mlm")
    info = jcls.compute_masked_targets(jcls(hidden_size=D, mlm_probability=0.3),
                                       jax.random.PRNGKey(seed), jnp.asarray(batch["item_id"]),
                                       training=True)
    original = jcls.compute_masked_targets

    def jax_masks(self, rng, item_ids, training=False, testing=False, segment_ids=None):
        return info if training else original(self, rng, item_ids, training, testing,
                                              segment_ids)

    monkeypatch.setattr(jcls, "compute_masked_targets", jax_masks)
    return convert.masking_info_from_jax(np.asarray(info.targets), np.asarray(info.mask),
                                         np.asarray(info.pad_mask),
                                         input_schema=np.asarray(info.input_schema))


# ------------------------------------------------------------- the cast set
@pytest.mark.parametrize("case", CASES)
def test_both_packages_cast_the_same_tables(case):
    _, params, tmodel = _pair(case)
    names = set(table_param_names(tmodel))
    assert names == _jax_cast_set(params)
    im = tmodel.heads[0].input_module
    assert {"heads.0.body.blocks.0.categorical_module.tables.item_id",
            "heads.0.body.blocks.0.categorical_module.tables.category"} <= names
    if case == "soft_layer_norm_untied":
        assert "heads.0.body.blocks.0.continuous_module.soft_item_recency.embedding_table" in names
        assert "heads.0.tasks.0.output_layer" not in names
    for n, p in tmodel.named_parameters():
        assert p.dtype == (torch.bfloat16 if n in names else torch.float32), n
    assert im.masking.masked_item_embedding.dtype == torch.float32
    # each bf16 leaf of the JAX trainer's params went in with its bits
    tree = params["params"]
    for path, (name, _, _) in convert._port_names(tree).items():
        if name in names:
            leaf = np.asarray(convert._get(tree, path))
            got = dict(tmodel.named_parameters())[name].detach()
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), leaf.view(np.int16))


def test_a_bf16_leaf_converts_with_its_bits_both_ways():
    rng = np.random.default_rng(0)
    leaf = rng.normal(0, 0.05, (16, 8)).astype(ml_dtypes.bfloat16)
    tree = {"blocks_0": {"categorical_module": {"item_id_table": leaf}}}
    sd = convert.params_from_jax(tree)
    got = sd["blocks.0.categorical_module.tables.item_id"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), leaf.view(np.int16))
    back = convert.params_to_jax(sd, tree)
    out = back["blocks_0"]["categorical_module"]["item_id_table"]
    assert out.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(out.view(np.int16), leaf.view(np.int16))


# ------------------------------------------------------- the plain kernels
def _vocab_inputs(n, e, rows, vocab_size, seed):
    rng = np.random.default_rng(seed)
    W = rng.normal(0.0, 0.05, (rows, e)).astype(ml_dtypes.bfloat16)
    labels = rng.integers(1, vocab_size, n).astype(np.int32)
    x = (rng.uniform(0, 12, (n, 1)) * W[labels].astype(np.float32)
         + rng.normal(0, 1, (n, e))).astype(np.float32)
    return x, W, labels


@pytest.mark.parametrize("n,e,rows,vocab_size,eps", [
    (1, 16, 520, 517, 0.0),     # one row: dW is a single product a row
    (37, 64, 1000, 997, 0.1),   # padded rows, smoothing
    (20, 448, 300, 300, 0.0),   # the paper's width
])
def test_plain_vocab_functions_on_a_bf16_table_follow_the_jax_scans(n, e, rows, vocab_size, eps):
    x, W, labels = _vocab_inputs(n, e, rows, vocab_size, n + e)
    tx, tW, tl = torch.from_numpy(x), convert._tensor(W), torch.from_numpy(labels)
    assert tW.dtype == torch.bfloat16
    jx, jW, jl = jnp.asarray(x), jnp.asarray(W), jnp.asarray(labels)
    lse, ll, zs = vocab.ce_fwd_plain(tx, tW, tl, vocab_size, eps > 0)
    jlse, jll, jzs = jvocab._ce_fwd_scan(jx, jW, jl, 128, vocab_size, smooth=eps > 0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5)
    np.testing.assert_allclose(ll.numpy(), np.asarray(jll), rtol=1e-5, atol=1e-6)
    if eps:
        np.testing.assert_allclose(zs.numpy(), np.asarray(jzs), rtol=1e-5, atol=1e-3)
    # the training CE's gradient through both packages' own autodiff
    w = np.ones(n, np.float32)

    def jloss(x_, W_):
        return jvocab.fused_softmax_ce(x_, W_, jl, jnp.asarray(w), vocab_size=vocab_size,
                                       label_smoothing=eps, use_pallas=False)

    jdx, jdW = jax.grad(jloss, argnums=(0, 1))(jx, jW)
    assert jdW.dtype == jnp.bfloat16
    xs, Ws = tx.clone().requires_grad_(), tW.clone().requires_grad_()
    vocab.fused_softmax_ce(xs, Ws, tl, torch.from_numpy(w), vocab_size=vocab_size,
                           label_smoothing=eps).backward()
    assert Ws.grad.dtype == torch.bfloat16
    assert _rel_fro(xs.grad.numpy(), np.asarray(jdx)) <= 1e-5
    got, want = _f(Ws.grad), np.asarray(jdW).astype(np.float32)
    if n == 1:
        np.testing.assert_array_equal(got, want)
    else:
        # an element summed from terms of either sign carries the f32 sums'
        # error, up to 1e-5 of the largest term, beyond its own spacing
        _within_ulps(got, want, 1, "dW", atol=1e-5 * float(np.abs(want).max()))
    # ranks: K3's and K4's plain versions against the JAX evaluation paths
    gathered = vocab.label_logits(tx, tW, tl)
    _, rank, _ = vocab.ce_rank_plain(tx, tW, tl, gathered, vocab_size, eps > 0)
    _, jrank = jvocab.fused_ce_and_rank(jx, jW, jl, jnp.ones(n), vocab_size=vocab_size,
                                        label_smoothing=eps, use_pallas=False)
    extra = np.asarray(jrank) - rank.numpy()
    assert ((extra == 0) | (extra == 1)).all() and (extra == 0).mean() >= 0.75
    cnt = vocab.rank_counts_plain(tx, tW, gathered, tl, vocab_size)
    jcnt = jvocab.rank_counts(jx, jW, jnp.asarray(gathered.numpy()), jl, block_v=128,
                              use_pallas=False, vocab_size=vocab_size)
    extra = np.asarray(jcnt) - cnt.numpy()
    assert ((extra == 0) | (extra == 1)).all() and (extra == 0).mean() >= 0.75
    # streamed top-k: bf16 products in both
    s, i = vocab.fused_topk(tx, tW, 5, chunk=128, vocab_size=vocab_size)
    js, ji = jvocab.fused_topk(jx, jW, 5, chunk=128, vocab_size=vocab_size)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


# ------------------------------------------------------------- Adafactor
def _adafactor_runs(make_jax, make_port, shapes, seed, scales=(1e-2, 1.0, 30.0)):
    """Three steps of both optimizers on bf16 parameters and gradients."""
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(0, 0.05, s).astype(ml_dtypes.bfloat16) for k, s in shapes.items()}
    grads = [{k: (rng.normal(0, 1, s) * c).astype(ml_dtypes.bfloat16)
              for k, s in shapes.items()} for c in scales]
    tx = make_jax()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
    tp = {k: torch.nn.Parameter(convert._tensor(v)) for k, v in params.items()}
    opt = make_port(list(tp.values()))
    for g in grads:
        for k in tp:
            tp[k].grad = convert._tensor(g[k])
        opt.step()
    return jp, state, tp, opt


@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("arm", ["plain_chain_bf16_moment", "streamed"])
def test_adafactor_on_bf16_tables_follows_the_jax_optimizer(arm, clip):
    """The adafactor arm's plain chain (bf16 moment) and the streamed update
    (``use_pallas=True``; the JAX Pallas passes in interpret mode) on bf16
    parameters: the update rounded to bf16, then the sum once more."""
    shapes = {"item_id_table": (4096, 16), "category_table": (24, 16)}
    if arm == "streamed":
        jax_tx = lambda: fused_adafactor(LR, use_pallas=True, clipping_threshold=clip)  # noqa
        port = lambda ps: FusedAdafactor(ps, lr=LR, use_pallas=True,  # noqa: E731
                                         clipping_threshold=clip)
    else:
        jax_tx = lambda: fused_adafactor(LR, clipping_threshold=clip,  # noqa: E731
                                         moment_dtype=jnp.bfloat16)
        port = lambda ps: FusedAdafactor(ps, lr=LR, clipping_threshold=clip,  # noqa: E731
                                         moment_dtype=torch.bfloat16)
    jp, jstate, tp, opt = _adafactor_runs(jax_tx, port, shapes, 7)
    for k in shapes:
        assert tp[k].dtype == torch.bfloat16 and opt.state[tp[k]]["v"].dtype == torch.bfloat16
        _within_ulps(_f(tp[k]), np.asarray(jp[k]).astype(np.float32), 1, k)
        _within_ulps(_f(opt.state[tp[k]]["v"]), np.asarray(jstate.v[k]).astype(np.float32), 1,
                     f"{k} moment")


def test_the_streamed_clip_reads_the_unrounded_moment():
    """Pass A of a bf16 table: the clip's sum of squares from the f32 moment
    before its rounding, the moment stored rounded."""
    rng = np.random.default_rng(8)
    g = torch.from_numpy((rng.normal(0, 30, (2048, 8))).astype(np.float32)).bfloat16()
    v0 = torch.from_numpy(rng.random((2048, 8)).astype(np.float32)).bfloat16()
    decay = torch.full((), 0.5)
    v = v0.clone()
    coef = adafactor_pass_a_plain(g, v, decay, LR, 1.0, 1e-30)
    nv = 0.5 * v0.float() + 0.5 * (g.float() ** 2 + 1e-30)
    assert torch.equal(v, nv.bfloat16())
    for moment, same in ((nv, True), (nv.bfloat16().float(), False)):
        rms = torch.sqrt(((g.float() * torch.rsqrt(moment)) ** 2).sum() / g.numel())
        want = -LR / torch.clamp_min(rms / 1.0, 1.0)
        assert torch.equal(coef, want.reshape(1)) == same


# ---------------------------------------------------------- a training step
@pytest.mark.parametrize("case", CASES)
def test_a_training_step_on_bf16_tables_matches_jax(case, monkeypatch):
    jmodel, params, tmodel = _pair(case)
    batch = _batch(11)
    info = _patch_jax_mask(batch, monkeypatch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rngs = {"masking": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}

    def jloss(p):
        return jmodel.apply(p, jb, targets=jb, training=True, compute_metrics=False,
                            rngs=rngs)[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    want = convert.params_from_jax(jax.tree.map(np.asarray, want_grads))
    tb = tmodel._as_dense(batch)
    loss, _ = tmodel(tb, targets=tb, training=True, masking_info=info)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=2e-5)
    tables = set(table_param_names(tmodel))
    for n, p in tmodel.named_parameters():
        assert p.grad.dtype == p.dtype == want[n].dtype, n
        if not n.endswith(ZERO_GRADIENT):
            assert _rel_fro(_f(p.grad), _f(want[n])) <= (1e-2 if n in tables else 5e-3), n


# ------------------------------------------------------------ sparse arms
@pytest.mark.parametrize("opt", ["sparse_adam", "sparse_adafactor"])
def test_the_sparse_arm_on_a_bf16_table_updates_as_the_jax_sparse_step(tmp_path, monkeypatch,
                                                                         opt):
    """One update of the sparse arm on a bf16 item table against the JAX
    package's ``make_sparse_one_step`` from the same weights (the form of
    ``tests/test_torch_sparse_step.py``): the rows gathered bf16, their
    gradients bf16 until the f32 buffer, the step rounded to bf16 before the
    scatter; the category table's Adafactor with a bf16 moment."""
    from types import SimpleNamespace

    import test_torch_sparse_step as sps
    from transformers4rec_tpu.ops import sparse_update as J
    from transformers4rec_tpu.trainer import sparse_embedding_step as jstep
    from transformers4rec_tpu.trainer.schedulers import get_scheduler as jax_scheduler
    from transformers4rec_tpu.trainer.trainer import TrainState

    CLIP, LR_S = 0.05, 1e-2
    _, jmodel, params32, tmodel = sps._jax_pair("mlm")
    params = jax.tree.map(np.asarray, _jax_cast(params32))
    cast_tables_(tmodel, torch.bfloat16)
    tmodel.load_state_dict(convert.params_from_jax(params))
    batches = [sps._batch(60)]
    infos = sps._jax_masks_by_batch("mlm", batches, monkeypatch)
    rng, _ = jax.random.split(jax.random.PRNGKey(42))
    key = jax.random.fold_in(rng, 4)
    neg = np.asarray(sps.JaxSampler(sps.N_NEG, sps.V + 1, 1).sample(
        jax.random.PRNGKey(50))).astype(np.int64)
    tinfo = convert.masking_info_from_jax(
        np.asarray(infos[0].targets), np.asarray(infos[0].mask), np.asarray(infos[0].pad_mask),
        input_schema=np.asarray(infos[0].input_schema), neg_ids=neg)

    sched = jax_scheduler("linear", LR_S, 0, 1)
    dense_tx = optax.multi_transform(
        {"dense": optax.adamw(sched, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0),
         "table": fused_adafactor(learning_rate=sched, moment_dtype=jnp.bfloat16)},
        J.label_embedding_params)
    args = SimpleNamespace(max_grad_norm=CLIP, gradient_accumulation_steps=1, adam_beta1=0.9,
                           adam_beta2=0.999, adam_epsilon=1e-8, embedding_moment_dtype="bf16")
    path = jstep.find_table_path(params, "item_id")
    rule = "adafactor" if opt == "sparse_adafactor" else "adam"
    one_step = jax.jit(jstep.make_sparse_one_step(
        jmodel, args, path, "item_id", "mlm", sps._ReplayedNegatives([key], [neg]), dense_tx,
        sched, rule=rule))
    jparams = jax.tree.map(jnp.asarray, params)
    table = jstep.tree_get(jparams, path)
    assert table.dtype == jnp.bfloat16
    init = J.sparse_rows_adafactor_init if rule == "adafactor" else J.sparse_rows_adam_init
    opt_state = (dense_tx.init(jstep.tree_set(jparams, path, None)),
                 init(table, moment_dtype=jnp.bfloat16))
    state = TrainState(params=jparams, opt_state=opt_state, step=jnp.zeros((), jnp.int32),
                       rng=jax.random.PRNGKey(42))

    tr = sps._trainer(tmp_path, opt, steps=1, clip=CLIP, model=tmodel,
                      embedding_table_dtype="bf16")
    tr.create_optimizer_and_scheduler(1)
    start = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    tb = tmodel._as_dense(batches[0])
    loss = tr._train_step(tb, masking_info=tinfo)
    state, jloss = one_step(state, {k: jnp.asarray(v) for k, v in batches[0].items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = convert.params_from_jax(jax.tree.map(np.asarray, state.params))
    item = sps.ITEM_TABLE
    for n, p in tmodel.named_parameters():
        assert p.dtype == want[n].dtype, n
        if n.endswith(ZERO_GRADIENT):
            continue
        got_move, want_move = _f(p) - _f(start[n]), _f(want[n]) - _f(start[n])
        slack = np.linalg.norm(_bf16_ulp(_f(start[n]))) / max(np.linalg.norm(want_move), 1e-30) \
            if n in (item, "heads.0.body.blocks.0.categorical_module.tables.category") else 0.0
        assert _rel_fro(got_move, want_move) <= 1e-3 + slack, n
    ts = tr._sparse.state
    js = convert.sparse_state_from_jax(jax.tree.map(np.asarray, state.opt_state[1]))
    assert int(ts.count) == int(js.count) == 1
    for name in ("mu", "nu", "v"):
        if hasattr(ts, name):
            assert getattr(ts, name).dtype == torch.bfloat16
            assert _rel_fro(_f(getattr(ts, name)), _f(getattr(js, name))) <= 2.0 ** -8, name
    assert tmodel.heads[0].input_module.item_embedding_table().grad is None


# ----------------------------------------------------------------- trainer
def _model(opt):
    """The flagship's model, or for a sparse arm configuration 4's (a
    sampled softmax over a tied table), at small widths."""
    small = dict(num_items=V, d_model=D, n_layer=L, n_head=H, dropout=0.0)
    if opt.startswith("sparse"):
        return flagship.build_large_vocab_model("cpu", max_n_samples=64, **small)
    return flagship.build_model("cpu", seq=S, **small)


def _trainer(tmp_path, opt="adafactor", steps=6, **kw):
    args = T4RecTrainingArguments(
        output_dir=str(tmp_path), data_loader_engine="synthetic", max_sequence_length=S,
        per_device_train_batch_size=16, per_device_eval_batch_size=16, max_steps=steps,
        learning_rate=1e-2, logging_steps=1, embedding_optimizer=opt, seed=5,
        embedding_table_dtype="bf16", **kw)
    return Trainer(_model(opt), args, schema=flagship.schema(V, S), device="cpu")


def _table_dtypes(model):
    params = dict(model.named_parameters())
    return {params[n].dtype for n in table_param_names(model)}


@pytest.mark.parametrize("opt", ["adafactor", "sparse_adam", "sparse_adafactor"])
def test_the_trainer_trains_and_checkpoints_bf16_tables(tmp_path, opt):
    """The port's form of the JAX ``test_embedding_table_dtype_bf16``: bf16
    after init, after training and after a checkpoint reload; the loss
    falls; a trainer made without the field loads the bf16 checkpoint as
    bf16."""
    tr = _trainer(tmp_path, opt, steps=12, save_steps=12)
    assert _table_dtypes(tr.model) == {torch.bfloat16}
    tr.train()
    hist = [h["loss"] for h in tr.state.log_history if "loss" in h]
    assert np.isfinite(hist).all() and np.mean(hist[-3:]) < np.mean(hist[:3]), hist
    assert _table_dtypes(tr.model) == {torch.bfloat16}
    ck = tr._latest_checkpoint()
    trained = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    tr.load(ck)
    assert _table_dtypes(tr.model) == {torch.bfloat16}
    fresh = Trainer(_model(opt),
                    T4RecTrainingArguments(output_dir=str(tmp_path / "f"), max_steps=1,
                                           data_loader_engine="synthetic",
                                           embedding_optimizer=opt),
                    schema=flagship.schema(V, S), device="cpu")
    assert _table_dtypes(fresh.model) == {torch.float32}
    fresh.load(ck)
    assert _table_dtypes(fresh.model) == {torch.bfloat16}
    for n, p in fresh.model.named_parameters():
        assert torch.equal(p.detach(), trained[n]), n


def test_the_streamed_update_trains_a_bf16_table(tmp_path, monkeypatch):
    from transformers4rec_tpu_torch.ops import fused_adafactor as fa

    calls = []
    real = fa.adafactor_update
    monkeypatch.setattr(fa, "adafactor_update",
                        lambda p, g, *a: (calls.append((p.dtype, g.dtype)), real(p, g, *a))[1])
    small = dict(num_items=2100, d_model=16, n_layer=1, n_head=2, seq=4)
    tr = flagship.build_trainer("cpu", streamed_table_update=True, batch=8,
                                embedding_table_dtype="bf16", output_dir=str(tmp_path), **small)
    tr.args.max_steps = 3
    before = tr.model.heads[0].input_module.item_embedding_table().detach().clone()
    assert before.dtype == torch.bfloat16
    tr.train()
    assert calls == [(torch.bfloat16, torch.bfloat16)] * 3
    after = tr.model.heads[0].input_module.item_embedding_table()
    assert after.dtype == torch.bfloat16 and not torch.equal(after.detach(), before)


@pytest.mark.parametrize("opt", ["dense", "lazy_adam"])
def test_dense_arms_warn_and_keep_f32_tables(tmp_path, opt):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tr = _trainer(tmp_path, opt, steps=2)
        tr.train()
    assert any("embedding_table_dtype" in str(w.message) for w in caught)
    assert tr.args.embedding_table_dtype is None
    assert _table_dtypes(tr.model) == {torch.float32}


# ----------------------------------------------------------------- serving
def test_export_and_the_runner_serve_a_bf16_model_as_jax_does(tmp_path):
    jmodel, params, tmodel = _pair("flagship")
    batch = _batch(21)
    want_s, want_i = jax.jit(lambda p, b: jmodel.apply(p, b, top_k=10))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    path = export_model(tmodel, batch, str(tmp_path / "art"), top_k=10)

    def build(device):
        return ttr.XLNetConfig.build(d_model=D, n_head=H, n_layer=L, total_seq_length=S,
                                     dropout=0.0).to_model(
            ttr.TabularSequenceFeatures.from_schema(
                flagship.schema(V, S), d_output=D, masking="mlm", aggregation="concat",
                masking_kwargs={"mlm_probability": 0.3}),
            ttr.NextItemPredictionTask(weight_tying=True), device=device)

    runner = InferenceRunner(path, build, device="cpu")
    assert _table_dtypes(runner.model) == {torch.bfloat16}
    scores, ids = runner.predict(batch)
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    np.testing.assert_allclose(scores, want_s, rtol=1e-5, atol=1e-5)
    gaps = np.abs(np.diff(want_s, axis=1)) > 1e-5
    clear = np.ones_like(want_i, dtype=bool)
    clear[:, :-1] &= gaps
    clear[:, 1:] &= gaps
    np.testing.assert_array_equal(ids[clear], want_i[clear])
