"""The sparse-embedding step (``trainer/sparse_embedding_step.py``) and
gradient accumulation, on the CPU, against the port's own dense path and the
JAX package. The cases mirror ``tests/test_sparse_step.py``.

- With one mask and one draw of negatives given to both, the port's sparse
  step (rows gathered outside autograd, ``Model(..., sparse_rows=)``) gives
  the loss of its dense path, and the scatter-add of its row gradients is
  the dense path's item-table gradient, under MLM, CLM and PLM, with swap
  noise and on packed rows; the loss, the row gradients and the dense
  gradients equal the JAX sparse step's on the same weights (the JAX
  draw's mask, JAX negatives, the port's swap draw given to the JAX step).
- Every refusal of ``validate_sparse_config``.
- The sparse arm's whole update against the JAX sparse step
  (``make_sparse_one_step``) from the same weights, at K = 1 and K = 2, on
  ``sparse_adam`` and ``sparse_adafactor``: the joint clip, AdamW on the
  dense weights, Adafactor on the other table, the rows' rule at the
  update's learning rate.
- Accumulation: two micro-steps of the sparse arm make one update from the
  mean of their gradients, clipped once over the joint norm; the dense
  arm's accumulation against ``optax.MultiSteps`` of the JAX optimizer
  chain on the same gradients; a run resumed from a checkpoint taken
  between two micro-steps ends where the unbroken run does.
- The trainer end to end on both sparse arms (loss down, the table's
  ``.grad`` stays ``None``, the rows' state through a checkpoint), and the
  hint at 1M rows.

Sizes: 2,000 items, d_model 32, 1 layer, sessions of 10, batches of 8, 64
negatives, dropout 0. Tolerances: the sparse and dense paths of the port
compute the same float32 sums but the table gradient's in another order
(the embedding backward against index_add_): the loss within 1e-6
relative, gradients within 1e-5 relative plus 1e-7 absolute. Against JAX
(float32 on both sides, the attention's softmax and the products summed in
other orders): the loss within 1e-5 relative, every gradient within 1e-4
in relative Frobenius norm. Optimizer trajectories as
``tests/test_torch_optim.py`` holds them: 2e-5 relative plus 1e-7
absolute. Against the JAX sparse step (its gradients computed apart from
the port's) each tensor's movement in an update is held to 1e-3 and the
rows' moments to 1e-4 in relative Frobenius norm: Adam's step
``m / (sqrt(v) + eps)`` passes a gradient's relative error through where
sqrt(v) lies below eps, and after the clip of 0.05 a few touched rows have
gradients near 1e-9, which carry about 20% of theirs (5e-4 of the table's
movement). Against ``optax.MultiSteps`` the movement of an update is held to
2e-5 relative plus 1e-6 absolute (1e-4 of a step of 1e-2): optax keeps a
running mean of the micro-steps' gradients where the port sums and divides
once, and Adam's first step, ``g / (|g| + eps)``, turns the last-bit
difference of an element whose mean gradient lies near eps into up to 1e-4
of its step.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flax.linen as fnn
import transformers4rec_tpu as jtr
from transformers4rec_tpu.data.synthetic import synthetic_ecommerce_data_schema as jax_schema_fn
from transformers4rec_tpu.masking import masking_registry as jax_masking_registry
from transformers4rec_tpu.model.prediction_task import LogUniformSampler as JaxSampler
from transformers4rec_tpu.trainer import sparse_embedding_step as jstep

from transformers4rec_tpu_torch import (
    NextItemPredictionTask,
    TabularSequenceFeatures,
    convert,
    flagship,
    transformer_registry,
)
from transformers4rec_tpu_torch.data import pack_sessions, synthetic_data
from transformers4rec_tpu_torch.features.embedding import PretrainedEmbeddingsInitializer
from transformers4rec_tpu_torch.model import Head, Model
from transformers4rec_tpu_torch.ops.fused_adafactor import FusedAdafactor
from transformers4rec_tpu_torch.ops.sparse_update import (
    dedupe_row_grads,
    sparse_rows_adam_init,
    sparse_rows_adam_update,
)
from transformers4rec_tpu_torch.trainer import T4RecTrainingArguments, Trainer
from transformers4rec_tpu_torch.trainer import trainer as trainer_mod
from transformers4rec_tpu_torch.trainer.sparse_embedding_step import (
    gather_rows,
    validate_sparse_config,
)

torch.set_num_threads(1)

V, D, H, L, S, ROWS, N_NEG = 2000, 32, 2, 1, 10, 8, 64
ZERO_GRADIENT = "attn.k.bias"  # the softmax ignores it: rounding noise in both
ITEM_TABLE = "heads.0.body.blocks.0.categorical_module.tables.item_id"
ARCH = {"mlm": "xlnet", "clm": "gpt2", "plm": "xlnet"}
MASKING = {"mlm": {"mlm_probability": 0.3}, "plm": {"plm_probability": 0.5,
                                                     "max_span_length": 3}}


def _rel_fro(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _schema():
    return flagship.schema(V, S)


def _batch(seed, rows=ROWS, packed=False):
    if packed:
        data = synthetic_data(_schema(), num_rows=rows * 3, max_session_length=S, ragged=True,
                              seed=seed)
        return pack_sessions(data, max_len=S, item_id_col="item_id")
    return synthetic_data(_schema(), num_rows=rows, max_session_length=S, seed=seed)


def _port_model(scheme, pre=None, sampled=True, tying=True, **im_kwargs):
    im = TabularSequenceFeatures.from_schema(_schema(), d_output=D, masking=scheme,
                                             aggregation="concat",
                                             masking_kwargs=MASKING.get(scheme), pre=pre,
                                             **im_kwargs)
    task = NextItemPredictionTask(weight_tying=tying, sampled_softmax=sampled,
                                  max_n_samples=N_NEG, target_dim=None if tying else V + 1)
    return transformer_registry.parse(ARCH.get(scheme, "electra")).build(
        d_model=D, n_head=H, n_layer=L, total_seq_length=S, dropout=0.0).to_model(
        im, task, device="cpu")


def _jax_pair(scheme, pre=None):
    """The JAX model and the port's, with the JAX weights."""
    schema = jax_schema_fn(num_items=V, num_categories=flagship.NUM_CATEGORIES,
                           max_session_length=S)
    jim = jtr.TabularSequenceFeatures.from_schema(schema, d_output=D, masking=scheme,
                                                  aggregation="concat",
                                                  masking_kwargs=MASKING.get(scheme), pre=pre)
    jmodel = jtr.transformer_registry.parse(ARCH[scheme]).build(
        d_model=D, n_head=H, n_layer=L, total_seq_length=S, dropout=0.0).to_model(
        jim, jtr.NextItemPredictionTask(weight_tying=True, sampled_softmax=True,
                                        max_n_samples=N_NEG))
    init = {k: jnp.asarray(v) for k, v in _batch(0, rows=4).items()}
    rngs = {k: jax.random.PRNGKey(i) for i, k in
            enumerate(("params", "masking", "dropout", "sampling", "augment"))}
    params = jax.tree.map(np.asarray, jax.jit(
        lambda b: jmodel.init(rngs, b, training=True))(init))
    tmodel = _port_model(scheme, pre=pre)
    tmodel.load_state_dict(convert.params_from_jax(params))  # strict
    return jim, jmodel, params, tmodel


def _jax_mask(scheme, batch, monkeypatch):
    """The JAX draw of the mask, returned by the JAX masking in training."""
    jcls = jax_masking_registry.parse(scheme)
    seg = batch.get("segment_ids")
    info = jcls.compute_masked_targets(
        jcls(hidden_size=D, **MASKING.get(scheme, {})), jax.random.PRNGKey(3),
        jnp.asarray(batch["item_id"]), training=True,
        **({} if seg is None else {"segment_ids": jnp.asarray(seg)}))
    original = jcls.compute_masked_targets

    def jax_masks(self, rng, item_ids, training=False, testing=False, segment_ids=None):
        return info if training else original(self, rng, item_ids, training, testing,
                                              segment_ids)

    monkeypatch.setattr(jcls, "compute_masked_targets", jax_masks)
    return info


def _port_info(info):
    return convert.masking_info_from_jax(
        np.asarray(info.targets), np.asarray(info.mask), np.asarray(info.pad_mask),
        input_schema=np.asarray(info.input_schema),
        perm_mask=None if info.perm_mask is None else np.asarray(info.perm_mask))


def _dense_step(model, batch, info):
    model.zero_grad(set_to_none=True)
    loss, _ = model(batch, targets=batch, training=True, masking_info=info)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return float(loss.detach()), grads


def _sparse_step(model, batch, info, neg, scheme, aug=None):
    model.zero_grad(set_to_none=True)
    table = model.heads[0].input_module.item_embedding_table()
    rows, ids = gather_rows(table, batch["item_id"], neg, scheme, aug_inputs=aug)
    loss, _ = model(batch, targets=batch, training=True, masking_info=info, sparse_rows=rows)
    loss.backward()
    assert table.grad is None
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return float(loss.detach()), grads, ids, rows.rows.grad


@pytest.mark.parametrize("case", ["mlm", "clm", "plm", "mlm_swap_noise", "clm_packed"])
def test_the_sparse_step_is_the_dense_path_and_jax_sparse_step(case, monkeypatch):
    scheme = case.split("_")[0]
    pre = "stochastic-swap-noise" if case.endswith("swap_noise") else None
    jim, jmodel, params, tmodel = _jax_pair(scheme, pre=pre)
    batch = _batch(11, packed=case.endswith("packed"))
    if "segment_ids" in batch:
        assert int(batch["segment_ids"].max()) > 1
    info = _jax_mask(scheme, batch, monkeypatch)
    neg = np.asarray(JaxSampler(N_NEG, V + 1, 1).sample(jax.random.PRNGKey(4))).astype(np.int64)
    tb = tmodel._as_dense(batch)
    tneg = torch.from_numpy(neg)
    aug = None
    if pre is not None:
        # the port's swap draw: the dense path applies it through ``draws``,
        # the sparse paths (port and JAX) receive the swapped inputs
        ssn = getattr(tmodel.heads[0].input_module, tmodel.heads[0].input_module._pre_names[0])
        ssn.draws = ssn.draw(tb, pad_mask=tb["item_id"] != 0,
                             generator=torch.Generator().manual_seed(8))
        aug = ssn(tb, training=True)
        assert int((aug["item_id"] != tb["item_id"]).sum()) > 0
    tinfo = _port_info(info)
    # the dense path reads the negatives from the reserved batch key
    loss_d, grads_d = _dense_step(tmodel, {**tb, "__neg_ids__": tneg}, tinfo)
    loss_s, grads_s, ids, g_rows = _sparse_step(tmodel, tb, tinfo, tneg, scheme, aug)
    np.testing.assert_allclose(loss_s, loss_d, rtol=1e-6)
    scattered = torch.zeros_like(grads_d[ITEM_TABLE]).index_add_(0, ids, g_rows)
    np.testing.assert_allclose(scattered.numpy(), grads_d[ITEM_TABLE].numpy(), rtol=1e-5,
                               atol=1e-7)
    assert set(grads_s) == set(grads_d) - {ITEM_TABLE}
    for n, g in grads_s.items():
        np.testing.assert_allclose(g.numpy(), grads_d[n].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=n)

    # the JAX sparse step: rows gathered outside autodiff, its interceptor
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["__neg_ids__"] = jnp.asarray(neg, jnp.int32)
    path = jstep.find_table_path(params, "item_id")
    table = jnp.asarray(jstep.tree_get(params, path))
    B = tb["item_id"].shape[0]
    n_in = B * S
    pmap = jnp.asarray(jstep._pos_map(scheme, B, S))
    jaug, neg_base = None, n_in
    if aug is not None:
        jaug = {k: jnp.asarray(aug[k].numpy()) for k in batch}
        pmap, neg_base = pmap + n_in, 2 * n_in
    all_ids = jnp.asarray(ids.numpy(), jnp.int32)
    dense_tree = jax.tree.map(jnp.asarray, jstep.tree_set(params, path, None))
    rngs = {"masking": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "sampling": jax.random.PRNGKey(2), "augment": jax.random.PRNGKey(5)}

    def jax_loss(dense_tree, rows):
        full = jstep.tree_set(dense_tree, path, jax.lax.stop_gradient(table))
        with fnn.intercept_methods(jstep.make_interceptor(
                rows, "item_id", n_in, pmap, jb["__neg_ids__"], neg_base=neg_base,
                aug_inputs=jaug)):
            return jmodel.apply(full, jb, targets=jb, training=True, compute_metrics=False,
                                rngs=rngs)[0]

    want_loss, (want_gd, want_rows) = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1)))(
        dense_tree, jnp.take(table, all_ids, axis=0))
    np.testing.assert_allclose(loss_s, float(want_loss), rtol=1e-5)
    assert _rel_fro(g_rows.numpy(), np.asarray(want_rows)) <= 1e-4
    want = convert.params_from_jax(jax.tree.map(np.asarray, jstep.tree_set(
        jax.tree.map(np.asarray, want_gd), path, np.zeros(table.shape, np.float32))))
    for n, g in grads_s.items():
        if not n.endswith(ZERO_GRADIENT):
            assert _rel_fro(g.numpy(), want[n].numpy()) <= 1e-4, n


# ------------------------------------------------------------------ refusals
@pytest.mark.parametrize("pre", ["layer-norm", ["stochastic-swap-noise", "layer-norm"]])
def test_validation_refuses_a_layer_norm_pre(pre):
    """A model with ``pre="layer-norm"`` (built from the raw columns' widths)
    is refused, as the JAX package's ``validate_sparse_config`` refuses it:
    swap noise is the only pre transformation the step composes with."""
    model = _port_model("mlm", pre=pre)
    assert hasattr(model.heads[0].input_module, "TabularLayerNorm_0")
    with pytest.raises(NotImplementedError, match="StochasticSwapNoise"):
        validate_sparse_config(model)


def test_validation_refuses_what_the_step_cannot_gather():
    assert validate_sparse_config(_port_model("mlm"))[1:] == ("item_id", "mlm")
    assert validate_sparse_config(_port_model("mlm", pre="stochastic-swap-noise"))
    with pytest.raises(NotImplementedError, match="sampled_softmax"):
        validate_sparse_config(_port_model("mlm", sampled=False))
    with pytest.raises(NotImplementedError, match="sampled_softmax"):
        validate_sparse_config(_port_model("mlm", tying=False))
    with pytest.raises(NotImplementedError, match="mlm/clm"):
        validate_sparse_config(_port_model("rtd"))
    with pytest.raises(NotImplementedError, match="StochasticSwapNoise"):
        validate_sparse_config(_port_model("mlm", pre="dropout"))
    frozen = np.random.default_rng(0).normal(size=(V + 1, 64)).astype(np.float32)
    with pytest.raises(NotImplementedError, match="frozen"):
        validate_sparse_config(_port_model("mlm", embeddings_initializers={
            "item_id": PretrainedEmbeddingsInitializer(frozen, trainable=False)}))
    model = _port_model("mlm")
    two = Model([model.heads[0], copy.deepcopy(model.heads[0])], device="cpu")
    with pytest.raises(NotImplementedError, match="exactly one head"):
        validate_sparse_config(two)
    head = model.heads[0]
    two_tasks = Head(head.body, [head.tasks[0], copy.deepcopy(head.tasks[0])])
    with pytest.raises(NotImplementedError, match="exactly one head"):
        validate_sparse_config(Model([two_tasks], device="cpu"))


# ------------------------------------------------------------------ trainers
def _trainer(tmp_path, opt, k=1, steps=4, clip=1.0, model=None, **kw):
    args = T4RecTrainingArguments(
        output_dir=str(tmp_path), data_loader_engine="synthetic", max_sequence_length=S,
        per_device_train_batch_size=ROWS, per_device_eval_batch_size=ROWS, max_steps=steps,
        learning_rate=1e-2, logging_steps=1, embedding_optimizer=opt,
        gradient_accumulation_steps=k, max_grad_norm=clip, seed=5, **kw)
    return Trainer(model or _port_model("mlm"), args, schema=_schema(), device="cpu")


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def test_sparse_accumulation_is_one_update_from_the_clipped_mean(tmp_path):
    """K = 2: after the first micro-step nothing moved; after the second the
    weights are one update from the mean of the two micro-steps' gradients
    (the rows' deduplicated over both), clipped once over the joint norm
    (a clip of 0.05 engages), each micro-step's draws replayed from the
    trainer's generator."""
    CLIP = 0.05
    tr = _trainer(tmp_path, "sparse_adam", k=2, clip=CLIP)
    tr._train_dataloader = [_batch(1), _batch(2)]
    ref = copy.deepcopy(tr.model)
    before = _params(tr.model)
    tr.create_optimizer_and_scheduler(4)
    gen_state = tr._generator.get_state()
    b1, b2 = (tr.model._as_dense(b) for b in tr._train_dataloader)
    tr._train_step(b1)
    for n, p in tr.model.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
    tr._train_step(b2)
    table = tr.model.heads[0].input_module.item_embedding_table()
    assert table.grad is None and int(tr._sparse.state.count) == 1

    # the reference: the same draws, mean, one joint clip, one update
    step = copy.copy(tr._sparse)
    step.model, step.table = ref, ref.heads[0].input_module.item_embedding_table()
    gen = torch.Generator().manual_seed(0)
    gen.set_state(gen_state)
    dense = {n: torch.zeros_like(p) for n, p in ref.named_parameters()
             if p is not step.table}
    all_ids, all_rows = [], []
    for b in (b1, b2):
        ref.zero_grad(set_to_none=True)
        rows, ids, b_neg = step.gather(b, gen)
        loss, _ = ref(b_neg, targets=b_neg, training=True, generator=gen, sparse_rows=rows)
        loss.backward()
        for n, p in ref.named_parameters():
            if p.grad is not None:
                dense[n] += p.grad
        all_ids.append(ids)
        all_rows.append(rows.rows.grad / 2)
    dense = {n: g / 2 for n, g in dense.items()}
    uids, g_sum = dedupe_row_grads(torch.cat(all_ids), torch.cat(all_rows), V + 7 - (V + 7) % 8)
    norm = torch.sqrt(sum((g ** 2).sum() for g in list(dense.values()) + [g_sum]))
    scale = min(1.0, CLIP / float(norm))
    assert scale < 1.0
    named = dict(ref.named_parameters())
    for n, p in named.items():
        p.grad = dense[n] * scale if n in dense else None
    torch.optim.AdamW([p for n, p in named.items() if "tables." not in n], lr=1e-2,
                      weight_decay=0.0).step()
    FusedAdafactor([named["heads.0.body.blocks.0.categorical_module.tables.category"]],
                   lr=1e-2, moment_dtype=torch.bfloat16).step()
    sparse_rows_adam_update(step.table.data, sparse_rows_adam_init(step.table.detach()),
                            uids, g_sum * scale, 1e-2, deduped=True)
    got = dict(tr.model.named_parameters())
    for n, p in ref.named_parameters():
        np.testing.assert_allclose(got[n].detach().numpy(), p.detach().numpy(), rtol=2e-5,
                                   atol=1e-7, err_msg=n)


class _ReplayedNegatives:
    """The JAX step's sampler, handing it the negatives drawn for its key:
    chosen by comparing keys (integers), so one compiled step serves every
    micro-step."""

    def __init__(self, keys, negs):
        self.keys, self.negs = keys, [jnp.asarray(n, jnp.int32) for n in negs]

    def sample(self, key):
        out = self.negs[0]
        for k, n in zip(self.keys[1:], self.negs[1:]):
            out = jnp.where(jnp.all(key == k), n, out)
        return out


def _jax_masks_by_batch(scheme, batches, monkeypatch):
    """The JAX draws of the masks of ``batches``; in training the JAX masking
    returns the draw of the batch whose ids it is given (chosen by comparing
    ids, so one compiled step serves every micro-step)."""
    jcls = jax_masking_registry.parse(scheme)
    module = jcls(hidden_size=D, **MASKING.get(scheme, {}))
    ids = [jnp.asarray(b["item_id"]) for b in batches]
    infos = [jcls.compute_masked_targets(module, jax.random.PRNGKey(30 + i), x, training=True)
             for i, x in enumerate(ids)]
    original = jcls.compute_masked_targets

    def jax_masks(self, rng, item_ids, training=False, testing=False, segment_ids=None):
        if not training:
            return original(self, rng, item_ids, training, testing, segment_ids)
        out = infos[0]
        for x, info in zip(ids[1:], infos[1:]):
            hit = jnp.all(item_ids == x)
            out = jax.tree.map(lambda a, b, hit=hit: jnp.where(hit, b, a), out, info)
        return out

    monkeypatch.setattr(jcls, "compute_masked_targets", jax_masks)
    return infos


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("opt", ["sparse_adam", "sparse_adafactor"])
def test_the_sparse_arm_updates_as_the_jax_sparse_step(tmp_path, monkeypatch, opt, k):
    """The port's sparse arm against the JAX package's sparse step
    (``make_sparse_one_step``) from the same weights, two updates of K
    micro-steps each: the JAX draw's masks and the same negatives on both
    sides, a clip of 0.05 that engages, a linear schedule over the
    micro-steps (so a rate read at the wrong count shows), AdamW on the
    dense weights and Adafactor on the category table as the JAX trainer
    builds them, float32 moments. Each micro-step's loss agrees; at K = 2
    nothing moves after the first micro-step; after each update the dense
    weights, the item table, the rows' moments and the count agree."""
    from types import SimpleNamespace

    from transformers4rec_tpu.ops import sparse_update as J
    from transformers4rec_tpu.ops.fused_adafactor import fused_adafactor
    from transformers4rec_tpu.trainer.schedulers import get_scheduler as jax_scheduler
    from transformers4rec_tpu.trainer.trainer import TrainState

    CLIP, LR, n_micro = 0.05, 1e-2, 2 * k
    _, jmodel, params, tmodel = _jax_pair("mlm")
    batches = [_batch(40 + i) for i in range(n_micro)]
    infos = _jax_masks_by_batch("mlm", batches, monkeypatch)
    # the JAX step's key for its negatives at each micro-step, and a draw for each
    keys, negs, r = [], [], jax.random.PRNGKey(42)
    for i in range(n_micro):
        rng, r = jax.random.split(r)
        keys.append(jax.random.fold_in(rng, 4))
        negs.append(np.asarray(JaxSampler(N_NEG, V + 1, 1).sample(
            jax.random.PRNGKey(50 + i))).astype(np.int64))
    tinfos = [convert.masking_info_from_jax(
        np.asarray(f.targets), np.asarray(f.mask), np.asarray(f.pad_mask),
        input_schema=np.asarray(f.input_schema), neg_ids=n) for f, n in zip(infos, negs)]
    tbs = [tmodel._as_dense(b) for b in batches]

    # the clip engages: the norm of the first update's mean gradient (the
    # port's dense path, whose table gradient is the rows' summed)
    probe = copy.deepcopy(tmodel)
    mean = {}
    for tb, info, n in zip(tbs[:k], tinfos, negs):
        for name, g in _dense_step(probe, {**tb, "__neg_ids__": torch.from_numpy(n)},
                                   info)[1].items():
            mean[name] = mean.get(name, 0) + g / k
    assert float(torch.sqrt(sum((g ** 2).sum() for g in mean.values()))) > 4 * CLIP

    sched = jax_scheduler("linear", LR, 0, n_micro)
    dense_tx = optax.multi_transform(
        {"dense": optax.adamw(sched, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0),
         "table": fused_adafactor(learning_rate=sched)}, J.label_embedding_params)
    args = SimpleNamespace(max_grad_norm=CLIP, gradient_accumulation_steps=k, adam_beta1=0.9,
                           adam_beta2=0.999, adam_epsilon=1e-8)
    path = jstep.find_table_path(params, "item_id")
    rule = "adafactor" if opt == "sparse_adafactor" else "adam"
    one_step = jax.jit(jstep.make_sparse_one_step(
        jmodel, args, path, "item_id", "mlm", _ReplayedNegatives(keys, negs), dense_tx, sched,
        rule=rule))
    jparams = jax.tree.map(jnp.asarray, params)
    table = jstep.tree_get(jparams, path)
    dense_tree = jstep.tree_set(jparams, path, None)
    init = J.sparse_rows_adafactor_init if rule == "adafactor" else J.sparse_rows_adam_init
    opt_state = (dense_tx.init(dense_tree), init(table))
    if k > 1:
        opt_state += (jstep.sparse_accum_init(dense_tree, ROWS * S + N_NEG, table.shape[1], k),)
    state = TrainState(params=jparams, opt_state=opt_state, step=jnp.zeros((), jnp.int32),
                       rng=jax.random.PRNGKey(42))

    tr = _trainer(tmp_path, opt, k=k, steps=n_micro, clip=CLIP, model=tmodel,
                  embedding_moment_dtype="f32")
    tr.create_optimizer_and_scheduler(n_micro)
    start = jstart = _params(tmodel)
    for i, (b, tb, info) in enumerate(zip(batches, tbs, tinfos)):
        before = _params(tmodel)
        loss = tr._train_step(tb, masking_info=info)
        state, jloss = one_step(state, {k_: jnp.asarray(v) for k_, v in b.items()})
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, err_msg=f"loss {i}")
        if (i + 1) % k:
            for n, p in tmodel.named_parameters():
                assert torch.equal(p.detach(), before[n]), n
            continue
        assert tmodel.heads[0].input_module.item_embedding_table().grad is None
        want = convert.params_from_jax(jax.tree.map(np.asarray, state.params))
        for n, p in tmodel.named_parameters():
            if not n.endswith(ZERO_GRADIENT):
                moved = _rel_fro((p.detach() - start[n]).numpy(), (want[n] - jstart[n]).numpy())
                assert moved <= 1e-3, f"{n} after micro-step {i}: {moved}"
        ts = tr._sparse.state
        js = convert.sparse_state_from_jax(jax.tree.map(np.asarray, state.opt_state[1]))
        assert int(ts.count) == int(js.count) == (i + 1) // k
        for name in ("mu", "nu", "v"):
            if hasattr(ts, name):
                got = _rel_fro(getattr(ts, name).numpy(), getattr(js, name).numpy())
                assert got <= 1e-4, f"{name} after micro-step {i}: {got}"
        start, jstart = _params(tmodel), want


@pytest.mark.parametrize("opt", ["adafactor", "lazy_adam"])
def test_dense_accumulation_is_optax_multisteps(tmp_path, opt):
    """A dense arm at K = 2 over 4 micro-steps (a full-softmax model, a clip
    of 0.5 that engages, a linear schedule over the updates) against
    ``optax.MultiSteps(chain(clip, multi_transform(adamw, table rule)), 2)``
    of the JAX package fed the same micro-step gradients: each recomputed
    from the weights of its update with the trainer's draws replayed."""
    from transformers4rec_tpu.ops.fused_adafactor import fused_adafactor
    from transformers4rec_tpu.ops.sparse_update import lazy_adam
    from transformers4rec_tpu.trainer.schedulers import get_scheduler as jax_scheduler

    model = _port_model("mlm", sampled=False)
    tr = _trainer(tmp_path, opt, k=2, steps=4, clip=0.5, model=model,
                  embedding_moment_dtype="f32")
    tr.create_optimizer_and_scheduler(4)
    batches = [model._as_dense(_batch(20 + i)) for i in range(4)]
    snapshots = [_params(model)]
    for i, b in enumerate(batches):
        tr._train_step(b)
        if i % 2 == 0:  # mid-accumulation: nothing moved
            for n, p in model.named_parameters():
                assert torch.equal(p.detach(), snapshots[-1][n]), n
        else:
            snapshots.append(_params(model))

    replay = copy.deepcopy(model)
    gen = torch.Generator().manual_seed(tr.args.seed + 17)
    micro = []
    for i, b in enumerate(batches):
        replay.load_state_dict(snapshots[i // 2])
        replay.zero_grad(set_to_none=True)
        loss, _ = replay(b, targets=b, training=True, generator=gen)
        loss.backward()
        micro.append({n: jnp.asarray(p.grad.numpy()) for n, p in replay.named_parameters()})
    labels = {n: ("table" if "tables." in n else "dense") for n in snapshots[0]}
    sched = jax_scheduler("linear", 1e-2, 0, 4)
    table_tx = lazy_adam(sched) if opt == "lazy_adam" else fused_adafactor(sched)
    tx = optax.MultiSteps(optax.chain(
        optax.clip_by_global_norm(0.5),
        optax.multi_transform({"dense": optax.adamw(sched, weight_decay=0.0),
                               "table": table_tx}, labels)), 2)
    jp = {n: jnp.asarray(v.numpy()) for n, v in snapshots[0].items()}
    js = tx.init(jp)
    update = jax.jit(tx.update)
    for i, g in enumerate(micro):
        upd, js = update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        if i % 2 == 1:
            got, start = snapshots[i // 2 + 1], snapshots[i // 2]
            for n in got:
                np.testing.assert_allclose((got[n] - start[n]).numpy(),
                                           np.asarray(jp[n]) - start[n].numpy(),
                                           rtol=2e-5, atol=1e-6, err_msg=f"{n} update {i // 2}")
            # the next update starts from the port's weights in both
            jp = {n: jnp.asarray(v.numpy()) for n, v in got.items()}
    assert tr._opt_step == 2


@pytest.mark.parametrize("opt", ["sparse_adam", "adafactor"])
def test_a_resume_between_micro_steps_continues_the_accumulation(tmp_path, opt):
    """K = 2, a save after micro-step 3 (half an update pending): the run
    resumed from it ends where the unbroken 6 micro-steps end, bit for
    bit (the pending gradient sums, the sparse rows' buffers and state
    travel in the checkpoint)."""
    def run(out, resume=None):
        model = _port_model("mlm")
        tr = _trainer(out, opt, k=2, steps=6, model=model, save_steps=3)
        tr.train(resume_from_checkpoint=resume)
        return tr

    whole = run(tmp_path / "a")
    resumed = run(tmp_path / "b", resume=str(tmp_path / "a" / "checkpoint-3"))
    assert resumed.state.global_step == 6 and resumed._opt_step == 3 == whole._opt_step
    got = dict(resumed.model.named_parameters())
    for n, p in whole.model.named_parameters():
        assert torch.equal(got[n].detach(), p.detach()), n
    if opt == "sparse_adam":
        assert torch.equal(resumed._sparse.state.mu, whole._sparse.state.mu)
        assert int(resumed._sparse.state.count) == 3


@pytest.mark.parametrize("opt", ["sparse_adam", "sparse_adafactor"])
def test_the_sparse_arms_train_end_to_end(tmp_path, opt):
    """24 micro-steps at K = 2 (steps_per_execution 3) on swap-noised MLM,
    one batch repeated: the loss goes down (the mean of the last 6 below the
    first 6's), the item table moves without ever holding a gradient, the
    other table keeps its Adafactor, the rows' state and its bf16 moments
    survive a checkpoint, and evaluation runs."""
    model = _port_model("mlm", pre="stochastic-swap-noise")
    tr = _trainer(tmp_path, opt, k=2, steps=24, model=model, save_steps=24,
                  steps_per_execution=3)
    tr._train_dataloader = [_batch(3)] * 24
    table = model.heads[0].input_module.item_embedding_table()
    before = table.detach().clone()
    tr.train()
    hist = [h["loss"] for h in tr.state.log_history if "loss" in h]
    assert np.isfinite(hist).all() and np.mean(hist[-6:]) < np.mean(hist[:6]), hist
    assert table.grad is None and not torch.equal(table.detach(), before)
    st = tr._sparse.state
    assert int(st.count) == 12
    moment = st.mu if opt == "sparse_adam" else st.v
    assert moment.dtype == torch.bfloat16
    assert all(p is not table for o in tr.optimizers.values()
               for g in o.param_groups for p in g["params"])
    want = moment.clone()
    tr.load(str(tmp_path / "checkpoint-24"))
    got = tr._sparse.state.mu if opt == "sparse_adam" else tr._sparse.state.v
    assert torch.equal(got, want)
    assert np.isfinite(tr.evaluate()["eval_loss"])


def test_the_hint_at_a_million_rows(tmp_path, monkeypatch):
    """A model that qualifies for the sparse step, on a dense table arm,
    hears of ``sparse_adam`` once its tied table reaches the threshold
    (patched to 1,000 rows); a full-softmax model does not."""
    import warnings

    monkeypatch.setattr(trainer_mod, "SPARSE_HINT_MIN_ROWS", 1000)
    with pytest.warns(UserWarning, match="sparse_adam"):
        _trainer(tmp_path, "adafactor", steps=1).train()
    with pytest.warns(UserWarning, match="sparse_adam"):
        _trainer(tmp_path, "adafactor", k=2, steps=2).train()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _trainer(tmp_path, "adafactor", steps=1, model=_port_model("mlm", sampled=False)).train()
        _trainer(tmp_path, "sparse_adam", steps=1).train()
    assert not [w for w in caught if "sparse_adam" in str(w.message)]
    monkeypatch.setattr(trainer_mod, "SPARSE_HINT_MIN_ROWS", 1_000_000)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _trainer(tmp_path, "adafactor", steps=1).train()
    assert not [w for w in caught if "sparse_adam" in str(w.message)]
