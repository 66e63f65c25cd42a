"""The port's optimizers and schedules against the JAX package's optax chain.

Same parameters and gradients, made with numpy from a seed, go through both
for 5 steps. What is compared is each parameter's total movement (about
1e-3, on parameters of about 0.05). Tolerances: float32 arithmetic in another
order leaves the parameters within 1e-6 of their own size, so 1e-7 absolute
on the movement plus 1e-6 (2e-5 for Adam's longer chain) relative; a
bf16-stored moment may land on a neighbouring bf16 value (one part in 2^8),
which moves an update by up to half of that.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from transformers4rec_tpu.ops.fused_adafactor import fused_adafactor
from transformers4rec_tpu.ops.sparse_update import label_embedding_params as jax_labels
from transformers4rec_tpu.trainer.schedulers import get_scheduler as jax_get_scheduler

from transformers4rec_tpu_torch import flagship
from transformers4rec_tpu_torch.ops.fused_adafactor import FusedAdafactor
from transformers4rec_tpu_torch.ops.sparse_update import label_embedding_params
from transformers4rec_tpu_torch.trainer import (
    T4RecTrainingArguments,
    clip_by_global_norm_,
    get_scheduler,
)

torch.set_num_threads(1)

STEPS = 5
SHAPES = {"item_id_table": (120, 16), "category_table": (24, 16), "bias": (16,)}


def _params_and_grads(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(0, 0.05, s).astype(np.float32) for k, s in SHAPES.items()}
    # gradient scales from 1e-4 to 10 across steps: the update clip engages on some
    grads = [{k: (rng.normal(0, 1, s) * 10.0 ** rng.uniform(-4, 1)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


def _run_optax(tx, params, grads):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(p)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, p)
        p = optax.apply_updates(p, updates)
    return {k: np.asarray(v) for k, v in p.items()}, state


def _run_torch(make_opt, params, grads, before_step=None):
    p = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_opt(list(p.values()))
    for i, g in enumerate(grads):
        for k in p:
            p[k].grad = torch.from_numpy(g[k].copy())
        if before_step is not None:
            before_step(opt, i, [t.grad for t in p.values()])
        opt.step()
    return {k: v.detach().numpy() for k, v in p.items()}, opt


@pytest.mark.parametrize("moment", ["f32", "bf16"])
@pytest.mark.parametrize("lr", ["constant", "schedule"])
def test_fused_adafactor_follows_the_reference(moment, lr):
    params, grads = _params_and_grads()
    jlr = 6.7e-4 if lr == "constant" else jax_get_scheduler("linear", 1e-3, 2, 10)
    tlr = 6.7e-4 if lr == "constant" else get_scheduler("linear", 1e-3, 2, 10)
    want, jstate = _run_optax(
        fused_adafactor(jlr, moment_dtype=jnp.bfloat16 if moment == "bf16" else None),
        params, grads)
    got, opt = _run_torch(
        lambda ps: FusedAdafactor(ps, lr=tlr,
                                  moment_dtype=torch.bfloat16 if moment == "bf16" else None),
        params, grads)
    rtol = 1e-6 if moment == "f32" else 2.0 ** -9
    for i, k in enumerate(SHAPES):
        # compare the total movement: the parameters themselves barely change
        np.testing.assert_allclose(got[k] - params[k], want[k] - params[k], rtol=rtol,
                                   atol=1e-7, err_msg=k)
        v = opt.state[opt.param_groups[0]["params"][i]]["v"]
        assert v.dtype == (torch.bfloat16 if moment == "bf16" else torch.float32)
        np.testing.assert_allclose(v.float().numpy(),
                                   np.asarray(jstate.v[k].astype(jnp.float32)),
                                   rtol=1e-6 if moment == "f32" else 2.0 ** -7, err_msg=k)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
def test_adamw_and_the_clip_follow_the_optax_chain(weight_decay):
    """clip_by_global_norm(1.0) then adamw with a schedule: the dense arm of
    the trainer's chain. Some of the steps' gradients are above the clip's
    norm and some below."""
    params, grads = _params_and_grads(seed=1)
    sched = get_scheduler("cosine", 5e-4, 1, 8, num_cycles=1.25)
    jsched = jax_get_scheduler("cosine", 5e-4, 1, 8, num_cycles=1.25)
    want, _ = _run_optax(
        optax.chain(optax.clip_by_global_norm(1.0),
                    optax.adamw(jsched, b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay)),
        params, grads)
    norms = []

    def before_step(opt, i, gs):
        norms.append(float(clip_by_global_norm_(gs, 1.0)))
        for group in opt.param_groups:
            group["lr"] = sched(i)

    got, _ = _run_torch(
        lambda ps: torch.optim.AdamW(ps, lr=sched(0), betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=weight_decay),
        params, grads, before_step)
    assert min(norms) < 1.0 < max(norms)
    for k in SHAPES:
        np.testing.assert_allclose(got[k] - params[k], want[k] - params[k], rtol=2e-5,
                                   atol=1e-7, err_msg=k)


def test_clip_leaves_small_gradients_bit_identical():
    g = [torch.full((3,), 0.1), torch.full((2, 2), -0.2)]
    keep = [t.clone() for t in g]
    norm = clip_by_global_norm_(g, 1.0)
    assert float(norm) < 1.0 and all(torch.equal(a, b) for a, b in zip(g, keep))
    big = [t * 100 for t in keep]
    clip_by_global_norm_(big, 1.0)
    np.testing.assert_allclose(float(torch.sqrt(sum((t ** 2).sum() for t in big))), 1.0,
                               rtol=1e-6)


SCHEDULES = [
    ("constant", 0, {}),
    ("constant_with_warmup", 7, {}),
    ("linear", 0, {}),
    ("linear", 5, {}),
    ("polynomial", 5, {"power": 2.0}),
    ("cosine", 5, {"num_cycles": 1.25}),
    ("cosine", 0, {"num_cycles": 0.5}),
    ("cosine_with_restarts", 5, {"num_cycles": 3}),
]


@pytest.mark.parametrize("name,warmup,kwargs", SCHEDULES)
def test_schedules_match_the_reference_at_50_steps(name, warmup, kwargs):
    want = jax_get_scheduler(name, 5e-4, warmup, 50, **kwargs)
    got = get_scheduler(name, 5e-4, warmup, 50, **kwargs)
    for step in range(56):  # past the end too
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5, atol=1e-10,
                                   err_msg=f"{name} step {step}")
    with pytest.raises(ValueError):
        get_scheduler("no_such_schedule", 1e-3, 0, 10)


def test_every_embedding_table_is_labelled_table():
    model = flagship.build_model("cpu", num_items=50, d_model=16, n_layer=1, n_head=2, seq=4)
    labels = label_embedding_params(model.named_parameters())
    tables = sorted(n for n, kind in labels.items() if kind == "table")
    assert [n.rsplit(".", 1)[1] for n in tables] == ["category", "item_id"]
    assert set(labels.values()) == {"table", "dense"}
    # the reference's rule on its own names
    want = jax_labels({"categorical_module": {"item_id_table": 0, "category_table": 0},
                       "projection_0": {"kernel": 0}})
    assert want["categorical_module"] == {"item_id_table": "table", "category_table": "table"}
    assert label_embedding_params([("a.item_id_table", None), ("b.kernel", None)]) == {
        "a.item_id_table": "table", "b.kernel": "dense"}


@pytest.mark.parametrize("field,value", [("profile_steps", "1,2"),
                                         ("save_async", True)])
def test_arguments_refuse_what_is_not_ported(field, value):
    """Both options are ported now: the value is kept, and what neither
    package could run is refused (a profile window that ends before it
    starts; the JAX package's checkpoint formats, by name)."""
    assert getattr(T4RecTrainingArguments(**{field: value}), field) == value
    with pytest.raises(ValueError, match="profile_steps"):
        T4RecTrainingArguments(**{field: value, "profile_steps": "2,1"})
    with pytest.raises(ValueError, match="'sharded'"):
        T4RecTrainingArguments(**{field: value, "checkpoint_format": "orbax"})


@pytest.mark.parametrize("field,value", [
    ("embedding_optimizer", "sparse_adam"), ("embedding_optimizer", "sparse_adafactor"),
    ("embedding_optimizer", "lazy_adam"), ("gradient_accumulation_steps", 2),
    ("embedding_table_dtype", "bf16"),
])
def test_arguments_accept_the_table_arms_and_accumulation(field, value, recwarn):
    """Each builds a trainer over a sampled-softmax model that selects its
    arm: the sparse step with its rule (the item table in neither torch
    optimizer), ``LazyAdam`` on the tables, the accumulation count, or
    bf16-stored tables under ``FusedAdafactor``."""
    from transformers4rec_tpu_torch.ops.sparse_update import LazyAdam
    from transformers4rec_tpu_torch.trainer import Trainer

    args = T4RecTrainingArguments(output_dir="unused", data_loader_engine="synthetic",
                                  embedding_moment_dtype="f32", **{field: value})
    model = flagship.build_large_vocab_model("cpu", num_items=50, d_model=16, n_layer=1,
                                             n_head=2, max_n_samples=8)
    trainer = Trainer(model, args, schema=flagship.schema(50, 20), device="cpu")
    trainer.create_optimizer_and_scheduler(1)
    table = model.heads[0].input_module.item_embedding_table()
    in_optimizers = {id(p) for o in trainer.optimizers.values()
                     for g in o.param_groups for p in g["params"]}
    if value in ("sparse_adam", "sparse_adafactor"):
        assert trainer._sparse.rule == value.split("_")[1]
        assert id(table) not in in_optimizers
    else:
        assert trainer._sparse is None and id(table) in in_optimizers
        want = LazyAdam if value == "lazy_adam" else FusedAdafactor
        assert type(trainer.optimizers["table"]) is want
        assert trainer.args.gradient_accumulation_steps == (
            value if field == "gradient_accumulation_steps" else 1)
        assert table.dtype == (torch.bfloat16 if field == "embedding_table_dtype"
                               else torch.float32)


def test_arguments_keep_the_reference_defaults():
    from transformers4rec_tpu.trainer.arguments import T4RecTrainingArguments as JaxArgs

    got, want = T4RecTrainingArguments(), JaxArgs()
    for f in ("learning_rate", "weight_decay", "adam_beta1", "adam_beta2", "adam_epsilon",
              "max_grad_norm", "embedding_optimizer", "embedding_moment_dtype",
              "steps_per_execution", "warmup_steps", "lr_scheduler_type", "num_train_epochs",
              "max_steps", "per_device_train_batch_size", "per_device_eval_batch_size",
              "seed", "logging_steps", "eval_steps", "save_steps",
              "gradient_accumulation_steps", "dataloader_drop_last",
              "learning_rate_num_cosine_cycles_by_epoch"):
        assert getattr(got, f) == getattr(want, f), f
    with pytest.raises(ValueError):
        T4RecTrainingArguments(embedding_moment_dtype="bfloat16")
