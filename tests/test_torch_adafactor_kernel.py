"""The port's streamed and factored Adafactor arms against the JAX package.

The same parameters and gradients, made with numpy from a seed, go through
``fused_adafactor`` and the port's ``FusedAdafactor`` for 3 steps.

- ``use_pallas=True``: the reference's two Pallas passes run in interpret
  mode on the CPU; the port runs ``adafactor_update``, which on CPU tensors
  takes the plain versions of its two CUDA kernels.
- ``min_dim_size_to_factor=64``: the factored second moment, plain tensor
  code on both sides.

Tolerance: float32 arithmetic in another order (the clip's sum of squares
above all), so 1e-6 relative on each parameter's movement and on the
moments, plus 1e-7 absolute on the movement (the parameters are about 0.05,
their float32 spacing about 4e-9).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from transformers4rec_tpu.ops.fused_adafactor import fused_adafactor

from transformers4rec_tpu_torch import flagship
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.ops import fused_adafactor as fa
from transformers4rec_tpu_torch.ops.fused_adafactor import (
    FusedAdafactor,
    adafactor_pass_a_plain,
    adafactor_update,
    adafactor_update_plain,
)

torch.set_num_threads(1)

STEPS = 3
LR = 6.7e-4


def _params_and_grads(shapes, seed, scales):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(0, 0.05, s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(0, 1, s) * scale).astype(np.float32) for k, s in shapes.items()}
             for scale in scales]
    return params, grads


def _run_optax(tx, params, grads):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(p)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, p)
        p = optax.apply_updates(p, updates)
    return {k: np.asarray(v) for k, v in p.items()}, state


def _run_torch(make_opt, params, grads, transpose_grad=()):
    p = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_opt(list(p.values()))
    for g in grads:
        for k in p:
            grad = torch.from_numpy(g[k].copy())
            if k in transpose_grad:  # the same values in a non-contiguous layout
                grad = grad.T.contiguous().T
                assert not grad.is_contiguous()
            p[k].grad = grad
        opt.step()
    return {k: v.detach().numpy() for k, v in p.items()}, {k: opt.state[v] for k, v in p.items()}


@pytest.mark.parametrize("clip", [1.0, None])
def test_streamed_update_follows_the_pallas_passes_in_interpret_mode(clip, monkeypatch):
    # the table takes the two-pass arm (4096 >= 4 * 512 rows); the small
    # table and the bias take the plain chain, in both packages
    shapes = {"item_id_table": (4096, 64), "category_table": (24, 16), "bias": (16,)}
    # step 0 has rms exactly 1; the growing gradients push it above the clip
    params, grads = _params_and_grads(shapes, 0, scales=(1e-2, 1.0, 30.0))
    want, jstate = _run_optax(fused_adafactor(LR, use_pallas=True, clipping_threshold=clip),
                              params, grads)
    calls = []
    monkeypatch.setattr(fa, "adafactor_pass_a_plain",
                        lambda g, *a: (calls.append(tuple(g.shape)),
                                       adafactor_pass_a_plain(g, *a))[1])
    got, state = _run_torch(
        lambda ps: FusedAdafactor(ps, lr=LR, use_pallas=True, clipping_threshold=clip),
        params, grads, transpose_grad=("item_id_table",))
    assert calls == [(4096, 64)] * STEPS
    for k in shapes:
        np.testing.assert_allclose(got[k] - params[k], want[k] - params[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
        assert state[k]["v"].dtype == torch.float32
        np.testing.assert_allclose(state[k]["v"].numpy(), np.asarray(jstate.v[k]), rtol=1e-6,
                                   err_msg=k)
    if clip is not None:
        # the clip did engage: without it the table moves further
        free, _ = _run_torch(
            lambda ps: FusedAdafactor(ps, lr=LR, use_pallas=True, clipping_threshold=None),
            params, grads)
        k = "item_id_table"
        assert np.abs(free[k] - params[k]).max() > 1.2 * np.abs(got[k] - params[k]).max()


@pytest.mark.parametrize("clip", [1.0, None])
def test_two_pass_plain_version_equals_the_plain_chain(clip):
    """With an f32 moment the two passes and the one-chain arm differ only in
    the order of the clip's partial sums."""
    shapes = {"table": (2051, 12)}  # a size off every vector width
    params, grads = _params_and_grads(shapes, 1, scales=(1.0, 1e-3, 50.0))
    chain, cstate = _run_torch(lambda ps: FusedAdafactor(ps, lr=LR, clipping_threshold=clip),
                               params, grads)
    p = torch.from_numpy(params["table"].copy())
    v = torch.zeros_like(p)
    for step, g in enumerate(grads):
        decay = 1.0 - torch.full((), float(step + 1)) ** -0.8
        update = adafactor_update if step % 2 else adafactor_update_plain  # the same on the CPU
        update(p, torch.from_numpy(g["table"]), v, decay, LR, clip, 1e-30)
    np.testing.assert_allclose(p.numpy() - params["table"], chain["table"] - params["table"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(v.numpy(), cstate["table"]["v"].numpy(), rtol=1e-6)


@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("moment", ["f32", "bf16"])
def test_factored_second_moment_follows_the_reference(clip, moment):
    # (120, 64) and (64, 200) are factored, with the larger axis first and
    # last; the small table (second-largest axis 16) and the bias are not
    shapes = {"item_id_table": (120, 64), "wide": (64, 200), "category_table": (24, 16),
              "bias": (16,)}
    params, grads = _params_and_grads(shapes, 2, scales=(1e-2, 1.0, 30.0))
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if moment == "bf16" else (None, None)
    want, jstate = _run_optax(
        fused_adafactor(LR, min_dim_size_to_factor=64, clipping_threshold=clip,
                        moment_dtype=jdt), params, grads)
    got, state = _run_torch(
        lambda ps: FusedAdafactor(ps, lr=LR, min_dim_size_to_factor=64, clipping_threshold=clip,
                                  moment_dtype=tdt), params, grads)
    # a bf16-stored moment may land on a neighbouring bf16 value
    rtol, vtol = (1e-6, 1e-6) if moment == "f32" else (2.0 ** -8, 2.0 ** -7)
    for k, shape in shapes.items():
        np.testing.assert_allclose(got[k] - params[k], want[k] - params[k], rtol=rtol,
                                   atol=1e-7, err_msg=k)
        if k in ("item_id_table", "wide"):
            assert "v" not in state[k]
            small, large = sorted(shape)
            assert state[k]["v_row"].shape == (small,) and state[k]["v_col"].shape == (large,)
            for name, ref in (("v_row", jstate.v_row[k]), ("v_col", jstate.v_col[k])):
                np.testing.assert_allclose(state[k][name].float().numpy(),
                                           np.asarray(ref.astype(jnp.float32)), rtol=vtol,
                                           err_msg=f"{k} {name}")
        else:
            assert set(state[k]) == {"step", "v"}


def test_streamed_update_and_a_moment_dtype_exclude_each_other():
    p = [torch.nn.Parameter(torch.zeros(4, 4))]
    with pytest.raises(ValueError, match="mutually exclusive"):
        FusedAdafactor(p, lr=1e-3, use_pallas=True, moment_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="mutually exclusive"):
        fused_adafactor(1e-3, use_pallas=True, moment_dtype=jnp.bfloat16)


def test_factored_state_survives_a_state_dict_round_trip():
    params, grads = _params_and_grads({"t": (96, 64)}, 3, scales=(1.0, 1.0, 1.0))
    make = lambda ps: FusedAdafactor(ps, lr=LR, min_dim_size_to_factor=64,  # noqa: E731
                                     moment_dtype=torch.bfloat16)
    want, _ = _run_torch(make, params, grads)
    p = torch.nn.Parameter(torch.from_numpy(params["t"].copy()))
    opt = make([p])
    for g in grads[:2]:
        p.grad = torch.from_numpy(g["t"].copy())
        opt.step()
    resumed = make([p])
    resumed.load_state_dict(opt.state_dict())
    assert resumed.state[p]["v_row"].dtype == torch.bfloat16
    p.grad = torch.from_numpy(grads[2]["t"].copy())
    resumed.step()
    np.testing.assert_array_equal(p.detach().numpy(), want["t"])


def test_build_trainer_hands_the_streamed_update_to_the_trainer(monkeypatch):
    """``flagship.build_trainer(streamed_table_update=True)``: an f32 moment on
    both tables, and the item table (2,104 rows here) goes through
    ``adafactor_update`` once per step; the 150-row category table does not."""
    small = dict(num_items=2100, d_model=16, n_layer=1, n_head=2, seq=4)
    data = synthetic_data(flagship.schema(2100, 4), num_rows=16, max_session_length=4, seed=1)
    calls = []
    monkeypatch.setattr(fa, "adafactor_update",
                        lambda p, *a: (calls.append(tuple(p.shape)), adafactor_update(p, *a))[1])
    trainer = flagship.build_trainer("cpu", train_dataset=data, streamed_table_update=True,
                                     **small)
    trainer.args.max_steps = 2
    trainer.args.per_device_train_batch_size = 8
    table = trainer.model.heads[0].input_module.item_embedding_table()
    before = table.detach().clone()
    metrics = trainer.train()
    assert np.isfinite(metrics["train_loss"]) and metrics["train_steps"] == 2
    assert calls == [(2104, 64)] * 2
    opt = trainer.optimizers["table"]
    assert opt.defaults["use_pallas"] and opt.defaults["moment_dtype"] is None
    assert all(s["v"].dtype == torch.float32 for s in opt.state.values())
    assert not torch.equal(table.detach(), before)
    # the default stays the bf16 moment and the one-chain arm
    default = flagship.build_trainer("cpu", train_dataset=data, **small)
    default.create_optimizer_and_scheduler(2)
    assert default.optimizers["table"].defaults["moment_dtype"] == torch.bfloat16
    assert not default.optimizers["table"].defaults["use_pallas"]
