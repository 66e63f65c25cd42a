"""The port's row-wise table optimizers (``ops/sparse_update.py``) against the
JAX package's, on the CPU: ``LazyAdam`` against ``lazy_adam``,
``dedupe_row_grads``, ``sparse_rows_adam_update`` and
``sparse_rows_adafactor_update`` from zero and from a nonzero state (made
with numpy, carried by ``convert.sparse_state_from_jax``), with float32 and
bf16 moments, and ``sharded_rows_adam_update`` against the unsharded
update. The cases mirror ``tests/test_sparse_update.py``.

Inputs come from a numpy seed: a (64, 8) table of scale 0.1, row gradients
of scale 1 (5 for the Adafactor clip), ids with repeats, and a schedule
that differs at every count (so reading it at the wrong count shows).

Tolerances. Both packages compute in float32 with the same formulas; only
the order of the segment sums and the library ``pow`` may differ by an
ulp, so parameters are held to 1e-6 absolute (a step moves them by about
0.1 at most) and float32 moments to 1e-6 relative. A bf16-stored moment
may round to the neighbouring bf16 value when its float32 value differs by
an ulp at a rounding boundary: moments to one bf16 ulp (2^-8 relative),
parameters to 1e-5. Untouched rows (and their moments) are held bit for bit.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from transformers4rec_tpu.ops import sparse_update as J

from transformers4rec_tpu_torch import convert
from transformers4rec_tpu_torch.ops.sparse_update import (
    LazyAdam,
    dedupe_row_grads,
    sharded_rows_adam_update,
    sparse_rows_adafactor_init,
    sparse_rows_adafactor_update,
    sparse_rows_adam_init,
    sparse_rows_adam_update,
)

torch.set_num_threads(1)

V, E = 64, 8
BF16_ULP = 2.0 ** -8


def schedule(count):
    """A rate that differs at every count; JAX calls it with a traced count."""
    return 0.1 / (1.0 + 0.5 * count)


def _table(seed=0):
    return (np.random.default_rng(seed).normal(size=(V, E)) * 0.1).astype(np.float32)


def _draws(seed, n, steps, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, V, n).astype(np.int64),
             (rng.normal(size=(n, E)) * scale).astype(np.float32)) for _ in range(steps)]


def _dense(ids, rg):
    g = np.zeros((V, E), np.float32)
    np.add.at(g, ids, rg)
    return g


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ lazy adam
@pytest.mark.parametrize("shape", [(V, E), (V,)], ids=["rows", "elements"])
def test_lazy_adam_matches_jax_and_freezes_untouched(shape):
    """Four steps, each touching a few rows (elements of a 1-D parameter):
    the parameter and both moments follow JAX's ``lazy_adam``; what no step
    touched is unchanged, bit for bit; a later step touching other rows
    leaves the first rows' moments as they were."""
    p0 = np.random.default_rng(1).normal(size=shape).astype(np.float32) * 0.1
    rng = np.random.default_rng(2)
    grads = []
    for _ in range(4):
        g = np.zeros(shape, np.float32)
        rows = rng.integers(0, 20, 5)  # rows 20.. are never touched
        g[rows] = rng.normal(size=(5,) + shape[1:]).astype(np.float32)
        grads.append(g)
    tx = J.lazy_adam(schedule)
    jp, js = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(_t(p0))
    opt = LazyAdam([tp], lr=schedule)
    for g in grads:
        upd, js = tx.update(jnp.asarray(g), js)
        jp = optax.apply_updates(jp, upd)
        tp.grad = _t(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    st = opt.state[tp]
    np.testing.assert_allclose(st["mu"].numpy(), np.asarray(js.mu), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(st["nu"].numpy(), np.asarray(js.nu), rtol=1e-6, atol=1e-12)
    assert st["step"] == int(js.count) == 4
    np.testing.assert_array_equal(tp.detach().numpy()[20:], p0[20:])
    np.testing.assert_array_equal(st["mu"].numpy()[20:], 0.0)
    # a step touching row 30 only keeps every other row's moments
    mu_before = st["mu"].clone()
    g = np.zeros(shape, np.float32)
    g[30] = 1.0
    tp.grad = _t(g)
    opt.step()
    keep = np.arange(shape[0]) != 30
    np.testing.assert_array_equal(st["mu"].numpy()[keep], mu_before.numpy()[keep])


def test_lazy_adam_is_adam_when_every_row_is_touched():
    g = np.random.default_rng(3).normal(size=(V, E)).astype(np.float32)
    g[g == 0] = 1e-3
    p0 = _table(4)
    ref, jp = optax.adam(1e-2), jnp.asarray(p0)
    js = ref.init(jp)
    tp = torch.nn.Parameter(_t(p0))
    opt = LazyAdam([tp], lr=1e-2)
    for _ in range(3):
        upd, js = ref.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = _t(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------- dedupe
def test_dedupe_matches_jax():
    ids = np.array([5, 3, 5, 9, 3, 5, 63, 0, 0], np.int64)
    rg = np.arange(len(ids) * E, dtype=np.float32).reshape(len(ids), E) / 7.0
    got_u, got_s = dedupe_row_grads(_t(ids), _t(rg), V)
    want_u, want_s = J.dedupe_row_grads(jnp.asarray(ids, jnp.int32), jnp.asarray(rg), V)
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6)
    # unique ids ascending, then the padding slots: sentinel id, zero gradient
    assert got_u.numpy().tolist() == [0, 3, 5, 9, 63, V, V, V, V]
    np.testing.assert_array_equal(got_s.numpy()[5:], 0.0)
    np.testing.assert_allclose(got_s.numpy()[2], rg[0] + rg[2] + rg[5], rtol=1e-6)


# ------------------------------------------------------------ sparse rows rules
def _nonzero_state(rule, moment_dtype, seed=5):
    """A JAX state with every moment nonzero (and nu, v positive), count 7."""
    rng = np.random.default_rng(seed)
    dt = jnp.bfloat16 if moment_dtype == "bf16" else jnp.float32
    count = jnp.asarray(7, jnp.int32)
    if rule == "adam":
        return J.SparseRowsAdamState(
            count=count, mu=jnp.asarray(rng.normal(size=(V, E)) * 0.1, dt),
            nu=jnp.asarray(rng.uniform(0.01, 0.2, (V, E)), dt))
    return J.SparseRowsAdafactorState(count=count,
                                      v=jnp.asarray(rng.uniform(0.01, 0.2, (V, E)), dt))


def _moments(state):
    return {k: getattr(state, k) for k in ("mu", "nu", "v") if hasattr(state, k)}


def _as_np(x):
    x = np.asarray(x) if not torch.is_tensor(x) else x.float().numpy()
    return x.astype(np.float32)


@pytest.mark.parametrize("moment_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("start", ["zero", "nonzero"])
@pytest.mark.parametrize("rule", ["adam", "adafactor"])
def test_sparse_rows_update_matches_jax(rule, start, moment_dtype):
    """Three steps of 12 ids with repeats (scale 5 for Adafactor: the clip
    engages) from a zero state or a converted nonzero one: the table, the
    moments and the count follow JAX's; untouched rows and moments stay bit
    for bit, row V - 1 (where the padding slots land) included."""
    jinit, jupd = ((J.sparse_rows_adam_init, J.sparse_rows_adam_update) if rule == "adam"
                   else (J.sparse_rows_adafactor_init, J.sparse_rows_adafactor_update))
    tinit, tupd = ((sparse_rows_adam_init, sparse_rows_adam_update) if rule == "adam"
                   else (sparse_rows_adafactor_init, sparse_rows_adafactor_update))
    t0 = _table()
    tdt = torch.bfloat16 if moment_dtype == "bf16" else None
    if start == "zero":
        js = jinit(jnp.asarray(t0), moment_dtype=jnp.bfloat16 if tdt else None)
        ts = tinit(_t(t0), moment_dtype=tdt)
    else:
        js = _nonzero_state(rule, moment_dtype)
        ts = convert.sparse_state_from_jax(jax.tree.map(np.asarray, js))
    for name, m in _moments(ts).items():
        assert m.dtype == (tdt or torch.float32), name
    m_before = {k: v.clone() for k, v in _moments(ts).items()}
    jt, tt = jnp.asarray(t0), _t(t0)
    touched = set()
    for ids, rg in _draws(6, 12, 3, scale=5.0 if rule == "adafactor" else 1.0):
        ids = np.minimum(ids, V - 2)  # row V - 1 is never touched
        touched |= set(ids.tolist())
        jt, js = jupd(jt, js, jnp.asarray(ids, jnp.int32), jnp.asarray(rg), schedule)
        tt, ts = tupd(tt, ts, _t(ids), _t(rg), schedule(int(ts.count)))
    assert int(ts.count) == int(js.count)
    bf16 = moment_dtype == "bf16"
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-5 if bf16 else 1e-6)
    for name, got in _moments(ts).items():
        want = _as_np(getattr(js, name))
        np.testing.assert_allclose(_as_np(got), want, rtol=BF16_ULP if bf16 else 1e-6,
                                   atol=1e-30, err_msg=name)
    untouched = np.array(sorted(set(range(V)) - touched))
    assert untouched[-1] == V - 1
    np.testing.assert_array_equal(tt.numpy()[untouched], t0[untouched])
    for name, m in _moments(ts).items():
        np.testing.assert_array_equal(m[untouched].float().numpy(),
                                      m_before[name][untouched].float().numpy())


def test_sparse_rows_adafactor_matches_the_dense_op_when_every_row_is_touched():
    """Every row touched: the O(N·E) rule is the dense unfactored
    ``fused_adafactor`` of the JAX package (decay, eps, rsqrt, the clip)."""
    from transformers4rec_tpu.ops.fused_adafactor import fused_adafactor

    t0 = _table(7)
    tx = fused_adafactor(0.1)
    jp = {"t": jnp.asarray(t0)}
    js = tx.init(jp)
    tt, ts = _t(t0), sparse_rows_adafactor_init(_t(t0))
    for _, rg in _draws(8, V, 3, scale=3.0):
        upd, js = tx.update({"t": jnp.asarray(rg)}, js, jp)
        jp = optax.apply_updates(jp, upd)
        tt, ts = sparse_rows_adafactor_update(tt, ts, torch.arange(V), _t(rg), 0.1)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jp["t"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v["t"]), rtol=1e-5)


def test_sparse_rows_adam_matches_dense_lazy_adam():
    """The gather/scatter rule is the mask-based lazy Adam, duplicates
    included: the port's two forms agree over four steps."""
    t0 = _table(9)
    tp = torch.nn.Parameter(_t(t0))
    opt = LazyAdam([tp], lr=0.1)
    tt, ts = _t(t0), sparse_rows_adam_init(_t(t0))
    for ids, rg in _draws(10, 10, 4):
        tp.grad = _t(_dense(ids, rg))
        opt.step()
        tt, ts = sparse_rows_adam_update(tt, ts, _t(ids), _t(rg), 0.1)
    np.testing.assert_allclose(tt.numpy(), tp.detach().numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.mu.numpy(), opt.state[tp]["mu"].numpy(), rtol=0, atol=1e-7)


def test_sharded_rows_update_matches_the_unsharded_one():
    """Two shards of 32 rows, each updated with all the ids over its row
    range, together equal the unsharded update (and JAX's)."""
    t0 = _table(11)
    ids = np.array([0, 5, 33, 33, 63, 5, 31, 32], np.int64)
    rg = np.random.default_rng(12).normal(size=(len(ids), E)).astype(np.float32)
    tt, ts = sparse_rows_adam_update(_t(t0), sparse_rows_adam_init(_t(t0)), _t(ids), _t(rg),
                                     0.1)
    half = V // 2
    shards = []
    for lo in (0, half):
        t = _t(t0[lo:lo + half])
        t, s = sharded_rows_adam_update(t, sparse_rows_adam_init(t), _t(ids), _t(rg), 0.1,
                                        lo=lo, rows_per_shard=half)
        shards.append((t, s))
    np.testing.assert_array_equal(torch.cat([t for t, _ in shards]).numpy(), tt.numpy())
    np.testing.assert_array_equal(torch.cat([s.nu for _, s in shards]).numpy(), ts.nu.numpy())
    jt, _ = J.sparse_rows_adam_update(jnp.asarray(t0), J.sparse_rows_adam_init(jnp.asarray(t0)),
                                      jnp.asarray(ids, jnp.int32), jnp.asarray(rg), 0.1)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="rows"):
        sharded_rows_adam_update(_t(t0), sparse_rows_adam_init(_t(t0)), _t(ids), _t(rg), 0.1,
                                 lo=0, rows_per_shard=half)


def test_convert_keeps_bf16_moments():
    js = _nonzero_state("adam", "bf16")
    ts = convert.sparse_state_from_jax(jax.tree.map(np.asarray, js))
    assert ts.mu.dtype == torch.bfloat16 and ts.count.dtype == torch.int32
    np.testing.assert_array_equal(ts.mu.float().numpy(),
                                  np.asarray(js.mu).astype(ml_dtypes.bfloat16).astype(np.float32))
