"""The port's ('data', 'model') layout of ranks (``parallel.mesh``), its
data-axis arithmetic and ``ShardedInferenceRunner``, against the JAX
package on the CPU.

The layout is built for worlds of up to 8 ranks inside this process:
``mesh.world`` is patched to name the rank and the world, and
``dist.new_group`` to record the groups. Each grid is the JAX ``make_mesh``
device grid over as many of the 8 forced CPU devices; each rank's model
group is its data row and its data group its model column, and every rank
makes the same groups in the same order. Multi-rank runs are in
``test_torch_data_parallel.py``.

``ShardedInferenceRunner(model_axis=2)`` on the CPU (both shards on the
CPU) gives ``InferenceRunner``'s top-k exactly and the JAX model's ids,
scores within 1e-5; the daemon started with ``model_axis=2`` answers the
same.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import transformers4rec_tpu as jtr
from transformers4rec_tpu.data.synthetic import synthetic_ecommerce_data_schema as jax_schema_fn
from transformers4rec_tpu.parallel import make_mesh as jax_make_mesh

from transformers4rec_tpu_torch import convert, flagship
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.model.base import task_loss_coefficients
from transformers4rec_tpu_torch.model.prediction_task import TaskOutput
from transformers4rec_tpu_torch.parallel import mesh as tmesh
from transformers4rec_tpu_torch.serving import (
    InferenceRunner,
    ServingServer,
    ShardedInferenceRunner,
    export_model,
)

torch.set_num_threads(1)

LAYOUTS = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2), (2, 4), (8, 1), (1, 8), (None, 2)]


def _layout(monkeypatch, rank, n, data, model):
    """``make_mesh(data, model)`` on rank ``rank`` of a world of ``n``, and
    the member lists of the groups it made, in order."""
    made = []

    def new_group(ranks):
        made.append(list(ranks))
        return tuple(ranks)

    monkeypatch.setattr(tmesh, "world", lambda: (rank, n))
    monkeypatch.setattr(tmesh.dist, "new_group", new_group)
    return tmesh.make_mesh(data, model), made


@pytest.mark.parametrize("data,model", LAYOUTS)
def test_make_mesh_lays_ranks_out_as_jax_lays_devices(monkeypatch, data, model):
    n = 8 if data is None else data * model
    want = np.vectorize(lambda d: d.id)(
        jax_make_mesh(data, model, devices=jax.devices()[:n]).devices)
    orders = []
    for rank in range(n):
        mesh, made = _layout(monkeypatch, rank, n, data, model)
        np.testing.assert_array_equal(mesh.ranks, want)
        assert mesh.shape == {"data": want.shape[0], "model": want.shape[1]}
        i, j = mesh.data_index, mesh.model_index
        assert want[i, j] == rank
        assert mesh.model_group == (tuple(want[i]) if model > 1 else None)
        assert mesh.data_group == (tuple(want[:, j]) if want.shape[0] > 1 else None)
        assert tmesh.process_data_stripe(mesh) == (i, want.shape[0])
        orders.append(made)
    # every rank makes every group, in the same order: rows, then columns
    assert all(o == orders[0] for o in orders)
    assert len(orders[0]) == (want.shape[0] if model > 1 else 0) + \
        (want.shape[1] if want.shape[0] > 1 else 0)


def test_make_mesh_refuses_what_jax_refuses(monkeypatch):
    with pytest.raises(ValueError):
        jax_make_mesh(data=3, model=2)
    with pytest.raises(ValueError, match="mesh 3x2 != 8 ranks"):
        _layout(monkeypatch, 0, 8, 3, 2)
    monkeypatch.undo()
    mesh = tmesh.make_mesh()  # no world: one rank
    assert mesh.shape == {"data": 1, "model": 1} and mesh.model_group is None


@pytest.mark.parametrize("rows,model,min_rows,want", [
    (32768, 2, 16384, True),   # the JAX test's item table
    (100, 2, 16384, False),    # too small to shard
    (32769, 2, 1, False),      # not divisible by the model axis
    (32768, 1, 16384, False),  # no model axis
    (32776, 4, 16384, True),   # the port's tests' padded table
    (16384, 2, tmesh.MIN_ROWS_TO_SHARD, True),
    (16376, 2, tmesh.MIN_ROWS_TO_SHARD, False),
])
def test_sharding_rule_is_the_jax_rule(rows, model, min_rows, want):
    """JAX ``param_shardings``' conditions (its tests' cases)."""
    from jax.sharding import PartitionSpec as P

    from transformers4rec_tpu.parallel.mesh import param_shardings

    assert tmesh.shards_rows(rows, model, min_rows) is want
    if model <= 8 and 8 % model == 0:
        jmesh = jax_make_mesh(model=model)
        spec = param_shardings({"x_table": jax.ShapeDtypeStruct((rows, 4), jnp.float32)}, jmesh,
                               min_rows_to_shard=min_rows)["x_table"].spec
        assert (spec == P("model", None)) is want


def test_data_parallel_loss_is_the_global_weighted_mean():
    """Without a group the objective and the value are the model's loss; the
    shares of two ranks (their sums given as the group's) add up to the
    global weighted mean and its gradient."""
    x = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0], requires_grad=True)
    w = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0])

    def out(sl):
        loss = (x[sl] * w[sl]).sum() / w[sl].sum().clamp_min(1.0)
        return {"t": TaskOutput(loss=loss, loss_weight=w[sl].sum())}

    obj, val = tmesh.data_parallel_loss({"t": 1.0}, out(slice(0, 5)), None)
    assert float(obj.detach()) == float(val) == pytest.approx(12 / 4)
    # a rank's share given the other rank's sums, as the all-reduce gives them
    shares = []
    for mine, other in ((slice(0, 2), slice(2, 5)), (slice(2, 5), slice(0, 2))):
        o = out(other)["t"]
        sums = torch.stack([o.loss_weight, o.loss * o.loss_weight.clamp_min(1.0)])
        orig = tmesh.all_reduce_
        tmesh.all_reduce_ = lambda t, group: t + sums.detach().reshape(-1)
        try:
            obj, val = tmesh.data_parallel_loss({"t": 1.0}, out(mine), object())
        finally:
            tmesh.all_reduce_ = orig
        assert float(val) == pytest.approx(12 / 4)
        shares.append(obj)
    sum(shares).backward()
    np.testing.assert_allclose(x.grad.numpy(), (w / 4).numpy())


def test_task_loss_coefficients_weigh_as_the_model_does():
    model = flagship.build_multitask_model("cpu", d_model=16, n_head=2, n_layer=1)
    model.heads[0].task_weights = [2.0, 1.0, 1.0]
    assert task_loss_coefficients(model) == {"next-item": 0.5, "click": 0.25,
                                             "play_percentage": 0.25}


def test_interleave_stripes_restores_the_dataset_order():
    n, d = 7, 3
    rows = np.arange(n)
    parts = [torch.from_numpy(np.concatenate([rows[i::d], -np.ones(3 - len(rows[i::d]))]))
             for i in range(d)]
    np.testing.assert_array_equal(tmesh.interleave_stripes(parts, n).numpy(), rows)


# ------------------------------------------------------------------ serving
V, S, D = 20000, 10, 32


@pytest.fixture(scope="module")
def sharded_artifact(tmp_path_factory):
    schema = jax_schema_fn(num_items=V, num_categories=flagship.NUM_CATEGORIES,
                           max_session_length=S)
    im = jtr.TabularSequenceFeatures.from_schema(schema, d_output=D, masking="mlm",
                                                 aggregation="concat")
    cfg = jtr.XLNetConfig.build(d_model=D, n_head=2, n_layer=1, total_seq_length=S)
    jmodel = cfg.to_model(im, jtr.NextItemPredictionTask(weight_tying=True))
    batch = synthetic_data(flagship.schema(V, S), num_rows=8, max_session_length=S, seed=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb)
    jax_s, jax_i = jax.jit(lambda p, b: jmodel.apply(p, b, top_k=5))(params, jb)

    def build(device):
        return flagship.build_model(device, num_items=V, d_model=D, n_layer=1, n_head=2,
                                    seq=S, dropout=0.0)

    model = build("cpu")
    model.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, params)))
    path = export_model(model, batch, str(tmp_path_factory.mktemp("sharded_art")), top_k=5,
                        bundle_params=True)
    return path, build, batch, np.asarray(jax_s), np.asarray(jax_i)


def test_sharded_runner_matches_inference_runner_and_jax(sharded_artifact):
    path, build, batch, jax_s, jax_i = sharded_artifact
    want_s, want_i = InferenceRunner(path, build, device="cpu").predict(batch)
    runner = ShardedInferenceRunner(path, build, model_axis=2, device="cpu")
    cat = runner.model.heads[0].input_module.categorical_module
    # the table left the parameters: two shards of 10,004 rows
    assert runner.sharded and [tuple(t.shape) for t in cat.table_shards["item_id"]] == \
        [(10004, 64), (10004, 64)]
    assert "item_id" not in cat.tables
    got_s, got_i = runner.predict(batch)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_i, jax_i)
    np.testing.assert_allclose(got_s, jax_s, rtol=1e-5, atol=1e-5)
    # a table the rule does not take stays whole
    assert not ShardedInferenceRunner(path, build, model_axis=3, device="cpu").sharded


def test_server_with_a_model_axis_answers_the_runners_top_k(sharded_artifact):
    path, build, batch, _, jax_i = sharded_artifact
    server = ServingServer(path, build, port=0, max_batch_size=8, device="cpu",
                           model_axis=2).start()
    try:
        assert isinstance(server.runner, ShardedInferenceRunner) and server.runner.sharded
        inputs = {k: np.asarray(v)[:3].tolist() for k, v in batch.items()}
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/v2/predict",
                                     data=json.dumps({"inputs": inputs}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        np.testing.assert_array_equal(np.asarray(out["item_ids"]), jax_i[:3])
    finally:
        server.stop()
