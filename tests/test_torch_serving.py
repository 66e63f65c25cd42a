"""The port's serving path on the CPU: export, in-process runner, HTTP server.

A small flagship-shaped model (V=500, d=32, sessions of 8) is exported with
``export_model`` and served by ``ServingServer(device="cpu")``. Answers over
HTTP must equal ``InferenceRunner.predict`` on the same sessions (both run
the same f32 arithmetic on the same device: scores within 1e-6, ids equal
where scores do not tie). Ragged and dense inputs densify exactly as the
JAX runner's ``_densify`` does.
"""

import json
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from transformers4rec_tpu.serving.export import InferenceRunner as JaxRunner

from transformers4rec_tpu_torch import flagship
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.serving import InferenceRunner, ServingServer, export_model
from transformers4rec_tpu_torch.serving.server import load_builder

torch.set_num_threads(1)

V, S = 500, 8
SMALL = dict(num_items=V, d_model=32, n_layer=2, n_head=2, seq=S)


def build_small(device):
    return flagship.build_model(device, seed=3, **SMALL)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    model = build_small("cpu")
    example = synthetic_data(flagship.schema(V, S), num_rows=4, max_session_length=S, seed=0)
    return export_model(model, example, str(tmp_path_factory.mktemp("art")), top_k=10)


@pytest.fixture(scope="module")
def server(artifact):
    srv = ServingServer(artifact, build_small, port=0, max_batch_size=32,
                        max_delay_ms=200.0, device="cpu").start()
    yield srv
    srv.stop()


def _requests(count, seed=1):
    """``count`` requests of 1-3 ragged sessions over all four columns."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 4, count)
    data = synthetic_data(flagship.schema(V, S), num_rows=int(sizes.sum()),
                          max_session_length=S, ragged=True, seed=seed)
    cols = [k[: -len("__values")] for k in data if k.endswith("__values")]
    off = {c: data[f"{c}__offsets"] for c in cols}
    reqs, at = [], 0
    for m in sizes:
        reqs.append({c: [data[f"{c}__values"][off[c][i]:off[c][i + 1]].tolist()
                         for i in range(at, at + int(m))] for c in cols})
        at += int(m)
    return reqs


def _post(srv, payload, path="/v2/predict"):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(srv, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}", timeout=60) as r:
        return json.loads(r.read())


def _assert_same_topk(got_s, got_i, want_s, want_i):
    got_s, got_i = np.asarray(got_s), np.asarray(got_i)
    np.testing.assert_allclose(got_s, want_s, atol=1e-6, rtol=0)
    gaps = np.abs(np.diff(want_s, axis=1)) > 1e-6
    clear = np.ones_like(want_i, dtype=bool)
    clear[:, :-1] &= gaps
    clear[:, 1:] &= gaps
    np.testing.assert_array_equal(got_i[clear], want_i[clear])


def test_http_answers_equal_the_runner_and_coalesce(artifact, server):
    runner = InferenceRunner(artifact, build_small, device="cpu")
    reqs = _requests(6)
    before = _get(server, "/v2/stats")
    with ThreadPoolExecutor(len(reqs)) as pool:
        answers = list(pool.map(lambda r: _post(server, {"inputs": r}), reqs))
    stats = _get(server, "/v2/stats")
    for req, ans in zip(reqs, answers):
        want_s, want_i = runner.predict(req)
        assert want_i.shape == (len(req["item_id"]), 10)
        assert ((want_i >= 1) & (want_i < V + 1)).all()
        _assert_same_topk(ans["item_id_scores"], ans["item_ids"], want_s, want_i)
    n_req = stats["requests"] - before["requests"]
    n_batch = stats["batches"] - before["batches"]
    assert n_req == len(reqs)
    assert n_batch < n_req  # the batcher coalesced concurrent requests


def test_dense_and_ragged_requests_agree(artifact, server):
    req = _requests(1, seed=4)[0]
    ragged = _post(server, {"inputs": req})
    runner = InferenceRunner(artifact, build_small, device="cpu")
    dense = {c: runner._densify(c, v, [S], runner.metadata["dtypes"][c]).tolist()
             for c, v in req.items()}
    dense_ans = _post(server, {"inputs": dense})
    _assert_same_topk(dense_ans["item_id_scores"], dense_ans["item_ids"],
                      np.asarray(ragged["item_id_scores"]), np.asarray(ragged["item_ids"]))


@pytest.mark.parametrize("case", ["ragged", "ragged_long", "dense_exact", "dense_short",
                                  "dense_long"])
def test_densify_matches_jax_runner(artifact, case):
    runner = InferenceRunner(artifact, build_small, device="cpu")
    rng = np.random.default_rng(5)
    v = {
        "ragged": [[1, 2, 3], [4], [5, 6, 7, 8, 9, 10, 11, 12]],
        "ragged_long": [list(range(1, 12)), [3, 4]],
        "dense_exact": rng.integers(1, V, (3, S)).tolist(),
        "dense_short": rng.integers(1, V, (3, S - 3)),
        "dense_long": rng.integers(1, V, (2, S + 4)),
    }[case]
    got = runner._densify("item_id", v, [S], "int64")
    want = JaxRunner._densify(None, "item_id", v, [S], "int64")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_health_stats_and_bad_requests(server):
    health = _get(server, "/v2/health")
    assert health["status"] == "ok" and health["metadata"]["top_k"] == 10
    assert set(_get(server, "/v2/stats")) == {"requests", "batches", "rows"}
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(server, {"inputs": {"item_id": [[1, 2]]}})  # the other columns are missing
    assert err.value.code == 400


def test_model_builder_spec_loads():
    assert load_builder("transformers4rec_tpu_torch.flagship:build_model") is \
        flagship.build_model
    with pytest.raises(ValueError):
        load_builder("no_colon")
