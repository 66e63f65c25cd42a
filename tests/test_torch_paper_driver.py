"""The port's paper experiment script (``transformers4rec_tpu_torch.paper_repro``)
against the JAX tree's ``examples/paper_repro/transf_exp_main.py`` on the
CPU.

- the README's headline XLNet-MLM command line
  (``examples/paper_repro/README.md``) parses to the same values through
  both parsers, flag for flag;
- ``get_model`` of each package builds a model that loads the other's
  weights strictly (``convert.params_from_jax`` one way,
  ``convert.params_to_jax`` the other), and both evaluate a batch alike;
- one training step of that model, with the reference's MLM mask and one
  swap-noise draw (the port's, made on the CPU) given to both, dropout 0:
  the loss and every gradient within 1e-4 (relative; gradients in
  Frobenius norm), the evaluation loss within 1e-4 and the metrics within
  1e-6; the same for the REES46 schema with side features under both
  numeric encodings (soft one-hot, projection);
- the README line runs through the port's experiment script on small windows with
  size flags appended (argparse keeps the last value), and runs with the
  MLM, CLM and PLM flags on synthetic windows yield the JAX experiment script's
  ``results.json`` keys.

Inputs come from numpy seeds; the sizes are small.
"""

import importlib.util
import json
import os
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformers4rec_tpu.masking import MaskedLanguageModeling as JaxMLM
from transformers4rec_tpu.schema import Schema as JaxSchema
from transformers4rec_tpu.tabular.transformations import StochasticSwapNoise as JaxSSN

from transformers4rec_tpu_torch import convert
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.data.synthetic import (
    generate_item_interactions,
    interactions_to_sessions,
    synthetic_ecommerce_data_schema,
)
from transformers4rec_tpu_torch.paper_repro import datasets_configs, transf_exp_main
from transformers4rec_tpu_torch.tabular import StochasticSwapNoise

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-4  # losses and gradients
METRIC_ATOL = 1e-6  # evaluation metrics: sums of per-row values of the same ranks
ZERO_GRADIENT = "attn.k.bias"  # the softmax ignores it: rounding noise in both
SMALL = ["--d_model", "16", "--n_layer", "1", "--n_head", "2", "--item_embedding_dim", "16",
         "--cpu"]


def _jax_cli():
    path = REPO / "examples" / "paper_repro" / "transf_exp_main.py"
    spec = importlib.util.spec_from_file_location("jax_transf_exp_main", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["jax_transf_exp_main"] = mod
    spec.loader.exec_module(mod)
    return mod


def readme_argv(data_path="/data", schema="/schema.pbtxt"):
    """The README's headline command line, ``$DATA_PATH`` and ``$SCHEMA``
    substituted."""
    text = (REPO / "examples" / "paper_repro" / "README.md").read_text()
    block = re.search(r"python examples/paper_repro/transf_exp_main\.py --output_dir \./tmp/"
                      r"(.*?)```", text, re.S).group(1)
    argv = ["--output_dir", "./tmp/"] + block.replace("\\\n", " ").split()
    return [a.replace("$DATA_PATH", data_path).replace("$SCHEMA", schema) for a in argv]


def _rel_fro(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_the_readme_line_parses_alike_flag_for_flag():
    argv = readme_argv()
    assert "--layer_norm_featurewise" in argv and "--stochastic_shared_embeddings_replacement_prob" in argv
    want = vars(_jax_cli().build_parser().parse_args(argv))
    got = vars(transf_exp_main.build_parser().parse_args(argv))
    assert got == want
    # and every flag of the JAX parser, with its default
    assert vars(transf_exp_main.build_parser().parse_args([])) == \
        vars(_jax_cli().build_parser().parse_args([]))


def _models(argv, schema):
    """The JAX and the port script's models of ``argv`` on ``schema`` (a
    port Schema), with the JAX weights in both."""
    cli = _jax_cli()
    jargs, targs = cli.build_parser().parse_args(argv), transf_exp_main.build_parser().parse_args(argv)
    jmodel = cli.get_model(jargs, JaxSchema.from_json(schema.to_json()))
    tmodel = transf_exp_main.get_model(targs, schema)
    batch = synthetic_data(schema, num_rows=4, max_session_length=20, seed=0)
    rngs = {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2), "augment": jax.random.PRNGKey(3)}
    params = jax.jit(lambda b: jmodel.init(rngs, b, training=True))(
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = jax.tree.map(np.asarray, params)
    tmodel.load_state_dict(convert.params_from_jax(params), strict=True)
    return jmodel, params, tmodel


def _item_only(num_items=300):
    schema = synthetic_ecommerce_data_schema(num_items=num_items, num_categories=20,
                                             max_session_length=20)
    return schema.select_by_name([schema.item_id_column_name])


def _dropout_free(argv):
    return argv + ["--dropout", "0.0"]


def test_each_get_model_loads_the_others_weights_strictly():
    schema = _item_only()
    argv = readme_argv() + SMALL
    jmodel, params, tmodel = _models(argv, schema)
    # port -> JAX: another port model's weights into the JAX tree
    other = transf_exp_main.get_model(transf_exp_main.build_parser().parse_args(
        argv + ["--seed", "7"]), schema)
    back = convert.params_to_jax(other.state_dict(), params)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    batch = synthetic_data(schema, num_rows=16, max_session_length=20, seed=4)
    want, got = jmodel.evaluate([batch], back), other.evaluate([batch])
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=RTOL)
    # the round trip is the identity
    again = convert.params_from_jax(back)
    assert all(torch.equal(again[k], v) for k, v in other.state_dict().items())
    with pytest.raises(KeyError):
        convert.params_to_jax({**other.state_dict(), "extra": torch.zeros(1)}, params)
    assert isinstance(tmodel.heads[0].input_module.StochasticSwapNoise_0, StochasticSwapNoise)


def _check_step_and_evaluation(argv, schema, monkeypatch, rows=16):
    """One training step with the same mask and swap draw, and one
    evaluation, JAX against the port; dropout 0."""
    jmodel, params, tmodel = _models(_dropout_free(argv), schema)
    batch = synthetic_data(schema, num_rows=rows, max_session_length=20, seed=11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = tmodel._as_dense(batch)
    ids = tb[schema.item_id_column_name].long()

    # the swap draw: the port's, on the CPU, given to both models
    noise = tmodel.heads[0].input_module.StochasticSwapNoise_0
    noise.draws = noise.draw(tb, ids != 0, torch.Generator().manual_seed(5))
    assert int(noise.draws[schema.item_id_column_name][1].sum()) > 0
    draws = {k: (jnp.asarray(s.numpy()), jnp.asarray(w.numpy()))
             for k, (s, w) in noise.draws.items()}

    def jax_noise(self, inputs, training=False, pad_mask=None):
        if not training:
            return inputs
        out = {}
        for k, v in inputs.items():
            if k not in draws:
                out[k] = v
                continue
            src, swap = draws[k]
            flat = v.reshape(-1, v.shape[-1]) if v.ndim == swap.ndim + 1 else v.reshape(-1)
            swap = swap[..., None] if v.ndim == swap.ndim + 1 else swap
            out[k] = jnp.where(swap, flat[src].reshape(v.shape), v)
        return out

    monkeypatch.setattr(JaxSSN, "__call__", jax_noise)
    masking = jmodel.heads[0].body.blocks[0].masking
    info = JaxMLM.compute_masked_targets(masking, jax.random.PRNGKey(3), jnp.asarray(ids.numpy()),
                                         training=True)
    original = JaxMLM.compute_masked_targets

    def jax_masks(self, rng, item_ids, training=False, testing=False, segment_ids=None):
        if not training:
            return original(self, rng, item_ids, training, testing, segment_ids)
        return info

    monkeypatch.setattr(JaxMLM, "compute_masked_targets", jax_masks)
    rngs = {"masking": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "augment": jax.random.PRNGKey(2)}
    want_loss, want_grads = jax.value_and_grad(lambda p: jmodel.apply(
        p, jb, targets=jb, training=True, compute_metrics=False, rngs=rngs)[0])(params)
    want_grads = convert.params_from_jax(jax.tree.map(np.asarray, want_grads))
    tinfo = convert.masking_info_from_jax(np.asarray(info.targets), np.asarray(info.mask),
                                          np.asarray(info.pad_mask))
    loss, _ = tmodel(tb, targets=tb, training=True, masking_info=tinfo)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=RTOL)
    named = dict(tmodel.named_parameters())
    assert set(named) == set(want_grads)
    for name, p in named.items():
        if name.endswith(ZERO_GRADIENT):
            continue
        assert _rel_fro(p.grad.numpy(), want_grads[name].numpy()) <= RTOL, name
    noise.draws = None

    loader = [synthetic_data(schema, num_rows=rows, max_session_length=20, seed=12)]
    want, got = jmodel.evaluate(loader, params), tmodel.evaluate(loader)
    assert want.keys() == got.keys()
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=RTOL)
    for k in want:
        if k != "eval_loss":
            np.testing.assert_allclose(got[k], want[k], atol=METRIC_ATOL, err_msg=k)
    return tmodel


def test_a_training_step_and_an_evaluation_of_the_readme_model_match_jax(monkeypatch):
    tmodel = _check_step_and_evaluation(readme_argv() + SMALL, _item_only(), monkeypatch)
    im = tmodel.heads[0].input_module
    assert im._pre_names == ["StochasticSwapNoise_0"] and im._post_names == ["TabularLayerNorm_0"]
    assert im.TabularLayerNorm_0.eps == 1e-6
    assert tmodel.heads[0].body.blocks[1].encoder.layers[0].ln1.eps == 1e-12


def _rees46(num_items=400):
    """The port's REES46 schema with its item cardinality cut for the CPU."""
    schema = datasets_configs.make_schema("rees46")
    item = schema["sess_pid_seq"]
    item.int_domain.max = num_items
    return schema


@pytest.mark.parametrize("encoding", [
    ["--numeric_features_soft_one_hot_encoding_num_embeddings", "10"],
    ["--numeric_features_project_to_embedding_dim", "16"],
])
def test_the_side_feature_model_matches_jax(encoding, monkeypatch):
    schema = _rees46()
    argv = ["--use_side_information_features", "--layer_norm_featurewise", "--mlm",
            "--stochastic_shared_embeddings_replacement_prob", "0.1"] + SMALL + encoding
    tmodel = _check_step_and_evaluation(argv, schema, monkeypatch)
    im = tmodel.heads[0].input_module
    names = set(im.feature_sizes())
    assert "sess_etime_seq" not in names and {"sess_ccid_seq", "sess_bid_seq"} <= names


def _windows(root, schema, pad_digits=4, splits=("train", "valid", "test")):
    for t in (1, 2, 3):
        d = root / str(t).zfill(pad_digits)
        os.makedirs(d)
        for split, n in zip(splits, (600, 200, 200)):
            df = generate_item_interactions(n, schema, seed=t * 7 + n)
            interactions_to_sessions(df, schema, max_session_length=20).to_parquet(
                d / f"{split}.parquet")


# the keys of the JAX experiment script's results.json, which the next test checks
# against a run of the JAX experiment script (one run: its compiles take 25 s)
RESULT_KEYS = sorted(f"indexed_by_time_eval_/next-item/{m}@{k}"
                     for m in ("avg_precision", "ndcg", "recall") for k in (10, 20))


def test_the_jax_script_writes_these_result_keys(tmp_path):
    _jax_cli().main(["--use_synthetic", "--mlm", "--d_model", "16", "--n_layer", "1",
                     "--n_head", "2", "--session_seq_length_max", "10",
                     "--synthetic_num_items", "200", "--synthetic_rows_per_window", "64",
                     "--per_device_train_batch_size", "16", "--per_device_eval_batch_size", "16",
                     "--output_dir", str(tmp_path), "--cpu"])
    assert sorted(json.loads((tmp_path / "results.json").read_text())) == RESULT_KEYS


def test_the_readme_line_runs_through_the_ports_script(tmp_path):
    schema = synthetic_ecommerce_data_schema(num_items=300, num_categories=20,
                                             max_session_length=20)
    schema_path = tmp_path / "schema.pbtxt"
    schema.to_proto_text_file(str(schema_path))
    _windows(tmp_path / "win", schema)
    argv = readme_argv(str(tmp_path / "win"), str(schema_path)) + SMALL + [
        "--per_device_train_batch_size", "16", "--per_device_eval_batch_size", "16",
        "--num_train_epochs", "1", "--output_dir", str(tmp_path / "out")]
    run = transf_exp_main.run(argv)
    assert run.trainer.args.eval_on_test_set and run.trainer.args.dataloader_drop_last
    assert sorted(json.loads((tmp_path / "out" / "results.json").read_text())) == \
        RESULT_KEYS == sorted(run.results)
    assert all(len(v) == 2 for v in run.results.values())
    assert run.top_ids.shape[1] == 10 and int(run.top_ids.max()) <= 300
    losses = [h["loss"] for h in run.trainer.state.log_history if "loss" in h]
    assert losses and all(np.isfinite(losses))


@pytest.mark.parametrize("flags", [["--model_type", "xlnet", "--mlm"],
                                   ["--model_type", "gpt2", "--masking", "clm"],
                                   ["--model_type", "xlnet", "--plm"],
                                   ["--model_type", "albert", "--mlm", "--mlm_probability", "0.6"],
                                   ["--model_type", "electra", "--rtd"],
                                   ["--model_type", "transfoxl"]])
def test_each_scheme_runs_on_synthetic_windows_with_the_jax_scripts_keys(flags, tmp_path):
    results = transf_exp_main.main(flags + [
        "--use_synthetic", "--d_model", "16", "--n_layer", "1", "--n_head", "2",
        "--session_seq_length_max", "10", "--synthetic_num_items", "200",
        "--synthetic_rows_per_window", "64", "--per_device_train_batch_size", "16",
        "--per_device_eval_batch_size", "16", "--output_dir", str(tmp_path), "--cpu"])
    assert sorted(results) == RESULT_KEYS
    assert all(len(v) == 2 and all(np.isfinite(v)) for v in results.values())
    with open(tmp_path / "results.json") as f:
        assert sorted(json.load(f)) == RESULT_KEYS


def test_every_model_type_builds_as_the_jax_script_builds_it():
    """The BERT family, ELECTRA with RTD (and its in-batch sampling flag),
    TransfoXL and ``--pre_ln``: each command line's encoder and masking as
    the JAX script's; Reformer says what is not ported."""
    from transformers4rec_tpu_torch.masking import ReplacementLanguageModeling

    schema = _item_only()
    cli = _jax_cli()
    jschema = JaxSchema.from_json(schema.to_json())
    for flags in (["--model_type", "albert", "--mlm"], ["--model_type", "bert", "--pre_ln"],
                  ["--model_type", "electra", "--rtd", "--rtd_sample_from_batch"],
                  ["--model_type", "longformer"], ["--model_type", "transfoxl"],
                  ["--model_type", "roberta", "--hidden_act", "gelu_exact"]):
        argv = flags + SMALL
        jargs = cli.build_parser().parse_args(argv)
        jmodel = cli.get_model(jargs, jschema)
        model = transf_exp_main.get_model(transf_exp_main.build_parser().parse_args(argv), schema)
        jcfg = jmodel.heads[0].body.blocks[1].transformer.encoder_kwargs()
        enc = model.heads[0].body.blocks[1].encoder
        assert (enc.norm_first, enc.embed_layer_norm, enc.share_layers, enc.causal,
                enc.local_window, enc.stack()[0].activation) == (
            jcfg["norm_first"], jcfg["embed_layer_norm"], jcfg["share_layers"], jcfg["causal"],
            jcfg["local_window"], jcfg["activation"]), flags
        masking = model.heads[0].input_module.masking
        assert type(masking).__name__ == type(jmodel.heads[0].body.blocks[0].masking).__name__
        if "--rtd" in flags:
            assert isinstance(masking, ReplacementLanguageModeling) and masking.sample_from_batch
    with pytest.raises(NotImplementedError, match="reformer: not ported yet"):
        transf_exp_main.get_model(transf_exp_main.build_parser().parse_args(
            ["--model_type", "reformer"] + SMALL), schema)
