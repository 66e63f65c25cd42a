"""``experimental.PostContextFusion`` against the JAX package on the CPU.

As the JAX package's own test builds it: a GPT-2-CLM body (the sequence
input module of the ecommerce schema, d_output 32, and one layer of 2
heads) fused with the ``weekday_sin`` column as its context, (B, S, 1), in
each of the three aggregations. The weights go JAX → port through
``convert.params_from_jax`` (``context_projection`` among them), loaded
strictly; the fused output of a training forward (dropout 0; the CLM mask
has no draw) within 1e-5 in relative Frobenius norm, and the gradient of
``sum(out * R)`` for a fixed random R in every weight within 1e-4 (but
a key bias's, which is rounding noise around zero in both packages). A
(B, C) context is broadcast over the positions, a dict context and an
unknown aggregation raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformers4rec_tpu as jtr
from transformers4rec_tpu.blocks import SequentialBlock as JaxSequentialBlock
from transformers4rec_tpu.blocks import TransformerBlock as JaxTransformerBlock
from transformers4rec_tpu.data.synthetic import synthetic_ecommerce_data_schema as jax_schema_fn
from transformers4rec_tpu.experimental import PostContextFusion as JaxPostContextFusion

import transformers4rec_tpu_torch as ttr
from transformers4rec_tpu_torch import convert, flagship
from transformers4rec_tpu_torch.blocks import SequentialBlock, TransformerBlock
from transformers4rec_tpu_torch.data import synthetic_data
from transformers4rec_tpu_torch.experimental import PostContextFusion

from test_torch_input_options import ZERO_GRADIENT, _perturbed, _rel_fro

torch.set_num_threads(1)

FWD_RTOL, GRAD_RTOL = 1e-5, 1e-4
V, S, D, B = 60, 20, 32, 8


def _bodies(pkg, schema, block_cls, tblock_cls):
    seq = pkg.TabularSequenceFeatures.from_schema(schema, d_output=D, masking="clm",
                                                  aggregation="concat")
    cfg = pkg.transformer_registry.parse("gpt2").build(D, 2, 1, S, dropout=0.0)
    body = block_cls(blocks=(seq, tblock_cls(transformer=cfg, masking="clm")))
    context = pkg.TabularSequenceFeatures.from_schema(schema.select_by_name(["weekday_sin"]),
                                                      aggregation="concat")
    return body, context


@pytest.mark.parametrize("aggregation,want_dim", [
    ("elementwise-mul", D), ("elementwise-sum", D), ("concat", D + 1)])
def test_post_context_fusion_matches_jax(aggregation, want_dim):
    jschema = jax_schema_fn(num_items=V, num_categories=flagship.NUM_CATEGORIES,
                            max_session_length=S)
    tschema = flagship.schema(V, S)
    data = synthetic_data(tschema, num_rows=B, max_session_length=S, seed=0)
    jin = {k: jnp.asarray(v) for k, v in data.items()}
    tin = {k: torch.from_numpy(v) for k, v in data.items()}
    jbody, jctx = _bodies(jtr, jschema, JaxSequentialBlock, JaxTransformerBlock)
    jfused = JaxPostContextFusion(sequential_module=jbody, post_context_module=jctx,
                                  fusion_aggregation=aggregation)
    rngs = {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    params = _perturbed(jfused.init(rngs, jin, training=True))
    if aggregation != "concat":
        assert params["params"]["context_projection"]["kernel"].shape == (1, D)

    def run(p):
        return jfused.apply(p, jin, training=True, rngs={"masking": rngs["masking"]})[0]

    want = np.asarray(run(params))
    R = np.random.default_rng(9).normal(size=want.shape).astype(np.float32)
    want_grads = convert.params_from_jax(jax.tree.map(
        np.asarray, jax.grad(lambda p: jnp.sum(run(p) * R))(params)))

    tbody, tctx = _bodies(ttr, tschema, SequentialBlock, TransformerBlock)
    fused = PostContextFusion(tbody, tctx, fusion_aggregation=aggregation)
    fused.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    assert fused.output_size() == jfused.output_size() == want_dim
    out, info = fused(tin, training=True)
    assert out.shape == want.shape == (B, S, want_dim) and info is not None
    assert _rel_fro(out.detach().numpy(), want) <= FWD_RTOL
    (out * torch.from_numpy(R)).sum().backward()
    for name, p in fused.named_parameters():
        if p.grad is None:  # the CLM scheme's [MASK] vector takes no gradient under CLM
            assert float(np.abs(want_grads[name].numpy()).max()) == 0.0, name
            continue
        if name.endswith(ZERO_GRADIENT):  # rounding noise around zero in both packages
            continue
        assert _rel_fro(p.grad.numpy(), want_grads[name].numpy()) <= GRAD_RTOL, name
    assert (aggregation == "concat") != hasattr(fused, "context_projection")


class _Fixed(torch.nn.Module):
    """A context block that returns a fixed tensor or dict."""

    def __init__(self, value, size=3):
        super().__init__()
        self.value, self.size = value, size

    def output_size(self):
        return self.size

    def forward(self, inputs, training=False, generator=None):
        return self.value


class _Seq(torch.nn.Module):
    def output_size(self):
        return 4

    def forward(self, inputs, training=False, testing=False, generator=None):
        return inputs["x"]


def test_post_context_fusion_broadcasts_a_2d_context_and_refuses_the_rest():
    x = torch.randn(2, 5, 4)
    ctx = torch.randn(2, 3)
    fused = PostContextFusion(_Seq(), _Fixed(ctx), "concat")
    out = fused({"x": x})  # no info from the sequential module: the tensor alone
    assert torch.equal(out[..., :4], x) and torch.equal(out[:, 2, 4:], ctx)
    summed = PostContextFusion(_Seq(), _Fixed(ctx), "elementwise-sum")
    want = x + summed.context_projection(ctx)[:, None, :]
    assert torch.allclose(summed({"x": x}), want)
    with pytest.raises(ValueError, match="aggregate"):
        PostContextFusion(_Seq(), _Fixed({"a": ctx}), "concat")({"x": x})
    with pytest.raises(ValueError, match="not supported"):
        PostContextFusion(_Seq(), _Fixed(ctx), "elementwise-max")
    assert "experimental" in ttr.__all__ and ttr.experimental.PostContextFusion is PostContextFusion


def test_a_head_over_the_fused_body_trains_and_evaluates():
    """The flagship's body fused with its ``weekday_sin`` column, as the
    body of a ``Head``: ``Head.input_module`` is the sequential module's
    first block (``PostContextFusion.blocks``), a training step gives the
    context projection a gradient, and evaluation runs."""
    base = flagship.build_model("cpu", num_items=V, d_model=D, n_layer=1, n_head=2, seq=S,
                                dropout=0.0)
    context = ttr.TabularSequenceFeatures.from_schema(
        flagship.schema(V, S).select_by_name(["weekday_sin"]), aggregation="concat")
    body = PostContextFusion(base.heads[0].body, context, "elementwise-mul")
    model = ttr.Model([ttr.Head(body, base.heads[0].tasks)], device="cpu")
    assert model.heads[0].input_module is base.heads[0].body.blocks[0]
    batch = synthetic_data(flagship.schema(V, S), num_rows=B, max_session_length=S, seed=2)
    dense = model._as_dense(batch)
    loss, _ = model(dense, targets=dense, training=True,
                    generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert torch.isfinite(loss) and body.context_projection.weight.grad.abs().sum() > 0
    metrics = model.evaluate([batch])
    assert np.isfinite(metrics["eval_loss"])
