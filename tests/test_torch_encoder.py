"""The port's XLNet encoder against the JAX package's on the CPU.

A small XLNet body (d=32, 2 heads, 2 layers, relative-position bias, pre-LN
with a final LayerNorm) is built in both packages from ``XLNetConfig``; the
flax weights move across through ``convert.params_from_jax``. Inputs are
sessions of 8 plus the MLM inference extension (9 positions, with the pad
mask that extension gives), one row entirely padding. Everything runs in
f32, so hidden states agree within 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import transformers4rec_tpu as jtr
from transformers4rec_tpu.blocks.transformer import RelativePositionBias as JaxRelBias
from transformers4rec_tpu.blocks.transformer import make_attention_bias as jax_bias

from transformers4rec_tpu_torch import XLNetConfig, convert
from transformers4rec_tpu_torch.blocks.transformer import RelativePositionBias, make_attention_bias

torch.set_num_threads(1)

D, H, L, S = 32, 2, 2, 8


def _session_inputs(seed=0, batch=5):
    rng = np.random.default_rng(seed)
    lengths = np.array([3, 8, 1, 5, 0])[:batch]  # the last row is all padding
    pad_mask = np.arange(S + 1)[None, :] < (lengths + 1)[:, None]  # [MASK] at index len
    pad_mask[lengths == 0] = False
    x = rng.normal(0.0, 1.0, (batch, S + 1, D)).astype(np.float32)
    return x, pad_mask


def test_xlnet_encoder_matches_jax():
    x, pad_mask = _session_inputs()
    jenc = jtr.XLNetConfig.build(d_model=D, n_head=H, n_layer=L, total_seq_length=S).to_encoder()
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(pad_mask))
    # the rel-bias table starts at N(0, 0.02): scale it up so the bias matters
    params = jax.tree.map(np.asarray, params)
    params["params"]["rel_pos"]["rel_bias"] = params["params"]["rel_pos"]["rel_bias"] * 50
    want = np.asarray(jenc.apply(params, jnp.asarray(x), jnp.asarray(pad_mask)))

    tenc = XLNetConfig.build(d_model=D, n_head=H, n_layer=L, total_seq_length=S).to_encoder()
    tenc.load_state_dict(convert.params_from_jax(params))
    with torch.no_grad():
        got = tenc(torch.from_numpy(x), pad_mask=torch.from_numpy(pad_mask)).numpy()
    assert got.shape == (5, S + 1, D)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (16, 20), (8, 9)])
def test_relative_position_buckets_match_jax(bidirectional, num_buckets, max_distance):
    rel = np.arange(-300, 301)
    want = np.asarray(JaxRelBias._bucket(jnp.asarray(rel), bidirectional, num_buckets,
                                         max_distance))
    got = RelativePositionBias._bucket(torch.from_numpy(rel), bidirectional, num_buckets,
                                       max_distance)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("causal,local_window", [(False, None), (True, None), (False, 2)])
def test_attention_bias_matches_jax(causal, local_window):
    _, pad_mask = _session_inputs()
    want = np.asarray(jax_bias(jnp.asarray(pad_mask), S + 1, causal=causal,
                               local_window=local_window))
    got = make_attention_bias(torch.from_numpy(pad_mask), S + 1, causal=causal,
                              local_window=local_window)
    np.testing.assert_array_equal(got.numpy(), want)
