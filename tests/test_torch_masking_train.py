"""MLM training masking of the port against the JAX package on the CPU.

The two packages draw from different generators, so the draws are not
compared: given the reference's mask the port produces the reference's
labels and masked inputs, and over seeded draws of its own the port keeps
the reference's guarantees (every session has at least one masked and one
unmasked item; pads are never masked; the masked share is near p).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transformers4rec_tpu.masking import MaskedLanguageModeling as JaxMLM

from transformers4rec_tpu_torch.convert import masking_info_from_jax
from transformers4rec_tpu_torch.masking import (
    MaskedLanguageModeling,
    _ensure_min_masking,
    _sample_index_from_mask,
)

torch.set_num_threads(1)

B, S, D, V, P = 16, 8, 12, 200, 0.3


def _sessions(seed, min_len=2):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(min_len, S + 1, B)
    ids = np.where(np.arange(S)[None, :] < lengths[:, None], rng.integers(1, V, (B, S)), 0)
    return ids.astype(np.int64), lengths


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_given_the_reference_mask_labels_and_inputs_agree(seed):
    rng = np.random.default_rng(seed)
    ids, _ = _sessions(seed)
    emb = rng.normal(size=(B, S, D)).astype(np.float32)
    mask_emb = rng.normal(size=(D,)).astype(np.float32)
    jm = JaxMLM(hidden_size=D, mlm_probability=P)
    want_x, want = jm.apply({"params": {"masked_item_embedding": jnp.asarray(mask_emb)}},
                            jnp.asarray(emb), jnp.asarray(ids), training=True,
                            rngs={"masking": jax.random.PRNGKey(seed)})
    info = masking_info_from_jax(np.asarray(want.targets), np.asarray(want.mask),
                                 np.asarray(want.pad_mask))
    tm = MaskedLanguageModeling(hidden_size=D, mlm_probability=P)
    with torch.no_grad():
        tm.masked_item_embedding.copy_(torch.from_numpy(mask_emb))
        got_x, got = tm(torch.from_numpy(emb), torch.from_numpy(ids), training=True,
                        masking_info=info)
    assert got is info  # the draw is skipped
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    # the labels are the item ids under the mask, the pad mask the non-pad items
    np.testing.assert_array_equal(got.targets.numpy(), np.where(np.asarray(want.mask), ids, 0))
    np.testing.assert_array_equal(got.pad_mask.numpy(), ids != 0)
    np.testing.assert_array_equal(got.input_schema.numpy(), np.asarray(want.input_schema))


def test_200_seeded_draws_keep_the_guarantees_and_the_share():
    tm = MaskedLanguageModeling(hidden_size=D, mlm_probability=P)
    jm = JaxMLM(hidden_size=D, mlm_probability=P)
    jax_mask = jax.jit(lambda key, ids: jm.compute_masked_targets(key, ids, training=True).mask)
    masked = total = ref_masked = 0
    for seed in range(200):
        ids, lengths = _sessions(seed)
        g = torch.Generator().manual_seed(seed)
        info = tm.compute_masked_targets(torch.from_numpy(ids), training=True, generator=g)
        mask, non_pad = info.mask.numpy(), ids != 0
        assert not (mask & ~non_pad).any()  # pads are never masked
        assert (mask.sum(1) >= 1).all()
        assert ((non_pad & ~mask).sum(1) >= 1).all()
        np.testing.assert_array_equal(info.targets.numpy(), np.where(mask, ids, 0))
        np.testing.assert_array_equal(info.pad_mask.numpy(), non_pad)
        assert info.input_schema is info.mask
        masked += mask.sum()
        total += non_pad.sum()
        ref_masked += np.asarray(jax_mask(jax.random.PRNGKey(seed), jnp.asarray(ids))).sum()
    # forcing one masked item into short sessions lifts the share a little
    # above p, in both packages alike
    assert abs(masked / total - P) < 0.05
    assert abs(masked / total - ref_masked / total) < 0.02


def test_same_generator_seed_gives_the_same_mask():
    tm = MaskedLanguageModeling(hidden_size=D, mlm_probability=P)
    ids = torch.from_numpy(_sessions(7)[0])
    a = tm.compute_masked_targets(ids, training=True, generator=torch.Generator().manual_seed(5))
    b = tm.compute_masked_targets(ids, training=True, generator=torch.Generator().manual_seed(5))
    c = tm.compute_masked_targets(ids, training=True, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a.mask, b.mask) and not torch.equal(a.mask, c.mask)


def test_ensure_min_masking_repairs_both_extremes():
    ids = torch.tensor([[5, 6, 7, 0], [8, 9, 0, 0], [3, 4, 5, 6]])
    non_pad = ids != 0
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        # nothing masked: one non-pad item gets forced
        labels, mask = _ensure_min_masking(torch.zeros_like(ids), torch.zeros_like(non_pad),
                                           ids, non_pad, 0, g)
        assert (mask.sum(1) == 1).all() and not (mask & ~non_pad).any()
        assert torch.equal(labels, torch.where(mask, ids, 0))
        # everything masked: one label is taken back
        labels, mask = _ensure_min_masking(ids.clone(), non_pad.clone(), ids, non_pad, 0, g)
        assert torch.equal(mask.sum(1), non_pad.sum(1) - 1)


def test_sample_index_from_mask_is_uniform_over_the_true_positions():
    mask = torch.tensor([[True, False, True, True]]).expand(3000, 4)
    idx = _sample_index_from_mask(mask, torch.Generator().manual_seed(1))
    counts = torch.bincount(idx, minlength=4).float() / 3000
    assert counts[1] == 0
    assert (counts[[0, 2, 3]] - 1 / 3).abs().max() < 0.03
