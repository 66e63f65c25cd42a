"""The port's step accounting (``utils/flops.py``) against the JAX package's:
every function gives the same count for the same shapes (integers exactly,
the utilisation to float rounding), for the flagship (REES46 XLNet-MLM:
batch 128, sessions of 20, d_model 192, 3 layers, 16 heads, 390,008 table
rows, E = 64), GPT-2-CLM (batch 32, sessions of 256) and the paper's tied
E = 448. Only the peaks differ: the card's, not the TPU's."""

import pytest

from transformers4rec_tpu.utils import flops as jax_flops

from transformers4rec_tpu_torch import flagship
from transformers4rec_tpu_torch.utils import flops

ROWS = flagship.NUM_ITEMS + 8  # the table's rows: the items, padding, to a multiple of 8
CONFIGS = {
    "flagship": dict(batch=flagship.BATCH, seq=flagship.SEQ, d_model=flagship.D_MODEL,
                     n_layer=flagship.N_LAYER, n_head=flagship.N_HEAD, vocab=ROWS, emb_dim=64,
                     mlm_p=flagship.MLM_PROBABILITY),
    "gpt2_clm": dict(batch=flagship.LONG_BATCH, seq=flagship.LONG_SEQ,
                     d_model=flagship.D_MODEL, n_layer=flagship.N_LAYER,
                     n_head=flagship.N_HEAD, vocab=ROWS, emb_dim=64, mlm_p=1.0),
    "paper_e448": dict(batch=flagship.BATCH, seq=flagship.SEQ, d_model=flagship.D_MODEL,
                       n_layer=flagship.N_LAYER, n_head=flagship.N_HEAD, vocab=ROWS,
                       emb_dim=flagship.PAPER_ITEM_DIM, mlm_p=flagship.MLM_PROBABILITY),
}


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("fwd_bwd", [True, False])
def test_every_count_is_the_jax_modules(config, fwd_bwd):
    c = CONFIGS[config]
    b, s, d, n, h = c["batch"], c["seq"], c["d_model"], c["n_layer"], c["n_head"]
    v, e = c["vocab"], c["emb_dim"]
    m = flops.mlm_budget_rows(b, s, c["mlm_p"])
    assert m == jax_flops.mlm_budget_rows(b, s, c["mlm_p"]) and 0 < m <= b * s
    for d_ff in (None, 3 * d):
        assert flops.encoder_step_flops(b, s, d, n, h, d_ff, fwd_bwd) == \
            jax_flops.encoder_step_flops(b, s, d, n, h, d_ff, fwd_bwd)
    assert flops.ce_step_flops(m, e, v, fwd_bwd) == jax_flops.ce_step_flops(m, e, v, fwd_bwd)
    assert flops.projection_step_flops(b, s, d, e, fwd_bwd) == \
        jax_flops.projection_step_flops(b, s, d, e, fwd_bwd)
    assert flops.ce_step_vpu_ops(m, v) == jax_flops.ce_step_vpu_ops(m, v)
    for nbytes in (4, 2):
        assert flops.ce_step_hbm_bytes(m, e, v, nbytes) == \
            jax_flops.ce_step_hbm_bytes(m, e, v, nbytes)
        assert flops.table_optimizer_hbm_bytes(v, e, nbytes) == \
            jax_flops.table_optimizer_hbm_bytes(v, e, nbytes)


@pytest.mark.parametrize("config", CONFIGS)
def test_the_step_accounting_and_mfu_are_the_jax_modules(config):
    c = CONFIGS[config]
    got = flops.xlnet_mlm_step_accounting(**c)
    want = jax_flops.xlnet_mlm_step_accounting(**c)
    assert got == want
    assert got["total_flops"] == got["encoder_flops"] + got["projection_flops"] + \
        got["ce_flops"]
    for peak in (flops.H100_PEAK_BF16_FLOPS, flops.H100_PEAK_F32_FLOPS):
        assert flops.mfu(got["total_flops"], 0.01, peak) == pytest.approx(
            jax_flops.mfu(want["total_flops"], 0.01, peak), rel=1e-12)


def test_the_defaults_are_the_flagships_and_the_peaks_the_cards():
    assert flops.xlnet_mlm_step_accounting() == jax_flops.xlnet_mlm_step_accounting()
    assert flops.xlnet_mlm_step_accounting() == flops.xlnet_mlm_step_accounting(
        **CONFIGS["flagship"])
    # the H100 SXM5 data sheet's dense rates, not the TPU's
    assert (flops.H100_PEAK_BF16_FLOPS, flops.H100_PEAK_F32_FLOPS,
            flops.H100_HBM_BYTES_PER_S) == (989e12, 67e12, 3.35e12)
    assert flops.mfu(989e12, 1.0) == pytest.approx(1.0)
    assert not hasattr(flops, "V5E_PEAK_BF16_FLOPS")
