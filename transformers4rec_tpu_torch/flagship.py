"""The flagship configuration: REES46 XLNet-MLM, as the JAX ``bench.py`` builds it.

390,000 items (table rows padded to a multiple of 8, the true vocab bounds
softmax and top-k), d_model 192, 3 layers, 16 heads, sessions of 20, a
64-wide item table tied to the output through a 192→64 projection, MLM with
``mlm_probability=0.3``. ``build_model`` is also a serving model builder:
``--model-builder transformers4rec_tpu_torch.flagship:build_model``.
"""

from __future__ import annotations

from .config import XLNetConfig
from .data.synthetic import synthetic_ecommerce_data_schema
from .features import TabularSequenceFeatures
from .model import Model, NextItemPredictionTask

NUM_ITEMS = 390_000
NUM_CATEGORIES = 150
D_MODEL, N_LAYER, N_HEAD = 192, 3, 16
SEQ = 20
BATCH = 128
MLM_PROBABILITY = 0.3


def schema(num_items: int = NUM_ITEMS, seq: int = SEQ):
    return synthetic_ecommerce_data_schema(
        num_items=num_items, num_categories=NUM_CATEGORIES, max_session_length=seq
    )


def build_model(device=None, num_items: int = NUM_ITEMS, d_model: int = D_MODEL,
                n_layer: int = N_LAYER, n_head: int = N_HEAD, seq: int = SEQ,
                seed: int = 0, top_k=None) -> Model:
    """The flagship model with weights drawn from ``seed``, on ``device``
    (CUDA unless ``"cpu"``)."""
    input_module = TabularSequenceFeatures.from_schema(
        schema(num_items, seq), d_output=d_model, masking="mlm", aggregation="concat",
        masking_kwargs={"mlm_probability": MLM_PROBABILITY},
    )
    cfg = XLNetConfig.build(d_model=d_model, n_head=n_head, n_layer=n_layer,
                            total_seq_length=seq, dropout=0.1)
    model = cfg.to_model(
        input_module,
        NextItemPredictionTask(weight_tying=True),
        device=device, seed=seed,
    )
    model.top_k = top_k
    return model
