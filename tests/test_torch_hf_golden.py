"""The port's encoder against the HuggingFace models the reference wraps.

The BERT family's post-LN form (the embedding LayerNorm after the position
add, residual then LayerNorm in every layer, the erf GELU, no final
LayerNorm) and GPT-2's pre-LN form (the tanh GELU, a final LayerNorm) admit
an exact weight transfer: real ``transformers.BertModel`` and
``transformers.GPT2Model`` weights, built from a config with a seed and
nothing downloaded, are copied into the port's ``TransformerEncoder``
(HF's token-type row folded into the position table), and the port's
outputs must equal HF's at every valid position within 1e-5, with and
without padding. Mirrors the JAX package's ``tests/test_hf_golden.py``.
"""

import os

import numpy as np
import pytest
import torch

# the models are PyTorch's: transformers need not import TensorFlow
os.environ.setdefault("USE_TF", "0")
transformers = pytest.importorskip("transformers")

from transformers4rec_tpu_torch.blocks.transformer import TransformerEncoder  # noqa: E402

torch.set_num_threads(1)

D, H, L, B, S = 64, 4, 2, 3, 10


def _inputs(with_padding):
    x = np.random.default_rng(0).normal(size=(B, S, D)).astype(np.float32)
    lengths = np.array([10, 7, 4]) if with_padding else np.full(B, S)
    return x, np.arange(S)[None] < lengths[:, None]


def _compare(hf, enc, x, valid):
    with torch.no_grad():
        want = hf(inputs_embeds=torch.from_numpy(x),
                  attention_mask=torch.from_numpy(valid.astype(np.float32))).last_hidden_state
        got = enc(torch.from_numpy(x), pad_mask=torch.from_numpy(valid))
    # HF lets padded queries attend too; downstream never reads them
    np.testing.assert_allclose(got.numpy()[valid], want.numpy()[valid], atol=1e-5, rtol=0)


@pytest.mark.parametrize("with_padding", [False, True])
def test_bert_exact_weight_transfer(with_padding):
    torch.manual_seed(0)
    hf = transformers.BertModel(transformers.BertConfig(
        vocab_size=1, hidden_size=D, num_hidden_layers=L, num_attention_heads=H,
        intermediate_size=4 * D, hidden_act="gelu", hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, max_position_embeddings=S, layer_norm_eps=1e-12,
        attn_implementation="eager"), add_pooling_layer=False).eval()
    sd = hf.state_dict()
    enc = TransformerEncoder(D, H, L, causal=False, pos_encoding="learned_absolute",
                             max_position=S, activation="gelu_exact", dropout=0.0,
                             norm_first=False, embed_layer_norm=True)
    ours = {"position_embedding": sd["embeddings.position_embeddings.weight"]
            + sd["embeddings.token_type_embeddings.weight"][0][None, :],
            "ln_emb.weight": sd["embeddings.LayerNorm.weight"],
            "ln_emb.bias": sd["embeddings.LayerNorm.bias"]}
    for i in range(L):
        hf_l = f"encoder.layer.{i}"
        names = {"attn.q": "attention.self.query", "attn.k": "attention.self.key",
                 "attn.v": "attention.self.value", "attn.out": "attention.output.dense",
                 "ln1": "attention.output.LayerNorm", "ffn_in": "intermediate.dense",
                 "ffn_out": "output.dense", "ln2": "output.LayerNorm"}
        for port, theirs in names.items():
            for w in ("weight", "bias"):
                ours[f"layers.{i}.{port}.{w}"] = sd[f"{hf_l}.{theirs}.{w}"]
    enc.load_state_dict(ours)  # strict: post-LN has no ln_f
    _compare(hf, enc, *_inputs(with_padding))


@pytest.mark.parametrize("with_padding", [False, True])
def test_gpt2_exact_weight_transfer(with_padding):
    torch.manual_seed(0)
    hf = transformers.GPT2Model(transformers.GPT2Config(
        vocab_size=1, n_positions=S, n_embd=D, n_layer=L, n_head=H,
        activation_function="gelu_new", resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
        layer_norm_epsilon=1e-5, attn_implementation="eager")).eval()
    sd = hf.state_dict()
    enc = TransformerEncoder(D, H, L, causal=True, pos_encoding="learned_absolute",
                             max_position=S, layer_norm_eps=1e-5, dropout=0.0)
    ours = {"position_embedding": sd["wpe.weight"], "ln_f.weight": sd["ln_f.weight"],
            "ln_f.bias": sd["ln_f.bias"]}
    for i in range(L):
        hf_l = f"h.{i}"
        # HF's Conv1D stores (in, out); c_attn packs q | k | v along out
        w, b = sd[f"{hf_l}.attn.c_attn.weight"], sd[f"{hf_l}.attn.c_attn.bias"]
        for j, name in enumerate(("q", "k", "v")):
            ours[f"layers.{i}.attn.{name}.weight"] = w[:, j * D:(j + 1) * D].T
            ours[f"layers.{i}.attn.{name}.bias"] = b[j * D:(j + 1) * D]
        for port, theirs in {"attn.out": "attn.c_proj", "ffn_in": "mlp.c_fc",
                             "ffn_out": "mlp.c_proj"}.items():
            ours[f"layers.{i}.{port}.weight"] = sd[f"{hf_l}.{theirs}.weight"].T
            ours[f"layers.{i}.{port}.bias"] = sd[f"{hf_l}.{theirs}.bias"]
        for port, theirs in {"ln1": "ln_1", "ln2": "ln_2"}.items():
            for p in ("weight", "bias"):
                ours[f"layers.{i}.{port}.{p}"] = sd[f"{hf_l}.{theirs}.{p}"]
    enc.load_state_dict(ours)
    _compare(hf, enc, *_inputs(with_padding))
