"""The encoder's bfloat16 compute type: the port against the JAX package on
the CPU.

Encoders of d_model 32, 2 heads and 2 layers are built in both packages
with ``dtype`` bfloat16 (``TransformerConfig``'s; the parameters stay f32 in
both, so ``convert.params_from_jax`` moves them with no new rule), dropout
0, and held on the same inputs: the output and the gradients of every
parameter and of the input of a fixed projection of it.

The JAX side is compiled with XLA's ``xla_allow_excess_precision`` off
(``literal``): each of its steps then rounds to bf16 where the program says
so, the bits of running it eagerly. With the flag on (``jit``'s default) XLA
keeps f32 across the bf16 steps it fuses (the residual sum into the next
LayerNorm), so where it rounds would depend on its fusions. The port rounds
where the program does: each Linear's product and then its bias add, each
LayerNorm's output once, each GELU step, the residual sums, the attention's
probabilities and context. The two then agree bit for bit through the first
layer's attention and LayerNorms (and through the whole BERT encoder); the
tanh of the tanh GELU differs in the last bit for about 0.3% of its values
(XLA's f32 tanh is a rational approximation), and a value that lands on the
other side of a bf16 rounding moves what follows. So outputs are held within
2e-2 and gradients within 5e-2 in relative Frobenius norm (3e-2 and 8e-2
over two segments of memory). That alone would not tell a port that ignores
``dtype`` from one that follows it: each dense case also asserts that the
port's bf16 first layer output is ``CLOSER`` = 4 times nearer JAX's bf16 one
than the port's f32 first layer output is (measured: 6 to 13, and exact for
BERT).

- Dense at S = 8: XLNet's relative bias, GPT-2's causal mask, the BERT
  family's post-LN layers with the embedding LayerNorm, XLNet's two streams
  (PLM), Transformer-XL's memory over two segments, Reformer's local and LSH
  layers (LSH's dense form below 64 positions).
- Flash at S = 128 (fixture ``jax_flash``: the JAX Pallas kernels in
  interpret mode, the port's plain versions):
  GPT-2, and XLNet's learned bias, whose backward goes through
  ``reference_attention`` with the probabilities rounded to bf16.
- The flash plain versions on bf16 q, k, v and dO against the JAX kernels:
  out, dq, dk and dv come back bf16 in both, within one bf16 spacing plus
  the f32 tests' tolerance.
- The configuration: ``dtype`` takes None, float32, bfloat16 and their
  names; float16 raises, naming it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import transformers4rec_tpu as jtr
from transformers4rec_tpu.ops import attention as jax_attn

from test_torch_clm import jax_flash  # noqa: F401  (a fixture)
from transformers4rec_tpu_torch import T4RecTrainingArguments, convert
from transformers4rec_tpu_torch.blocks.transformer import TransformerEncoder
from transformers4rec_tpu_torch.config.transformer import compute_dtype, transformer_registry
from transformers4rec_tpu_torch.ops import attention as attn

torch.set_num_threads(1)

D, H, L = 32, 2, 2
BF16 = torch.bfloat16
JAX_TYPES = {BF16: jnp.bfloat16, torch.float32: jnp.float32}
# a key bias shifts every logit of a query alike and the softmax ignores it:
# its gradient is rounding noise around zero in both packages
ZERO_GRADIENT = "attn.k.bias"
CLOSER = 4.0  # the bf16 port's distance to JAX's bf16 first layer, times this, is below the f32 port's


def _rel_fro(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _perturbed(params, seed=9):
    """The JAX init with its LayerNorms moved off (1, 0), the Dense biases
    off 0, the relative-bias table scaled up and the query stream's start
    drawn wider, so that every weight matters."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        names = [getattr(k, "key", "") for k in path]
        if names[-1] in ("scale", "bias") and any(n.startswith("ln") for n in names):
            return leaf + rng.normal(0.0, 0.1, leaf.shape).astype(leaf.dtype)
        if names[-1] == "bias":  # the Dense layers' biases start at 0
            return leaf + rng.normal(0.0, 0.1, leaf.shape).astype(leaf.dtype)
        if names[-1] == "rel_bias":
            return leaf * 50
        if names[-1] == "query_stream_init":
            return leaf * 25
        return leaf

    return jax.tree_util.tree_map_with_path(move, jax.tree.map(np.asarray, params))


def _inputs(S, rows=3, perm=False, seed=5):
    """Inputs (rows, S, D), a pad mask with a short row and a row all
    padding, and with ``perm`` a factorisation order's perm mask."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (rows, S, D)).astype(np.float32)
    pad = np.arange(S)[None, :] < np.array([S, S // 3 + 1, 0])[:rows, None]
    if not perm:
        return x, pad, None
    order = np.stack([rng.permutation(S) for _ in range(rows)])
    return x, pad, (order[:, None, :] >= order[:, :, None]).astype(np.float32)


def literal(f, *args):
    """``f(*args)`` compiled by XLA with ``xla_allow_excess_precision`` off:
    every step rounds to its type as the program says, the bits of running
    ``f`` eagerly."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _jax_rotations(seed, dh, hashes, buckets):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (dh, hashes, buckets // 2),
                                        dtype=jnp.float32))


class Pair:
    """One configuration in both packages with the same weights: ``jax(dtype)``
    and ``port(dtype)`` build the encoders; ``run_jax`` and ``run_port`` give
    the output, the gradients of ``sum(out * w)`` and the first layer's
    output."""

    def __init__(self, arch, S, plm=False, remat=False, **kw):
        self.arch, self.plm, self.remat = arch, plm, remat
        self.x, self.pad, self.perm = _inputs(S, perm=plm)
        self.build = dict(d_model=D, n_head=H, n_layer=L, total_seq_length=S, dropout=0.0, **kw)
        jenc = self.jax(jnp.float32)
        self.params = _perturbed(jax.jit(lambda xx: jenc.init(
            jax.random.PRNGKey(0), xx, *self._jax_masks()))(jnp.asarray(self.x)))
        jcfg = jtr.transformer_registry.parse(arch).build(**self.build)
        self.rotations = {
            f"layer_{i}": _jax_rotations(i, D // H, jcfg.lsh_num_hashes, jcfg.lsh_num_buckets)
            for i, kind in enumerate(jcfg.attn_layers or ()) if kind == "lsh"}
        self.w = np.random.default_rng(8).normal(size=self.x.shape).astype(np.float32)

    def _jax_masks(self):
        masks = (jnp.asarray(self.pad),)
        return masks + ((jnp.asarray(self.perm),) if self.plm else ())

    def jax(self, dtype):
        return jtr.transformer_registry.parse(self.arch).build(
            **self.build, dtype=dtype, remat=self.remat).to_encoder()

    def port(self, dtype):
        tenc = transformer_registry.parse(self.arch).build(
            **self.build, dtype=dtype, remat=self.remat).to_encoder(
                masking="plm" if self.plm else None)
        tenc.load_state_dict(convert.params_from_jax(self.params, lsh_rotations=self.rotations))
        return tenc

    def run_jax(self, dtype):
        jenc, w, masks = self.jax(JAX_TYPES[dtype]), jnp.asarray(self.w), self._jax_masks()

        def loss(p, xx):
            return (jenc.apply(p, xx, *masks) * w).sum()

        x = jnp.asarray(self.x)
        out, state = literal(lambda p, xx: jenc.apply(p, xx, *masks, capture_intermediates=True),
                             self.params, x)
        gp, gx = literal(jax.grad(loss, argnums=(0, 1)), self.params, x)
        grads = {k: v.numpy() for k, v in convert.params_from_jax(
            jax.tree.map(lambda a: np.asarray(a, np.float32), gp)).items()}
        grads["x"] = np.asarray(gx, np.float32)
        layers = state["intermediates"]
        first = layers["layer_0" if "layer_0" in layers else "layer_shared"]["__call__"][0][0]
        return np.asarray(out, np.float32), grads, np.asarray(first, np.float32)

    def run_port(self, dtype):
        tenc = self.port(dtype)
        first = []
        tenc.stack()[0].register_forward_hook(lambda m, i, o: first.append(o[0]))
        xt = torch.from_numpy(self.x).requires_grad_()
        out = tenc(xt, pad_mask=torch.from_numpy(self.pad),
                   perm_mask=None if self.perm is None else torch.from_numpy(self.perm))
        (out * torch.from_numpy(self.w)).sum().backward()
        grads = {n: p.grad.numpy() for n, p in tenc.named_parameters()}
        grads["x"] = xt.grad.numpy()
        return out.detach().numpy(), grads, first[0].detach().float().numpy()


# ------------------------------------------------------------- dense, S = 8
@pytest.mark.parametrize("arch,plm,kw", [
    ("xlnet", False, {}),
    ("gpt2", False, {}),
    ("bert", False, {}),
    ("xlnet", True, {}),
    ("reformer", False, {"attn_layers": ("local", "lsh"), "local_window": 2}),
])
def test_bf16_encoder_matches_jax_on_the_dense_path(arch, plm, kw, monkeypatch):
    pair = Pair(arch, 8, plm=plm, **kw)
    monkeypatch.setattr(attn, "flash_fwd", None)  # the dense path: no flash call
    want_out, want, want_first = pair.run_jax(BF16)
    got_out, got, got_first = pair.run_port(BF16)
    assert got_out.dtype == np.float32 and set(got) == set(want)
    assert _rel_fro(got_out, want_out) <= 2e-2
    for name in want:
        if not name.endswith(ZERO_GRADIENT):
            assert _rel_fro(got[name], want[name]) <= 5e-2, name
    near = _rel_fro(got_first, want_first)
    far = _rel_fro(pair.run_port(None)[2], want_first)
    assert CLOSER * near <= far, (near, far)


def test_bf16_encoder_keeps_its_types():
    """Parameters f32, every Linear and LayerNorm computing in bf16 (their
    outputs bf16), the residual stream bf16, the output f32."""
    pair = Pair("xlnet", 8)
    tenc = pair.port(BF16)
    assert all(p.dtype == torch.float32 for p in tenc.parameters())
    seen = {}
    hooks = [m.register_forward_hook(lambda m, i, o, name=name: seen.setdefault(
        name, (i[0].dtype, o.dtype if torch.is_tensor(o) else o[0].dtype)) and None)
        for name, m in tenc.named_modules() if name.endswith(("ffn_in", "ln1", "attn", "ln_f"))
        or name == "layers.0"]
    out = tenc(torch.from_numpy(pair.x), pad_mask=torch.from_numpy(pair.pad))
    for h in hooks:
        h.remove()
    assert out.dtype == torch.float32
    assert seen["layers.0"] == (BF16, BF16)  # the residual stream
    assert seen["layers.0.ffn_in"] == (BF16, BF16)
    assert seen["layers.0.ln1"] == (BF16, BF16)
    assert seen["layers.0.attn"][1] == BF16
    assert seen["ln_f"] == (BF16, BF16)


def test_bf16_memory_over_two_segments_matches_jax():
    """Transformer-XL's memory: the states are kept in bf16 (``init_mems``
    and the returned ones); two segments through both packages, the second
    segment's output and gradients against JAX's."""
    B, S, M = 3, 6, 4
    kw = dict(d_model=D, n_head=H, n_layer=L, dropout=0.0, causal=True,
              pos_encoding="relative_bias", mem_len=M)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, B, S, D)).astype(np.float32)
    pad = np.arange(S)[None, :] < np.array([S, 4, 1])[:, None]
    w = rng.normal(size=(B, S, D)).astype(np.float32)
    jenc = jtr.TransformerEncoder(**kw, dtype=jnp.bfloat16)
    params = _perturbed(jax.jit(lambda xx: jenc.init(
        jax.random.PRNGKey(0), xx, jnp.asarray(pad), mems=jenc.init_mems(B),
        return_mems=True))(jnp.asarray(x[0])))
    def apply(p, xx, m):
        return literal(lambda p_, x_, m_: jenc.apply(p_, x_, jnp.asarray(pad), mems=m_,
                                                     return_mems=True), p, xx, m)

    _, jm = apply(params, jnp.asarray(x[0]), jenc.init_mems(B))
    assert jm["states"].dtype == jnp.bfloat16
    want_out = np.asarray(apply(params, jnp.asarray(x[1]), jm)[0], np.float32)

    def loss(p, xx):
        return (jenc.apply(p, xx, jnp.asarray(pad), mems=jm, return_mems=True)[0]
                * jnp.asarray(w)).sum()

    gp, gx = literal(jax.grad(loss, argnums=(0, 1)), params, jnp.asarray(x[1]))
    want = convert.params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), gp))
    outs = {}
    for dt in (BF16, None):
        tenc = TransformerEncoder(**kw, dtype=dt)
        tenc.load_state_dict(convert.params_from_jax(params))
        tm = tenc.init_mems(B)
        assert tm["states"].dtype == (dt or torch.float32)
        with torch.no_grad():
            _, tm = tenc(torch.from_numpy(x[0]), pad_mask=torch.from_numpy(pad), mems=tm,
                         return_mems=True)
        assert tm["states"].dtype == (dt or torch.float32)
        np.testing.assert_array_equal(tm["pad"].numpy(), np.asarray(jm["pad"]))
        xt = torch.from_numpy(x[1]).requires_grad_()
        out, _ = tenc(xt, pad_mask=torch.from_numpy(pad), mems=tm, return_mems=True)
        (out * torch.from_numpy(w)).sum().backward()
        outs[dt] = out.detach().numpy()
        if dt is None:
            continue
        assert _rel_fro(tm["states"].float().numpy(), np.asarray(jm["states"], np.float32)) \
            <= 3e-2
        assert _rel_fro(outs[dt], want_out) <= 3e-2
        for name, p in tenc.named_parameters():
            if not name.endswith(ZERO_GRADIENT):
                assert _rel_fro(p.grad.numpy(), want[name].numpy()) <= 8e-2, name
        assert _rel_fro(xt.grad.numpy(), np.asarray(gx, np.float32)) <= 8e-2
    # the whole output here (its first layer's is not returned): 2 times
    # nearer (measured: 3.1)
    near, far = _rel_fro(outs[BF16], want_out), _rel_fro(outs[None], want_out)
    assert 2 * near <= far, (near, far)


# ----------------------------------------------------------- flash, S = 128
@pytest.mark.parametrize("arch", ["gpt2", "xlnet"])
def test_bf16_encoder_matches_jax_on_the_flash_path(arch, jax_flash, monkeypatch):  # noqa: F811
    pair = Pair(arch, 128)
    taken = []
    real = attn.FlashAttention.apply
    monkeypatch.setattr(attn.FlashAttention, "apply",
                        lambda *a: taken.append(a[:3]) or real(*a))
    want_out, want, _ = pair.run_jax(BF16)
    got_out, got, _ = pair.run_port(BF16)
    # both packages took the flash path in every layer, on bf16 q, k, v
    assert len(jax_flash) >= L and len(taken) == L
    assert all(t.dtype == BF16 for qkv in taken for t in qkv)
    assert _rel_fro(got_out, want_out) <= 2e-2
    for name in want:
        if not name.endswith(ZERO_GRADIENT):
            assert _rel_fro(got[name], want[name]) <= 5e-2, name
    if arch == "xlnet":  # the learned bias's gradient, through reference_attention
        assert np.abs(got["rel_pos.rel_bias"]).max() > 0


def test_flash_plain_versions_on_bf16_match_the_jax_kernels():
    """K5's and K6a's plain versions on bf16 q, k, v, dO against the JAX
    Pallas kernels in interpret mode: both return bf16; within one bf16
    spacing of each value plus the f32 tests' tolerances."""
    B, S, Hh, Dh = 2, 130, 2, 16
    rng = np.random.default_rng(3)
    q, k, v, g = (rng.normal(0, 1, (B, S, Hh, Dh)).astype(np.float32) for _ in range(4))
    q, k, v, g = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (q, k, v, g))
    pad = np.arange(S)[None, :] < np.array([S, 77])[:, None]
    bias = rng.normal(0, 0.5, (1, Hh, S, S)).astype(np.float32)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))

    def jfn(q_, k_, v_):
        return jax_attn.flash_attention(q_, k_, v_, jnp.asarray(bias), jnp.asarray(pad), True,
                                        128, 128, True, False)

    want_out, vjp = jax.vjp(jfn, jq, jk, jv)
    want = [want_out, *vjp(jg)]
    assert all(w.dtype == jnp.bfloat16 for w in want)
    tq, tk, tv, tg = (torch.from_numpy(np.asarray(a, np.float32)).to(BF16) for a in (q, k, v, g))
    tbias, tpad = torch.from_numpy(bias), torch.from_numpy(pad)
    out, lse = attn.flash_forward_plain(tq, tk, tv, tbias, tpad, True)
    got = [out, *attn.flash_backward_plain(tq, tk, tv, tbias, tpad, True, out, lse, tg)]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == BF16, name
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        spacing = np.exp2(np.floor(np.log2(np.maximum(np.abs(b), 2.0 ** -120))) - 7)
        atol = 5e-3 if name == "out" else 2e-2 * np.abs(b).max()
        assert (np.abs(a - b) <= atol + spacing).all(), name
        assert _rel_fro(a, b) <= 5e-3, name


# ------------------------------------------------------------ configuration
@pytest.mark.parametrize("given,want", [(None, torch.float32), (torch.float32, torch.float32),
                                        ("float32", torch.float32), (BF16, BF16),
                                        ("bfloat16", BF16)])
def test_the_config_takes_float32_and_bfloat16(given, want):
    cfg = transformer_registry.parse("gpt2").build(d_model=D, n_head=H, n_layer=1,
                                                   total_seq_length=8, dtype=given, remat=True)
    assert compute_dtype(given) == want
    enc = cfg.to_encoder()
    assert enc.compute_dtype == want and enc.remat


@pytest.mark.parametrize("bad,name", [(torch.float16, "float16"), ("float16", "float16"),
                                      (torch.float64, "float64")])
def test_the_config_refuses_other_types(bad, name):
    with pytest.raises(NotImplementedError, match=name):
        transformer_registry.parse("xlnet").build(d_model=D, n_head=H, n_layer=1,
                                                  total_seq_length=8, dtype=bad)


def test_gradient_checkpointing_is_accepted_and_read_by_no_module():
    args = T4RecTrainingArguments(gradient_checkpointing=True)
    assert args.gradient_checkpointing
