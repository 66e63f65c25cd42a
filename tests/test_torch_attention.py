"""The port's flash attention (K5 forward, K6 backward) against the JAX
package on the CPU.

Same inputs, made with numpy from a seed, go through the JAX
``flash_attention`` in interpret mode with 128-row blocks (how
``tests/test_attention_kernel.py`` runs the Pallas kernels on the CPU) and
through the port's, whose wrappers take the plain PyTorch versions for CPU
tensors. Both sides round q, k, v, dO, P and dS to bf16 at the same places
and sum in f32, so outputs and gradients agree within atol 2e-3 / rtol 2e-3:
a bf16 rounding of P or dS may flip where the two packages' ``exp`` differ in
the last f32 bit. ``reference_attention`` is f32 on both sides: 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transformers4rec_tpu.ops import attention as jax_attn

from transformers4rec_tpu_torch.ops import attention as attn

torch.set_num_threads(1)

B, H = 2, 2
TOL = dict(atol=2e-3, rtol=2e-3)


def _inputs(S, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(0.0, 1.0, (B, S, H, Dh)).astype(np.float32) for _ in range(4))


def _pad(S, lengths):
    return np.arange(S)[None, :] < np.asarray(lengths)[:, None]


def _bias(shape, seed=9):
    """A constant bias with blocked entries, as a local window gives, over
    small finite values."""
    rng = np.random.default_rng(seed)
    return (np.where(rng.random(shape) > 0.8, -1e9, 0.0)
            + rng.normal(0.0, 0.5, shape)).astype(np.float32)


def _jax_flash(q, k, v, bias=None, pad=None, causal=False, bias_grad=False):
    return jax_attn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias),
        None if pad is None else jnp.asarray(pad),
        causal, 128, 128, True, bias_grad)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


CASES = {
    "causal": dict(S=160, Dh=32, causal=True),
    "causal_ragged_pad": dict(S=160, Dh=32, causal=True, lengths=(160, 40)),
    "pad_only": dict(S=128, Dh=16, causal=False, lengths=(100, 128)),
    "bias_1_1": dict(S=160, Dh=32, causal=False, bias=(1, 1)),
    "bias_B_1": dict(S=160, Dh=32, causal=False, bias=(B, 1)),
    "bias_1_H": dict(S=160, Dh=32, causal=True, bias=(1, H)),
    "bias_B_H": dict(S=160, Dh=32, causal=False, bias=(B, H), lengths=(160, 100)),
    "dh16_on_the_tile": dict(S=128, Dh=16, causal=True),
    "dh12": dict(S=160, Dh=12, causal=True, lengths=(160, 77)),
}


def _case(name):
    c = CASES[name]
    S, Dh = c["S"], c["Dh"]
    q, k, v, g = _inputs(S, Dh, seed=len(name))
    pad = _pad(S, c["lengths"]) if "lengths" in c else None
    bias = _bias((*c["bias"], S, S)) if "bias" in c else None
    return q, k, v, g, bias, pad, c["causal"]


@pytest.mark.parametrize("name", CASES)
def test_flash_forward_matches_the_jax_kernel(name):
    q, k, v, _, bias, pad, causal = _case(name)
    want = np.asarray(_jax_flash(q, k, v, bias, pad, causal))
    got = attn.flash_attention(_t(q), _t(k), _t(v), _t(bias), _t(pad), causal)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # and within bf16 noise of the dense f32 function, as the reference's own test
    ref = attn.reference_attention(_t(q), _t(k), _t(v), _t(bias), _t(pad), causal)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-2, rtol=5e-2)


@pytest.mark.parametrize("name", CASES)
def test_flash_gradients_match_the_jax_kernel(name):
    q, k, v, g, bias, pad, causal = _case(name)

    def loss(q_, k_, v_):
        return (_jax_flash(q_, k_, v_, bias, pad, causal) * jnp.asarray(g)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    tb = None if bias is None else _t(bias).requires_grad_()
    out = attn.flash_attention(*leaves, tb, _t(pad), causal)
    out.backward(_t(g))
    for name_, got, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), err_msg=name_, **TOL)
    if tb is not None:
        assert tb.grad is None  # a constant bias: the kernels give it no gradient


def test_every_key_masked_gives_exactly_zero_and_the_sentinel():
    q, k, v, g = _inputs(160, 32)
    none = np.zeros((B, 160), bool)
    want = np.asarray(_jax_flash(q, k, v, pad=none))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    got = attn.flash_attention(*leaves, None, _t(none), False)
    assert (want == 0).all() and (got.detach().numpy() == 0).all()
    _, lse = attn.flash_fwd(_t(q), _t(k), _t(v), None, _t(none), False)
    assert (lse == attn.LSE_MASKED).all()
    got.backward(_t(g))
    assert all((t.grad == 0).all() for t in leaves)
    # one session wholly padded beside a real one
    pad = _pad(160, (0, 90))
    want = np.asarray(_jax_flash(q, k, v, pad=pad, causal=True))
    got = attn.flash_attention(_t(q), _t(k), _t(v), None, _t(pad), True)
    assert (got.numpy()[0] == 0).all() and (want[0] == 0).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_reference_attention_matches_jax():
    q, k, v, _, bias, pad, _ = _case("bias_B_H")
    for causal in (False, True):
        want = jax_attn.reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            jnp.asarray(bias), jnp.asarray(pad), causal)
        got = attn.reference_attention(_t(q), _t(k), _t(v), _t(bias), _t(pad), causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_learned_bias_route_gives_the_reference_gradients():
    """``bias_grad=True``: the backward is autograd of the dense f32 function,
    as the JAX package's vjp of ``reference_attention``: all four gradients
    agree at 1e-4 and the bias gradient is not zero."""
    S, Dh = 128, 16
    q, k, v, g = _inputs(S, Dh, seed=3)
    bias = np.random.default_rng(4).normal(0.0, 0.5, (1, H, S, S)).astype(np.float32)
    pad = _pad(S, (128, 60))

    def loss(q_, k_, v_, b_):
        out = jax_attn.flash_attention(q_, k_, v_, b_, jnp.asarray(pad), True, 128, 128, True,
                                       True)
        return (out * jnp.asarray(g)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (q, k, v, bias)))
    leaves = [_t(a).requires_grad_() for a in (q, k, v, bias)]
    attn.flash_attention(*leaves, _t(pad), True, bias_grad=True).backward(_t(g))
    for name, got, w in zip(("q", "k", "v", "bias"), leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    assert float(leaves[3].grad.abs().max()) > 1e-3


@pytest.mark.parametrize("name", ["causal_ragged_pad", "bias_B_H", "dh12"])
def test_fused_and_split_backward_arithmetic_agree(name):
    """K6a's arithmetic (dq by per-key-tile partials) and K6b + K6c's (dq
    summed per query tile) differ in the order of dq's f32 sum only."""
    q, k, v, g, bias, pad, causal = _case(name)
    tq, tk, tv, tg, tb, tp = (_t(a) for a in (q, k, v, g, bias, pad))
    out, lse = attn.flash_forward_plain(tq, tk, tv, tb, tp, causal)
    fused = attn.flash_backward_plain(tq, tk, tv, tb, tp, causal, out, lse, tg, fused=True)
    split = attn.flash_backward_plain(tq, tk, tv, tb, tp, causal, out, lse, tg, fused=False)
    for a, b in zip(fused, split):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert torch.equal(fused[1], split[1]) and torch.equal(fused[2], split[2])


def _spy(monkeypatch, module, names, calls):
    """Record in ``calls`` the name of each function of ``names`` in
    ``module`` as it is called, and call it."""
    for name in names:
        real = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, _n=name, _r=real, **kw: calls.append(_n) or _r(*a, **kw))


@pytest.mark.parametrize("name", ["dh12", "causal_ragged_pad", "bias_B_H"])
def test_split_backward_matches_the_jax_split_kernels(name, monkeypatch):
    """The port's split route (K6b + K6c, taken above the dq-partials cap)
    against the JAX package's own split kernels (``_make_bwd_dq_kernel`` and
    ``_make_bwd_dkv_kernel`` in interpret mode). At these sizes JAX takes its
    fused kernel unless its dq scratch cap is lowered, which this test does
    for itself; the caches are cleared first, so that no earlier trace of the
    fused route is reused, and both sides are watched taking the split route."""
    q, k, v, g, bias, pad, causal = _case(name)
    made = []
    _spy(monkeypatch, jax_attn,
         ("_make_bwd_fused_kernel", "_make_bwd_dq_kernel", "_make_bwd_dkv_kernel"), made)
    monkeypatch.setattr(jax_attn, "_BWD_DQ_SCRATCH_MAX_BYTES", 0)
    jax.clear_caches()

    def loss(q_, k_, v_):
        return (_jax_flash(q_, k_, v_, bias, pad, causal) * jnp.asarray(g)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert made == ["_make_bwd_dq_kernel", "_make_bwd_dkv_kernel"]

    taken = []
    _spy(monkeypatch, attn, ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"), taken)
    monkeypatch.setattr(attn, "BWD_DQ_PARTIAL_MAX_BYTES", 0)
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    attn.flash_attention(*leaves, _t(bias), _t(pad), causal).backward(_t(g))
    assert taken == ["flash_bwd_dq", "flash_bwd_dkv"]
    for name_, got, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), err_msg=name_, **TOL)


def test_backward_routes_by_the_size_of_the_dq_partials(monkeypatch):
    q, k, v, g = (_t(a) for a in _inputs(128, 16))
    # the main path's partials fit under the cap, the 4,096-item step's do not
    main = torch.empty(32, 256, 16, 12, device="meta")
    long = torch.empty(4, 4096, 16, 12, device="meta")
    assert attn.dq_partial_bytes(main) <= attn.BWD_DQ_PARTIAL_MAX_BYTES
    assert attn.dq_partial_bytes(long) > attn.BWD_DQ_PARTIAL_MAX_BYTES
    calls = []
    _spy(monkeypatch, attn, ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"), calls)
    out, lse = attn.flash_fwd(q, k, v, None, None, True)
    assert attn.dq_partial_bytes(q) == 2 * q.numel() * 4
    want = attn.flash_backward(q, k, v, None, None, True, out, lse, g)
    monkeypatch.setattr(attn, "BWD_DQ_PARTIAL_MAX_BYTES", attn.dq_partial_bytes(q) - 1)
    got = attn.flash_backward(q, k, v, None, None, True, out, lse, g)
    assert calls == ["flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("head_dim,wgmma", [
    (12, False),   # the CLM path: the mma.sync kernels are faster there
    (32, False),   # and at (32, 256, 16, 32)
    (33, True),
    (64, True),    # the Hopper designs: about 2x faster at (4, 2048, 8, 64)
    (128, False),  # K6a's Hopper consumers would not hold dk and dv of 128 values
])
def test_each_head_dim_takes_the_design_its_times_chose(head_dim, wgmma):
    assert attn.uses_wgmma(head_dim) == wgmma
    # K6b and K6c, the two halves of the split backward: the streamed designs
    # up to 32 (the CLM path's 12 and the S = 4,096 step), the mma.sync
    # bodies above (K6c's is the one K6a shares)
    assert attn.uses_split_stream(head_dim) == (head_dim <= attn.SPLIT_STREAM_MAX_DH == 32)


@pytest.mark.parametrize("heads,key_tiles", [(1, 1), (3, 5), (64, 32)])
def test_streamed_dkv_blocks_take_every_key_tile_once_longest_first(heads, key_tiles):
    """The streamed K6c's launch order is a permutation of the (batch·head,
    key tile) pairs, and under the causal mask no block has fewer query
    steps than one launched after it."""
    order = attn.dkv_block_order(heads, key_tiles)
    assert sorted(order) == [(bh, kt) for bh in range(heads) for kt in range(key_tiles)]
    S = key_tiles * attn.DKV_STREAM_KEYS
    steps = [S // attn.TILE - kt * attn.DKV_STREAM_KEYS // attn.TILE for _, kt in order]
    assert steps == sorted(steps, reverse=True)


@pytest.mark.parametrize("heads,query_tiles", [(1, 1), (3, 5), (64, 32)])
def test_streamed_dq_blocks_take_every_query_tile_once_longest_first(heads, query_tiles):
    """The streamed K6b's launch order is a permutation of the (batch·head,
    query tile) pairs, the last query tile first, and under the causal mask
    no block has fewer key steps than one launched after it."""
    order = attn.dq_block_order(heads, query_tiles)
    assert sorted(order) == [(bh, qt) for bh in range(heads) for qt in range(query_tiles)]
    assert order[0] == (0, query_tiles - 1)
    steps = [(qt + 1) * attn.DQ_STREAM_QUERIES // attn.TILE for _, qt in order]
    assert steps == sorted(steps, reverse=True)


def test_cuda_tensors_never_take_the_plain_versions(monkeypatch):
    """A CPU tensor is the only way to the plain versions: anything else goes
    to the kernel launchers (which raise without a card). K5 is the
    registered operator ``t4r::flash_fwd``: its CUDA kernel is the
    launcher, and a tensor without data (``meta``, or a trace's fake) takes
    its fake, which gives the shapes and launches nothing."""
    called = []
    for name in ("_flash_fwd_cuda", "_flash_bwd_fused_cuda", "_flash_bwd_dq_cuda",
                 "_flash_bwd_dkv_cuda"):
        monkeypatch.setattr(attn, name, lambda *a, _n=name: called.append(_n))
    for name in ("flash_forward_plain", "flash_bwd_fused_plain", "flash_bwd_dq_plain",
                 "flash_bwd_dkv_plain"):
        monkeypatch.setattr(attn, name, lambda *a, _n=name: pytest.fail(_n))
    meta = torch.empty(2, 128, 2, 16, device="meta")
    rows = torch.empty(4, 128, device="meta")
    out, lse = attn.flash_fwd(meta, meta, meta)
    assert (out.shape, out.device.type, lse.shape) == (meta.shape, "meta", rows.shape)
    assert torch._C._dispatch_has_kernel_for_dispatch_key("t4r::flash_fwd", "CUDA")
    attn._flash_fwd_op_cuda(meta, meta, meta, None, None, False)
    attn.flash_bwd_fused(meta, meta, meta, meta, rows, rows)
    attn.flash_bwd_dq(meta, meta, meta, meta, rows, rows)
    attn.flash_bwd_dkv(meta, meta, meta, meta, rows, rows)
    assert called == ["_flash_fwd_cuda", "_flash_bwd_fused_cuda", "_flash_bwd_dq_cuda",
                      "_flash_bwd_dkv_cuda"]
    assert attn.flash_fwd.launches == 0 and attn.flash_bwd_fused.launches == 0


@pytest.mark.parametrize("bad", ["dh_not_mult4", "dh_too_wide", "q_dtype", "strided_k",
                                 "bias_shape", "pad_shape", "cpu_v"])
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(bad):
    """The checks run before anything is built or launched, so they can be
    held here on tensors that claim to be on a card."""
    dev = "meta"
    q = k = v = torch.empty(2, 128, 2, 16, device=dev)
    bias, pad = None, None
    if bad == "dh_not_mult4":
        q = k = v = torch.empty(2, 128, 2, 14, device=dev)
    elif bad == "dh_too_wide":
        q = k = v = torch.empty(2, 128, 2, 132, device=dev)
    elif bad == "q_dtype":
        q = q.half()
    elif bad == "strided_k":
        k = torch.empty(2, 128, 2, 32, device=dev)[..., ::2]
    elif bad == "bias_shape":
        bias = torch.empty(3, 2, 128, 128, device=dev)
    elif bad == "pad_shape":
        pad = torch.empty(2, 64, dtype=torch.bool, device=dev)
    elif bad == "cpu_v":
        v = torch.empty(2, 128, 2, 16)
    with pytest.raises((TypeError, ValueError)):
        attn._check_cuda_inputs("flash_fwd", {"q": q, "k": k, "v": v}, {}, bias, pad)


def test_use_flash_policy():
    assert not attn.use_flash(127, 0.0, True)
    assert attn.use_flash(128, 0.0, True)
    assert attn.use_flash(256, 0.1, False)  # dropout is not drawn outside training
    assert not attn.use_flash(256, 0.1, True)
    assert attn.NEG == jax_attn.NEG == -1e9
