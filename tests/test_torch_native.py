"""The loader's C++ kernels (``transformers4rec_tpu_torch.native``) against
numpy and against the JAX package's ``native``, bit for bit: both kernels
copy bytes, so any difference is a fault. Rows may be empty, shorter than,
equal to or longer than ``max_len`` (truncation keeps the first items)."""

import importlib

import numpy as np
import pytest

from transformers4rec_tpu import native as jax_native
from transformers4rec_tpu.data.padding import pad_ragged as jax_pad_ragged

from transformers4rec_tpu_torch import native
from transformers4rec_tpu_torch.data import loader as loader_mod
from transformers4rec_tpu_torch.data.loader import InMemoryDataLoader
from transformers4rec_tpu_torch.data.padding import pad_ragged

LENGTHS = [0, 3, 0, 7, 12, 1, 0, 20, 5, 0]


def _ragged(dtype, lengths=LENGTHS, seed=0):
    rng = np.random.default_rng(seed)
    offsets = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    values = (rng.normal(size=offsets[-1]) * 1000).astype(dtype)
    return values, offsets


@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.int32])
@pytest.mark.parametrize("max_len", [1, 7, 20, 32])
def test_pad_ragged_gives_numpys_and_the_jax_kernels_bits(dtype, max_len):
    values, offsets = _ragged(dtype)
    got = native.pad_ragged(values, offsets, max_len)
    want = pad_ragged(values, offsets, max_len, use_native=False)
    assert got.dtype == want.dtype == np.dtype(dtype) and got.shape == (len(LENGTHS), max_len)
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == jax_native.pad_ragged(values, offsets, max_len).tobytes()
    assert got.tobytes() == jax_pad_ragged(values, offsets, max_len).tobytes()
    # the dispatching entry point takes the kernel
    assert pad_ragged(values, offsets, max_len).tobytes() == got.tobytes()


def test_pad_ragged_of_no_rows_and_of_many():
    values, offsets = _ragged(np.int64, lengths=[])
    assert native.pad_ragged(values, offsets, 5).shape == (0, 5)
    # past the kernel's 256-row threshold the rows fan out over threads
    lengths = np.random.default_rng(1).integers(0, 30, 5000).tolist()
    values, offsets = _ragged(np.float32, lengths=lengths, seed=2)
    got = native.pad_ragged(values, offsets, 20)
    assert got.tobytes() == pad_ragged(values, offsets, 20, use_native=False).tobytes()
    assert got.tobytes() == jax_native.pad_ragged(values, offsets, 20).tobytes()


def test_a_type_the_kernel_does_not_take():
    values, offsets = _ragged(np.float64)
    with pytest.raises(TypeError, match="float64"):
        native.pad_ragged(values, offsets, 4)
    # the dispatching entry point takes numpy for it, as the JAX package does
    assert pad_ragged(values, offsets, 4).tobytes() == \
        jax_pad_ragged(values, offsets, 4).tobytes()


@pytest.mark.parametrize("shape,dtype", [((300,), np.int64), ((300, 20), np.float32),
                                         ((300, 4, 3), np.int32)])
def test_gather_rows_gives_numpys_and_the_jax_kernels_bits(shape, dtype):
    rng = np.random.default_rng(3)
    src = (rng.normal(size=shape) * 100).astype(dtype)
    idx = rng.integers(0, shape[0], 1000)
    got = native.gather_rows(src, idx)
    assert got.shape == (1000,) + shape[1:]
    assert got.tobytes() == src[idx].tobytes()
    assert got.tobytes() == jax_native.gather_rows(src, idx).tobytes()
    assert native.gather_rows(src, idx[:0]).shape == (0,) + shape[1:]


def test_the_loader_gathers_natively_from_its_size_rule(monkeypatch):
    rng = np.random.default_rng(4)
    data = {"item_id": rng.integers(1, 100, (70, 8)),
            "wide": rng.normal(size=(70, 4096)).astype(np.float32)}
    assert not loader_mod.native_gathers(data, 16)  # 16 rows of 16 KiB: numpy
    assert loader_mod.native_gathers(data, 512)
    calls = []
    gather = native.gather_rows
    monkeypatch.setattr(native, "gather_rows", lambda s, i: calls.append(1) or gather(s, i))

    def batches(min_bytes):
        monkeypatch.setattr(loader_mod, "NATIVE_GATHER_MIN_BYTES", min_bytes)
        return list(InMemoryDataLoader(data, 16, shuffle=True, drop_last=False, seed=2,
                                       prefetch=0))

    with_numpy = batches(1 << 40)
    assert not calls
    with_kernel = batches(0)
    assert calls  # the full batches; the zero-filled tail takes numpy
    assert len(with_kernel) == len(with_numpy) == 5
    for a, b in zip(with_kernel, with_numpy):
        assert all(a[k].tobytes() == b[k].tobytes() for k in data)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "padding.cc"
    bad.write_text("this is not C++\n")
    fresh = importlib.reload(native)
    try:
        monkeypatch.setattr(fresh, "SOURCE", bad)
        monkeypatch.setattr(fresh, "BUILD_DIR", tmp_path / "build")
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            fresh.available()
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            fresh.pad_ragged(*_ragged(np.int64), 4)
        assert not list((tmp_path / "build").glob("*.so"))
    finally:
        monkeypatch.undo()
        importlib.reload(native)
