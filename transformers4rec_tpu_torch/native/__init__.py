"""Host kernels of the loader in C++: ragged padding and row gathers.

Counterpart of ``transformers4rec_tpu/native``. ``padding.cc`` (this
package's own copy) is compiled with ``g++`` at first use into
``transformers4rec_tpu_torch/_build/`` (named by a hash of the source and
the flags) and loaded with ``ctypes``. A failed build raises
``RuntimeError`` with the compiler's output: no caller falls back to numpy
on it. Numpy stays an explicit choice of the caller (``data.padding``'s
``use_native`` argument, the loader's size rule for gathers) or the rule
for a type the kernels do not take (``pad_ragged`` takes float32, int64
and int32). Both kernels copy bytes, so their results are numpy's bit for
bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "padding.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

PAD_FNS = {
    np.dtype(np.float32): "pad_ragged_f32",
    np.dtype(np.int64): "pad_ragged_i64",
    np.dtype(np.int32): "pad_ragged_i32",
}


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libt4r_native-{digest[:16]}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        proc = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"the loader's native kernels could not be built: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("g++ failed to build the loader's native kernels:\n"
                           + proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            # pointers go as plain addresses (``ndarray.ctypes.data``): a
            # typed pointer object costs microseconds a call
            ptr, i64 = ctypes.c_void_p, ctypes.c_int64
            for name in (*PAD_FNS.values(), "gather_rows"):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = [ptr, ptr, i64, i64, ptr], None
            _lib = lib
        return _lib


def available() -> bool:
    """True once the library is built and loaded (building it now if it is
    not); a failed build raises."""
    return _load() is not None


def pad_ragged(values: np.ndarray, offsets: np.ndarray, max_len: int) -> np.ndarray:
    """Ragged → dense ``(rows, max_len)``, zero padded, the first
    ``max_len`` items of each row kept. ``values`` float32, int64 or int32;
    another type raises ``TypeError``."""
    values = np.ascontiguousarray(values)
    name = PAD_FNS.get(values.dtype)
    if name is None:
        raise TypeError(f"the native pad_ragged takes {sorted(map(str, PAD_FNS))}, "
                        f"not {values.dtype}")
    lib = _load()
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    rows = len(offsets) - 1
    out = np.empty((rows, max_len), dtype=values.dtype)
    getattr(lib, name)(values.ctypes.data, offsets.ctypes.data, rows, max_len, out.ctypes.data)
    return out


def gather_rows(src: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """``src[indices]`` along the first axis, for any fixed row size."""
    lib = _load()
    src = np.ascontiguousarray(src)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    row_bytes = int(src.dtype.itemsize * int(np.prod(src.shape[1:], dtype=np.int64)))
    out = np.empty((len(indices),) + src.shape[1:], dtype=src.dtype)
    lib.gather_rows(src.ctypes.data, indices.ctypes.data, len(indices), row_bytes,
                    out.ctypes.data)
    return out
