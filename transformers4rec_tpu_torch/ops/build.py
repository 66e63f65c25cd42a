"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, at first use, and loaded
with ``ctypes``. Libraries land in ``transformers4rec_tpu_torch/_build/``
(listed in ``.gitignore``), named by a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is reused. Nothing is downloaded; the sources include only
those headers and the CUDA toolkit's. A source may also be built a second
time with extra flags into a library of another name (``VARIANTS``): the
attention kernels' bf16 and f16 forms are ``flash_fwd.cu`` and
``flash_bwd.cu`` instantiated for bf16 and for f16, and compile beside the
f32 forms.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# libraries built from a source with extra flags: {name: (source stem, flags)}
VARIANTS = {
    "flash_fwd_bf16": ("flash_fwd", ("-DT4R_FLASH_BF16",)),
    "flash_bwd_bf16": ("flash_bwd", ("-DT4R_FLASH_BF16",)),
    "flash_fwd_f16": ("flash_fwd", ("-DT4R_FLASH_F16",)),
    "flash_bwd_f16": ("flash_bwd", ("-DT4R_FLASH_F16",)),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}  # dlopen is process-wide: so is this cache


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc`` or ``nvcc`` on PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")
    return found


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC_DIR.glob("*.cu"))}


def libraries() -> Dict[str, Tuple[Path, tuple]]:
    """Every library: ``{name: (source, extra nvcc flags)}``, each source
    under its own name and the ``VARIANTS``."""
    srcs = sources()
    libs = {name: (path, ()) for name, path in srcs.items()}
    libs.update({name: (srcs[stem], flags) for name, (stem, flags) in VARIANTS.items()})
    return libs


def library_path(name: str) -> Path:
    src, flags = libraries()[name]
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS + flags).encode()
    ).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None, ptxas_verbose: bool = False) -> Dict[str, str]:
    """Compile the named libraries (all by default) that are not built yet,
    one ``nvcc`` per library, all started together. Returns ``{name:
    compiler output}`` for the libraries compiled in this call; raises
    ``RuntimeError`` with the compiler's output when one fails."""
    libs = libraries()
    names = list(libs) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        src, flags = libs[name]
        cmd = [nvcc, *NVCC_FLAGS, *flags, *(["-Xptxas", "-v"] if ptxas_verbose else []),
               "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The library ``name`` (``csrc/<name>.cu`` or a variant), built first
    when missing."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib


def raise_on_error(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise when a library's launch function returned a CUDA error: a launch
    that is refused never runs, and a later synchronise does not report it."""
    if err != 0:
        lib.t4r_cuda_error_string.argtypes = [ctypes.c_int]
        lib.t4r_cuda_error_string.restype = ctypes.c_char_p
        msg = lib.t4r_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {err})")
