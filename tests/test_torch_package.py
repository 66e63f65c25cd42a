"""Package rules of the PyTorch port.

- ``transformers4rec_tpu_torch`` imports neither JAX, flax, optax nor the JAX
  package, in a fresh interpreter and in its source;
- the repository's lint rules (``ci/lint.py``, imported, not edited) find
  nothing in the port or in ``chip_smoke.py``;
- the entry points run on CUDA unless the caller asks for the CPU, and on a
  machine without CUDA they raise instead of carrying on on the CPU;
- every CUDA source is found by the build module and says which TPU kernel
  it replaces.
"""

import ast
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from transformers4rec_tpu_torch import flagship
from transformers4rec_tpu_torch.ops import build
from transformers4rec_tpu_torch.serving import InferenceRunner, ServingServer
from transformers4rec_tpu_torch.serving.server import main as server_main
from transformers4rec_tpu_torch.trainer import T4RecTrainingArguments, Trainer
from transformers4rec_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "transformers4rec_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "transformers4rec_tpu")
SMALL = dict(num_items=50, d_model=16, n_layer=1, n_head=2, seq=4)


def _port_sources():
    # the git-ignored kernel build directory is no source of the package
    return sorted(p for p in PACKAGE.rglob("*.py") if build.BUILD_DIR not in p.parents) + [
        REPO / "chip_smoke.py"
    ]


def test_fresh_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import transformers4rec_tpu_torch, transformers4rec_tpu_torch.flagship\n"
        "import transformers4rec_tpu_torch.serving.server, transformers4rec_tpu_torch.ops.build\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_sources_import_no_jax():
    found = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.relative_to(REPO)}:{node.lineno} {n}" for n in names
                      if n.split(".")[0] in FORBIDDEN]
    assert found == []


def test_repo_lint_rules_find_nothing_in_the_port():
    spec = importlib.util.spec_from_file_location("repo_lint", REPO / "ci" / "lint.py")
    lint = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lint)
    problems = [p for path in _port_sources() for p in lint.lint_file(path)]
    assert problems == []


def _without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the entry points would run there")


@pytest.mark.parametrize("entry", ["model", "runner", "server", "cli", "trainer", "build_trainer"])
def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path, entry):
    _without_cuda()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "model":
            flagship.build_model(**SMALL)
        elif entry == "runner":
            InferenceRunner(str(tmp_path), flagship.build_model)
        elif entry == "server":
            ServingServer(str(tmp_path), flagship.build_model, port=0)
        elif entry == "trainer":
            Trainer(flagship.build_model("cpu", **SMALL), T4RecTrainingArguments())
        elif entry == "build_trainer":
            flagship.build_trainer(**SMALL)
        else:
            server_main(["--artifact", str(tmp_path), "--model-builder",
                         "transformers4rec_tpu_torch.flagship:build_model", "--port", "0"])
    # the CPU is always there when asked for by name
    assert resolve_device("cpu") == torch.device("cpu")
    assert flagship.build_model("cpu", **SMALL).device == torch.device("cpu")
    assert flagship.build_trainer("cpu", **SMALL).device == torch.device("cpu")


def test_build_finds_every_cuda_source_and_each_names_its_tpu_kernel():
    srcs = build.sources()
    replaces = {"ce_rank": "_ce_rank_kernel", "ce_fwd": "_ce_fwd_kernel_vmajor",
                "ce_bwd": "_ce_bwd_fused_kernel_dxsc"}
    assert set(srcs) == {p.stem for p in (PACKAGE / "csrc").glob("*.cu")} == set(replaces)
    for name, path in srcs.items():
        text = path.read_text()
        assert f"Replaces: transformers4rec_tpu/ops/vocab.py:{replaces[name]}" in text
        assert "Bound on an H100" in text
        assert build.library_path(name).parent == build.BUILD_DIR
        assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_an_edited_shared_header_renames_every_library(tmp_path, monkeypatch):
    """The libraries are named by a hash of source, shared headers and flags:
    a change to ``csrc/common.cuh`` must rebuild all of them."""
    before = {name: build.library_path(name) for name in build.sources()}
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in build.CSRC_DIR.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    assert {name: build.library_path(name) for name in build.sources()} == before
    with open(csrc / "common.cuh", "a") as f:
        f.write("// edited\n")
    after = {name: build.library_path(name) for name in build.sources()}
    assert all(after[name] != before[name] for name in before)
