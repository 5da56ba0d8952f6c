"""Guards of the port's boundaries: `src/repro_torch/` and
`chip_smoke.py` import neither jax nor the JAX package, and the port's
entry points never carry on on the CPU unasked."""

import ast
import pathlib

import pytest
import torch

from repro_torch.core.backends import (available_backends, get_backend,
                                       resolve_backend)
from repro_torch.core.batch import AlignmentBatch, align_batch
from repro_torch.core.engine import AlignmentEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_has_its_modules():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "chip_smoke.py" in names
    for mod in ("core/banded.py", "core/engine.py", "core/interop.py",
                "core/traceback_device.py", "core/backends/cuda.py",
                "kernels/banded_dp/ops.py", "serve/service.py",
                "launch/serve.py"):
        assert f"src/repro_torch/{mod}" in names


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax"), (path, mod)
        assert top != "repro", (path, mod)


def test_kernel_sources_are_in_the_package():
    from repro_torch.kernels import build
    for name, src in build.SOURCES.items():
        assert src.is_file() and src.suffix == ".cu", name
        assert (ROOT / "src" / "repro_torch") in src.parents
    assert build.build_dir().name == "build"


def test_no_card_means_an_error_not_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    assert set(available_backends()) == {"reference", "cuda"}
    assert resolve_backend("reference") == "reference"
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_backend("auto")
    with pytest.raises(RuntimeError):
        get_backend("auto")
    with pytest.raises(RuntimeError):
        AlignmentEngine()                       # defaults: auto, cuda
    with pytest.raises(RuntimeError):
        AlignmentEngine(backend="reference")    # device still "cuda"
    with pytest.raises(ValueError, match="cuda"):
        AlignmentEngine(backend="cuda", device="cpu")
    batch = AlignmentBatch.from_lists([[0, 1, 2, 3]], [[0, 1, 2, 3]])
    with pytest.raises(RuntimeError):
        align_batch(batch)
    with pytest.raises(ValueError):
        get_backend("pallas")
