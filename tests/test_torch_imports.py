"""Guards of the port's boundaries: `src/repro_torch/` and
`chip_smoke.py` import neither jax nor the JAX package, and the port's
entry points never carry on on the CPU unasked."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core.backends import (available_backends, get_backend,
                                       resolve_backend)
from repro_torch.core.batch import AlignmentBatch, align_batch
from repro_torch.core.engine import AlignmentEngine
from repro_torch.launch import map as map_launcher
from repro_torch.configs import get_config
from repro_torch.kernels.local_attention.local_attention import (
    flash_attention_cuda)
from repro_torch.map import chain_batch
from repro_torch.models import LanguageModel, init_cache, init_params

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
                "kernels/banded_dp/ops.py", "kernels/banded_dp/persistent.py",
                "map/__init__.py", "map/index.py", "map/chain.py",
                "map/mapper.py", "serve/service.py", "serve/router.py",
                "core/edit_distance.py", "core/diff_dp.py", "launch/serve.py",
                "launch/map.py", "configs/base.py", "configs/archs.py",
                "data/tokens.py", "models/layers.py", "models/attention.py",
                "models/blocks.py", "models/model.py", "models/interop.py",
                "kernels/local_attention/ops.py",
                "kernels/local_attention/local_attention.py",
                "kernels/local_attention/ref.py", "train/train_step.py",
                "core/pim_model.py", "core/distributed.py",
                "launch/mesh.py", "roofline/__init__.py",
                "roofline/analysis.py", "roofline/analytic.py",
                "models/moe.py", "models/rglru.py", "models/xlstm.py",
                "launch/specs.py", "launch/train.py", "sharding/__init__.py",
                "sharding/rules.py", "checkpoint/__init__.py",
                "checkpoint/checkpoint.py", "runtime/__init__.py",
                "runtime/elastic.py", "runtime/recovery.py",
                "runtime/straggler.py"):
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
    with pytest.raises(RuntimeError):
        AlignmentEngine(dispatch="persistent")
    with pytest.raises(RuntimeError):
        AlignmentEngine(backend="reference", dispatch="persistent")
    with pytest.raises(RuntimeError):
        chain_batch([(np.arange(3), np.arange(3))])   # default: the card
    with pytest.raises(RuntimeError, match="is_available"):
        map_launcher.main(["--reads", "2", "--genome", "5000"])


def test_no_card_means_an_error_for_the_lm_path():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    cfg = get_config("gemma3-27b").reduced()
    with pytest.raises(RuntimeError, match="is_available"):
        init_params(cfg, 0)                         # default: the card
    with pytest.raises(RuntimeError, match="is_available"):
        init_params(cfg, 0, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="is_available"):
        LanguageModel.create(cfg, 0)
    q = torch.zeros(1, 2, 64, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, q, q)               # the kernel: no CPU run
