"""Build and load the port's CUDA kernels.

Each kernel is one ``.cu`` file with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` into a shared library under ``build/`` at the
repository root (``REPRO_TORCH_BUILD_DIR`` overrides the place) and loaded
with ``ctypes``. Nothing is built when this module is imported: a library
is built at the first `load` of its name, or ahead of time — all sources
in parallel — by `build_all`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]

#: name -> source file. One shared library per source; every header
#: (``.cuh``) of the package counts as part of each.
SOURCES = {
    "banded_dp": _PKG / "kernels" / "banded_dp" / "csrc" / "banded_dp.cu",
    "traceback": _PKG / "core" / "csrc" / "traceback.cu",
    "persistent": _PKG / "kernels" / "banded_dp" / "csrc" / "persistent.cu",
    "chain": _PKG / "map" / "csrc" / "chain.cu",
    "local_attention": _PKG / "kernels" / "local_attention" / "csrc"
    / "local_attention.cu",
    "flash_tc": _PKG / "kernels" / "local_attention" / "csrc"
    / "flash_tc.cu",
    "flash_tc_bwd": _PKG / "kernels" / "local_attention" / "csrc"
    / "flash_tc_bwd.cu",
    "flash_tf32x3": _PKG / "kernels" / "local_attention" / "csrc"
    / "flash_tf32x3.cu",
    "flash_tf32x3_bwd": _PKG / "kernels" / "local_attention" / "csrc"
    / "flash_tf32x3_bwd.cu",
    "rglru_scan": _PKG / "models" / "csrc" / "rglru_scan.cu",
    "rglru_scan_bwd": _PKG / "models" / "csrc" / "rglru_scan_bwd.cu",
    "mlstm_chunk": _PKG / "models" / "csrc" / "mlstm_chunk.cu",
    "mlstm_chunk_bwd": _PKG / "models" / "csrc" / "mlstm_chunk_bwd.cu",
    "slstm": _PKG / "models" / "csrc" / "slstm.cu",
    "slstm_bwd": _PKG / "models" / "csrc" / "slstm_bwd.cu",
    "slstm_probe": _PKG / "models" / "csrc" / "slstm_probe.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
# Dispatcher threads of several services (a router's replicas) may reach a
# kernel's first `load` together.
_LOAD_LOCK = threading.Lock()
# The same threads bump the wrappers' launch counters.
_COUNT_LOCK = threading.Lock()

#: The dry run's active counter (`launch.dryrun.StepCounter`) or None.
#: While one is active every kernel wrapper hands it each call's work
#: (`kernels.work`), whether the call launched on CUDA tensors or was
#: traced on meta ones; with none, a launch pays one test of this name.
WORK = None


def kernel_side(t) -> bool:
    """Whether `t` takes a kernel's route rather than its plain version:
    on a CUDA tensor the wrapper launches the kernel; on a "meta" tensor
    (the dry run's abstract trees) it allocates what the launch would
    allocate, launches nothing and counts no launch."""
    return t.is_cuda or t.is_meta


def count(fn, attr: str = "launches", **keyed) -> None:
    """Add one to the counter `fn.<attr>` (a wrapper's ``launches``, a
    plain version's ``calls``) and, for each ``name=key``, to
    ``fn.<name>[key]`` (a `collections.Counter`), under one lock: the
    dispatcher threads of several services launch at once."""
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + 1)
        for name, key in keyed.items():
            getattr(fn, name)[key] += 1


def records_grad(*tensors) -> bool:
    """Whether autograd would record an operation on `tensors`: grad mode
    is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise RuntimeError if autograd would record a call of the kernel
    wrapper `name`: grad mode is on and one of `tensors` requires grad.
    The wrappers that call it have no backward: B5's FMA kernel (on no
    route) and B7's three pass kernels launched on their own (the whole of
    B7, B8, B6 and B5's two routes go through their autograd Functions
    instead). Their outputs would silently carry no gradient to their
    inputs."""
    if records_grad(*tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but this kernel has no "
            f"backward yet; call it under torch.no_grad()")


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else _PKG.parents[1] / "build"


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if not cand.exists():
            raise RuntimeError(
                "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the "
                "CUDA kernels cannot be built on this machine")
        exe = str(cand)
    return exe


def lib_path(name: str) -> Path:
    return build_dir() / f"librepro_torch_{name}.so"


def _stale(name: str) -> bool:
    lib = lib_path(name)
    newest = max(p.stat().st_mtime
                 for p in (SOURCES[name], *_PKG.rglob("*.cuh")))
    return not lib.exists() or lib.stat().st_mtime < newest


def _start(name: str, extra=()) -> tuple[subprocess.Popen, Path]:
    """Start one `nvcc` run; it writes to a temporary name that
    `_finish` moves into place, so a half-written library is never
    loaded."""
    nvcc = _nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    tmp = lib_path(name).with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp), str(SOURCES[name])]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish(name: str, proc: subprocess.Popen, tmp: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
    os.replace(tmp, lib_path(name))
    return log


def build_all() -> dict:
    """Compile every stale kernel source, all `nvcc` runs started
    together, with ``-Xptxas -v``. Returns {'seconds': wall time, 'built':
    [names], 'logs': {name: nvcc output — registers, shared memory and
    spills per kernel}}."""
    t0 = time.perf_counter()
    started = {name: _start(name, ("-Xptxas", "-v"))
               for name in SOURCES if _stale(name)}
    logs = {name: _finish(name, *run) for name, run in started.items()}
    return {"seconds": time.perf_counter() - t0, "built": list(started),
            "logs": logs}


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel `name`, built first if its
    source is newer than the library (or the library is missing)."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                if _stale(name):
                    _finish(name, *_start(name))
                lib = ctypes.CDLL(str(lib_path(name)))
                _LIBS[name] = lib
    return lib
