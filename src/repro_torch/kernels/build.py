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
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]

#: name -> source file. One shared library per source.
SOURCES = {
    "banded_dp": _PKG / "kernels" / "banded_dp" / "csrc" / "banded_dp.cu",
    "traceback": _PKG / "core" / "csrc" / "traceback.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}


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


def _lib_path(name: str) -> Path:
    return build_dir() / f"librepro_torch_{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    return (not lib.exists()
            or lib.stat().st_mtime < SOURCES[name].stat().st_mtime)


def _start(name: str, extra=()) -> tuple[subprocess.Popen, Path]:
    """Start one `nvcc` run; it writes to a temporary name that
    `_finish` moves into place, so a half-written library is never
    loaded."""
    nvcc = _nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp), str(SOURCES[name])]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish(name: str, proc: subprocess.Popen, tmp: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
    os.replace(tmp, _lib_path(name))
    return log


def build_all(verbose: bool = False) -> dict:
    """Compile every stale kernel source, all `nvcc` runs started
    together. Returns {'seconds': wall time, 'built': [names], 'log': str}
    (`verbose` adds ``-Xptxas -v``: registers and shared memory per
    kernel in the log)."""
    t0 = time.perf_counter()
    extra = ("-Xptxas", "-v") if verbose else ()
    started = {name: _start(name, extra) for name in SOURCES if _stale(name)}
    logs = [_finish(name, *run) for name, run in started.items()]
    return {"seconds": time.perf_counter() - t0, "built": list(started),
            "log": "\n".join(logs)}


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel `name`, built first if its
    source is newer than the library (or the library is missing)."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            _finish(name, *_start(name))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib
