"""Fault-tolerant checkpointing: atomic, async, placing restore. The port
of the JAX package's `checkpoint/checkpoint.py`, with its layout on disk.

  * atomic visibility — writes go to `step_XXXXXXXX.tmp/` then
    `os.replace` to `step_XXXXXXXX/`; a reader never sees a partial
    checkpoint, so a preemption mid-write costs one step of progress,
    never corruption;
  * async — the serialisation happens on a background thread off the
    training loop's critical path (`CheckpointManager.save(...,
    blocking=False)`); the manager joins the writer before the next save;
  * placing restore — arrays are stored whole; `restore` puts each leaf
    on its template leaf's device and dtype, or on the device a matching
    `shardings` tree names (the elastic-remesh path);
  * self-describing — each step directory holds `arrays.npz`, keyed by
    the leaves' '/'-joined paths, and `meta.json`; a template mismatch
    fails loudly with the offending paths.

Interchange with the JAX package: a checkpoint of a tree of f32 / int
leaves written by either package restores in the other. A bf16 leaf is
stored here as its uint16 bits, its dtype recorded under "dtypes" in
`meta.json`, and restores bit-exact; numpy has no bfloat16 of its own, so
a JAX checkpoint with bf16 leaves (written through `ml_dtypes`) need not
load in the port.

A restore reads the members of `arrays.npz` in parallel threads, each
in one read straight into its array, its CRC checked (`np.load` reads a
member in 256 KiB pieces through `zipfile` and copies each; the file
reads and `zlib.crc32` release the GIL).

The snapshot copies: the port's AdamW updates parameters, moments and
step in place, and on the CPU `Tensor.numpy()` aliases the live tensor,
so `CheckpointManager.save` takes a copy of every leaf before its writer
thread starts.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import struct
import threading
import time
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.models.model import tree_leaves_with_path, tree_map_with_path

_MANIFEST = "manifest.json"


def _name(path) -> str:
    return "/".join(path)


def _to_numpy(leaf, *, copy: bool):
    """A tensor leaf as a numpy array (bf16 as its uint16 bits), copied
    off the tensor when `copy` (or when it is not on the CPU)."""
    t = leaf.detach()
    if t.device.type != "cpu" or copy:
        t = t.to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _snapshot(tree, *, copy: bool):
    """({path: numpy array}, {path: "bfloat16"} for the bf16 leaves)."""
    arrays, dtypes = {}, {}
    for path, leaf in tree_leaves_with_path(tree):
        arrays[_name(path)] = _to_numpy(leaf, copy=copy)
        if leaf.dtype == torch.bfloat16:
            dtypes[_name(path)] = "bfloat16"
    return arrays, dtypes


def _write(ckpt_dir: str, step: int, arrays: dict, dtypes: dict,
           metadata: dict | None):
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {"step": step, "time": time.time(), "num_arrays": len(arrays),
            **({"dtypes": dtypes} if dtypes else {}), **(metadata or {})}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _update_manifest(ckpt_dir)
    return final


def save(ckpt_dir: str, step: int, tree, *, metadata: dict | None = None):
    """Write one atomic checkpoint for `step` (synchronously)."""
    arrays, dtypes = _snapshot(tree, copy=False)
    return _write(ckpt_dir, step, arrays, dtypes, metadata)


def _update_manifest(ckpt_dir: str):
    steps = latest_step(ckpt_dir, all_steps=True)
    with open(os.path.join(ckpt_dir, _MANIFEST), "w") as f:
        json.dump({"steps": steps}, f)


def latest_step(ckpt_dir: str, all_steps: bool = False):
    if not os.path.isdir(ckpt_dir):
        return [] if all_steps else None
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    if all_steps:
        return steps
    return steps[-1] if steps else None


def _from_numpy(arr, stored_dtype, like, device):
    """A stored array as a tensor in the template leaf `like`'s dtype, on
    `device` or else on `like`'s."""
    arr = np.ascontiguousarray(arr).reshape(arr.shape)  # keeps 0-d leaves
    if stored_dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device if device is None else device,
                dtype=like.dtype)


def _read(ckpt_dir: str, step: int | None):
    """(meta, {path: array}) of the checkpoint of `step`, or the latest."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return meta, _load_npz(os.path.join(path, "arrays.npz"))


_NPY_HEADERS = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}


def _load_member(path: str, info: zipfile.ZipInfo):
    """(key, array) of one stored (uncompressed) `.npy` member of the
    archive at `path`: read whole into a fresh buffer, its CRC checked,
    the array a view of the buffer past the `.npy` header."""
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        n_name, n_extra = struct.unpack("<26xHH", f.read(30))
        f.seek(info.header_offset + 30 + n_name + n_extra)
        buf = np.empty(info.file_size, np.uint8)
        if f.readinto(memoryview(buf)) != info.file_size:
            raise ValueError(f"{path}: {info.filename} is truncated")
    if zlib.crc32(buf) != info.CRC:
        raise ValueError(f"{path}: {info.filename} fails its CRC check")
    start = 10 if buf[6] == 1 else 12   # magic, version, header length
    end = start + int.from_bytes(buf[8:start].tobytes(), "little")
    fp = io.BytesIO(buf[:end].tobytes())
    shape, fortran, dtype = _NPY_HEADERS[np.lib.format.read_magic(fp)](fp)
    arr = buf[end:].view(dtype)
    arr = arr.reshape(shape[::-1]).T if fortran else arr.reshape(shape)
    return info.filename.removesuffix(".npy"), arr


def _load_npz(path: str) -> dict:
    """{key: array} of an `np.savez` archive (both packages write its
    members stored, uncompressed), the members read in parallel."""
    with zipfile.ZipFile(path) as zf:
        infos = zf.infolist()
    packed = [i.filename for i in infos
              if i.compress_type != zipfile.ZIP_STORED]
    if packed:
        raise ValueError(f"{path}: compressed members {packed}; a "
                         "checkpoint's arrays are written by np.savez")
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return dict(pool.map(lambda i: _load_member(path, i), infos))


def _place(meta, arrays, template, shardings):
    names = {_name(p) for p, _ in tree_leaves_with_path(template)}
    missing = sorted(names - set(arrays))
    extra = sorted(set(arrays) - names)
    if missing or extra:
        raise ValueError(f"checkpoint/template mismatch: missing={missing} "
                         f"extra={extra}")
    stored = meta.get("dtypes", {})
    devices = ({} if shardings is None else
               {_name(p): d for p, d in tree_leaves_with_path(shardings)})
    return tree_map_with_path(
        lambda p, like: _from_numpy(arrays[_name(p)], stored.get(_name(p)),
                                    like, devices.get(_name(p))),
        template)


def restore(ckpt_dir: str, template, *, step: int | None = None,
            shardings=None):
    """Restore into `template`'s structure: each leaf on its template
    leaf's device and dtype, or on the `torch.device` of the matching
    leaf of `shardings` — the elastic-remesh path. Returns (tree,
    meta)."""
    meta, arrays = _read(ckpt_dir, step)
    return _place(meta, arrays, template, shardings), meta


class CheckpointManager:
    """Async checkpoint writer with retention.

    save() snapshots to host memory synchronously (a copy of every leaf)
    and serialises on a background thread; wait() joins and raises what
    the writer raised. keep_last bounds disk usage. `events` records the
    seconds of each save (snapshot and write apart) and restore (the
    npz read and the placement apart).
    """

    def __init__(self, ckpt_dir: str, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self.events: list[dict] = []
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, tree, *, metadata=None, blocking=False):
        self.wait()
        t0 = time.perf_counter()
        arrays, dtypes = _snapshot(tree, copy=True)   # snapshot now
        event = {"op": "save", "step": step,
                 "snapshot_s": time.perf_counter() - t0}
        self.events.append(event)

        def work():
            t1 = time.perf_counter()
            try:
                _write(self.ckpt_dir, step, arrays, dtypes, metadata)
                self._gc()
            except Exception as e:  # surfaced on next wait()
                self._error = e
            event["write_s"] = time.perf_counter() - t1

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = latest_step(self.ckpt_dir, all_steps=True)
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)
        _update_manifest(self.ckpt_dir)

    def restore_latest(self, template, shardings=None):
        self.wait()
        t0 = time.perf_counter()
        meta, arrays = _read(self.ckpt_dir, None)
        t1 = time.perf_counter()
        tree = _place(meta, arrays, template, shardings)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        self.events.append({"op": "restore", "step": int(meta["step"]),
                            "seconds": t2 - t0, "read_s": t1 - t0,
                            "place_s": t2 - t1})
        return tree, meta
