"""Persistent dispatch: every dispatch group of a request in one launch.

The CUDA kernel (`csrc/persistent.cu`) replaces the TPU kernel
`_persistent_kernel` of the JAX package's `kernels/banded_dp/persistent.py`;
its design note is at the top of the ``.cu`` source. Where the TPU kernel
stacks the groups into one uniform layout padded to the widest group, the
port describes a request by a **work table**: flat ragged buffers and one
table row per pair giving its output row, its q / r offsets and padded
lengths, its group's band and sweep length, and where its
``(T, ceil(B/2))`` flag plane and ``(T + 1,)`` band offsets go. All of it
is run-time data, so a new request geometry builds nothing.

Results are in **merged row order**: group after group, each group's
padded rows in order (the `run_persistent` layout of `core.backends`).
The table itself is sorted longest live sweep first, which is the order
the kernel starts its blocks in.

The kernel has two bodies, picked for the whole request by the per-group
kernel's rule (`kernel_body`) on its widest band: one warp per table row
(B1's warp body, band state in registers) when the widest band is at most
`WARP_MAX_BAND`, one block per row above. ``block_body=True`` is a measurement switch that runs the block
body at any band; no main path sets it. Launches are counted by body in
``persistent_align_cuda.bodies``.

`persistent_align_cuda` is the wrapper (CUDA tensors, launches the kernel
or raises); `persistent_align_plain` is its plain version, which runs
each group through `core.banded.banded_align_batch` with that group's
band and sweep length; `persistent_align` picks one by the tensors'
device.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.core.banded import banded_align_batch, packed_tb_width
from repro_torch.core.scoring import ScoringConfig
from repro_torch.kernels import build
from repro_torch.kernels.banded_dp.banded_dp import (MAX_SWEEP, STAT_KEYS,
                                                     kernel_body)

#: Columns of the int64 work table, in order (`enum Col` of the sources).
TABLE_COLS = ("row", "q_off", "r_off", "q_len", "r_len", "band", "steps",
              "tb_off", "los_off")
_COL = {name: i for i, name in enumerate(TABLE_COLS)}

_P, _I = ctypes.c_void_p, ctypes.c_int


@dataclasses.dataclass(frozen=True)
class GroupSpan:
    """Where one dispatch group lies in the flat buffers."""
    rows: int
    q_len: int
    r_len: int
    band: int
    steps: int       # the group's sweep length T_g
    row0: int        # first merged row
    q0: int          # first byte of its queries
    r0: int
    tb0: int         # first byte of its flag planes
    los0: int        # first word of its band offsets

    @property
    def tb_width(self) -> int:
        return packed_tb_width(self.band)


@dataclasses.dataclass(frozen=True)
class WorkTable:
    """A persistent request: its groups and the per-row work table."""
    spans: tuple            # GroupSpan per group, in merged order
    rows: torch.Tensor      # (R, len(TABLE_COLS)) int64, longest first

    @property
    def num_rows(self) -> int:
        return sum(s.rows for s in self.spans)

    @property
    def band_max(self) -> int:
        return max(s.band for s in self.spans)

    @property
    def steps_max(self) -> int:
        """Width of the merged RLE planes: the longest group sweep."""
        return max(s.steps for s in self.spans)

    @property
    def tb_bytes(self) -> int:
        return sum(s.rows * s.steps * s.tb_width for s in self.spans)

    @property
    def los_words(self) -> int:
        return sum(s.rows * (s.steps + 1) for s in self.spans)

    def to(self, device) -> "WorkTable":
        from repro_torch.core.batch import upload
        return dataclasses.replace(
            self, rows=upload(self.rows.numpy(), torch.device(device)))


def pack_groups(groups):
    """Flatten per-group padded arrays into one persistent request.

    `groups` is a sequence of (q_pad, r_pad, n, m, band, t_max) — host
    arrays, one entry per dispatch group (t_max None = the full padded
    sweep). Returns (WorkTable with a CPU table, (q, r, n, m)) where q / r
    are the flat int8 concatenations of the padded rows and n / m the
    (R,) int32 lengths in merged order.
    """
    if not len(groups):
        raise ValueError("a persistent request needs at least one group")
    spans, qs, rs, ns, ms = [], [], [], [], []
    row0 = q0 = r0 = tb0 = los0 = 0
    for q_pad, r_pad, n, m, band, t_max in groups:
        q_pad = np.asarray(q_pad, np.int8)
        r_pad = np.asarray(r_pad, np.int8)
        rows, q_len = q_pad.shape
        r_len = r_pad.shape[1]
        steps = int(t_max) if t_max is not None else q_len + r_len
        span = GroupSpan(rows=rows, q_len=q_len, r_len=r_len,
                         band=int(band), steps=steps, row0=row0, q0=q0,
                         r0=r0, tb0=tb0, los0=los0)
        spans.append(span)
        qs.append(q_pad.ravel())
        rs.append(r_pad.ravel())
        ns.append(np.asarray(n, np.int32).reshape(rows))
        ms.append(np.asarray(m, np.int32).reshape(rows))
        row0 += rows
        q0 += rows * q_len
        r0 += rows * r_len
        tb0 += rows * steps * span.tb_width
        los0 += rows * (steps + 1)
    n, m = np.concatenate(ns), np.concatenate(ms)
    table = np.empty((row0, len(TABLE_COLS)), np.int64)
    for s in spans:
        k = np.arange(s.rows, dtype=np.int64)
        t = table[s.row0:s.row0 + s.rows]
        t[:, _COL["row"]] = s.row0 + k
        t[:, _COL["q_off"]] = s.q0 + k * s.q_len
        t[:, _COL["r_off"]] = s.r0 + k * s.r_len
        t[:, _COL["q_len"]] = s.q_len
        t[:, _COL["r_len"]] = s.r_len
        t[:, _COL["band"]] = s.band
        t[:, _COL["steps"]] = s.steps
        t[:, _COL["tb_off"]] = s.tb0 + k * s.steps * s.tb_width
        t[:, _COL["los_off"]] = s.los0 + k * (s.steps + 1)
    live = np.minimum(n.astype(np.int64) + m, table[:, _COL["steps"]])
    table = table[np.argsort(-live, kind="stable")]
    return (WorkTable(spans=tuple(spans), rows=torch.from_numpy(table)),
            (np.concatenate(qs), np.concatenate(rs), n, m))


def group_rows(flat, span: GroupSpan, start: int, per_row: int,
               *shape) -> torch.Tensor:
    """View of one group's rows in a flat buffer: `span.rows` rows of
    `per_row` elements from `start`, shaped (rows, *shape)."""
    return flat[start:start + span.rows * per_row].view(span.rows, *shape)


def persistent_align_plain(table: WorkTable, q, r, n, m, *,
                           sc: ScoringConfig, adaptive: bool = True,
                           collect_tb: bool = True, mode: str = "global",
                           cell_dtype: str = "int32",
                           xdrop: int | None = None):
    """Plain PyTorch version of the persistent kernel: each group through
    `banded_align_batch` with its own band and sweep length, on the
    tensors' device. Same arguments and results as
    `persistent_align_cuda`."""
    outs = []
    for s in table.spans:
        rows = slice(s.row0, s.row0 + s.rows)
        outs.append(banded_align_batch(
            group_rows(q, s, s.q0, s.q_len, s.q_len),
            group_rows(r, s, s.r0, s.r_len, s.r_len), n[rows], m[rows],
            sc=sc, band=s.band, adaptive=adaptive, collect_tb=collect_tb,
            mode=mode, t_max=s.steps, cell_dtype=cell_dtype, xdrop=xdrop))
    out = {key: torch.cat([o[key] for o in outs]) for key in STAT_KEYS}
    if collect_tb:
        out["tb"] = torch.cat([o["tb"].reshape(-1) for o in outs])
        out["los"] = torch.cat([o["los"].reshape(-1) for o in outs])
    return out


def _lib():
    lib = build.load("persistent")
    fn = lib.persistent_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 11 + [_P]
        fn.restype = _I
        if lib.persistent_table_cols() != len(TABLE_COLS):
            raise RuntimeError("persistent.cu and TABLE_COLS disagree on "
                               "the work table's columns")
    return lib


def persistent_align_cuda(table: WorkTable, q, r, n, m, *,
                          sc: ScoringConfig, adaptive: bool = True,
                          collect_tb: bool = True, mode: str = "global",
                          cell_dtype: str = "int32",
                          xdrop: int | None = None,
                          block_body: bool = False):
    """Run the persistent kernel on CUDA tensors: one launch for every row
    of `table` (on the same device), queued on the current stream, not
    synchronised.

    Args:
      q, r: flat int8 query / reference buffers (`pack_groups`).
      n, m: (R,) int32 true lengths in merged row order.
      sc, adaptive, mode, xdrop: as `banded_align_batch`;
        ``cell_dtype="narrow"`` runs on the kernel's int32 path.
      block_body: a measurement switch: run the block body at any band,
        so that both bodies can be timed on the same table. The main
        paths never set it.

    Returns a dict of (R,) int32 'score', 'final_lo', 'best_score',
    'best_i', 'best_j', 'status' in merged row order and, when
    collect_tb, 'tb' (flat uint8: each row's (T_g, ceil(B_g/2)) plane at
    its table offset) and 'los' (flat int32: each row's (T_g + 1,) band
    offsets). Equal to `persistent_align_plain` bit for bit.
    """
    if not (isinstance(q, torch.Tensor) and q.is_cuda):
        raise ValueError("persistent_align_cuda takes CUDA tensors; the "
                         "plain version persistent_align_plain runs "
                         "anywhere")
    if mode not in ("global", "semiglobal"):
        raise ValueError(f"unknown mode {mode!r}")
    if cell_dtype not in ("int32", "narrow"):
        raise ValueError(f"unknown cell_dtype {cell_dtype!r}")
    if xdrop is not None and int(xdrop) < 0:
        raise ValueError("xdrop must be non-negative or None")
    dev = q.device
    R = table.num_rows
    rows = table.rows
    if rows.device != dev or rows.dtype != torch.int64 \
            or tuple(rows.shape) != (R, len(TABLE_COLS)) \
            or not rows.is_contiguous():
        raise ValueError("the work table must be a contiguous "
                         f"({R}, {len(TABLE_COLS)}) int64 tensor on {dev}")
    for s in table.spans:
        kernel_body(s.band)
        if not 0 <= s.steps <= MAX_SWEEP or s.q_len < 1 or s.r_len < 1:
            raise ValueError(f"group geometry {s} outside the kernel's "
                             "range")
    q_bytes = sum(s.rows * s.q_len for s in table.spans)
    r_bytes = sum(s.rows * s.r_len for s in table.spans)
    for name, t, size, dtype in (("q", q, q_bytes, torch.int8),
                                 ("r", r, r_bytes, torch.int8),
                                 ("n", n, R, torch.int32),
                                 ("m", m, R, torch.int32)):
        if t.device != dev or t.dtype != dtype or t.dim() != 1 \
                or t.numel() != size or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({size},) "
                             f"{dtype} tensor on {dev}")

    stats = torch.empty((len(STAT_KEYS), R), dtype=torch.int32, device=dev)
    tb = los = None
    if collect_tb:
        tb = torch.empty(table.tb_bytes, dtype=torch.uint8, device=dev)
        los = torch.empty(table.los_words, dtype=torch.int32, device=dev)
    if R:
        lib = _lib()
        with torch.cuda.device(dev):
            err = lib.persistent_launch(
                rows.data_ptr(), q.data_ptr(), r.data_ptr(), n.data_ptr(),
                m.data_ptr(), stats.data_ptr(),
                tb.data_ptr() if collect_tb else None,
                los.data_ptr() if collect_tb else None,
                R, table.band_max, sc.match, sc.mismatch, sc.gap_open,
                sc.gap_extend, -1 if xdrop is None else int(xdrop),
                int(mode == "semiglobal"), int(bool(adaptive)),
                int(bool(collect_tb)), int(bool(block_body)),
                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"persistent kernel launch failed: CUDA "
                               f"error {err}")
        build.count(persistent_align_cuda, shapes=(table.steps_max, R),
                    bodies=kernel_body(table.band_max, block_body))
    out = {key: stats[i] for i, key in enumerate(STAT_KEYS)}
    if collect_tb:
        out["tb"] = tb
        out["los"] = los
    return out


#: Kernel launches since the count was last set to 0, and the same launches
#: by (longest sweep, table rows) and by body ("warp" / "block").
persistent_align_cuda.launches = 0
persistent_align_cuda.shapes = collections.Counter()
persistent_align_cuda.bodies = collections.Counter()


def persistent_align(table: WorkTable, q, r, n, m, **kw):
    """The persistent wavefront where the tensors live: CPU tensors take
    `persistent_align_plain`, CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return persistent_align_plain(table, q, r, n, m, **kw)
    return persistent_align_cuda(table, q, r, n, m, **kw)
