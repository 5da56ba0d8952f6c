"""The staged traceback walker (`src/repro_torch/core/csrc/traceback.cu`)
emulated in numpy on the CPU: its window schedule (rows per window from
the band, the refill points, the two buffers), its segment ring and the
final assembly of the RLE row, step for step as the kernel does them.

The emulation raises if a step reads a band offset or a flag row outside
the window staged for it, or if the window in a buffer is not the one the
schedule put there; its CIGAR arrays must equal the port's plain walker
(`decode_packed_tb_plain`) and the JAX package's `decode_packed_tb`,
tolerance 0. The kernel itself is held against the plain walker on the
card by `chip_smoke.py`; here the CUDA wrappers refuse CPU tensors."""

import numpy as np
import pytest
import torch

from repro.core import traceback_device as jtbd
from repro_torch.core import banded as tbanded
from repro_torch.core import traceback_device as ttbd
from repro_torch.kernels.banded_dp.persistent import pack_groups
from repro_torch.kernels.banded_dp.persistent import persistent_align_plain
from torch_parity import TORCH_SC, make_pairs, pad_pairs

#: Segments the kernel's ring holds (`SEGS` of the source).
SEGS = 256
#: Dynamic shared memory one block may have on an H100.
SMEM_PER_BLOCK = 232448
RLE_KEYS = ("cig_ops", "cig_runs", "cig_len")


class WindowMiss(AssertionError):
    pass


def _clamp(v, lo, hi):
    return lo if v < lo else (hi if v > hi else v)


def _next_span(lo, W):
    hi = lo + 1
    return max(hi - W + 1, 0), hi


def staged_walk(tb, los, band, i, j, K, *, W=None, segs=SEGS, events=None):
    """One pair through the kernel's staged walk.

    tb (T, Bp) uint8 and los (T + 1,) int32 are the pair's plane; (i, j)
    the start cell; K the RLE row width. `W` overrides the window rows
    (default `window_rows(band, T)`) and `segs` the ring size, so that
    small inputs cross windows and flush the ring. `events` collects
    (t before, t after, window lo) of every step that left a window.
    Returns (ops (K,) uint8, runs (K,) int32, nseg)."""
    T, Bp = tb.shape
    # The RLE row starts as garbage: every column must be written.
    ops = np.full(K, 0xEE, np.uint8)
    runs = np.full(K, -7, np.int64)
    ring = []
    flushed = 0
    t0 = i + j
    if t0 > 0 and T > 0:
        W = ttbd.window_rows(band, T) if W is None else min(W, T)
        assert W >= 4 or W == T
        hi = _clamp(t0 - 1, 0, T - 1)
        lo = max(hi - W + 1, 0)

        def staged(span):
            s_lo, s_hi = span
            assert s_hi - s_lo + 1 <= W
            return {"span": span, "tb": tb[s_lo:s_hi + 1].copy(),
                    "los": los[s_lo:s_hi + 2].copy()}

        bufs = [staged((lo, hi)), staged(_next_span(lo, W)) if lo else None]
        b = 0
        st = cur_op = cur_run = step = 0

        def lookup(win, ii, jj):
            s_lo, s_hi = win["span"]
            t = ii + jj
            li = _clamp(t, 0, T)
            ri = _clamp(t - 1, 0, T - 1)
            if not (s_lo <= li <= s_hi + 1 and s_lo <= ri <= s_hi):
                raise WindowMiss(f"step at t={t} reads los[{li}], row {ri} "
                                 f"outside the window [{s_lo}, {s_hi}]")
            k = ii - int(win["los"][li - s_lo])
            ok = t >= 1 and 0 <= k < band
            kc = _clamp(k, 0, band - 1)
            byte = int(win["tb"][ri - s_lo, kc >> 1])
            return (byte >> ((kc & 1) * 4)) & 0xF, ok

        while True:
            win = bufs[b]
            assert win["span"][0] == lo, (win["span"], lo)
            # Lane 0's walk until a window edge, a full ring or the end.
            while True:
                if not (step < T and (i > 0 or j > 0)):
                    if cur_op and len(ring) == segs:
                        why = "flush"
                        break
                    if cur_op:
                        ring.append((cur_op, cur_run))
                        cur_op = 0
                    why = "done"
                    break
                if _clamp(i + j - 2, 0, T - 1) < lo:
                    why = "window"
                    break
                if len(ring) == segs:
                    why = "flush"
                    break
                t_before = i + j
                c, in_band = lookup(win, i, j)
                cu, up_ok = lookup(win, i - 1, j)
                cl, left_ok = lookup(win, i, j - 1)
                d = c & 3
                b_del = i == 0
                b_ins = i > 0 and j == 0
                interior = i > 0 and j > 0
                esc = interior and not in_band
                core = interior and in_band
                diag = core and st == 0 and d == 0
                ins = core and (st == 1 or (st == 0 and d == 1))
                dele = core and (st == 2 or (st == 0 and d >= 2))
                ext_e = up_ok and i - 1 >= 1 and j >= 1 and bool(cu & 4)
                ext_f = left_ok and j - 1 >= 1 and i >= 1 and bool(cl & 8)
                emit = (tbanded._OP_I if (b_ins or ins) else
                        tbanded._OP_D if (b_del or dele) else
                        tbanded._OP_M if (diag or esc) else 0)
                if diag or esc or b_ins or ins:
                    i -= 1
                if diag or esc or b_del or dele:
                    j -= 1
                if ins:
                    st = 1 if ext_e else 0
                elif dele:
                    st = 2 if ext_f else 0
                step += 1
                if emit == cur_op:
                    cur_run += 1
                else:
                    if cur_op:
                        ring.append((cur_op, cur_run))
                    cur_op, cur_run = emit, 1
                if events is not None and lo and \
                        _clamp(i + j - 2, 0, T - 1) < lo:
                    events.append((t_before, i + j, lo))
            if why == "done":
                break
            if why == "flush":
                for s, (o, r) in enumerate(ring):
                    ops[K - 1 - flushed - s] = o
                    runs[K - 1 - flushed - s] = r
                flushed += len(ring)
                ring = []
                continue
            # The next window is in the other buffer; its successor goes
            # into the buffer just left.
            lo = _next_span(lo, W)[0]
            b ^= 1
            bufs[b ^ 1] = staged(_next_span(lo, W)) if lo else None
    nring = len(ring)
    nseg = flushed + nring
    shift = K - nseg
    if shift > 0:
        # The warp's move, 32 columns at a time, reads before writes.
        for p0 in range(nseg - flushed, nseg, 32):
            ps = [p for p in range(p0, p0 + 32) if p < nseg]
            vals = [(ops[p + shift], runs[p + shift]) for p in ps]
            for p, (o, r) in zip(ps, vals):
                ops[p], runs[p] = o, r
    for p in range(nring):
        ops[p], runs[p] = ring[nring - 1 - p]
    ops[nseg:] = 0
    runs[nseg:] = 0
    return ops, runs.astype(np.int32), nseg


def _planes(seed, lengths, band, mode="global", xdrop=None, t_max=None,
            unrelated=()):
    reads, refs = make_pairs(seed, lengths, unrelated)
    L = max(len(x) for x in reads + refs)
    q, r, n, m = pad_pairs(reads, refs, L, L)
    if t_max == "trim":
        t_max = int((n + m).max()) + 3
    out = tbanded.banded_align_batch(q, r, n, m, sc=TORCH_SC, band=band,
                                     mode=mode, collect_tb=True, t_max=t_max,
                                     xdrop=xdrop)
    si, sj = ttbd._start_cells(out, n, m, mode)
    return out["tb"], out["los"], si, sj


def _emulate_all(tb, los, si, sj, band, **kw):
    N, T, _ = tb.shape
    res = [staged_walk(tb[p].numpy(), los[p].numpy(), band, int(si[p]),
                       int(sj[p]), T, **kw) for p in range(N)]
    return (np.stack([r[0] for r in res]), np.stack([r[1] for r in res]),
            np.asarray([r[2] for r in res], np.int32))


def _assert_walks_equal(tb, los, si, sj, band, jax_too=True, **kw):
    emu = _emulate_all(tb, los, si, sj, band, **kw)
    plain = [x.numpy() for x in ttbd.decode_packed_tb_plain(
        tb, los, si, sj, band=band)]
    for a, b, key in zip(emu, plain, RLE_KEYS):
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    if jax_too:
        ref = jtbd.decode_packed_tb(tb.numpy(), los.numpy(), si.numpy(),
                                    sj.numpy(), band=band)
        for a, b, key in zip(emu, ref, RLE_KEYS):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=key)
    return emu


#: Small planes at bands from 1 to 1024; with the kernel's
#: own window rule the wide bands already take several windows (band 1024:
#: 32 rows, 400: 64), the narrow ones one.
@pytest.mark.parametrize("band,lengths", [
    (1, (30, 31, 1)), (2, (40, 38, 25)), (20, (60, 45, 70, 1)),
    (60, (80, 75, 33)), (100, (90, 64, 2)), (129, (90, 80, 50)),
    (400, (120, 100)), (1024, (150, 130)),
])
def test_kernel_window_rule_matches_plain_and_jax(band, lengths):
    tb, los, si, sj = _planes(band, lengths, band, t_max="trim")
    T = tb.shape[1]
    assert ttbd.window_rows(band, T) == min(
        max(12800 // ((band + 1) // 2), 32), 1024, T)
    _assert_walks_equal(tb, los, si, sj, band)


@pytest.mark.parametrize("band,W,segs,mode,xdrop,t_max", [
    (20, 4, 3, "global", None, None),
    (21, 5, 1, "global", 12, "trim"),
    (20, 7, 2, "semiglobal", None, "trim"),
    (33, 6, 256, "semiglobal", 12, None),
    (9, 4, 4, "global", None, 40),        # t_max below some n + m
    (64, 9, 5, "global", None, "trim"),
])
def test_small_windows_and_ring_match_plain_and_jax(band, W, segs, mode,
                                                    xdrop, t_max):
    """Windows of a few rows and a ring of a few segments, so that short
    paths cross many windows and flush many times: odd and even bands,
    trimmed and cut sweeps, xdrop-retired pairs, semiglobal start
    cells."""
    tb, los, si, sj = _planes(7 * band + W, (50, 44, 61, 30), band,
                              mode=mode, xdrop=xdrop, t_max=t_max,
                              unrelated=(1,) if xdrop else ())
    if xdrop:
        assert (si == 0).any()            # a retired pair: empty walk
    _assert_walks_equal(tb, los, si, sj, band, W=W, segs=segs)


def test_a_diagonal_step_crosses_a_window_edge():
    """A diagonal move lowers t by 2: from t = lo + 2, the lowest t of a
    window, to lo — past lo + 1. The next window (rows lo + 2 - W ..
    lo + 1) serves it."""
    tb, los, si, sj = _planes(3, (60, 58, 64), 20)
    events = []
    for p in range(tb.shape[0]):
        staged_walk(tb[p].numpy(), los[p].numpy(), 20, int(si[p]),
                    int(sj[p]), tb.shape[1], W=4, events=events)
    assert any(a - b == 2 and b == lo for a, b, lo in events), events
    assert any(a - b == 1 for a, b, _ in events), events


def test_window_schedule_covers_every_band_within_shared_memory():
    """Every band 1..1024 gets a window of at least 4 rows (or the whole
    plane), and four warps' two buffers and rings fit in one block."""
    for band in range(1, 1025):
        Bp = (band + 1) // 2
        for T in (1, 3, 31, 320, 4000, 32768):
            W = ttbd.window_rows(band, T)
            assert W == T or W >= 4
            flags = (W * Bp + 32 + 15) // 16 * 16
            offs = (4 * (W + 1) + 32 + 15) // 16 * 16
            assert 4 * (2 * (flags + offs) + 5 * SEGS) <= SMEM_PER_BLOCK


def test_table_rows_walk_in_their_own_windows():
    """The table entry point: every row of a persistent request walks with
    its own band and sweep, within the launch's window capacities
    (`table_windows`), and the rows merge to the plain table walker's
    (R, K) planes."""
    groups = []
    for seed, lengths, band, t_max in ((1, (40, 52, 36), 20, 128),
                                       (2, (70, 66), 400, None),
                                       (3, (30, 25, 33, 12), 9, 70)):
        reads, refs = make_pairs(seed, lengths)
        L = max(len(x) for x in reads + refs)
        q, r, n, m = pad_pairs(reads, refs, L, L)
        groups.append((q, r, n, m, band, t_max))
    table, arrays = pack_groups(groups)
    q, r, n, m = (torch.from_numpy(a) for a in arrays)
    out = persistent_align_plain(table, q, r, n, m, sc=TORCH_SC)
    si, sj = ttbd._start_cells(out, n, m, "global")
    flag_cap, rows_cap, two = ttbd.table_windows(table)
    assert two                            # band 400 takes 64-row windows
    K = table.steps_max
    ops = np.zeros((table.num_rows, K), np.uint8)
    runs = np.zeros((table.num_rows, K), np.int32)
    lens = np.zeros(table.num_rows, np.int32)
    for s in table.spans:
        W = ttbd.window_rows(s.band, s.steps)
        assert W * s.tb_width <= flag_cap and W <= rows_cap
        for k in range(s.rows):
            row = s.row0 + k
            tb = out["tb"][s.tb0 + k * s.steps * s.tb_width:][
                :s.steps * s.tb_width].view(s.steps, s.tb_width)
            lo = out["los"][s.los0 + k * (s.steps + 1):][:s.steps + 1]
            ops[row], runs[row], lens[row] = staged_walk(
                tb.numpy(), lo.numpy(), s.band, int(si[row]), int(sj[row]),
                K, segs=8)
    ref = ttbd.decode_packed_tb_table_plain(table, out["tb"], out["los"],
                                            si, sj)
    for a, b, key in zip((ops, runs, lens), ref, RLE_KEYS):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=key)


def test_cuda_walkers_refuse_cpu_tensors_and_the_removed_switch():
    """Both CUDA entry points launch only on CUDA tensors: on CPU tensors
    they raise and launch nothing. The dispatching wrapper takes the plain
    walker for CPU tensors. None of the three takes the switch that
    selected the earlier walker design: it was removed with it."""
    tb, los, si, sj = _planes(5, (40, 30), 20)
    groups = [(*pad_pairs(*make_pairs(6, (30, 20)), 40, 40), 20, None)]
    table, arrays = pack_groups(groups)
    q, r, n, m = (torch.from_numpy(a) for a in arrays)
    out = persistent_align_plain(table, q, r, n, m, sc=TORCH_SC)
    calls = [
        (ttbd.decode_packed_tb_cuda,
         lambda **kw: ttbd.decode_packed_tb_cuda(tb, los, si, sj, band=20,
                                                 **kw)),
        (ttbd.decode_packed_tb_table_cuda,
         lambda **kw: ttbd.decode_packed_tb_table_cuda(
             table, out["tb"], out["los"], n, m, **kw))]
    for wrapper, call in calls:
        launches = wrapper.launches
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
        assert wrapper.launches == launches
    plain = ttbd.decode_packed_tb_plain.calls
    ttbd.decode_packed_tb(tb, los, si, sj, band=20)
    assert ttbd.decode_packed_tb_plain.calls == plain + 1
    for call in [c for _, c in calls] + [
            lambda **kw: ttbd.decode_packed_tb(tb, los, si, sj, band=20,
                                               **kw)]:
        with pytest.raises(TypeError):
            call(direct_reads=True)
    assert ttbd.decode_packed_tb_plain.calls == plain + 1
