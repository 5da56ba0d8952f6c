"""Persistent dispatch of `repro_torch` on the CPU, against the JAX
package: the reference backend's `run_persistent` (the plain persistent
wavefront and the plain table walker) against JAX's `run_persistent`, the
engine's persistent `align` against JAX's and against the port's own
pipelined path, and the ported cases of tests/test_persistent_dispatch.py.
Tolerance 0 (integer DP)."""

import numpy as np
import pytest
import torch

from repro.core.backends import get_backend as jax_get_backend
from repro.core.engine import AlignmentEngine as JaxEngine
from repro_torch.core import traceback_device as tbd
from repro_torch.core.backends import get_backend, merge_persistent_outputs
from repro_torch.core.banded import banded_align_batch
from repro_torch.core.engine import (PERSISTENT_PAD, SCALAR_KEYS,
                                     AlignmentEngine, PendingPersistent)
from repro_torch.kernels.banded_dp.persistent import (
    TABLE_COLS, pack_groups, persistent_align, persistent_align_cuda,
    persistent_align_plain)
from torch_parity import JAX_SC, TORCH_SC, make_pairs, pad_pairs

RLE_KEYS = ("cig_ops", "cig_runs", "cig_len")


def _group(seed, lengths, band, t_max, n_pad, unrelated=()):
    """One padded dispatch group: pairs at `lengths`, dummy rows (length
    1, base 4) up to `n_pad`."""
    reads, refs = make_pairs(seed, lengths, unrelated)
    L = max(len(x) for x in reads + refs)
    q, r, n, m = pad_pairs(reads, refs, L, L)
    k = n_pad - len(reads)
    fill = np.full((k, L), 4, np.int8)
    ones = np.ones(k, np.int32)
    return (np.concatenate([q, fill]), np.concatenate([r, fill]),
            np.concatenate([n, ones]), np.concatenate([m, ones]), band,
            t_max)


def _request(seed=0):
    """Three groups with odd and even bands, a trimmed, an untrimmed and
    a tight sweep, ragged pair counts and two unrelated pairs (which the
    xdrop rule retires)."""
    return [_group(seed + 1, (50, 60, 44), 11, 128, 4),
            _group(seed + 2, (90, 100, 80, 70, 95), 16, None, 8,
                   unrelated=(1,)),
            _group(seed + 3, (30, 20, 33), 9, 70, 4, unrelated=(2,))]


def _to_np(out):
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_merged_equal(ref, out):
    assert set(ref) == set(out)
    for key in ref:
        assert ref[key].shape == out[key].shape, key
        assert ref[key].dtype == out[key].dtype, key
        np.testing.assert_array_equal(ref[key], out[key], err_msg=key)


# ---------------------------------------------------------------------------
# Backend run_persistent against the JAX package.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,cell_dtype,xdrop", [
    ("global", "int32", None), ("global", "narrow", 20),
    ("semiglobal", "int32", 20), ("semiglobal", "narrow", None),
])
def test_run_persistent_matches_jax_reference(mode, cell_dtype, xdrop):
    groups = _request()
    kw = dict(adaptive=True, collect_tb=True, mode=mode,
              cell_dtype=cell_dtype, xdrop=xdrop)
    ref = _to_np(jax_get_backend("reference").run_persistent(
        groups, sc=JAX_SC, **kw))
    out = _to_np(get_backend("reference").run_persistent(
        groups, sc=TORCH_SC, device="cpu", **kw))
    _assert_merged_equal(ref, out)
    if xdrop is not None:
        assert (out["status"] != 0).sum() >= 2


def test_run_persistent_matches_jax_pallas_interpret():
    groups = _request(seed=7)
    kw = dict(collect_tb=True, mode="global", xdrop=20)
    pallas = jax_get_backend("pallas", batch_tile=4, chunk=64,
                             interpret=True)
    ref = _to_np(pallas.run_persistent(groups, sc=JAX_SC, **kw))
    out = _to_np(get_backend("reference").run_persistent(
        groups, sc=TORCH_SC, device="cpu", **kw))
    _assert_merged_equal(ref, out)


def test_run_persistent_scores_only_and_non_adaptive():
    groups = _request(seed=3)
    kw = dict(adaptive=False, collect_tb=False, mode="semiglobal")
    ref = _to_np(jax_get_backend("reference").run_persistent(
        groups, sc=JAX_SC, **kw))
    out = _to_np(get_backend("reference").run_persistent(
        groups, sc=TORCH_SC, device="cpu", **kw))
    _assert_merged_equal(ref, out)
    assert set(out) == set(SCALAR_KEYS)


def test_run_persistent_rejects_host_decode_and_empty():
    be = get_backend("reference")
    with pytest.raises(ValueError, match="decode"):
        be.run_persistent(_request(), sc=TORCH_SC, collect_tb=True,
                          decode="host")
    with pytest.raises(ValueError, match="at least one group"):
        be.run_persistent([], sc=TORCH_SC)


# ---------------------------------------------------------------------------
# The work table, the plain persistent wavefront and the table walker.
# ---------------------------------------------------------------------------

def _flat(groups):
    table, arrays = pack_groups(groups)
    return table, [torch.from_numpy(a) for a in arrays]


def test_work_table_layout():
    groups = _request()
    table, (q, r, n, m) = _flat(groups)
    rows = table.rows.numpy()
    col = {c: i for i, c in enumerate(TABLE_COLS)}
    assert rows.shape == (table.num_rows, len(TABLE_COLS)) == (16, 9)
    assert sorted(rows[:, col["row"]].tolist()) == list(range(16))
    # Longest live sweep first.
    live = np.minimum(n.numpy()[rows[:, col["row"]]]
                      + m.numpy()[rows[:, col["row"]]], rows[:, col["steps"]])
    assert (np.diff(live) <= 0).all()
    assert table.band_max == 16 and table.steps_max == 200
    assert [s.steps for s in table.spans] == [128, 200, 70]
    assert table.tb_bytes == 4 * 128 * 6 + 8 * 200 * 8 + 4 * 70 * 5
    assert table.los_words == 4 * 129 + 8 * 201 + 4 * 71
    # Each row's q offset points at its own padded row.
    for rec in rows:
        s = next(s for s in table.spans
                 if s.row0 <= rec[col["row"]] < s.row0 + s.rows)
        k = rec[col["row"]] - s.row0
        np.testing.assert_array_equal(
            q[rec[col["q_off"]]:rec[col["q_off"]] + s.q_len].numpy(),
            groups[table.spans.index(s)][0][k])


def test_plain_persistent_and_table_walker_are_per_group_runs():
    """Merged rows equal each group run alone and laid end to end: the
    wavefront's flat planes, and the walker's RLE rows zero-padded to the
    longest group sweep (the JAX package's merge on the same arrays)."""
    groups = _request(seed=5)
    table, (q, r, n, m) = _flat(groups)
    kw = dict(sc=TORCH_SC, adaptive=True, collect_tb=True, mode="global",
              cell_dtype="int32", xdrop=20)
    out = persistent_align(table, q, r, n, m, **kw)
    dec = tbd.device_decode_table(out, table, n, m, mode="global")
    per_group = []
    for (gq, gr, gn, gm, band, t_max), s in zip(groups, table.spans):
        o = banded_align_batch(gq, gr, gn, gm, band=band, t_max=s.steps,
                               **kw)
        rows = slice(s.row0, s.row0 + s.rows)
        for key in SCALAR_KEYS:
            assert torch.equal(out[key][rows], o[key]), key
        assert torch.equal(out["tb"][s.tb0:s.tb0 + o["tb"].numel()],
                           o["tb"].reshape(-1))
        assert torch.equal(out["los"][s.los0:s.los0 + o["los"].numel()],
                           o["los"].reshape(-1))
        per_group.append(tbd.device_decode_result(o, gn, gm, band=band))
    merged = merge_persistent_outputs(per_group)
    for key in SCALAR_KEYS + RLE_KEYS:
        assert torch.equal(dec[key], merged[key]), key
    assert dec["cig_ops"].shape == (table.num_rows, table.steps_max)

    from repro.core.backends import merge_persistent_outputs as jax_merge
    jm = jax_merge([{k: v.numpy() for k, v in g.items()}
                    for g in per_group])
    for key in RLE_KEYS:
        np.testing.assert_array_equal(np.asarray(jm[key]),
                                      merged[key].numpy())


def test_cuda_wrappers_take_only_cuda_tensors():
    table, (q, r, n, m) = _flat(_request())
    with pytest.raises(ValueError, match="CUDA"):
        persistent_align_cuda(table, q, r, n, m, sc=TORCH_SC)
    out = persistent_align_plain(table, q, r, n, m, sc=TORCH_SC)
    with pytest.raises(ValueError, match="CUDA"):
        tbd.decode_packed_tb_table_cuda(table, out["tb"], out["los"], n, m)


# ---------------------------------------------------------------------------
# The engine's persistent path.
# ---------------------------------------------------------------------------

#: Three length classes (buckets 128, 256, 512), ragged inside each.
LENGTHS = (40, 150, 90, 300, 41, 160, 35, 120, 1, 140, 280, 60, 77)


def _engines(**kw):
    common = dict(capacity=4, **kw)
    return (JaxEngine(backend="reference", sc=JAX_SC, dispatch="persistent",
                      **common),
            AlignmentEngine(backend="reference", device="cpu", sc=TORCH_SC,
                            dispatch="persistent", **common),
            AlignmentEngine(backend="reference", device="cpu", sc=TORCH_SC,
                            **common))


def _assert_same(ref, out, collect_tb=True):
    assert set(ref) == set(out)
    for key in SCALAR_KEYS + ("band",):
        assert out[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(ref[key], out[key], err_msg=key)
    if collect_tb:
        assert ref["cigars"] == out["cigars"]


@pytest.mark.parametrize("mode,xdrop", [("global", 20),
                                        ("semiglobal", None)])
def test_engine_persistent_matches_jax_and_pipelined(mode, xdrop):
    reads, refs = make_pairs(51, LENGTHS, unrelated=(2, 5))
    jax_p, port_p, port_pipe = _engines(xdrop=xdrop)
    ref = jax_p.align(reads, refs, mode=mode, collect_tb=True)
    out = port_p.align(reads, refs, mode=mode, collect_tb=True)
    _assert_same(ref, out)
    _assert_same(port_pipe.align(reads, refs, mode=mode, collect_tb=True),
                 out)
    if xdrop is not None:
        assert {2, 5} <= set(np.flatnonzero(out["status"]).tolist())
        for p in range(len(reads)):
            assert (out["cigars"][p] is None) == (out["status"][p] != 0)


def test_engine_persistent_scores_only_path():
    reads, refs = make_pairs(52, LENGTHS)
    _, port_p, port_pipe = _engines(cell_dtype="narrow")
    a = port_pipe.align(reads, refs)
    b = port_p.align(reads, refs)
    _assert_same(a, b, collect_tb=False)
    assert "cigars" not in b


def test_engine_persistent_enqueue_finalize_matches_jax():
    reads, refs = make_pairs(53, LENGTHS)
    jax_p, port_p, _ = _engines()
    pd = port_p.enqueue_persistent(reads, refs, collect_tb=True)
    jpd = jax_p.enqueue_persistent(reads, refs, collect_tb=True)
    assert isinstance(pd, PendingPersistent) and pd.ready is None
    assert pd.num_slots == jpd.num_slots
    assert pd.signature == jpd.signature
    st, jst = {}, {}
    out = port_p.finalize_persistent(pd, stats=st)
    ref = jax_p.finalize_persistent(jpd, stats=jst)
    _assert_same(ref, out)
    # The port trims each group's RLE rows to that group's longest CIGAR
    # (the JAX package trims the whole request to its longest): cig_len
    # and the six scalars per row, plus 5 bytes per kept RLE column.
    lens = pd.outs["cig_len"].numpy()
    rle, off = 0, 0
    for grp in pd.batch:
        n_pad = grp[0].shape[0]
        rle += n_pad * 5 * max(int(lens[off:off + n_pad].max()), 1)
        off += n_pad
    assert st["fetched_bytes"] == pd.num_slots * (4 + 24) + rle
    assert 0 < st["fetched_bytes"] <= jst["fetched_bytes"]


def test_persistent_pads_to_tile_not_capacity():
    eng = AlignmentEngine(backend="reference", device="cpu",
                          dispatch="persistent", capacity=64)
    reads, refs = make_pairs(54, [50] * 13)
    pd = eng.enqueue_persistent(reads, refs)
    n_pad = -(-13 // PERSISTENT_PAD) * PERSISTENT_PAD
    assert pd.num_slots == n_pad == 16 < 64
    assert pd.num_real == 13
    assert eng.finalize_persistent(pd)["score"].shape == (13,)


def test_persistent_rejects_host_decode_and_empty_request():
    eng = AlignmentEngine(backend="reference", device="cpu",
                          dispatch="persistent", decode="host")
    reads, refs = make_pairs(55, (40, 300, 90))
    with pytest.raises(ValueError, match="persistent"):
        eng.align(reads, refs, collect_tb=True)
    # Without tracebacks there is no decode stage to reject.
    eng.align(reads, refs, collect_tb=False)
    with pytest.raises(ValueError, match="persistent"):
        AlignmentEngine(backend="reference",
                        device="cpu").enqueue_persistent(reads, refs)
    out = AlignmentEngine(backend="reference", device="cpu",
                          dispatch="persistent").align([], [],
                                                       collect_tb=True)
    assert out["score"].shape == (0,) and out["cigars"] == []


def test_service_over_persistent_engine_matches_one_shot():
    from repro_torch.serve import AlignmentService
    reads, refs = make_pairs(56, LENGTHS)
    _, port_p, port_pipe = _engines()
    one_shot = port_pipe.align(reads, refs, collect_tb=True)
    with AlignmentService(port_p, collect_tb=True, max_wait_ms=2.0,
                          max_inflight_groups="auto") as svc:
        res = [f.result(timeout=120) for f in
               [svc.submit(rd, rf) for rd, rf in zip(reads, refs)]]
        stats = svc.stats()
    assert stats["completed"] == len(reads) and stats["bytes_fetched"] > 0
    for p, r in enumerate(res):
        assert r["cigar"] == one_shot["cigars"][p]
        for key in SCALAR_KEYS + ("band",):
            assert int(r[key]) == int(one_shot[key][p]), key
