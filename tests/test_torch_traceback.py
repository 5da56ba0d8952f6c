"""Parity of `repro_torch.core.traceback_device` with the reference's
jit'd walker, cross-fed through `repro_torch.core.interop` both ways.
Tolerance 0."""

import numpy as np
import pytest
import torch

from repro.core import banded as jbanded
from repro.core import traceback_device as jtbd
from repro_torch.core import banded as tbanded
from repro_torch.core import traceback_device as ttbd
from repro_torch.core.interop import result_from_numpy, result_to_numpy
from torch_parity import JAX_SC, TORCH_SC, make_pairs, pad_pairs

LENGTHS = (50, 37, 50, 1, 44, 29, 50)


def _planes(mode, band, xdrop, seed=31):
    reads, refs = make_pairs(seed, LENGTHS, unrelated=(2,))
    q, r, n, m = pad_pairs(reads, refs, 64, 56)
    kw = dict(band=band, mode=mode, collect_tb=True,
              t_max=int((n + m).max()) + 1, xdrop=xdrop)
    ref = jbanded.banded_align_batch(q, r, n, m, sc=JAX_SC, **kw)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    out = tbanded.banded_align_batch(q, r, n, m, sc=TORCH_SC, **kw)
    return n, m, ref, out


def _starts(res, n, m, mode):
    if mode == "semiglobal":
        si, sj = np.asarray(res["best_i"]), np.asarray(res["best_j"])
    else:
        si, sj = n.copy(), m.copy()
    keep = np.asarray(res["status"]) == 0
    return (si * keep).astype(np.int32), (sj * keep).astype(np.int32)


@pytest.mark.parametrize("mode,band,xdrop", [
    ("global", 9, None), ("global", 10, 14),
    ("semiglobal", 9, 14), ("semiglobal", 10, None),
])
def test_decode_matches_reference_cross_fed(mode, band, xdrop):
    n, m, ref, out = _planes(mode, band, xdrop)
    # Reference planes -> the port's walker.
    fed = result_from_numpy(ref, "cpu")
    assert fed["tb"].dtype == torch.uint8 and fed["los"].dtype == torch.int32
    dec_t = ttbd.device_decode_result(fed, n, m, band=band, mode=mode)
    dec_j = jtbd.device_decode_result(ref, n, m, band=band, mode=mode)
    for key in ("cig_ops", "cig_runs", "cig_len"):
        a, b = np.asarray(dec_j[key]), dec_t[key].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert "tb" not in dec_t and "los" not in dec_t
    # The port's planes -> the reference's host decoder and walker.
    back = result_to_numpy(out)
    si, sj = _starts(back, n, m, mode)
    host = jbanded.traceback_banded_batch(
        back["tb"], back["los"], n, m, band,
        starts=np.stack([si, sj], axis=1))
    ops, runs, lens = ttbd.fetch_rle(dec_t)
    assert ttbd.rle_to_cigars(ops, runs, lens) == host
    jops, jruns, jlens = jtbd.decode_packed_tb(back["tb"], back["los"],
                                               si, sj, band=band)
    np.testing.assert_array_equal(np.asarray(jlens), lens)
    np.testing.assert_array_equal(np.asarray(jops)[:, :ops.shape[1]], ops)
    # ... and the port's own host decoder agrees with both.
    assert tbanded.traceback_banded_batch(
        out["tb"], out["los"], n, m, band,
        starts=np.stack([si, sj], axis=1)) == host
    if xdrop is not None:      # retired pair: empty walk
        assert back["status"][2] > 0 and lens[2] == 0 and host[2] == []


def test_decode_packed_tb_wrapper_and_per_pair_oracle():
    n, m, ref, out = _planes("global", 9, None, seed=32)
    ops, runs, lens = ttbd.decode_packed_tb(
        out["tb"].numpy(), out["los"].numpy(), n, m, band=9)
    cigars = ttbd.rle_to_cigars(ops.numpy(), runs.numpy(), lens.numpy())
    for p in range(len(n)):
        assert cigars[p] == tbanded.traceback_banded(
            out["tb"][p], out["los"][p], int(n[p]), int(m[p]), 9)
        assert cigars[p] == jbanded.traceback_banded(
            ref["tb"][p], ref["los"][p], int(n[p]), int(m[p]), 9)
    # Columns past cig_len are zero (the output layout's contract).
    cols = np.arange(ops.shape[1])[None, :]
    assert not ops.numpy()[cols >= lens.numpy()[:, None]].any()
    assert not runs.numpy()[cols >= lens.numpy()[:, None]].any()


def test_fetch_rle_byte_count():
    """Host traffic per pair is 5 * K_used + 4 bytes, never the plane."""
    n, m, ref, out = _planes("global", 10, None, seed=33)
    dec = ttbd.device_decode_result(out, n, m, band=10)
    ops, runs, lens = ttbd.fetch_rle(dec)
    N = len(n)
    k_used = int(lens.max())
    assert ops.shape == runs.shape == (N, k_used)
    assert ops.nbytes + runs.nbytes + lens.nbytes == N * (5 * k_used + 4)
    plane = out["tb"].numel() // N
    assert plane == tbanded.packed_tb_width(10) * out["tb"].shape[1]
    jo, jr, jl = jtbd.fetch_rle(jtbd.device_decode_result(
        ref, n, m, band=10))
    assert (jo.nbytes, jr.nbytes, jl.nbytes) == \
        (ops.nbytes, runs.nbytes, lens.nbytes)


def test_walker_wrappers_count_and_refuse():
    n, m, ref, out = _planes("global", 9, None, seed=32)
    before = ttbd.decode_packed_tb_plain.calls
    ttbd.decode_packed_tb(out["tb"], out["los"], n, m, band=9)
    assert ttbd.decode_packed_tb_plain.calls == before + 1
    launches = ttbd.decode_packed_tb_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        ttbd.decode_packed_tb_cuda(out["tb"], out["los"],
                                   torch.from_numpy(n), torch.from_numpy(m),
                                   band=9)
    assert ttbd.decode_packed_tb_cuda.launches == launches
