"""Parity of `repro_torch.core.banded` (the plain PyTorch wavefront)
with the JAX reference `repro.core.banded`. Integer DP: tolerance 0."""

import numpy as np
import pytest
import torch

from repro.core import banded as jbanded
from repro.core.scoring import EDIT_DISTANCE as JAX_EDIT
from repro.core.scoring import ScoringConfig as JaxScoring
from repro_torch.core import banded as tbanded
from repro_torch.core.scoring import (EDIT_DISTANCE, ScoringConfig,
                                      adaptive_bandwidth, decode, encode)
from repro.core.scoring import adaptive_bandwidth as jax_adaptive_bandwidth
from torch_parity import (JAX_SC, TORCH_SC, assert_same_result, make_pairs,
                          pad_pairs)

LENGTHS = (60, 48, 33, 60, 1, 57)


def _batch(seed=11):
    reads, refs = make_pairs(seed, LENGTHS, unrelated=(3,))
    q, r, n, m = pad_pairs(reads, refs, 72, 64)
    return q, r, n, m


@pytest.mark.parametrize("xdrop", [None, 14])
@pytest.mark.parametrize("cell_dtype", ["int32", "narrow"])
@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("mode", ["global", "semiglobal"])
def test_banded_align_batch_matches_reference(mode, adaptive, cell_dtype,
                                              xdrop):
    """All eight result keys, odd band, trimmed sweep."""
    q, r, n, m = _batch()
    t_max = int((n + m).max()) + 3
    kw = dict(band=11, adaptive=adaptive, collect_tb=True, mode=mode,
              t_max=t_max, cell_dtype=cell_dtype, xdrop=xdrop)
    ref = jbanded.banded_align_batch(q, r, n, m, sc=JAX_SC, **kw)
    out = tbanded.banded_align_batch(q, r, n, m, sc=TORCH_SC, **kw)
    assert_same_result(ref, out, n, m, collect_tb=True)
    if xdrop is not None:
        assert out["status"][3] > 0 and out["score"][3] == tbanded.NEG
        assert (out["status"][:3] == 0).all()


@pytest.mark.parametrize("band,t_max,collect_tb", [
    (12, None, True),      # even band, full padded sweep
    (12, 128, False),      # score only
    (7, 126, True),        # narrow odd band
])
def test_banded_align_batch_band_and_sweep(band, t_max, collect_tb):
    q, r, n, m = _batch(seed=12)
    kw = dict(band=band, collect_tb=collect_tb, t_max=t_max)
    ref = jbanded.banded_align_batch(q, r, n, m, sc=JAX_SC, **kw)
    out = tbanded.banded_align_batch(q, r, n, m, sc=TORCH_SC, **kw)
    assert_same_result(ref, out, n, m, collect_tb=collect_tb)


def test_banded_other_scoring_matches_reference():
    q, r, n, m = _batch(seed=13)
    kw = dict(band=10, collect_tb=True, t_max=int((n + m).max()))
    ref = jbanded.banded_align_batch(q, r, n, m, sc=JAX_EDIT, **kw)
    out = tbanded.banded_align_batch(q, r, n, m, sc=EDIT_DISTANCE, **kw)
    assert_same_result(ref, out, n, m, collect_tb=True)


def test_plain_wavefront_counts_its_calls():
    q, r, n, m = _batch()
    before = tbanded.banded_align_batch.calls
    tbanded.banded_align_batch(q[:1], r[:1], n[:1], m[:1], sc=TORCH_SC,
                               band=8, collect_tb=False, t_max=8)
    assert tbanded.banded_align_batch.calls == before + 1


@pytest.mark.parametrize("band", [1, 2, 9, 16])
def test_pack_unpack_select_match_reference(band):
    rng = np.random.default_rng(band)
    code = rng.integers(0, 16, (3, 5, band)).astype(np.uint8)
    ref = np.asarray(jbanded.pack_tb_lanes(code))
    out = tbanded.pack_tb_lanes(torch.from_numpy(code))
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(ref, out.numpy())
    assert out.shape[-1] == tbanded.packed_tb_width(band) \
        == jbanded.packed_tb_width(band)
    np.testing.assert_array_equal(tbanded.unpack_tb_lanes(out, band), code)
    np.testing.assert_array_equal(jbanded.unpack_tb_lanes(ref, band), code)
    lanes = np.arange(band)
    byte = out.numpy()[..., lanes >> 1]
    np.testing.assert_array_equal(tbanded.select_tb_nibble(byte, lanes),
                                  code)
    if band % 2:  # odd band: the last byte's high nibble is zero
        assert not (out.numpy()[..., -1] >> 4).any()


@pytest.mark.parametrize("fields,band", [
    (dict(match=2, mismatch=4, gap_open=4, gap_extend=2), 100),
    (dict(match=2, mismatch=4, gap_open=4, gap_extend=2), 1000),
    (dict(match=2, mismatch=4, gap_open=4, gap_extend=2), 1025),
    (dict(match=100, mismatch=4, gap_open=10, gap_extend=4), 10),
    (dict(match=1, mismatch=4, gap_open=6, gap_extend=1), 400),
])
def test_validate_narrow_cells_matches_reference(fields, band):
    def verdict(fn, sc):
        try:
            fn(sc, band)
            return None
        except ValueError as e:
            return str(e)
    ref = verdict(jbanded.validate_narrow_cells, JaxScoring(**fields))
    out = verdict(tbanded.validate_narrow_cells, ScoringConfig(**fields))
    assert ref == out
    assert tbanded.narrow_spread_bound(ScoringConfig(**fields), band) == \
        jbanded.narrow_spread_bound(JaxScoring(**fields), band)


def test_sentinels_and_scoring_helpers_match_reference():
    assert int(jbanded.NEG) == tbanded.NEG
    assert jbanded.DEAD_THRESHOLD == tbanded.DEAD_THRESHOLD
    assert jbanded.DEAD16 == tbanded.DEAD16
    assert jbanded.XDROP_CHUNK == tbanded.XDROP_CHUNK
    for L in (100, 150, 1024, 2048, 8192, 16384):
        for w in (10, 30):
            assert adaptive_bandwidth(L, w) == jax_adaptive_bandwidth(L, w)
    assert decode(encode("ACGTNacgt")) == "ACGTNACGT"
    q = np.array([0, 1, 4, 3], np.int8)
    r = np.array([0, 2, 4, 3], np.int8)
    np.testing.assert_array_equal(
        TORCH_SC.substitution(torch.from_numpy(q),
                              torch.from_numpy(r)).numpy(),
        np.asarray(JAX_SC.substitution(q, r)))
