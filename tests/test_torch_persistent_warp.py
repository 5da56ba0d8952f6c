"""B2's two bodies: which request runs which, what the wrapper refuses
before it launches anything, and the plain version they are both held
against on the card, here against the JAX package on a request whose
bands lie on both sides of the warp body's edge.

The warp kernel (`csrc/persistent.cu: persistent_warp_kernel`, one warp
per table row running `wavefront_warp.cuh`) takes requests whose widest
band is 1..128; the block kernel (one block per row, `wavefront.cuh`)
takes wider ones, and any request with ``block_body=True``. Both are held
`torch.equal` against `persistent_align_plain`, and against each other,
by `chip_smoke.py`. Tolerance 0 (integer DP)."""

import numpy as np
import pytest
import torch

from repro.core.backends import get_backend as jax_get_backend
from repro_torch.core import traceback_device as tbd
from repro_torch.kernels.banded_dp.banded_dp import (MAX_BAND, WARP_MAX_BAND,
                                                     kernel_body)
from repro_torch.kernels.banded_dp.persistent import (pack_groups,
                                                      persistent_align_cuda,
                                                      persistent_align_plain)
from torch_parity import (JAX_SC, SCALAR_KEYS, TORCH_SC, make_pairs,
                          pad_pairs)

RLE_KEYS = ("cig_ops", "cig_runs", "cig_len")


def test_body_by_widest_band():
    """A persistent launch runs the per-group kernel's rule (`kernel_body`)
    on the request's widest band."""
    assert WARP_MAX_BAND == 128
    assert [kernel_body(b) for b in range(1, 129)] == ["warp"] * 128
    assert {kernel_body(b) for b in range(129, MAX_BAND + 1)} == {"block"}
    assert {kernel_body(b, block_body=True)
            for b in range(1, MAX_BAND + 1)} == {"block"}


@pytest.mark.parametrize("band", [0, 1025])
def test_body_refuses_bands_outside_the_kernel(band):
    with pytest.raises(ValueError, match="outside the kernel's range"):
        kernel_body(band)


def _group(seed, lengths, band, t_max=None, unrelated=()):
    reads, refs = make_pairs(seed, lengths, unrelated)
    L = max(len(x) for x in reads + refs)
    q, r, n, m = pad_pairs(reads, refs, L, L)
    return q, r, n, m, band, t_max


def _mixed_request():
    """Bands on both sides of the warp body's edge: 20 and 100 (warp body
    alone) and 129 (the whole request on the block body); a trimmed and
    an untrimmed sweep; an unrelated pair for the xdrop rule."""
    return [_group(11, (60, 45, 52), 20, t_max=128),
            _group(12, (90, 70), 100, unrelated=(1,)),
            _group(13, (80, 66, 75), 129, t_max=168)]


def _flat(groups):
    table, arrays = pack_groups(groups)
    return table, [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("block_body", [False, True])
def test_wrapper_refuses_cpu_tensors_before_anything(block_body):
    table, (q, r, n, m) = _flat(_mixed_request()[:2])
    launches = persistent_align_cuda.launches
    bodies = dict(persistent_align_cuda.bodies)
    with pytest.raises(ValueError, match="CUDA tensors"):
        persistent_align_cuda(table, q, r, n, m, sc=TORCH_SC,
                              block_body=block_body)
    assert persistent_align_cuda.launches == launches
    assert dict(persistent_align_cuda.bodies) == bodies


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it lives on a card, so that the wrapper's
    own argument checks (which come after the device check) run here."""

    @property
    def is_cuda(self):
        return True


def test_wrapper_refuses_a_band_outside_the_kernel():
    groups = _mixed_request()[:1]
    q, r, n, m, _, t_max = groups[0]
    table, (tq, tr, tn, tm) = _flat([(q, r, n, m, MAX_BAND + 1, t_max)])
    launches = persistent_align_cuda.launches
    with pytest.raises(ValueError, match="outside the kernel's range"):
        persistent_align_cuda(table, tq.as_subclass(_FakeCuda), tr, tn, tm,
                              sc=TORCH_SC)
    assert persistent_align_cuda.launches == launches


@pytest.mark.parametrize("mode,xdrop", [("global", 20),
                                        ("semiglobal", None)])
def test_plain_on_a_request_across_the_edge_matches_jax(mode, xdrop):
    """`persistent_align_plain` (what the card holds both bodies against)
    and the plain table walker behind it vs the JAX package's persistent
    reference backend, on a request with bands 20, 100 and 129."""
    groups = _mixed_request()
    table, (q, r, n, m) = _flat(groups)
    assert table.band_max == 129 and kernel_body(table.band_max) == "block"
    assert kernel_body(max(g[4] for g in groups[:2])) == "warp"
    kw = dict(adaptive=True, collect_tb=True, mode=mode, xdrop=xdrop)
    ref = jax_get_backend("reference").run_persistent(groups, sc=JAX_SC,
                                                      **kw)
    out = persistent_align_plain(table, q, r, n, m, sc=TORCH_SC,
                                 cell_dtype="int32", **kw)
    dec = tbd.device_decode_table(out, table, n, m, mode=mode)
    for key in SCALAR_KEYS + RLE_KEYS:
        a, b = np.asarray(ref[key]), dec[key].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    if xdrop is not None:
        assert (dec["status"] != 0).any()
