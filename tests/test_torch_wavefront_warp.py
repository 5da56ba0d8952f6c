"""B1's two per-pair bodies: which band runs which, and what the wrapper
refuses before it launches anything.

The warp body (`csrc/wavefront_warp.cuh`: one warp per pair, C =
ceil(B / 32) band lanes per thread in registers) takes bands 1..128; the
block body (`csrc/wavefront.cuh`: one block per pair, band state in shared
memory) takes 129..1024, and the persistent kernel runs it for every band.
Both bodies are held `torch.equal` against `core.banded.banded_align_batch`
on the card by `chip_smoke.py` over bands across these edges; here, on the
CPU, the wrapper takes CPU tensors nowhere (no fallback) and the plain
version gives the same result for a band on either side of the edge as
the JAX package's reference."""

import numpy as np
import pytest
import torch

from repro.kernels.banded_dp.ref import \
    banded_align_ref_batch as jax_ref_batch
from repro_torch.kernels.banded_dp import banded_align_kernel_batch
from repro_torch.kernels.banded_dp.banded_dp import (MAX_BAND, WARP_MAX_BAND,
                                                     banded_align_cuda,
                                                     kernel_body)
from torch_parity import (JAX_SC, TORCH_SC, assert_same_result, make_pairs,
                          pad_pairs)


def test_body_by_band():
    assert WARP_MAX_BAND == 128 and MAX_BAND == 1024
    assert [kernel_body(b) for b in range(1, 129)] == ["warp"] * 128
    assert [kernel_body(b) for b in range(129, 1025)] == ["block"] * 896
    # The bucket classes of the main paths (bands 20, 60, 100).
    assert {kernel_body(b) for b in (20, 60, 100)} == {"warp"}


def test_block_body_switch_runs_the_block_body_at_any_band():
    """`block_body=True`, the switch that lets both bodies be timed on the
    same inputs, picks the block body at every band; the range checks
    stay."""
    assert {kernel_body(b, block_body=True)
            for b in range(1, MAX_BAND + 1)} == {"block"}
    with pytest.raises(ValueError, match="outside the kernel's range"):
        kernel_body(MAX_BAND + 1, block_body=True)


@pytest.mark.parametrize("band", [0, -3, 1025, 4096])
def test_body_refuses_bands_outside_the_kernel(band):
    with pytest.raises(ValueError, match="outside the kernel's range"):
        kernel_body(band)


def _cuda_args(n=3, L=40):
    q = torch.zeros(n, L, dtype=torch.int8)
    return q, q.clone(), torch.full((n,), L), torch.full((n,), L)


@pytest.mark.parametrize("kw,match", [
    (dict(band=20), "CUDA tensors"),
    (dict(band=128, mode="local"), "CUDA tensors"),
    (dict(band=60, block_body=True), "CUDA tensors"),
])
def test_wrapper_refuses_cpu_tensors_before_anything(kw, match):
    """A CPU tensor raises first, whatever else is given: the plain version
    is `core.banded.banded_align_batch`, never taken silently."""
    launches = banded_align_cuda.launches
    bodies = dict(banded_align_cuda.bodies)
    with pytest.raises(ValueError, match=match):
        banded_align_cuda(*_cuda_args(), sc=TORCH_SC, **kw)
    assert banded_align_cuda.launches == launches
    assert dict(banded_align_cuda.bodies) == bodies


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it lives on a card, so that the wrapper's
    own argument checks (which come after the device check) run here;
    every check below raises before anything is built or launched."""

    @property
    def is_cuda(self):
        return True


def _fake(n=3, L=40):
    q, r, n_, m = _cuda_args(n, L)
    return q.as_subclass(_FakeCuda), r, n_, m


@pytest.mark.parametrize("kw,match", [
    (dict(band=0), "outside the kernel's range"),
    (dict(band=1025), "outside the kernel's range"),
    (dict(band=64, mode="local"), "unknown mode"),
    (dict(band=64, cell_dtype="int8"), "unknown cell_dtype"),
    (dict(band=64, t_max=40000), "sweep length"),
    (dict(band=64, xdrop=-1), "xdrop"),
])
def test_wrapper_argument_checks(kw, match):
    launches = banded_align_cuda.launches
    with pytest.raises(ValueError, match=match):
        banded_align_cuda(*_fake(), sc=TORCH_SC, **kw)
    assert banded_align_cuda.launches == launches


@pytest.mark.parametrize("band", [31, 32, 33, 128, 129])
def test_plain_across_the_body_edges_matches_jax(band):
    """The plain version the card holds both bodies against, at bands on
    both sides of C's steps and of the warp/block edge, vs the JAX
    reference. Tolerance 0."""
    lengths = [(60, 45, 70, 33)[k % 4] for k in range(5)]
    reads, refs = make_pairs(31 + band, lengths, unrelated=(1,))
    q, r, n, m = pad_pairs(reads, refs, 72, 72)
    kw = dict(band=band, collect_tb=True)
    ref = jax_ref_batch(q, r, n, m, sc=JAX_SC, **kw)
    out = banded_align_kernel_batch(q, r, n, m, sc=TORCH_SC, **kw)
    assert_same_result(ref, out, n, m, collect_tb=True)
    assert np.asarray(out["tb"]).shape[-1] == (band + 1) // 2
