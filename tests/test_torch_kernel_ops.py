"""Parity of `repro_torch.kernels.banded_dp.ops.banded_align_kernel_batch`
on CPU tensors (where the wrapper takes its kernel's plain version) with
the reference's Pallas kernel run in interpret mode. Tolerance 0.

The CUDA kernel itself cannot run without a card; it is held against
the same plain version on the card by `chip_smoke.py`."""

import pytest
import torch

from repro.kernels.banded_dp.ops import \
    banded_align_kernel_batch as jax_kernel_batch
from repro.kernels.banded_dp.ref import \
    banded_align_ref_batch as jax_ref_batch
from repro_torch.kernels.banded_dp import (banded_align_kernel_batch,
                                           banded_align_ref_batch)
from repro_torch.kernels.banded_dp.banded_dp import (MAX_BAND,
                                                     banded_align_cuda)
from torch_parity import (JAX_SC, TORCH_SC, assert_same_result, make_pairs,
                          pad_pairs)


def _batch(count, seed):
    lengths = [(40, 28, 36, 17)[k % 4] for k in range(count)]
    reads, refs = make_pairs(seed, lengths, unrelated=(2,))
    return pad_pairs(reads, refs, 48, 40)


@pytest.mark.parametrize("mode,adaptive,cell_dtype,xdrop,band,count", [
    ("global", True, "int32", None, 9, 11),       # batch not divisible by 8
    ("semiglobal", True, "narrow", 12, 8, 8),
    ("global", False, "int32", 12, 8, 5),
])
def test_kernel_batch_cpu_matches_pallas_interpret(mode, adaptive,
                                                   cell_dtype, xdrop, band,
                                                   count):
    q, r, n, m = _batch(count, seed=21)
    kw = dict(band=band, adaptive=adaptive, collect_tb=True, mode=mode,
              t_max=int((n + m).max()) + 2, cell_dtype=cell_dtype,
              xdrop=xdrop)
    ref = jax_kernel_batch(q, r, n, m, sc=JAX_SC, interpret=True,
                           chunk=32, **kw)
    out = banded_align_kernel_batch(q, r, n, m, sc=TORCH_SC, **kw)
    assert out["score"].shape == (count,)
    assert_same_result(ref, out, n, m, collect_tb=True)


def test_kernel_batch_score_only_and_ref_wrapper():
    q, r, n, m = _batch(6, seed=22)
    ref = jax_kernel_batch(q, r, n, m, sc=JAX_SC, band=8, collect_tb=False,
                           interpret=True, chunk=32)
    out = banded_align_kernel_batch(q, r, n, m, sc=TORCH_SC, band=8,
                                    collect_tb=False)
    assert_same_result(ref, out, n, m, collect_tb=False)
    ref = jax_ref_batch(q, r, n, m, sc=JAX_SC, band=8)
    out = banded_align_ref_batch(q, r, n, m, sc=TORCH_SC, band=8)
    assert_same_result(ref, out, n, m, collect_tb=True)


def test_kernel_batch_accepts_tensors_and_keeps_their_device():
    q, r, n, m = _batch(4, seed=23)
    out = banded_align_kernel_batch(
        torch.from_numpy(q), torch.from_numpy(r), torch.from_numpy(n),
        torch.from_numpy(m), sc=TORCH_SC, band=8)
    assert out["tb"].device.type == "cpu" and out["tb"].dtype == torch.uint8
    assert out["los"].dtype == torch.int32


def test_cuda_wrapper_never_falls_back_on_cpu_tensors():
    q, r, n, m = _batch(4, seed=23)
    before = banded_align_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        banded_align_cuda(torch.from_numpy(q), torch.from_numpy(r), n, m,
                          sc=TORCH_SC, band=8)
    assert banded_align_cuda.launches == before
    assert MAX_BAND >= 512
