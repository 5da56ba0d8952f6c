"""Anchor chaining of `repro_torch` on the CPU (the plain version of the
chaining kernel) against the JAX package's jit'd chainer and the numpy
oracle of tests/mapper_oracle.py. Tolerance 0 (integer DP)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapper_oracle import chain_oracle, gap_cost_py
from repro.map import chain as jax_chain
from repro_torch.map import chain as port_chain


def _compare(sets, params_kw):
    jp = jax_chain.ChainParams(**params_kw)
    tp = port_chain.ChainParams(**params_kw)
    ref = jax_chain.chain_batch(sets, jp)
    out = port_chain.chain_batch(sets, tp, device="cpu")
    assert len(ref) == len(out) == len(sets)
    for (f0, p0, m0, b0), (f1, p1, m1, b1) in zip(ref, out):
        for a, b in ((f0, f1), (p0, p1), (m0, m1)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert b0 == b1
    return out


def _sorted_set(rng, a, q_hi=300, r_hi=2000):
    q = rng.integers(0, q_hi, a)
    r = rng.integers(0, r_hi, a)
    order = np.lexsort((q, r))
    return q[order], r[order]


def _colinear(rng, a, locus, step=16):
    q = np.arange(0, a * step, step) + rng.integers(0, 3, a)
    return q, q + locus + rng.integers(-2, 3, a)


def test_chain_batch_matches_jax_on_random_sets():
    rng = np.random.default_rng(15)
    sets = [_sorted_set(rng, int(rng.integers(1, 60))) for _ in range(20)]
    sets += [_colinear(rng, 12, 5000), _colinear(rng, 30, 100)]
    out = _compare(sets, dict(k=13))
    for (q, r), (f, pred, _, _) in zip(sets, out):
        f_ref, pred_ref = chain_oracle(q, r, k=13)
        np.testing.assert_array_equal(f[:len(q)], f_ref)
        np.testing.assert_array_equal(pred[:len(q)], pred_ref)


def test_chain_batch_empty_overlong_and_tied_sets():
    rng = np.random.default_rng(16)
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    q = np.arange(0, 1500, 10)            # 150 anchors > cap: subsampled
    overlong = (q, q + 100)
    # Ties: two identical colinear runs on two loci (equal f), the same
    # anchor twice, and a join whose candidate equals k exactly.
    a = np.arange(0, 80, 16)
    q2, r2 = np.concatenate([a, a]), np.concatenate([a + 1000, a + 3000])
    order = np.lexsort((q2, r2))
    tied = (q2[order], r2[order])
    dup = (np.asarray([5, 5, 40]), np.asarray([700, 700, 735]))
    exact_k = (np.asarray([0, 13]), np.asarray([0, 13]))
    sets = [empty, overlong, tied, dup, exact_k, empty]
    for kw in (dict(k=13), dict(k=10, anchors_cap=16),
               dict(k=13, max_gap=20, max_diag_diff=3)):
        out = _compare(sets, kw)
        assert out[0][3] == -1 and not out[0][2].any()
        assert (out[0][0] == port_chain.NEG).all()
        assert (out[0][1] == -1).all()
    assert port_chain.chain_batch([], port_chain.ChainParams(),
                                  device="cpu") == []


def test_padding_rows_come_back_as_jax_writes_them():
    """Whole padded batches: the rows `_pad_anchors` adds (to a multiple of
    16) and the invalid slots are NEG / -1 / False / -1."""
    rng = np.random.default_rng(17)
    sets = [_sorted_set(rng, int(a)) for a in (3, 0, 40)]
    qp, rp, valid = port_chain._pad_anchors(sets, 64)
    assert qp.shape == (16, 64)
    fn = jax_chain._chain_batch_fn(13, 5000, 500)
    ref = [np.asarray(x) for x in fn(qp, rp, valid)]
    out = port_chain.chain_padded(torch.from_numpy(qp),
                                  torch.from_numpy(rp),
                                  torch.from_numpy(valid), k=13,
                                  max_gap=5000, max_dd=500)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a, b.numpy())
    f, pred, mask, best = out
    assert (f[3:] == port_chain.NEG).all() and (pred[3:] == -1).all()
    assert not mask[3:].any() and (best[3:] == -1).all()
    assert (f[~torch.from_numpy(valid)] == port_chain.NEG).all()


@pytest.mark.parametrize("k", [10, 13, 15])
def test_gap_cost_matches_jax_over_the_whole_range(k):
    dd = np.arange(0, 501, dtype=np.int32)
    ref = np.asarray(jax_chain.gap_cost(jnp.asarray(dd), k))
    out = port_chain.gap_cost(dd, k).numpy()
    np.testing.assert_array_equal(ref, out)
    assert out.dtype == np.int32
    assert [int(x) for x in out[:64]] == [gap_cost_py(int(d), k)
                                          for d in range(64)]


def test_top_chains_matches_jax():
    rng = np.random.default_rng(18)
    a = np.arange(0, 80, 16)
    sets = [
        (np.concatenate([a, a[:3]]),
         np.concatenate([a + 1000, a[:3] + 8000])),   # two loci
        (a, a + 1000),                                # one locus
        _sorted_set(rng, 50),
        (np.arange(0, 1400, 10), np.arange(0, 1400, 10) + 50),  # over cap
    ]
    sets = [(q[o], r[o]) for q, r in sets for o in [np.lexsort((q, r))]]
    ref = jax_chain.chain_batch(sets, jax_chain.ChainParams(k=10))
    out = port_chain.chain_batch(sets, port_chain.ChainParams(k=10),
                                 device="cpu")
    for (q, r), rj, rt in zip(sets, ref, out):
        for kw in (dict(), dict(max_chains=3, min_sep=10)):
            cj = jax_chain.top_chains(q, r, rj, **kw)
            ct = port_chain.top_chains(q, r, rt, **kw)
            assert len(cj) == len(ct)
            for x, y in zip(cj, ct):
                assert x.score == y.score and x.diag_start == y.diag_start
                np.testing.assert_array_equal(x.q_pos, y.q_pos)
                np.testing.assert_array_equal(x.r_pos, y.r_pos)


def test_chain_kernel_wrapper_takes_only_cuda_tensors():
    z = torch.zeros((16, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        port_chain.chain_padded_cuda(z, z, z.bool(), k=13, max_gap=5000,
                                     max_dd=500)
