"""The chaining kernel's warp design (`src/repro_torch/map/csrc/chain.cu`)
emulated in numpy on the CPU: slot j on lane j % 32 in register j / 32,
the loop over steps up to the last valid slot (found by per-register
ballots) with invalid steps skipped, candidates only from slots j < i,
each lane's leftmost maximum over its registers by a strict >, then the
warp's maximum and the lowest slot among the lanes that hold it, the
update of lane i % 32's register i / 32, the endpoint by the same
reduction and lane 0's walk of pred.

The emulation must equal the JAX package's `_chain_one` (jit'd and
vmapped, on the CPU) and the port's plain version `chain_padded_plain`
bit for bit, on prefix and non-prefix valid masks, sets with no valid
slot, unsorted positions, forced ties and the max_gap / max_dd edges.
The kernel itself is held against the plain version on the card by
`chip_smoke.py`; here its wrapper refuses CPU tensors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.map.chain import _chain_batch_fn
from repro_torch.map import chain as port_chain

NEG = port_chain.NEG
NONE = np.iinfo(np.int64).max
LANES = 32


def _gap_cost(dd, k):
    lg = np.frexp(np.maximum(dd + 1, 1).astype(np.float64))[1] - 1
    return (dd * k) // 100 + np.where(dd > 0, lg // 2, 0)


def _candidate(qi, ri, qj, rj, vj, fj, k, max_gap, max_dd):
    dq, dr = qi - qj, ri - rj
    dd = np.abs(dr - dq)
    ok = (vj & (dq > 0) & (dr > 0) & (dq <= max_gap) & (dr <= max_gap)
          & (dd <= max_dd))
    gain = np.minimum(np.minimum(dq, dr), k) - _gap_cost(dd, k)
    return np.where(ok, fj + gain, NEG)


def _warp_argmax(lbest, lslot):
    """(max over lanes, lowest slot among the lanes holding it), per set."""
    wbest = lbest.max(axis=1)
    wslot = np.where(lbest == wbest[:, None], lslot, NONE).min(axis=1)
    return wbest, wslot


def warp_chain(qp, rp, valid, *, k, max_gap, max_dd):
    """The kernel's arithmetic, warp by warp (all sets at once, each with
    its own live-slot loop). Returns (f, pred, mask, best) as numpy."""
    qp, rp = qp.astype(np.int64), rp.astype(np.int64)
    valid = valid.astype(bool)
    R, A = qp.shape
    # Registers a lane of the instance `chain_launch` picks: 4 for every
    # A <= 128, 8 up to 256; above, f and pred sit in shared memory, which
    # the emulation keeps as ceil(A / 32) registers.
    S = 4 if A <= 128 else 8 if A <= 256 else -(-A // LANES)

    def regs(x, fill):          # (R, A) -> (R, S registers, 32 lanes)
        out = np.full((R, S * LANES), fill, x.dtype)
        out[:, :A] = x
        return out.reshape(R, S, LANES)

    Q, RP, V = regs(qp, 0), regs(rp, 0), regs(valid, False)
    slot = np.arange(S * LANES).reshape(S, LANES)
    F = np.full((R, S, LANES), NEG, np.int64)
    P = np.full((R, S, LANES), -1, np.int64)

    last = np.full(R, -1)
    for s in range(S):          # one ballot per register
        bal = V[:, s, :]
        hi = LANES - 1 - np.argmax(bal[:, ::-1], axis=1)
        last = np.where(bal.any(axis=1), s * LANES + hi, last)

    steps = np.zeros(R, np.int64)
    for i in range(int(last.max(initial=-1)) + 1):
        live = (i <= last) & valid[:, i]      # the same on every lane
        if not live.any():
            continue
        steps += live
        qi, ri = qp[:, i, None], rp[:, i, None]
        lbest = np.full((R, LANES), NEG, np.int64)
        lslot = np.full((R, LANES), NONE, np.int64)
        for s in range(S):
            if s * LANES >= i:
                break
            c = _candidate(qi, ri, Q[:, s], RP[:, s],
                           V[:, s] & (slot[s] < i), F[:, s], k, max_gap,
                           max_dd)
            better = c > lbest
            lbest = np.where(better, c, lbest)
            lslot = np.where(better, slot[s], lslot)
        wbest, wslot = _warp_argmax(lbest, lslot)
        extend = wbest > k
        rows = np.flatnonzero(live)
        F[rows, i // LANES, i % LANES] = np.where(extend, wbest, k)[rows]
        P[rows, i // LANES, i % LANES] = np.where(extend, wslot, -1)[rows]
    # Only valid slots up to the last one were stepped.
    assert (steps == valid.sum(axis=1)).all()

    inside = slot < A
    fbest = np.where(inside, F, NEG)
    lbest = np.full((R, LANES), NEG, np.int64)
    lslot = np.full((R, LANES), NONE, np.int64)
    for s in range(S):
        better = fbest[:, s] > lbest
        lbest = np.where(better, fbest[:, s], lbest)
        lslot = np.where(better, slot[s], lslot)
    _, end = _warp_argmax(lbest, lslot)

    f = F.reshape(R, -1)[:, :A]
    pred = P.reshape(R, -1)[:, :A]
    mask = np.zeros((R, A), bool)
    best = np.where(last < 0, -1, end)
    for row in range(R):
        cur = int(best[row])
        for _ in range(A):
            if cur < 0:
                break
            mask[row, cur] = True
            cur = int(pred[row, cur])
    return (f.astype(np.int32), pred.astype(np.int32), mask,
            best.astype(np.int32))


def _check(qp, rp, valid, *, k=13, max_gap=5000, max_dd=500):
    kw = dict(k=k, max_gap=max_gap, max_dd=max_dd)
    emu = warp_chain(qp, rp, valid, **kw)
    ref = [np.asarray(x) for x in _chain_batch_fn(k, max_gap, max_dd)(
        jnp.asarray(qp, jnp.int32), jnp.asarray(rp, jnp.int32),
        jnp.asarray(valid))]
    plain = [x.numpy() for x in port_chain.chain_padded_plain(
        torch.from_numpy(qp), torch.from_numpy(rp),
        torch.from_numpy(valid), **kw)]
    for name, a, b, c in zip(("f", "pred", "mask", "best"), emu, ref, plain):
        np.testing.assert_array_equal(a, b, err_msg=f"{name} vs JAX")
        np.testing.assert_array_equal(a, c, err_msg=f"{name} vs plain")
    return emu


def _random_sets(rng, A, R=16):
    """Prefix and non-prefix masks, an empty set, unsorted positions and
    sorted near-colinear runs (long chains)."""
    qp = np.zeros((R, A), np.int32)
    rp = np.zeros((R, A), np.int32)
    valid = np.zeros((R, A), bool)
    for row in range(R):
        kind = row % 4
        if kind == 0:           # prefix of random length, unsorted
            a = int(rng.integers(1, A + 1))
            valid[row, :a] = True
            qp[row] = rng.integers(0, 300, A)
            rp[row] = rng.integers(0, 600, A)
        elif kind == 1:         # non-prefix mask, unsorted
            valid[row] = rng.random(A) < 0.6
            qp[row] = rng.integers(0, 300, A)
            rp[row] = rng.integers(0, 600, A)
        elif kind == 2:         # a colinear run with noise, then padding
            a = int(rng.integers(1, A + 1))
            q = np.sort(rng.integers(0, 20 * A, a))
            qp[row, :a] = q
            rp[row, :a] = q + 1000 + rng.integers(-3, 4, a)
            valid[row, :a] = True
        # kind 3: no valid slot (a padding row)
    return qp, rp, valid


@pytest.mark.parametrize("A", [1, 31, 32, 33, 128, 200])
def test_warp_design_equals_jax_and_plain(A):
    rng = np.random.default_rng(100 + A)
    qp, rp, valid = _random_sets(rng, A)
    _, _, mask, best = _check(qp, rp, valid)
    assert (best[3::4] == -1).all() and not mask[3::4].any()
    assert (best[valid.any(axis=1)] >= 0).all()


def test_warp_design_forced_ties():
    """Equal candidates on different lanes and registers, one slot below
    another on a higher lane, equal endpoints, and a join worth exactly k
    (strict >: no extension)."""
    A = 128
    rows = []

    def row(anchors):
        qp = np.zeros(A, np.int32)
        rp = np.zeros(A, np.int32)
        valid = np.zeros(A, bool)
        for j, (q, r) in anchors.items():
            qp[j], rp[j], valid[j] = q, r, True
        rows.append((qp, rp, valid))

    tie, end = (10, 1000), (30, 1020)
    for ties, i in (((33, 70, 96), 120),   # lanes 1, 6, 0; registers 1-3
                    ((40, 72, 104), 110),  # lane 8, registers 1, 2, 3
                    ((64, 65, 90), 95),    # register 2, lanes 0, 1, 26
                    ((31, 32), 60)):       # lane 31 reg 0 before lane 0 reg 1
        row({**{j: tie for j in ties}, i: end})
    # Two equal chains on far-apart loci: the endpoint is the leftmost.
    row({2: (0, 100), 50: (20, 120), 34: (0, 90000), 82: (20, 90020)})
    # A join whose candidate is exactly k: dq 1, dr 4 -> gain 0.
    row({5: (0, 0), 9: (1, 4)})
    qp, rp, valid = (np.stack(x) for x in zip(*rows))
    f, pred, mask, best = _check(qp, rp, valid)
    assert [int(pred[r, i]) for r, i in ((0, 120), (1, 110), (2, 95),
                                         (3, 60))] == [33, 40, 64, 31]
    assert f[4, 50] == f[4, 82] and best[4] == 50
    assert pred[5, 9] == -1 and f[5, 9] == 13


def test_warp_design_gap_edges():
    """Joins at max_gap and max_dd exactly, and one past each."""
    max_gap, max_dd = 50, 7
    joins = [(50, 50), (51, 51), (43, 50), (42, 50), (50, 43), (50, 42),
             (0, 5), (5, 0), (1, 1), (50, 51)]
    A = 40
    qp = np.zeros((len(joins), A), np.int32)
    rp = np.zeros((len(joins), A), np.int32)
    valid = np.zeros((len(joins), A), bool)
    for r, (dq, dr) in enumerate(joins):
        qp[r, 3], rp[r, 3] = 100, 100
        qp[r, 36], rp[r, 36] = 100 + dq, 100 + dr
        valid[r, [3, 36]] = True
    _, pred, _, _ = _check(qp, rp, valid, max_gap=max_gap, max_dd=max_dd)
    assert pred[:, 36].tolist() == [3, -1, 3, -1, 3, -1, -1, -1, 3, -1]
    rng = np.random.default_rng(7)
    _check(*_random_sets(rng, 64), max_gap=max_gap, max_dd=max_dd)


def test_chain_padded_cuda_refuses_cpu_tensors():
    qp = torch.zeros((16, 128), dtype=torch.int32)
    valid = torch.ones((16, 128), dtype=torch.bool)
    launches = port_chain.chain_padded_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_chain.chain_padded_cuda(qp, qp, valid, k=13, max_gap=5000,
                                     max_dd=500)
    assert port_chain.chain_padded_cuda.launches == launches
