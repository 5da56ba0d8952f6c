"""Difference-based DP alignment (paper Eq. (2)) and its parallelized,
shifted reformulation (paper Eq. (4)).

Eq. (2) stores the four difference matrices

    dH(i,j) = H(i,j) - H(i-1,j)        dV(i,j) = H(i,j) - H(i,j-1)
    dE(i,j) = E(i+1,j) - H(i,j)        dF(i,j) = F(i,j+1) - H(i,j)

whose ranges depend only on the scoring parameters, never on sequence
length — this is the paper's 32-bit -> 5-bit claim. Eq. (4) then shifts
everything to be non-negative and regroups terms so that, once the shared
intermediate A' is known, all four updates depend exclusively on
*previous-iteration* values:

    A'(i,j)  = max( s(i,j) + 2(o+e),  x'(i-1,j),  y'(i,j-1) )
    u'(i,j)  = A' - v'(i-1,j)                     # dH + (o+e)
    v'(i,j)  = A' - u'(i,j-1)                     # dV + (o+e)
    x'(i,j)  = max(A', x'(i-1,j) + o) - u'(i,j-1) # dE + dV + 2(o+e)
    y'(i,j)  = max(A', y'(i,j-1) + o) - v'(i-1,j) # dF + dH + 2(o+e)

(u', v', x', y' are the paper's dH', dV', dE', dF'; we derive the exact
index placement in DESIGN.md — the published equations carry an off-by-one
in the dE'/dF' definition that cancels once substituted.)

This module is the *clarity* implementation: an O(mn) cell-serial sweep in
numpy used to (a) prove Eq. (1) == Eq. (2) == Eq. (4) exactly on small
inputs and (b) assert the bit-width invariants. The production wavefront
lives in `core.banded` (the plain PyTorch version) and `kernels.banded_dp`
(the CUDA kernels).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.full_dp import NEG_INF
from repro_torch.core.scoring import ScoringConfig


@dataclasses.dataclass
class DiffDPResult:
    score: int
    H: np.ndarray          # reconstructed score matrix (int64)
    aprime: np.ndarray     # A' matrix (shifted); for range property tests
    uprime: np.ndarray     # dH' = dH + (o+e)
    vprime: np.ndarray     # dV' = dV + (o+e)
    xprime: np.ndarray     # dE' combined term
    yprime: np.ndarray     # dF' combined term


def diff_dp(query, reference, sc: ScoringConfig) -> DiffDPResult:
    """Cell-serial Eq. (4) sweep over the full (n+1) x (m+1) grid.

    Boundary cells (row 0 / column 0) take the analytically derived
    constants (see `core.banded` for the derivation); interior cells use
    the shifted parallelized update. H is reconstructed incrementally with
    the paper's step 5 (one small-int subtraction + one wide addition) and
    must match Eq. (1) exactly.
    """
    q = np.asarray(query, dtype=np.int64)
    r = np.asarray(reference, dtype=np.int64)
    n, m = len(q), len(r)
    o, e = sc.gap_open, sc.gap_extend
    oe = o + e
    shift = 2 * oe
    sub = sc.substitution_scores()

    shp = (n + 1, m + 1)
    A = np.zeros(shp, dtype=np.int64)
    U = np.zeros(shp, dtype=np.int64)   # u' (dH')
    V = np.zeros(shp, dtype=np.int64)   # v' (dV')
    X = np.zeros(shp, dtype=np.int64)   # x' (dE')
    Y = np.zeros(shp, dtype=np.int64)   # y' (dF')
    H = np.full(shp, NEG_INF, dtype=np.int64)

    # Boundary constants (derived in DESIGN.md / core.banded):
    #   row 0:  v'(0,j) = x'(0,j) = 0 if j == 1 else o;  H(0,j) = -(o + j e)
    #   col 0:  u'(i,0) = y'(i,0) = 0 if i == 1 else o;  H(i,0) = -(o + i e)
    H[0, 0] = 0
    for j in range(1, m + 1):
        V[0, j] = X[0, j] = 0 if j == 1 else o
        U[0, j] = Y[0, j] = o  # unused by interior cells; any value works
        H[0, j] = -(o + j * e)
    for i in range(1, n + 1):
        U[i, 0] = Y[i, 0] = 0 if i == 1 else o
        V[i, 0] = X[i, 0] = o
        H[i, 0] = -(o + i * e)

    for i in range(1, n + 1):
        for j in range(1, m + 1):
            s = int(sub[q[i - 1], r[j - 1]])
            a = max(s + shift, X[i - 1, j], Y[i, j - 1])
            A[i, j] = a
            U[i, j] = a - V[i - 1, j]
            V[i, j] = a - U[i, j - 1]
            X[i, j] = max(a, X[i - 1, j] + o) - U[i, j - 1]
            Y[i, j] = max(a, Y[i, j - 1] + o) - V[i - 1, j]
            # Paper §V-C1 step 5: H(i,j) = H(i-1,j) + dH = H_up + u' - (o+e).
            H[i, j] = H[i - 1, j] + U[i, j] - oe

    return DiffDPResult(score=int(H[n, m]), H=H, aprime=A, uprime=U,
                        vprime=V, xprime=X, yprime=Y)


def range_report(res: DiffDPResult, sc: ScoringConfig) -> dict:
    """Observed ranges of the shifted quantities over *interior* cells.

    The paper's precision claim: every shifted quantity lies in
    [0, M + 2o + 2e], hence ceil(log2(M+2o+2e+1)) bits suffice regardless
    of sequence length. Held against the JAX package's by
    tests/test_torch_edit_distance.py.
    """
    interior = np.s_[1:, 1:]
    quantities = {
        "A'": res.aprime[interior],
        "dH'": res.uprime[interior],
        "dV'": res.vprime[interior],
        "dE'": res.xprime[interior],
        "dF'": res.yprime[interior],
    }
    lo, hi = sc.value_range
    out = {}
    for name, arr in quantities.items():
        out[name] = dict(min=int(arr.min()), max=int(arr.max()),
                         within=bool((arr >= lo).all() and (arr <= hi).all()))
    out["allowed"] = dict(min=lo, max=hi, bits=sc.required_bits)
    return out


def serial_eq2(query, reference, sc: ScoringConfig) -> int:
    """Literal Eq. (2) (unshifted, serial) — the 'Banded Difference-based
    DP' row of Table I, included to demonstrate its doubled critical path.

    Updates dH, dV, dE, dF in their *dependent* order: A -> dH -> dV ->
    dE/dF, each needing the freshly computed predecessor.
    """
    q = np.asarray(query, dtype=np.int64)
    r = np.asarray(reference, dtype=np.int64)
    n, m = len(q), len(r)
    o, e = sc.gap_open, sc.gap_extend
    oe = o + e
    sub = sc.substitution_scores()

    shp = (n + 1, m + 1)
    dH = np.zeros(shp, dtype=np.int64)
    dV = np.zeros(shp, dtype=np.int64)
    dE = np.zeros(shp, dtype=np.int64)
    dF = np.zeros(shp, dtype=np.int64)
    H = np.full(shp, NEG_INF, dtype=np.int64)

    H[0, 0] = 0
    for j in range(1, m + 1):
        dV[0, j] = -oe if j == 1 else -e
        dE[0, j] = -oe
        H[0, j] = -(o + j * e)
    for i in range(1, n + 1):
        dH[i, 0] = -oe if i == 1 else -e
        dF[i, 0] = -oe
        H[i, 0] = -(o + i * e)

    for i in range(1, n + 1):
        for j in range(1, m + 1):
            s = int(sub[q[i - 1], r[j - 1]])
            # Eq. (2): serial chain A -> dH -> dV -> dE -> dF.
            a = max(s, dE[i - 1, j] + dV[i - 1, j], dF[i, j - 1] + dH[i, j - 1])
            dH[i, j] = a - dV[i - 1, j]
            dV[i, j] = a - dH[i, j - 1]
            dE[i, j] = max(-o, dE[i - 1, j] - dH[i, j]) - e
            dF[i, j] = max(-o, dF[i, j - 1] - dV[i, j]) - e
            H[i, j] = H[i - 1, j] + dH[i, j]

    return int(H[n, m])
