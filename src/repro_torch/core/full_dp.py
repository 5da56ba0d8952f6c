"""Full dynamic-programming alignment with affine gaps (paper Eq. (1)).

This is the framework's *oracle*: the exact O(mn) Gotoh algorithm the paper
uses as ground truth ("The alignment results of original DP with affine gap
penalty in Eq (1) are regarded as the ground truth", §VI-B). Everything else
(the adaptive banded parallelized DP and its CUDA kernel) is
validated against this module.

Implementation notes
--------------------
The naive recurrence is sequential along a row because the horizontal-gap
matrix F depends on H of the *same* row. We vectorise each row with the
closed form

    F(i,j) = max_{0<=k<j} ( G^(i,k) - (o+e) - (j-1-k) * e )

where ``G^(i,k)`` is the row value excluding the F arm (opening a gap from an
F cell is always dominated by extending it, because o >= 0). With
``P(k) = G^(i,k) + k*e`` this is a running maximum — ``np.maximum.accumulate``
— so the oracle is exact *and* fast enough to ground-truth millions of cells.

Conventions (match `core.scoring`): match +A, mismatch -B, gap of length l
costs o + l*e. H has shape (n+1, m+1); row/column 0 are the global-alignment
boundaries; i indexes the query Q (vertical), j the reference R (horizontal).
A vertical step (i-1 -> i) consumes a query base only (CIGAR 'I'); a
horizontal step consumes a reference base only (CIGAR 'D').
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.scoring import ScoringConfig

NEG_INF = -(1 << 28)  # "minus infinity" that never overflows int32 arithmetic


@dataclasses.dataclass
class FullDPResult:
    score: int
    H: np.ndarray  # (n+1, m+1) int32
    E: np.ndarray  # vertical-gap matrix
    F: np.ndarray  # horizontal-gap matrix
    mode: str = "global"
    end: tuple[int, int] | None = None  # best cell for local mode


def full_dp_matrices(query: np.ndarray, reference: np.ndarray,
                     sc: ScoringConfig, mode: str = "global") -> FullDPResult:
    """Exact affine-gap DP. Returns all three score matrices.

    Args:
      query: (n,) encoded bases (0..3, 4=N).
      reference: (m,) encoded bases.
      sc: scoring config.
      mode: "global" (Needleman-Wunsch) or "local" (Smith-Waterman).
    """
    q = np.asarray(query, dtype=np.int64)
    r = np.asarray(reference, dtype=np.int64)
    n, m = len(q), len(r)
    o, e = sc.gap_open, sc.gap_extend
    oe = o + e
    is_local = mode == "local"
    is_semi = mode == "semiglobal"  # free gaps at reference start/end

    sub = sc.substitution_scores()  # (5,5)
    H = np.full((n + 1, m + 1), NEG_INF, dtype=np.int64)
    E = np.full((n + 1, m + 1), NEG_INF, dtype=np.int64)
    F = np.full((n + 1, m + 1), NEG_INF, dtype=np.int64)

    js = np.arange(m + 1, dtype=np.int64)
    if is_local:
        H[0, :] = 0
        H[:, 0] = 0
    elif is_semi:
        H[0, :] = 0  # the read may start anywhere in the window
        H[1:, 0] = -(o + np.arange(1, n + 1, dtype=np.int64) * e)
    else:
        H[0, 0] = 0
        H[0, 1:] = -(o + js[1:] * e)

    for i in range(1, n + 1):
        hprev = H[i - 1]
        # Vertical gap: depends on row i-1 only.
        erow = np.maximum(hprev - oe, E[i - 1] - e)
        # All arms except F.
        srow = sub[q[i - 1], np.clip(r, 0, 4)]
        grow = np.full(m + 1, NEG_INF, dtype=np.int64)
        grow[1:] = np.maximum(hprev[:-1] + srow, erow[1:])
        # Row boundary (column 0).
        h0 = 0 if is_local else -(o + i * e)
        if is_local:
            grow = np.maximum(grow, 0)
        # Closed-form F via running max of P(k) = G^(i,k) + k*e.
        ghat = grow.copy()
        ghat[0] = h0
        P = ghat + js * e
        runmax = np.maximum.accumulate(P)
        frow = np.full(m + 1, NEG_INF, dtype=np.int64)
        frow[1:] = runmax[:-1] - oe - (js[1:] - 1) * e
        hrow = np.maximum(grow, frow)
        hrow[0] = h0
        if is_local:
            hrow = np.maximum(hrow, 0)
        erow[0] = np.maximum(hprev[0] - oe, E[i - 1, 0] - e)
        H[i], E[i], F[i] = hrow, erow, frow

    if is_local:
        flat = int(np.argmax(H))
        end = (flat // (m + 1), flat % (m + 1))
        score = int(H[end])
    elif is_semi:
        end = (n, int(np.argmax(H[n])))  # read fully consumed, window free
        score = int(H[end])
    else:
        end = (n, m)
        score = int(H[n, m])
    return FullDPResult(score=score, H=H.astype(np.int64), E=E, F=F,
                        mode=mode, end=end)


def full_dp_score(query, reference, sc: ScoringConfig,
                  mode: str = "global") -> int:
    """Optimal alignment score only."""
    return full_dp_matrices(query, reference, sc, mode).score


def traceback_full(res: FullDPResult, query, reference,
                   sc: ScoringConfig) -> list[tuple[str, int]]:
    """Exact affine traceback from the stored H/E/F matrices.

    Returns a CIGAR as (op, run-length) tuples with ops in {'M','I','D'}
    ('M' covers both match and mismatch, as in SAM).
    """
    q = np.asarray(query)
    r = np.asarray(reference)
    sub = sc.substitution_scores()
    o, e = sc.gap_open, sc.gap_extend
    oe = o + e
    H, E, F = res.H, res.E, res.F
    i, j = res.end
    ops: list[str] = []
    state = "M"
    while i > 0 or j > 0:
        if res.mode == "local" and state == "M" and H[i, j] == 0:
            break
        if res.mode == "semiglobal" and i == 0:
            break  # free leading reference gap (soft clip, not deletion)
        if i == 0:
            ops.append("D")
            j -= 1
            continue
        if j == 0:
            ops.append("I")
            i -= 1
            continue
        if state == "M":
            if H[i, j] == H[i - 1, j - 1] + sub[q[i - 1], r[j - 1]]:
                ops.append("M")
                i -= 1
                j -= 1
            elif H[i, j] == E[i, j]:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            ops.append("I")
            if E[i, j] == E[i - 1, j] - e:
                pass  # stay in E (gap extension)
            else:
                assert E[i, j] == H[i - 1, j] - oe
                state = "M"
            i -= 1
        else:  # state == "F"
            ops.append("D")
            if F[i, j] == F[i, j - 1] - e:
                pass
            else:
                assert F[i, j] == H[i, j - 1] - oe
                state = "M"
            j -= 1
    ops.reverse()
    # Run-length encode.
    cigar: list[tuple[str, int]] = []
    for op in ops:
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + 1)
        else:
            cigar.append((op, 1))
    return cigar


def cigar_score(cigar: list[tuple[str, int]], query, reference,
                sc: ScoringConfig) -> int:
    """Score an alignment path — used to cross-check tracebacks."""
    q = np.asarray(query)
    r = np.asarray(reference)
    sub = sc.substitution_scores()
    i = j = 0
    score = 0
    for op, ln in cigar:
        if op == "M":
            for _ in range(ln):
                score += int(sub[q[i], r[j]])
                i += 1
                j += 1
        elif op == "I":
            score -= sc.gap_open + ln * sc.gap_extend
            i += ln
        elif op == "D":
            score -= sc.gap_open + ln * sc.gap_extend
            j += ln
        else:
            raise ValueError(f"bad op {op}")
    return score


def full_dp_align(query, reference, sc: ScoringConfig,
                  mode: str = "global"):
    """Convenience: (score, cigar)."""
    res = full_dp_matrices(query, reference, sc, mode)
    return res.score, traceback_full(res, query, reference, sc)
