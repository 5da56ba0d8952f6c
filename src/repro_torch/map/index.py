"""Minimizer index over a reference genome (the seeding stage).

The paper positions RAPIDx behind the seeding/filtering front half of a
read-mapping pipeline (Fig. 2(a)): seeding finds short exact matches
("anchors") between a read and the reference, chaining picks the
colinear subset, and only then does the banded aligner run — on one
candidate window per read instead of the whole genome. This module is
the seeding half: a (k, w)-minimizer index in the minimap2 family.

Minimizer scheme (robust winnowing): hash every k-mer of the sequence
with an invertible integer mixer (so poly-A runs don't all hash low),
then slide a w-wide window over the hashed k-mer sequence and keep each
window's minimum — the leftmost on ties, which makes the selection a
pure function of the sequence. Two properties the tests assert:

  * every selected (kmer, position) is a true substring occurrence, and
  * any two consecutive selected positions differ by at most w (window
    coverage — a read overlapping the reference by >= w + k - 1
    error-free bases shares at least one minimizer with the index).

Occurrence capping: k-mers occurring more than `max_occ` times in the
reference ("hot" k-mers — repeats, low-complexity runs) are kept in the
index but their position lists are withheld from `lookup`, which counts
them in `LookupResult.capped` instead. A read whose ONLY seeds were
capped is therefore distinguishable from a read with no seeds at all —
the mapper flags it (`status="seed_capped"`) rather than silently
dropping it (tests/test_mapper.py asserts this).

Everything here is host-side numpy (CSR over sorted arrays, searchsorted
lookups) — seeding is pointer-chasing, not DP; the accelerator work
starts at chaining (`repro_torch.map.chain`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: Default minimizer parameters: k=13 / w=8 resolves uniquely in random
#: genomes up to tens of Mb while staying sensitive at long-read error
#: rates (a clean stretch of k + w - 1 = 20 bases guarantees a shared
#: minimizer; see ERROR_PROFILES for per-profile survival rates).
DEFAULT_K = 13
DEFAULT_W = 8

#: Default occurrence cap: position lists longer than this are withheld
#: from lookups (hot k-mers contribute candidate sites everywhere and
#: drown the chainer; minimap2's -f works the same way by frequency).
DEFAULT_MAX_OCC = 64


def encode_kmers(seq: np.ndarray, k: int) -> np.ndarray:
    """Pack every k-mer of a 2-bit sequence into uint64 (big-endian in
    the base order: seq[i] is the high 2 bits of kmers[i]). Returns an
    empty array when the sequence is shorter than k."""
    seq = np.asarray(seq, np.uint64)
    if seq.size < k:
        return np.zeros(0, np.uint64)
    n = seq.size - k + 1
    out = np.zeros(n, np.uint64)
    for j in range(k):  # k is tiny; the vector dimension is n
        out = (out << np.uint64(2)) | seq[j:j + n]
    return out


def _mix64(x: np.ndarray) -> np.ndarray:
    """Invertible 64-bit finalizer (splitmix64's) — decorrelates the
    hash order from the lexicographic k-mer order so low-complexity
    k-mers are not systematically selected as minimizers."""
    x = np.asarray(x, np.uint64).copy()
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def minimizers(seq: np.ndarray, k: int = DEFAULT_K,
               w: int = DEFAULT_W) -> tuple[np.ndarray, np.ndarray]:
    """(kmer values, positions) of the (k, w)-minimizers of `seq`.

    Positions are sorted and unique; consecutive positions differ by at
    most w (window coverage). Sequences shorter than k yield nothing;
    sequences with fewer than w k-mers yield the single global minimum
    (one window, truncated).
    """
    kmers = encode_kmers(seq, k)
    if kmers.size == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    hashed = _mix64(kmers)
    w_eff = min(w, kmers.size)
    windows = np.lib.stride_tricks.sliding_window_view(hashed, w_eff)
    # argmin is leftmost-on-ties: the selection is deterministic and a
    # pure function of the sequence (required for read/reference
    # minimizer agreement).
    sel = np.unique(np.argmin(windows, axis=1)
                    + np.arange(windows.shape[0]))
    return kmers[sel], sel.astype(np.int64)


@dataclasses.dataclass
class LookupResult:
    """Candidate anchors for one read (one strand).

    q_pos/r_pos are parallel arrays: read minimizer at q_pos matched the
    reference k-mer starting at r_pos (genome coordinates). `capped` is
    the number of read minimizers whose reference position list was
    withheld by the occurrence cap; `total` the number of read
    minimizers queried. `capped == total > 0` with no anchors means the
    read's only seeds were hot — flagged, never silently dropped."""

    q_pos: np.ndarray  # (A,) int64 read positions
    r_pos: np.ndarray  # (A,) int64 reference positions
    capped: int
    total: int


class MinimizerIndex:
    """CSR minimizer index over one reference genome.

    Build once (`MinimizerIndex(genome, k=..., w=...)`), look up per
    read. Lookups return *all* occurrences of each shared minimizer
    (subject to the occurrence cap), sorted by reference position — the
    anchor list the chainer consumes.
    """

    def __init__(self, genome: np.ndarray, *, k: int = DEFAULT_K,
                 w: int = DEFAULT_W, max_occ: int = DEFAULT_MAX_OCC):
        if not 1 <= k <= 31:
            raise ValueError(f"k must be in [1, 31] (uint64 packing), "
                             f"got {k}")
        if w < 1:
            raise ValueError(f"w must be >= 1, got {w}")
        if max_occ < 1:
            raise ValueError(f"max_occ must be >= 1, got {max_occ}")
        self.genome = np.asarray(genome, np.int8)
        self.k, self.w, self.max_occ = k, w, max_occ
        vals, pos = minimizers(self.genome, k, w)
        order = np.argsort(vals, kind="stable")
        vals, pos = vals[order], pos[order]
        # CSR: unique k-mer values -> [start, end) into the position
        # array. Positions within a run are ascending (stable sort of an
        # ascending position sequence).
        self._keys, starts = np.unique(vals, return_index=True)
        self._starts = starts.astype(np.int64)
        self._ends = np.append(self._starts[1:], vals.size).astype(np.int64)
        self._pos = pos

    @property
    def num_minimizers(self) -> int:
        """Selected minimizer instances across the genome."""
        return int(self._pos.size)

    @property
    def num_hot(self) -> int:
        """Distinct k-mers whose occurrence list exceeds max_occ."""
        return int(np.sum(self._ends - self._starts > self.max_occ))

    def lookup(self, read: np.ndarray) -> LookupResult:
        """Anchors of `read` against the reference (forward strand of
        the read as given — callers probe the other strand by passing
        the reverse complement)."""
        qv, qp = minimizers(np.asarray(read, np.int8), self.k, self.w)
        idx = np.searchsorted(self._keys, qv)
        idx_c = np.minimum(idx, max(self._keys.size - 1, 0))
        hit = (self._keys.size > 0) & (self._keys[idx_c] == qv)
        counts = np.where(hit, self._ends[idx_c] - self._starts[idx_c], 0)
        capped = counts > self.max_occ
        take = hit & ~capped
        q_list, r_list = [], []
        for q, i in zip(qp[take], idx_c[take]):
            span = self._pos[self._starts[i]:self._ends[i]]
            q_list.append(np.full(span.size, q, np.int64))
            r_list.append(span)
        if q_list:
            q_pos = np.concatenate(q_list)
            r_pos = np.concatenate(r_list)
            order = np.lexsort((q_pos, r_pos))
            q_pos, r_pos = q_pos[order], r_pos[order]
        else:
            q_pos = np.zeros(0, np.int64)
            r_pos = np.zeros(0, np.int64)
        return LookupResult(q_pos=q_pos, r_pos=r_pos,
                            capped=int(np.sum(hit & capped)),
                            total=int(qv.size))


__all__ = ["MinimizerIndex", "LookupResult", "minimizers", "encode_kmers",
           "DEFAULT_K", "DEFAULT_W", "DEFAULT_MAX_OCC"]
