"""Affine-gap scoring configurations (paper §III-A2, §V-D).

The paper's convention (Gotoh / Suzuki-Kasahara / minimap2):
  * a match adds +A to the score,
  * a mismatch subtracts B,
  * a gap of length l subtracts (o + l*e)  — i.e. the first gap cell costs
    o+e and every extension costs e.

Difference-form value ranges (paper §III-B): after the Eq.(4) shift all
five wavefront quantities lie in [0, M + 2o + 2e] where M = A is the
maximum substitution score, so the required precision is
``ceil(log2(M + 2o + 2e + 1))`` bits, *independent of sequence length*.
With minimap2's defaults (A=2,B=4,o=4,e=2) that is 4 bits of magnitude
(the paper quotes 5 bits: 4 magnitude + headroom for the traceback flag
read-out); edit distance (A=0,B=1,o=0,e=1) needs 3 bits (paper §V-D2).
The port computes in int32 (and can carry the band as int8/int16, see
`core.banded`) — the *invariant* that the range is fixed and tiny is what
transfers (see DESIGN.md §6).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# Base encoding: A=0, C=1, G=2, T=3 (2-bit, paper §V-C1), N/pad = 4.
BASES = "ACGT"
PAD_BASE = 4


@dataclasses.dataclass(frozen=True)
class ScoringConfig:
    """Affine-gap scoring function.

    Attributes:
      match: A — score added for a match (>= 0).
      mismatch: B — penalty subtracted for a mismatch (>= 0).
      gap_open: o — penalty for opening a gap (>= 0).
      gap_extend: e — penalty per gap cell including the first (> 0).
      name: label used in benchmark output.
    """

    match: int = 2
    mismatch: int = 4
    gap_open: int = 4
    gap_extend: int = 2
    name: str = "minimap2"

    @property
    def M(self) -> int:
        """Maximum substitution score (paper's M)."""
        return self.match

    @property
    def shift(self) -> int:
        """The Eq.(4) non-negativity shift: 2o + 2e."""
        return 2 * (self.gap_open + self.gap_extend)

    @property
    def half_shift(self) -> int:
        """o + e, the per-matrix shift for dH'/dV'."""
        return self.gap_open + self.gap_extend

    @property
    def value_range(self) -> tuple[int, int]:
        """Inclusive range of all shifted wavefront quantities."""
        return (0, self.M + self.shift)

    @property
    def required_bits(self) -> int:
        """ceil(log2(M + 2o + 2e + 1)) — paper §III-B."""
        return max(1, math.ceil(math.log2(self.M + self.shift + 1)))

    @property
    def gap_first(self) -> int:
        """Cost of the first cell of a gap (o + e)."""
        return self.gap_open + self.gap_extend

    def substitution_scores(self) -> np.ndarray:
        """(5, 5) substitution score table over {A,C,G,T,N}.

        N (=4) scores as a mismatch against everything, including itself,
        mirroring minimap2's ambiguous-base handling.
        """
        tbl = np.full((5, 5), -self.mismatch, dtype=np.int32)
        for i in range(4):
            tbl[i, i] = self.match
        return tbl

    def substitution(self, q, r):
        """Vectorised substitution score for encoded base tensors q, r
        (int32 tensor on their device)."""
        q = torch.as_tensor(q)
        r = torch.as_tensor(r, device=q.device)
        match = (q == r) & (q < 4) & (r < 4)
        return torch.where(match, self.match, -self.mismatch).to(torch.int32)


#: minimap2 default scoring (paper §V-D1, used in Table V and all accuracy
#: experiments): A=2, B=4, o=4, e=2  ->  4-bit magnitude, "5-bit PIM".
MINIMAP2 = ScoringConfig(2, 4, 4, 2, name="minimap2")

#: BWA-MEM scoring (paper §V-D1): A=1, B=4, o=6, e=1.
BWA_MEM = ScoringConfig(1, 4, 6, 1, name="bwa-mem")

#: Edit distance (paper §V-D2): match 0, mismatch/open/extend 1 as a
#: maximisation of -distance. 3-bit PIM precision.
EDIT_DISTANCE = ScoringConfig(0, 1, 0, 1, name="edit-distance")

#: Linear gap penalty special case (paper §VI-F): o == 0.
LINEAR_GAP = ScoringConfig(2, 4, 0, 2, name="linear-gap")

#: Constant gap penalty special case (paper §VI-F): e == 0 is disallowed by
#: the e>0 requirement of the difference recurrence, so constant-gap is
#: approximated with e=1 ("discourages gap count, tolerates long gaps").
CONSTANT_GAP = ScoringConfig(2, 4, 6, 1, name="constant-gap")

PRESETS = {
    c.name: c for c in (MINIMAP2, BWA_MEM, EDIT_DISTANCE, LINEAR_GAP, CONSTANT_GAP)
}


def encode(seq: str) -> np.ndarray:
    """Encode an ACGT string to the 2-bit base alphabet (int8)."""
    lut = np.full(256, PAD_BASE, dtype=np.int8)
    for i, b in enumerate(BASES):
        lut[ord(b)] = i
        lut[ord(b.lower())] = i
    return lut[np.frombuffer(seq.encode(), dtype=np.uint8)]


def decode(arr) -> str:
    """Decode an encoded base array back to a string (pads become N)."""
    return "".join(BASES[int(v)] if 0 <= int(v) < 4 else "N" for v in np.asarray(arr))


def adaptive_bandwidth(length: int, base_bandwidth: int = 10, coeff: float = 0.01,
                       cap: int = 100) -> int:
    """Paper §IV-B1: B = min(w + 0.01 * L, 100), rounded up to a multiple of w.

    ``w`` is the base bandwidth (10 for short reads, 30 for long reads per
    §VI-B); the 0.01 coefficient and the 100 cap follow BWA-MEM's evidence
    that B=100 suffices for all lengths.
    """
    b = min(base_bandwidth + coeff * length, cap)
    # "B is set to the multiple of w" — round up to a multiple of w.
    mult = int(math.ceil(b / base_bandwidth))
    return int(min(mult * base_bandwidth, cap))
