"""ReadMapper — seed → chain → align, fed into the AlignmentService.

The front half the paper assumes exists (Fig. 2(a): RAPIDx is "a
co-processor integrated into existing genome analysis pipelines"): for
each read,

  1. **seed** — minimizer lookup against the reference index, both
     strands (`repro_torch.map.index`; hot k-mers occurrence-capped, with
     the capped-only-seed case flagged rather than dropped),
  2. **chain** — one launch of the chaining kernel over every read's
     anchor lists picks colinear candidate chains
     (`repro_torch.map.chain`), each projecting a candidate reference
     window,
  3. **align** — the top candidate windows become banded semiglobal
     alignment requests submitted to an `AlignmentService` (or
     `AlignmentRouter` — same surface), primary candidates at normal
     priority, rescue candidates as bulk; X-drop on the engine retires
     junk candidates on-device, and
  4. **report** — results scatter back per read: the best candidate's
     chain-projected locus and strand, its alignment score, and a
     mapping quality from the best-vs-second-best alignment score margin
     (minimap2-style, integer arithmetic).

The mapper generates exactly the skewed, bursty traffic the serving
layer was built for: per-read candidate counts vary (0-2+), length
classes mix (read vs window geometry), and hot reference regions
concentrate load — the DiMSA thesis that end-to-end throughput is set
by how well this pipeline keeps the accelerator fed.

Determinism: seeding and chaining are pure functions of the read and
index; alignment scores are bit-identical across engine backends and
dispatch modes (the repo's core contract); and all ranking/tie-breaking
below is integer arithmetic with total orders — so `map_batch` output
is bit-identical across `backend=reference|cuda` and
`dispatch=pipelined|persistent`, and equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.data.genome import reverse_complement
from repro_torch.map.chain import (Chain, ChainParams, chain_batch,
                                   top_chains)
from repro_torch.map.index import MinimizerIndex

#: MapResult.status values.
STATUS_MAPPED = "mapped"
STATUS_UNMAPPED = "unmapped"        # no candidate survived (or none found)
STATUS_SEED_CAPPED = "seed_capped"  # every seed hit an occurrence-capped
#                                     hot k-mer: flagged, not silent


@dataclasses.dataclass
class MapResult:
    """Per-read mapping report.

    ref_start is the chain-projected locus on the forward reference
    (the first chain anchor's diagonal), comparable to the simulator's
    truth locus within the alignment band. score/second_score are
    banded-alignment scores (second_score = 0 when only one candidate
    existed); mapq is the minimap2-style margin quality in [0, 60].
    `window` is the aligned candidate's reference slice [lo, hi) and
    `band` the alignment band it ran under — the accuracy harness's
    ±band tolerance. `cigar` is populated when the service collects
    tracebacks."""

    status: str
    strand: int = 0
    ref_start: int = -1
    score: int = 0
    second_score: int = 0
    mapq: int = 0
    chain_score: int = 0
    band: int = 0
    window: tuple[int, int] = (0, 0)
    n_candidates: int = 0
    cigar: object = None


@dataclasses.dataclass
class _Candidate:
    chain: Chain
    strand: int
    wlo: int = 0
    whi: int = 0
    future: object = None


def _mapq(s1: int, s2: int, n_candidates: int) -> int:
    """Best-vs-second-best mapping quality (integer minimap2 flavour):
    60 for an uncontested hit, else 40 * margin fraction san-clamped
    into [0, 60]."""
    if n_candidates <= 1:
        return 60
    margin = max(s1 - max(s2, 0), 0)
    return min(60, (60 * margin) // max(s1, 1))


class ReadMapper:
    """Maps reads against a `MinimizerIndex` through an alignment
    service.

    Args:
      index: the reference minimizer index (owns the genome array).
      service: an `AlignmentService` or `AlignmentRouter` constructed
        with `mode="semiglobal"` over that same reference's engine
        config — semiglobal scoring (free reference end gaps) is what
        "locate a read inside a padded window" means. The mapper only
        submits; service policy/priorities/backpressure all apply.
      chain_params: chaining configuration; None derives k from the
        index and keeps the defaults.
      max_candidates: candidate windows aligned per read (best vs
        second-best reporting needs >= 2).
      window_pad: reference bases added on each side of the
        chain-projected window before alignment (start slack; the free
        semiglobal end gaps absorb it).
      min_sep: minimum reference separation for a distinct secondary
        chain (same-locus re-discoveries are the same candidate).
      both_strands: probe the reverse complement too (on by default;
        strand truth comes from `ReadSimulator(rc_prob=...)`).
      priorities: (primary, rescue) SLA classes for submitted
        alignments.
      device: where chaining runs; None = `service.device` (a router's:
        its first replica's engine's), the card unless the engine was
        built for the CPU.
    """

    def __init__(self, index: MinimizerIndex, service, *,
                 chain_params: ChainParams | None = None,
                 max_candidates: int = 2, window_pad: int = 16,
                 min_sep: int = 100, both_strands: bool = True,
                 priorities: tuple[str, str] = ("normal", "bulk"),
                 device=None):
        if max_candidates < 1:
            raise ValueError(f"max_candidates must be >= 1, "
                             f"got {max_candidates}")
        svc_mode = getattr(service, "mode", None)
        if svc_mode is not None and svc_mode != "semiglobal":
            raise ValueError(
                f"ReadMapper needs a semiglobal service (free reference "
                f"end gaps locate the read inside its padded window); "
                f"got mode={svc_mode!r}")
        self.index = index
        self.service = service
        self.params = chain_params or ChainParams(k=index.k)
        self.max_candidates = max_candidates
        self.window_pad = window_pad
        self.min_sep = min_sep
        self.both_strands = both_strands
        self.priorities = priorities
        self.collect_tb = bool(getattr(service, "collect_tb", False))
        self.device = device if device is not None else service.device

    # ------------------------------------------------------------------
    # Pipeline stages.
    # ------------------------------------------------------------------
    def _seed(self, reads):
        """Stage 1: per-read, per-strand anchor lookups. Returns
        (lookups, per-read capped/total counters); lookups is a flat
        list of LookupResults, strand-major per read."""
        lookups, flags = [], []
        for read in reads:
            probes = [self.index.lookup(read)]
            if self.both_strands:
                probes.append(self.index.lookup(reverse_complement(read)))
            lookups.append(probes)
            flags.append((sum(p.capped for p in probes),
                          sum(p.total for p in probes)))
        return lookups, flags

    def _chain(self, lookups):
        """Stage 2: ONE chaining launch over every (read, strand) anchor
        list, then per-read top-chain extraction. Returns per-read
        candidate lists sorted best-first under a total order."""
        flat = [(p.q_pos, p.r_pos) for probes in lookups for p in probes]
        chained = chain_batch(flat, self.params, device=self.device)
        out, pos = [], 0
        for probes in lookups:
            cands = []
            for strand, probe in enumerate(probes):
                for chain in top_chains(
                        probe.q_pos, probe.r_pos, chained[pos],
                        max_chains=self.max_candidates,
                        min_sep=self.min_sep,
                        cap=self.params.anchors_cap):
                    cands.append(_Candidate(chain=chain, strand=strand))
                pos += 1
            # Total order: score desc, then strand, then locus — the
            # ranking (and therefore every MapResult) is reproducible.
            cands.sort(key=lambda c: (-c.chain.score, c.strand,
                                      c.chain.diag_start))
            out.append(cands[:self.max_candidates])
        return out

    def _submit(self, read, cand: _Candidate, rank: int):
        """Stage 3: turn one candidate chain into a banded semiglobal
        alignment request against its projected window. Project the
        full read span onto the reference through the chain's end
        anchors, then pad: the semiglobal free end gaps eat the slack,
        the band only has to absorb indel drift *between* anchors."""
        chain = cand.chain
        wlo = int(chain.r_pos[0] - chain.q_pos[0]) - self.window_pad
        whi = int(chain.r_pos[-1] + (len(read) - chain.q_pos[-1])
                  + self.params.k + self.window_pad)
        cand.wlo = max(wlo, 0)
        cand.whi = min(whi, len(self.index.genome))
        oriented = read if cand.strand == 0 else reverse_complement(read)
        prio = self.priorities[0] if rank == 0 else self.priorities[1]
        cand.future = self.service.submit(
            oriented, self.index.genome[cand.wlo:cand.whi], priority=prio)

    # ------------------------------------------------------------------
    # Client API.
    # ------------------------------------------------------------------
    def map_batch(self, reads, *, stats: dict | None = None
                  ) -> list[MapResult]:
        """Map a batch of reads; returns one `MapResult` per read, in
        order. All candidates of all reads are submitted before any
        result is awaited, so the service micro-batches across the whole
        batch (that is the point of the service). With `stats`, records
        the host-clock seconds of each stage ('seed_s', 'chain_s',
        'align_s': submit to the last result)."""
        reads = [np.asarray(r, np.int8) for r in reads]
        t0 = time.perf_counter()
        lookups, flags = self._seed(reads)
        t1 = time.perf_counter()
        per_read = self._chain(lookups)
        t2 = time.perf_counter()

        for read, cands in zip(reads, per_read):
            for rank, cand in enumerate(cands):
                self._submit(read, cand, rank)

        results = []
        for read, cands, (capped, total) in zip(reads, per_read, flags):
            if not cands:
                status = (STATUS_SEED_CAPPED if capped > 0 and capped == total
                          else STATUS_UNMAPPED)
                results.append(MapResult(status=status))
                continue
            scored = []
            for cand in cands:
                res = cand.future.result()
                ok = int(res["status"]) == 0  # xdrop may retire a junk
                #   candidate on-device; it then scores like no hit
                score = int(res["best_score"]) if ok else None
                scored.append((score, cand, res))
            alive = [(s, c, r) for s, c, r in scored if s is not None]
            if not alive:
                results.append(MapResult(status=STATUS_UNMAPPED,
                                         n_candidates=len(cands)))
                continue
            alive.sort(key=lambda t: (-t[0], t[1].strand,
                                      t[1].chain.diag_start))
            s1, best, res = alive[0]
            s2 = alive[1][0] if len(alive) > 1 else 0
            results.append(MapResult(
                status=STATUS_MAPPED, strand=best.strand,
                ref_start=max(best.chain.diag_start, 0),
                score=s1, second_score=s2,
                mapq=_mapq(s1, s2, len(alive)),
                chain_score=best.chain.score,
                band=int(res["band"]),
                window=(best.wlo, best.whi),
                n_candidates=len(cands),
                cigar=res.get("cigar") if self.collect_tb else None))
        if stats is not None:
            stats.update(seed_s=t1 - t0, chain_s=t2 - t1,
                         align_s=time.perf_counter() - t2)
        return results


__all__ = ["ReadMapper", "MapResult", "STATUS_MAPPED", "STATUS_UNMAPPED",
           "STATUS_SEED_CAPPED"]
