"""Synthetic genome + read simulator (paper §VI-A "Datasets").

The paper generates long reads with PBSIM (PacBio 15% / ONT_2D 30% total
error) and short reads with Mason (Illumina 5%), against GRCh38. Offline we
reproduce the *error model*: a random (or seeded) reference genome, reads
sampled at random loci, then substitutions / insertions / deletions applied
at the Table II rates. The output is (reference window, corrupted read)
pairs — exactly what the alignment phase of the pipeline consumes after
seeding/filtering (paper Fig. 2(a); seeding is upstream of RAPIDx's scope).

Every sampled read also carries its **ground truth**: the genome locus it
was drawn from and the strand it was read on. The truth labels never feed
the aligner — they exist so the end-to-end mapping accuracy harness
can score a read mapper against the loci
the simulator actually used, the way real mapper papers validate against
simulated reads.

Deterministic given a seed — required for reproducible accuracy tables and
for the fault-tolerance tests (a restarted pipeline must replay the same
stream).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Table II of the paper: per-base error rates.
ERROR_PROFILES: dict[str, dict[str, float]] = {
    "pacbio":   {"sub": 0.015, "ins": 0.090, "del": 0.045},  # 15% total
    "ont_2d":   {"sub": 0.165, "ins": 0.050, "del": 0.085},  # 30% total
    "illumina": {"sub": 0.030, "ins": 0.010, "del": 0.010},  # 5% total
}


def random_genome(length: int, seed: int = 0) -> np.ndarray:
    """A uniform random genome in the 2-bit alphabet (int8)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=length, dtype=np.int8)


def reverse_complement(seq: np.ndarray) -> np.ndarray:
    """Reverse complement in the 2-bit alphabet (A=0,C=1,G=2,T=3:
    complement is 3 - base)."""
    return (3 - np.asarray(seq, np.int8))[::-1].copy()


@dataclasses.dataclass
class SimulatedRead:
    """One simulated read plus its ground truth.

    `ref` is the true source window of the *forward* genome and `locus`
    its start position; `strand` is 0 when the read was taken forward,
    1 when the corrupted copy was reverse-complemented (the read then
    still maps to `locus` on the forward reference). Iteration yields
    the legacy `(ref, read)` tuple so existing callers' two-element
    unpacking keeps working; the truth labels ride along as attributes.
    """

    ref: np.ndarray
    read: np.ndarray
    locus: int
    strand: int = 0

    def __iter__(self):
        # Legacy tuple shape: `ref, read = sim.sample(L)`.
        yield self.ref
        yield self.read


@dataclasses.dataclass
class ReadSimulator:
    """Samples reads from a reference and corrupts them per an error profile.

    Mirrors PBSIM's CLR mode at the fidelity the paper's experiments need:
    i.i.d. per-base substitution / insertion / deletion events at the given
    rates (PBSIM's default profile is approximately uniform over the read).

    `rc_prob` turns on strand simulation: with that probability the
    corrupted read is reverse-complemented before being returned (the
    truth `strand` flips to 1, the truth `locus` stays the forward-genome
    window start). Default 0.0 keeps the legacy forward-only stream.
    """

    genome: np.ndarray
    profile: str = "illumina"
    seed: int = 0
    rc_prob: float = 0.0

    def __post_init__(self):
        if self.profile not in ERROR_PROFILES:
            raise ValueError(f"unknown profile {self.profile!r}; "
                             f"choose from {sorted(ERROR_PROFILES)}")
        if not 0.0 <= self.rc_prob <= 1.0:
            raise ValueError(f"rc_prob must be in [0, 1], "
                             f"got {self.rc_prob!r}")
        self._rng = np.random.default_rng(self.seed)

    def sample(self, read_len: int, *, start: int | None = None
               ) -> SimulatedRead:
        """Returns a `SimulatedRead` — unpacks as the legacy
        (reference_window, read) tuple and carries `.locus`/`.strand`
        ground truth.

        The reference window is the true source span; the read is the
        corrupted copy (its length varies around read_len because of
        indels, as with a real sequencer). `start` pins the sampling
        locus (traffic-shaping hook: hot-region benchmarks draw skewed
        loci themselves); the RNG consumption order is identical either
        way, so a pinned-locus stream replays the same error events.
        """
        rng = self._rng
        rates = ERROR_PROFILES[self.profile]
        drawn = int(rng.integers(0, len(self.genome) - read_len))
        if start is None:
            start = drawn
        start = int(np.clip(start, 0, len(self.genome) - read_len))
        ref = self.genome[start:start + read_len].copy()

        out = []
        for base in ref:
            roll = rng.random()
            if roll < rates["del"]:
                continue  # deletion: base dropped from the read
            if roll < rates["del"] + rates["ins"]:
                out.append(int(rng.integers(0, 4)))  # inserted base
                out.append(int(base))
                continue
            if roll < rates["del"] + rates["ins"] + rates["sub"]:
                out.append(int((base + 1 + rng.integers(0, 3)) % 4))  # sub
                continue
            out.append(int(base))
        read = np.asarray(out, dtype=np.int8)
        if read.size == 0:  # pathological corner at tiny read_len
            read = np.asarray([int(rng.integers(0, 4))], dtype=np.int8)
        strand = 0
        if self.rc_prob > 0.0 and rng.random() < self.rc_prob:
            read = reverse_complement(read)
            strand = 1
        return SimulatedRead(ref=ref, read=read, locus=start, strand=strand)


def simulate_read_pairs(num_pairs: int, read_len: int, profile: str,
                        seed: int = 0, genome_len: int | None = None,
                        return_truth: bool = False):
    """Batch helper: returns padded arrays + true lengths.

    Returns:
      q_pad: (num_pairs, q_max) int8 reads (padded with 4).
      r_pad: (num_pairs, r_max) int8 reference windows.
      n: (num_pairs,) int32 read lengths.
      m: (num_pairs,) int32 window lengths.
      loci: (num_pairs,) int64 true sampling loci — only with
        `return_truth=True` (the mapper accuracy harness's labels;
        strands are all 0 here, `ReadSimulator(rc_prob=...)` is the
        strand-simulation entry point).
    """
    genome_len = genome_len or max(read_len * 8, 100_000)
    sim = ReadSimulator(random_genome(genome_len, seed=seed ^ 0x9E3779B9),
                        profile=profile, seed=seed)
    refs, reads, loci = [], [], []
    for _ in range(num_pairs):
        sr = sim.sample(read_len)
        refs.append(sr.ref)
        reads.append(sr.read)
        loci.append(sr.locus)
    n = np.asarray([len(x) for x in reads], dtype=np.int32)
    m = np.asarray([len(x) for x in refs], dtype=np.int32)
    q_max = int(n.max())
    r_max = int(m.max())
    q_pad = np.full((num_pairs, q_max), 4, dtype=np.int8)
    r_pad = np.full((num_pairs, r_max), 4, dtype=np.int8)
    for idx, (read, ref) in enumerate(zip(reads, refs)):
        q_pad[idx, :len(read)] = read
        r_pad[idx, :len(ref)] = ref
    if return_truth:
        return q_pad, r_pad, n, m, np.asarray(loci, dtype=np.int64)
    return q_pad, r_pad, n, m
