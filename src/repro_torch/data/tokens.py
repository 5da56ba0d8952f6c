"""Deterministic synthetic token pipeline for the LM architectures.

Real deployments would plug a tokenized corpus in here; for the framework's
tests, smoke runs and the end-to-end training example we need a stream that
is (a) deterministic given (seed, step) — so a restarted job replays
identically, which the fault-tolerance tests rely on — and (b) *learnable*,
so the quickstart training run shows a falling loss. We use a k-th order
Markov-ish stream: token[t] = (a * token[t-1] + b * token[t-2] + noise) mod V
with a small noise rate. A model with context can drive loss well below
log(V).

The pipeline is stateless per step: `batch(step)` derives everything from
(seed, step), which makes checkpoint-resume trivially exact and enables
straggler-tolerant re-issue of a step's data on another host.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    batch_size: int        # global batch
    seq_len: int
    seed: int = 0
    noise: float = 0.05

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Returns {'tokens': (B, S+1) int32} — shift for inputs/labels."""
        rng = np.random.default_rng((self.seed * 1_000_003 + step) & 0x7FFFFFFF)
        B, S, V = self.batch_size, self.seq_len + 1, self.vocab_size
        a, b = 6364136223846793005 % V or 1, 1442695040888963407 % V or 1
        toks = np.empty((B, S), dtype=np.int64)
        toks[:, 0] = rng.integers(0, V, B)
        toks[:, 1] = rng.integers(0, V, B)
        noise_mask = rng.random((B, S)) < self.noise
        noise_vals = rng.integers(0, V, (B, S))
        for t in range(2, S):
            nxt = (a * toks[:, t - 1] + b * toks[:, t - 2] + 17) % V
            toks[:, t] = np.where(noise_mask[:, t], noise_vals[:, t], nxt)
        return {"tokens": toks.astype(np.int32)}


def synthetic_batch_specs(batch_size: int, seq_len: int):
    """Shapes for input/label token batches (used by input_specs())."""
    return {
        "tokens": (batch_size, seq_len),
        "labels": (batch_size, seq_len),
    }
