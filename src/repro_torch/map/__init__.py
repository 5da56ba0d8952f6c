"""Read-mapping front end: seed -> chain -> align.

The pipeline half the paper places *in front of* the accelerator
(Fig. 2(a)): `map.index` is the (k, w)-minimizer reference index with
occurrence-capped hot k-mers (numpy, on the host), `map.chain` the
minimap2-style anchor chaining (a CUDA kernel on the card), and
`map.ReadMapper` the front end that turns chains into banded semiglobal
requests against a `serve.AlignmentService` and reports per-read loci
with best-vs-second-best mapping quality. Accuracy is measured against
`data.genome.ReadSimulator`'s truth labels.
"""

from repro_torch.map.chain import Chain, ChainParams, chain_batch, top_chains
from repro_torch.map.index import LookupResult, MinimizerIndex, minimizers
from repro_torch.map.mapper import (MapResult, ReadMapper, STATUS_MAPPED,
                              STATUS_SEED_CAPPED, STATUS_UNMAPPED)

__all__ = ["MinimizerIndex", "LookupResult", "minimizers",
           "Chain", "ChainParams", "chain_batch", "top_chains",
           "ReadMapper", "MapResult", "STATUS_MAPPED", "STATUS_UNMAPPED",
           "STATUS_SEED_CAPPED"]
