"""Tile-level parallelism (paper Fig. 6(a)) — the batch sharded over a
device mesh.

RAPIDx distributes kt sequence batches over 64 independent tiles with *no
inter-tile communication*; here the batch dimension of an alignment
dispatch is split over the mesh's data axes, one contiguous block per
device. Each block is uploaded to its device, aligned there, and fetched
device-to-host; the host joins the blocks in shard order. No tensor moves
between devices and no collective runs: this package does not use
`torch.distributed` at all (the roofline's collective term for the
alignment workload is 0).

Also hosts the alignment serve step: the mesh's ("pod", "data") axes both
shard the batch; the "model" axis is unused for alignment, matching the
paper's single-tile independence.
"""

from __future__ import annotations

import torch

from repro_torch.core.scoring import MINIMAP2, ScoringConfig


def make_aligner(mesh, sc: ScoringConfig = MINIMAP2, *, band: int,
                 adaptive: bool = True, collect_tb: bool = False,
                 batch_axes: tuple[str, ...] | None = None,
                 backend: str = "auto", backend_opts: dict | None = None,
                 t_max: int | None = None, decode: str = "host"):
    """A batched aligner sharded over the mesh.

    A thin wrapper over `AlignmentEngine(mesh=...)`: the returned callable
    is the engine's `sharded_runner` for this dispatch signature — padded
    host arrays (q, r, n, m) in, whose batch divides by the shard count;
    one raw result dict per shard out, in shard order, each on its shard's
    device. The engine's ragged `align` path shards its dispatch slices
    through the same `enqueue_dispatch`.

    Args:
      mesh: `launch.mesh.DeviceMesh`; the batch shards over `batch_axes`.
      batch_axes: mesh axes to shard the batch over. Defaults to all axes
        named "pod"/"data" present in the mesh (alignment never uses
        "model" — a tile needs no partner).
      backend: engine backend run on each shard ('cuda', 'reference',
        'auto' = 'cuda'; a CPU mesh needs 'reference').
      t_max: optional trimmed sweep length (>= max true n + m of every
        batch the aligner will see).
      decode: traceback decode stage when collect_tb — "host" returns the
        raw packed planes, "device" runs the walker on each shard's device
        and returns RLE CIGAR arrays (still no communication: the walk is
        per-pair).
    """
    from repro_torch.core.engine import AlignmentEngine

    eng = AlignmentEngine(backend=backend, sc=sc, adaptive=adaptive,
                          backend_opts=backend_opts, mesh=mesh,
                          batch_axes=batch_axes)
    return eng.sharded_runner(band=band, collect_tb=collect_tb,
                              t_max=t_max, decode=decode)


def alignment_serve_step(mesh, sc: ScoringConfig = MINIMAP2, *,
                         band: int, collect_tb: bool = False,
                         backend: str = "auto"):
    """The alignment-as-a-service step: a padded dispatch batch (global)
    in; scores (+ optional traceback planes) out, one dict per shard.
    `backend` as in `make_aligner` (a CPU mesh needs 'reference')."""
    return make_aligner(mesh, sc, band=band, collect_tb=collect_tb,
                        backend=backend)


def alignment_input_specs(global_batch: int, q_len: int, r_len: int):
    """The aligner's inputs as tensors on the "meta" device (shapes and
    dtypes, no storage)."""
    return (
        torch.empty((global_batch, q_len), dtype=torch.int8, device="meta"),
        torch.empty((global_batch, r_len), dtype=torch.int8, device="meta"),
        torch.empty((global_batch,), dtype=torch.int32, device="meta"),
        torch.empty((global_batch,), dtype=torch.int32, device="meta"),
    )
