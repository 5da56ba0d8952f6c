"""AlignmentEngine — the unified multi-backend alignment execution stack.

This is the host dispatcher of the paper's deployment picture (Fig. 2a):
requests arrive as ragged lists of (read, candidate window) pairs; the
engine

  1. plans per-length-class `DispatchGroup`s (`core.batch.plan_buckets`)
     so every compute dispatch runs a fixed geometry with its own adaptive
     band width B = min(w + 0.01 L, 100) — the paper's host-side length
     grouping that keeps each fixed-geometry compute memory full (§IV-B,
     Fig. 6). Each group also records its trimmed sweep length
     `t_max` (max true n + m, §VI-F) so no backend sweeps the dead
     diagonals of the padded geometry,
  2. dispatches groups through a depth-1 lookahead pipeline on the
     selected backend ('cuda' = the hand-written kernels, 'reference' =
     the plain PyTorch versions, 'auto' = 'cuda', raising without a card;
     see `core.backends`): group k+1's capacity slices are queued on the
     device's current stream before group k is materialised, and group
     k's results are copied to the host on a second stream that waits
     only for an event recorded behind group k's own launches — so the
     device computes group k+1 while the host fetches and CIGAR-decodes
     group k, with at most two groups' buffers live,
  3. with `mesh=` (a `launch.mesh.DeviceMesh`), shards each dispatch
     slice over the mesh's data axes (paper Fig. 6(a) tile level):
     one capacity block per shard per slice, each block uploaded to its
     shard's device and launched on that device's current stream, each
     shard's results copied device-to-host behind an event of its own
     device and joined on the host in shard order — alignment needs no
     inter-tile communication, so no tensor moves between devices and
     no collective runs,
  4. scatters results back into the caller's original read order, and
  5. when tracebacks are requested, walks every group's packed
     (T, ceil(B/2)) flag plane **on-device** (`core.traceback_device`)
     and fetches only fixed-width RLE CIGAR arrays trimmed to the
     longest path present — O(path segments) host bytes per pair instead
     of the ceil(B/2) x t_max plane (DESIGN.md §5). decode="host" keeps
     the vectorised numpy `traceback_banded_batch` path as the oracle.

The engine runs **on the card by default** (`device="cuda"`,
`backend="auto"`) and raises at construction when there is none; the CPU
is used only when asked for (`device="cpu"`, `backend="reference"`).

All backends return bit-identical results (integer DP) — the engine is a
pure scheduling layer. `engine.align` is the one-shot entry point; the
streaming front-end that keeps this pipeline continuously fed from a live
request stream is `repro_torch.serve.AlignmentService`, which drives the
same `plan` / `enqueue_group` / `finalize_group` primitives.

With `dispatch="persistent"` the whole request is one launch of the
persistent wavefront over every group plus one launch of the table
walker (`enqueue_persistent` / `finalize_persistent`), and the host
waits only when it fetches the results; it runs on one device and
cannot be combined with `mesh=`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.backends import available_backends, get_backend, \
    resolve_backend
from repro_torch.core.banded import validate_narrow_cells
from repro_torch.core.batch import (DEFAULT_BAND_CAP, DEFAULT_BUCKET_EDGES,
                                    BucketSpec, HostFetch, check_device,
                                    default_base_bandwidth, enqueue_dispatch,
                                    finalize_dispatch, pad_group,
                                    plan_buckets, run_dispatch)
from repro_torch.core.scoring import ScoringConfig, MINIMAP2, adaptive_bandwidth

#: Result keys every backend returns for each pair (original read order).
#: 'status' is the xdrop early-termination verdict: 0 = aligned, k > 0 =
#: retired at wavefront step k (always 0 when xdrop is off).
SCALAR_KEYS = ("score", "final_lo", "best_score", "best_i", "best_j",
               "status")

#: Dummy-row pad multiple for persistent dispatch groups. The pipelined
#: path pads every group to its capacity slice because each slice is a
#: separate launch; the persistent kernel has no per-group launch to
#: amortise, so groups pad only to this multiple — a ragged tail group of
#: 22 pairs costs 24 rows, not 64.
PERSISTENT_PAD = 8


@dataclasses.dataclass
class PendingDispatch:
    """One enqueued (device-resident, not yet fetched) dispatch group.

    Produced by `AlignmentEngine.enqueue_group` and consumed by
    `AlignmentEngine.finalize_group`. Between the two calls the group's
    result buffers live only on the device (its launches are queued on
    the stream, nothing has been fetched), so a caller holding several PendingDispatch handles is exactly the
    engine's lookahead pipeline — `engine.align` keeps one in flight
    (depth 1); the streaming `serve.AlignmentService` keeps up to its
    `max_inflight_groups`.
    """
    spec: BucketSpec
    n: np.ndarray        # (N_pad,) true query lengths incl. dummy pairs
    m: np.ndarray        # (N_pad,) true reference lengths
    outs: list           # raw per-slice backend result dicts (device)
    num_real: int        # request pairs before dummy padding
    collect_tb: bool
    mode: str
    ready: dict | None = None  # {device: CUDA event behind its launches}

    @property
    def num_slots(self) -> int:
        """Padded dispatch slots (N_pad) — the fill-ratio denominator."""
        return int(self.n.shape[0])

    @property
    def signature(self) -> tuple:
        """The dispatch signature of this group (the key a depth
        autotuner works in). The kernels take all of it as run-time
        arguments, so a new signature builds nothing."""
        return (self.spec.q_len, self.spec.r_len, self.spec.band,
                self.spec.t_max, self.mode, self.collect_tb)


@dataclasses.dataclass
class PendingPersistent:
    """One enqueued persistent-dispatch request (ALL of its groups in one
    launch of each kernel; see `AlignmentEngine.enqueue_persistent`).

    The same two-phase contract as `PendingDispatch`, at request
    granularity: between enqueue and finalize the merged result buffers
    live on the device, and `finalize_persistent` is where the host waits
    for them and fetches the scalars and the trimmed RLE arrays."""
    groups: list         # planned DispatchGroups (caller-order indices)
    batch: list          # per-group (q_pad, r_pad, n, m, band, t_max)
    outs: dict           # run_persistent's merged device result
    num_real: int        # request pairs before dummy padding
    collect_tb: bool
    mode: str
    ready: dict | None = None  # {device: CUDA event behind the launches}

    @property
    def num_slots(self) -> int:
        """Padded rows across all groups — the fill-ratio denominator."""
        return sum(int(grp[0].shape[0]) for grp in self.batch)

    @property
    def signature(self) -> tuple:
        """The request's group geometry (the key a depth autotuner works
        in). The kernels take all of it as run-time data, so a new
        signature builds nothing."""
        return ("persistent",) + tuple(
            (int(grp[0].shape[0]), int(grp[0].shape[1]),
             int(grp[1].shape[1]), int(grp[4]), grp[5])
            for grp in self.batch)


def _check_t_max(t_max, n, m) -> None:
    """Reject a trimmed sweep shorter than some pair's true n + m — the
    carry would freeze before that pair's corner and silently return a
    truncated alignment. Checked where the lengths are host arrays; for
    device tensors the caller's guarantee stands (reading them back would
    synchronise)."""
    if t_max is None or isinstance(n, torch.Tensor) \
            or isinstance(m, torch.Tensor):
        return
    lens = np.asarray(n).astype(np.int64) + np.asarray(m).astype(np.int64)
    if lens.size == 0:
        return
    t_true = int(lens.max())
    if t_max < t_true:
        raise ValueError(
            f"t_max={t_max} < max true n + m = {t_true}: the trimmed "
            "sweep would stop before every pair reaches its corner")


@dataclasses.dataclass
class AlignmentEngine:
    """One result contract over interchangeable execution backends.

    Attributes:
      backend: 'cuda' | 'reference' | 'auto' (resolved at construction;
        'auto' is 'cuda' and raises without a card), or an
        already-constructed backend object.
      device: where every dispatch runs. Default "cuda"; raises at
        construction when there is no such device. "cpu" needs
        backend="reference".
      sc: affine-gap scoring config shared by every dispatch.
      adaptive: adaptive wavefront direction (Table V ablation switch).
      base_bandwidth: w in B = min(w + 0.01 L, band_cap); None =
        per-class default (10 short / 30 long, §VI-B).
      band_cap: cap of the adaptive band width (paper §IV-B1; default
        100 per BWA-MEM's evidence). Raise it for long-read scenarios
        that need a wider band than the short-read default.
      capacity: pairs per dispatch group slice (sequence-level k): one
        kernel launch covers this many pairs. With `mesh=` this is the
        *per-shard* capacity: each dispatch slice spans
        capacity x num_shards pairs.
      backend_opts: forwarded to the backend constructor.
      trim: sweep each group only t_max wavefront steps (max true n + m
        of its members) instead of the full padded q_len + r_len.
        Results are bit-identical either way; False exists for the
        trimming-parity tests and benchmarks.
      dispatch: "pipelined" (default) or "persistent". Pipelined is the
        depth-1 lookahead loop: one backend launch per dispatch group
        slice, host mediating group boundaries. Persistent hands ALL of
        a request's groups to the backend's `run_persistent`: one launch
        of the persistent wavefront (per-group band and sweep length in
        a work table) and one of the table walker, groups padded only to
        `PERSISTENT_PAD` rows, and the results fetched at the end.
        Results are bit-identical. Persistent with collect_tb requires
        decode="device".
      cell_dtype: "int32" (default) or "narrow" — backend band-state
        storage precision (paper §IV bit-width reduction). Narrow keeps
        int8 difference planes + int16 band-relative H in the plain
        version (the CUDA kernel runs it on its int32 path); bit-exact
        with int32 under the static guard `validate_narrow_cells(sc,
        band_cap)`, which runs at construction and rejects scoring
        configs whose worst case could overflow.
      xdrop: X-drop early-termination threshold (None = off). When set,
        a pair retires the first wavefront step its live-band max H
        falls more than `xdrop` below the pair's running best; its
        'status' reports the retiring step (0 = aligned), its 'score'
        stays at the NEG sentinel and its CIGAR entry is None. Surviving
        pairs are bit-identical to an xdrop-off run (the retire freeze
        is the same carry freeze the trimmed sweep uses); the CUDA
        kernel leaves a retired pair's loop at the retiring step.
      decode: traceback decode stage for the ragged `align` path.
        "device" (default) fuses the lockstep walker after the compute —
        the packed tb plane never leaves the device and the host fetches
        RLE CIGAR arrays; "host" fetches the packed plane and decodes
        with the numpy `traceback_banded_batch` (oracle / CPU fallback).
        CIGARs are bit-identical either way.
      mesh: optional `launch.mesh.DeviceMesh` — shard every dispatch
        slice's batch over `batch_axes`, one block per shard, no
        communication between shards. `device` then becomes the first
        shard's device; every shard's device must exist (a CUDA mesh
        without cards raises). Pipelined dispatch only.
      batch_axes: mesh axes to shard over; None = every axis named
        "pod"/"data" in the mesh (alignment never uses "model": along it
        the shards would be replicas, and only its first entry runs).
      compilation_cache_dir: kept for signature parity and unused. The
        kernels take band, sweep length, sequence lengths and the
        persistent work table as run-time arguments, so there is no
        per-signature program to cache; the shared libraries are built
        once into ``build/``.
    """

    backend: object = "auto"
    device: object = "cuda"
    sc: ScoringConfig = MINIMAP2
    adaptive: bool = True
    base_bandwidth: int | None = None
    band_cap: int = DEFAULT_BAND_CAP
    capacity: int = 64
    backend_opts: dict | None = None
    bucket_edges: tuple = DEFAULT_BUCKET_EDGES
    trim: bool = True
    dispatch: str = "pipelined"
    cell_dtype: str = "int32"
    xdrop: int | None = None
    decode: str = "device"
    mesh: object = None
    batch_axes: tuple | None = None
    compilation_cache_dir: str | None = None

    def __post_init__(self):
        if self.dispatch not in ("pipelined", "persistent"):
            raise ValueError(f"dispatch must be 'pipelined' or "
                             f"'persistent', got {self.dispatch!r}")
        if self.mesh is not None:
            self._shards = self._mesh_shards()
            self.device = self._shards[0]
        else:
            self.device = check_device(self.device)
            self._shards = (self.device,)
        self.backend = get_backend(self.backend,
                                   **(self.backend_opts or {}))
        if self.backend.name == "cuda" and self.device.type != "cuda":
            raise ValueError(
                f"backend 'cuda' cannot run on device {self.device}; use "
                "backend='reference' for the CPU")
        if self.cell_dtype not in ("int32", "narrow"):
            raise ValueError(f"cell_dtype must be 'int32' or 'narrow', "
                             f"got {self.cell_dtype!r}")
        if self.xdrop is not None and int(self.xdrop) <= 0:
            raise ValueError(f"xdrop must be a positive threshold or "
                             f"None, got {self.xdrop!r}")
        if self.cell_dtype == "narrow":
            # Static overflow guard: the band never exceeds band_cap, and
            # the bound is monotonic in the band width, so checking the
            # cap covers every dispatch this engine can plan.
            validate_narrow_cells(self.sc, self.band_cap)
        # Per device, a second stream for the result fetch (see
        # finalize_dispatch).
        self._copy_streams: dict = {}

    def _mesh_shards(self) -> tuple:
        """Validate the mesh settings; the shards' devices in order."""
        from repro_torch.launch.mesh import DeviceMesh

        if not isinstance(self.mesh, DeviceMesh):
            raise TypeError(f"mesh must be a launch.mesh.DeviceMesh, got "
                            f"{type(self.mesh).__name__}")
        if self.dispatch == "persistent":
            raise ValueError(
                "dispatch='persistent' runs the whole request as one "
                "single-device launch and cannot shard over a mesh; use "
                "the pipelined dispatch with mesh=")
        if self.batch_axes is None:
            self.batch_axes = tuple(a for a in self.mesh.axis_names
                                    if a in ("pod", "data"))
        return tuple(check_device(d)
                     for d in self.mesh.shard_devices(self.batch_axes))

    @property
    def backend_name(self) -> str:
        return self.backend.name

    @property
    def num_shards(self) -> int:
        """Mesh shards a dispatch slice spans (1 without a mesh)."""
        return len(self._shards)

    @property
    def shard_devices(self) -> tuple:
        """The device of each shard, in shard order (without a mesh:
        `device` alone)."""
        return self._shards

    # ------------------------------------------------------------------
    # Mesh path: each shard's block on its own device.
    # ------------------------------------------------------------------
    def sharded_runner(self, *, band: int, collect_tb: bool = False,
                       mode: str = "global", t_max: int | None = None,
                       decode: str = "host"):
        """The sharded backend call for one dispatch signature: a function
        of padded host arrays (q, r, n, m) whose batch divides by
        `num_shards`. It splits the batch into `num_shards` contiguous
        blocks, uploads block s to shard s's device and queues the backend
        there (no synchronisation), and returns one raw result dict per
        shard, in shard order, each on its own shard's device. No tensor
        crosses between devices and no collective runs — including with
        decode="device", where each shard's walker runs on its own block
        (the walk is per-pair)."""
        if self.mesh is None:
            raise ValueError("sharded_runner requires AlignmentEngine("
                             "mesh=...)")
        run = functools.partial(
            self.backend.run, sc=self.sc, band=band, adaptive=self.adaptive,
            collect_tb=collect_tb, mode=mode, t_max=t_max, decode=decode,
            cell_dtype=self.cell_dtype, xdrop=self.xdrop)

        def runner(q_pad, r_pad, n, m):
            N = int(q_pad.shape[0])
            if N == 0 or N % self.num_shards:
                raise ValueError(f"a batch of {N} rows does not split "
                                 f"over {self.num_shards} shards")
            _check_t_max(t_max, n, m)
            return enqueue_dispatch(run, q_pad, r_pad, n, m,
                                    capacity=N // self.num_shards,
                                    devices=self._shards)
        return runner

    # ------------------------------------------------------------------
    # Padded single-length-class path (arrays in, device tensors out).
    # ------------------------------------------------------------------
    def align_arrays(self, q_pad, r_pad, n, m, *, band: int | None = None,
                    mode: str = "global", collect_tb: bool = False,
                    t_max: int | None = None, decode: str = "host"):
        """Align an already-padded single-class batch on the backend.

        The thin path used by plane-level tooling and tests; takes numpy
        arrays or tensors, places them on the engine's device and
        returns the raw backend result dict as tensors there (queued on
        the current stream, not synchronised). With `mesh=`, the batch
        (host arrays, leading dimension divisible by `num_shards`) goes
        through `sharded_runner` and the result is its list of per-shard
        dicts, each on its shard's device. `t_max` optionally trims
        the sweep (caller guarantees t_max >= max true n + m). `decode`
        defaults to "host" here — the raw-plane contract (tb/los) that
        the oracle tests consume; pass "device" to get the on-device
        walk's RLE arrays instead.
        """
        if band is None:
            L = max(int(q_pad.shape[1]), int(r_pad.shape[1]))
            band = adaptive_bandwidth(L, default_base_bandwidth(
                L, self.base_bandwidth), cap=self.band_cap)
        if self.mesh is not None:
            return self.sharded_runner(band=band, collect_tb=collect_tb,
                                       mode=mode, t_max=t_max,
                                       decode=decode)(q_pad, r_pad, n, m)
        _check_t_max(t_max, n, m)
        q_pad, r_pad, n, m = (torch.as_tensor(a).to(self.device)
                              for a in (q_pad, r_pad, n, m))
        return self.backend.run(q_pad, r_pad, n, m, sc=self.sc, band=band,
                                adaptive=self.adaptive,
                                collect_tb=collect_tb, mode=mode,
                                t_max=t_max, decode=decode,
                                cell_dtype=self.cell_dtype,
                                xdrop=self.xdrop)

    # ------------------------------------------------------------------
    # Group-at-a-time pipeline primitives (the service's driving API).
    # ------------------------------------------------------------------
    def plan(self, q_lens, r_lens):
        """Plan per-length-class `DispatchGroup`s for a ragged request
        under this engine's bucketing config (edges, band_cap, capacity,
        base_bandwidth) — the scheduler `align` and the streaming
        `serve.AlignmentService` share."""
        return plan_buckets(q_lens, r_lens,
                            base_bandwidth=self.base_bandwidth,
                            capacity=self.capacity,
                            edges=self.bucket_edges,
                            band_cap=self.band_cap)

    def enqueue_group(self, reads, refs, spec: BucketSpec, *,
                      mode: str = "global",
                      collect_tb: bool = False) -> PendingDispatch:
        """Pad one length-class's member pairs and enqueue them on the
        device (asynchronous — no host sync). `reads`/`refs` are the
        group members in group order (the caller keeps the scatter
        indices). Returns the `PendingDispatch` handle for
        `finalize_group`; on CUDA it carries, per shard device, an event
        recorded behind the group's last launch there. With `mesh=`, the
        group pads to whole slices of capacity x num_shards rows and each
        slice's blocks run on their shards' devices."""
        t_max = spec.t_max if self.trim else None
        q_pad, r_pad, n, m = pad_group(
            reads, refs, spec, pad_multiple=spec.capacity * self.num_shards)
        run = functools.partial(
            self.backend.run, sc=self.sc, band=spec.band,
            adaptive=self.adaptive, collect_tb=collect_tb,
            mode=mode, t_max=t_max, decode=self.decode,
            cell_dtype=self.cell_dtype, xdrop=self.xdrop)
        outs, ready = self._queue(lambda: enqueue_dispatch(
            run, q_pad, r_pad, n, m, capacity=spec.capacity,
            devices=self._shards))
        return PendingDispatch(spec=spec, n=n, m=m, outs=outs,
                               num_real=len(reads), collect_tb=collect_tb,
                               mode=mode, ready=ready)

    def _queue(self, launch):
        """Run `launch` (which queues device work) with this engine's
        device current; on CUDA also record, on every shard's device, an
        event behind the work queued there. Returns (its result, {device:
        event} or None)."""
        if self.device.type != "cuda":
            return launch(), None
        with torch.cuda.device(self.device):
            out = launch()
        ready = {}
        for dev in self._shards:
            with torch.cuda.device(dev):
                ready[dev] = torch.cuda.Event()
                ready[dev].record()
        return out, ready

    def _fetch_streams(self, ready):
        """{device: the engine's second stream there} for fetches behind
        `ready`, each created at the first CUDA fetch on its device (None
        when there are no events)."""
        if ready is None:
            return None
        for dev in ready:
            if dev not in self._copy_streams:
                self._copy_streams[dev] = torch.cuda.Stream(device=dev)
        return self._copy_streams

    def finalize_group(self, pending: PendingDispatch, *,
                       stats: dict | None = None) -> dict:
        """Materialise an enqueued group: blocks only on *that* group's
        device work (the fetch runs, per device, on a second stream behind
        the group's own event there; shards join on the host in shard
        order), strips dummy padding, and (with collect_tb)
        joins its CIGARs per the engine's decode stage. With `stats`,
        reports the bytes this fetch really materialised
        (`stats["fetched_bytes"]`, padded rows included)."""
        return finalize_dispatch(pending.outs, pending.n, pending.m,
                                 band=pending.spec.band,
                                 num_real=pending.num_real,
                                 collect_tb=pending.collect_tb,
                                 mode=pending.mode, decode=self.decode,
                                 stats=stats, ready=pending.ready,
                                 copy_streams=self._fetch_streams(
                                     pending.ready))

    # ------------------------------------------------------------------
    # Persistent-dispatch pipeline primitives (request granularity).
    # ------------------------------------------------------------------
    def enqueue_persistent(self, reads, refs, *, mode: str = "global",
                           collect_tb: bool = False) -> PendingPersistent:
        """Plan a whole ragged request and enqueue ALL of its groups as one
        launch of each kernel (`run_persistent`) — no synchronisation. The
        `PendingPersistent` handle goes to `finalize_persistent`; a caller
        interleaving several handles pipelines whole requests the way
        `enqueue_group` pipelines groups (the streaming service does
        exactly this when its engine runs `dispatch="persistent"`)."""
        if self.dispatch != "persistent":
            raise ValueError("enqueue_persistent requires AlignmentEngine("
                             "dispatch='persistent')")
        if collect_tb and self.decode != "device":
            raise ValueError(
                "dispatch='persistent' fuses the traceback decode "
                "on-device; decode='host' exists only on the pipelined "
                "path")
        if not len(reads):
            raise ValueError("enqueue_persistent needs at least one pair")
        groups = self.plan([len(x) for x in reads],
                           [len(x) for x in refs])
        batch = []
        for g in groups:
            idx = g.indices
            t_max = g.spec.t_max if self.trim else None
            q_pad, r_pad, n, m = pad_group(
                [reads[i] for i in idx], [refs[i] for i in idx], g.spec,
                pad_multiple=PERSISTENT_PAD)
            _check_t_max(t_max, n, m)
            batch.append((q_pad, r_pad, n, m, g.spec.band, t_max))
        outs, ready = self._queue(lambda: self.backend.run_persistent(
            batch, sc=self.sc, adaptive=self.adaptive,
            collect_tb=collect_tb, mode=mode, decode=self.decode,
            cell_dtype=self.cell_dtype, xdrop=self.xdrop,
            device=self.device))
        return PendingPersistent(groups=groups, batch=batch, outs=outs,
                                 num_real=len(reads),
                                 collect_tb=collect_tb, mode=mode,
                                 ready=ready)

    def finalize_persistent(self, pending: PendingPersistent, *,
                            stats: dict | None = None) -> dict:
        """Materialise a persistent request on the second stream behind
        the request's event: the scalars and, with collect_tb, `cig_len`
        and then each group's RLE rows trimmed to that group's longest
        CIGAR (one short request's rows never pay a long group's width);
        strip the per-group dummy padding and scatter back to the
        caller's original pair order. Returns (N,) arrays for the
        SCALAR_KEYS plus 'band', and 'cigars' when tracebacks were
        collected. With `stats`, reports `stats["fetched_bytes"]` (padded
        rows included)."""
        from repro_torch.core.traceback_device import rle_to_cigars

        fetch = HostFetch(pending.ready, self._fetch_streams(pending.ready))
        N = pending.num_real
        out = {k: np.zeros(N, np.int32) for k in SCALAR_KEYS}
        out["band"] = np.zeros(N, np.int32)
        merged = pending.outs
        if pending.collect_tb:
            lens = fetch(merged["cig_len"])
        scalars = {k: fetch(merged[k]) for k in SCALAR_KEYS}
        cigars: list = [None] * N
        off = 0
        for g, grp in zip(pending.groups, pending.batch):
            idx = g.indices
            n_real = len(idx)
            n_pad = grp[0].shape[0]
            for key in SCALAR_KEYS:
                out[key][idx] = scalars[key][off:off + n_real]
            out["band"][idx] = g.spec.band
            if pending.collect_tb:
                rows = slice(off, off + n_pad)
                k_g = max(int(lens[rows].max(initial=0)), 1)
                ops = fetch(merged["cig_ops"][rows, :k_g])
                runs = fetch(merged["cig_runs"][rows, :k_g])
                cigs = rle_to_cigars(ops[:n_real], runs[:n_real],
                                     lens[off:off + n_real])
                st = scalars["status"][off:off + n_real]
                for pos, cig, rej in zip(idx, cigs, st != 0):
                    cigars[pos] = None if rej else cig
            off += n_pad
        if pending.collect_tb:
            out["cigars"] = cigars
        if stats is not None:
            stats["fetched_bytes"] = fetch.nbytes
        return out

    # ------------------------------------------------------------------
    # Warm start.
    # ------------------------------------------------------------------
    def warmup(self, lengths, *, mode: str = "global",
               collect_tb: bool = False) -> int:
        """Build and load the kernels and run one dummy alignment, so the
        first real request pays neither `nvcc` nor the library load.

        `lengths` is an iterable of representative (q_len, r_len) pairs —
        one per length class the replica expects. The warmup runs one
        dummy alignment through the full dispatch path (plan -> enqueue
        -> finalize). The kernels take every dispatch signature as
        run-time arguments, so one pass warms them all; the lengths only
        size the dummy request. Returns the number of dispatch groups
        warmed."""
        lengths = list(lengths)
        if not lengths:
            return 0
        reads = [np.zeros(int(q), np.int8) for q, _ in lengths]
        refs = [np.zeros(int(r), np.int8) for _, r in lengths]
        self.align(reads, refs, mode=mode, collect_tb=collect_tb)
        return len(self.plan([len(x) for x in reads],
                             [len(x) for x in refs]))

    # ------------------------------------------------------------------
    # Ragged multi-bucket path (lists in, original-order numpy out).
    # ------------------------------------------------------------------
    def align(self, reads, refs, *, mode: str = "global",
              collect_tb: bool = False):
        """Align ragged (read, reference) lists through the multi-bucket
        scheduler.

        The dispatch pipeline overlaps host and device with a depth-1
        lookahead: group k+1's capacity slices are enqueued on-device
        (asynchronous — no host sync) *before* group k is fetched and decoded,
        so the host CIGAR-decodes group k while the device computes
        group k+1, and at most two groups' result buffers are live at
        once (bounded memory at any request size).

        Returns a dict of (N,) arrays in the caller's original order:
        the SCALAR_KEYS plus 'band' (the per-read band width actually
        used); with collect_tb also 'cigars' (list of N CIGARs — by
        default walked on-device per group by the fused lockstep decoder
        and fetched as trimmed RLE arrays, with semiglobal start-cell
        selection on-device off the tracked best cell; decode="host"
        falls back to fetching the packed plane and running the numpy
        batched traceback. Identical CIGARs either way).
        """
        if len(reads) != len(refs):
            raise ValueError("reads and refs must pair up")
        if self.dispatch == "persistent":
            return self._align_persistent(reads, refs, mode=mode,
                                          collect_tb=collect_tb)
        N = len(reads)
        out = {k: np.zeros(N, np.int32) for k in SCALAR_KEYS}
        out["band"] = np.zeros(N, np.int32)
        cigars: list = [None] * N

        groups = self.plan([len(x) for x in reads],
                           [len(x) for x in refs])

        def enqueue(g):
            idx = g.indices
            pd = self.enqueue_group([reads[i] for i in idx],
                                    [refs[i] for i in idx], g.spec,
                                    mode=mode, collect_tb=collect_tb)
            return g, pd

        # Depth-1 lookahead pipeline: group k+1 is enqueued on-device
        # before group k is materialised, so decode overlaps compute
        # while only two groups' buffers are ever live.
        pending = enqueue(groups[0]) if groups else None
        for k in range(len(groups)):
            g, pd = pending
            pending = enqueue(groups[k + 1]) if k + 1 < len(groups) \
                else None
            idx = g.indices
            merged = self.finalize_group(pd)
            for key in SCALAR_KEYS:
                out[key][idx] = merged[key]
            out["band"][idx] = g.spec.band
            if collect_tb:
                for pos, cig in zip(idx, merged["cigars"]):
                    cigars[pos] = cig
        if collect_tb:
            out["cigars"] = cigars
        return out

    def _align_persistent(self, reads, refs, *, mode: str,
                          collect_tb: bool):
        """The persistent-dispatch realisation of `align`: every planned
        group in one launch of each kernel, fetched at the end.
        Output contract identical to the pipelined `align` (bit-exact)."""
        if not len(reads):
            out = {k: np.zeros(0, np.int32) for k in SCALAR_KEYS}
            out["band"] = np.zeros(0, np.int32)
            if collect_tb:
                out["cigars"] = []
            return out
        pending = self.enqueue_persistent(reads, refs, mode=mode,
                                          collect_tb=collect_tb)
        return self.finalize_persistent(pending)


__all__ = ["AlignmentEngine", "PendingDispatch", "PendingPersistent",
           "PERSISTENT_PAD", "SCALAR_KEYS", "available_backends",
           "get_backend", "resolve_backend", "run_dispatch"]
