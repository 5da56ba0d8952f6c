"""Batched alignment API — the host-side staging layer (paper Fig. 6(b)).

The paper batches kt (segments x tiles) sequence pairs per dispatch; the
host groups reads by length so each ReRAM segment's band width matches.
Here: bucket by padded length class, pick the adaptive band per class
(B = min(w + 0.01 L, band_cap), §IV-B1), pad, and run the selected
backend in two phases — `enqueue_dispatch` (asynchronous: launches queued
on the device's current stream, results device-resident) and
`finalize_dispatch` (materialise + decode). Work is split into
fixed-capacity "dispatch" groups — mirroring the fixed CM geometry. On the
default `decode="device"` path finalize fetches only trimmed RLE CIGAR
arrays; the packed traceback plane reaches the host only on the
`decode="host"` oracle / CPU-fallback path (DESIGN.md §5).

`plan_buckets` is the multi-bucket scheduler: it partitions a ragged
request into per-length-class `DispatchGroup`s, each remembering the
caller positions of its members so results scatter back into the original
read order (see `core.engine.AlignmentEngine`, and
`repro_torch.serve.AlignmentService` for the streaming front end that feeds
these phases continuously).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import banded
from repro_torch.core.backends import get_backend
from repro_torch.core.scoring import ScoringConfig, MINIMAP2, adaptive_bandwidth


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    q_len: int       # padded query length
    r_len: int       # padded reference length
    band: int        # band width used for the bucket
    capacity: int    # sequences per dispatch (sequence-level parallelism k)
    t_max: int | None = None  # trimmed sweep length: max true n+m of the
    #   members, rounded up to TRIM_QUANTUM (None = full q_len + r_len)


DEFAULT_BUCKET_EDGES = (128, 256, 512, 1024, 2048, 4096, 8192, 16384)

#: Trimmed sweep lengths are rounded up to this multiple, so the number
#: of distinct dispatch signatures per bucket stays bounded (q_len + r_len
#: over TRIM_QUANTUM classes at most) while giving up < TRIM_QUANTUM
#: wasted wavefront steps.
TRIM_QUANTUM = 64


def trimmed_sweep(q_lens, r_lens, q_len: int, r_len: int) -> int:
    """A group's trimmed sweep length: the max true n + m over its
    members (§VI-F — the wavefront needs exactly n + m trips), rounded up
    to TRIM_QUANTUM and capped at the full padded geometry."""
    t_true = int((np.asarray(q_lens, np.int64)
                  + np.asarray(r_lens, np.int64)).max())
    t_max = int(-(-t_true // TRIM_QUANTUM) * TRIM_QUANTUM)
    return min(t_max, q_len + r_len)


def check_device(device) -> torch.device:
    """Resolve an entry point's `device` argument. A CUDA device that is
    not there raises: an entry point never carries on on the CPU
    unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but "
            "torch.cuda.is_available() is False; pass device='cpu' (and "
            "backend='reference') to run on the CPU")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _round_up(x: int, edges=DEFAULT_BUCKET_EDGES) -> int:
    for edge in edges:
        if x <= edge:
            return edge
    return int(2 ** np.ceil(np.log2(max(x, 1))))


def length_class(q_len: int, r_len: int,
                 edges=DEFAULT_BUCKET_EDGES) -> int:
    """The bucket-edge length class one (read, ref) pair falls into —
    the same classing `plan_buckets` applies, exposed so callers that
    see requests one at a time (the serving layer's per-class flush
    controllers) can pre-classify without planning."""
    return _round_up(int(max(q_len, r_len)), edges)


def default_base_bandwidth(L: int, base_bandwidth: int | None = None) -> int:
    """Base bandwidth w for a length class (§VI-B: 10 short / 30 long),
    unless the caller pins one. Shared policy of make_bucket,
    plan_buckets, and the engine."""
    if base_bandwidth is not None:
        return base_bandwidth
    return 10 if L <= 1024 else 30


#: Band-width cap of B = min(w + 0.01 L, cap) (paper §IV-B1; 100 follows
#: BWA-MEM's evidence that B=100 suffices for typical read lengths).
#: Scheduler/engine callers can raise it for long-read scenarios.
DEFAULT_BAND_CAP = 100


def make_bucket(q_lens, r_lens, *, base_bandwidth: int | None = None,
                capacity: int = 64,
                band_cap: int = DEFAULT_BAND_CAP) -> BucketSpec:
    """Bucket spec for a set of reads forced into ONE length class.

    Prefer `plan_buckets` — it keeps length classes separate so short
    reads never pay the longest read's padded geometry.
    """
    q_len = _round_up(int(np.max(q_lens)))
    r_len = _round_up(int(np.max(r_lens)))
    L = max(q_len, r_len)
    w = default_base_bandwidth(L, base_bandwidth)
    return BucketSpec(q_len=q_len, r_len=r_len,
                      band=adaptive_bandwidth(L, w, cap=band_cap),
                      capacity=capacity,
                      t_max=trimmed_sweep(q_lens, r_lens, q_len, r_len))


@dataclasses.dataclass(frozen=True)
class DispatchGroup:
    """One length class of a ragged request: its bucket geometry plus the
    caller positions of the member pairs (for scatter-back)."""
    spec: BucketSpec
    indices: np.ndarray  # (k,) int64 positions in the caller's order


def plan_buckets(q_lens, r_lens, *, base_bandwidth: int | None = None,
                 capacity: int = 64, edges=DEFAULT_BUCKET_EDGES,
                 band_cap: int = DEFAULT_BAND_CAP) -> list[DispatchGroup]:
    """Multi-bucket scheduler: partition reads into per-length-class
    dispatch groups, each with its own padded geometry and band width
    B = min(w + 0.01 L, band_cap)."""
    q_lens = np.asarray(q_lens, np.int64)
    r_lens = np.asarray(r_lens, np.int64)
    cls = np.array([_round_up(int(max(q, r)), edges)
                    for q, r in zip(q_lens, r_lens)], np.int64)
    groups = []
    for c in sorted(set(cls.tolist())):
        idx = np.flatnonzero(cls == c)
        q_len = _round_up(int(q_lens[idx].max()), edges)
        r_len = _round_up(int(r_lens[idx].max()), edges)
        w = default_base_bandwidth(int(c), base_bandwidth)
        spec = BucketSpec(q_len=q_len, r_len=r_len,
                          band=adaptive_bandwidth(int(c), w, cap=band_cap),
                          capacity=capacity,
                          t_max=trimmed_sweep(q_lens[idx], r_lens[idx],
                                              q_len, r_len))
        groups.append(DispatchGroup(spec=spec, indices=idx))
    return groups


def _scatter_ragged(buf: np.ndarray, seqs, lens: np.ndarray) -> None:
    """Bulk-copy N ragged sequences into the rows of a padded buffer.

    One flat concatenation plus one boolean-mask scatter — no per-pair
    Python copy loop (the mask selects row-major exactly the prefix cells
    the concatenation order fills)."""
    if len(seqs) == 0 or int(lens.max(initial=0)) == 0:
        return
    flat = np.concatenate([np.asarray(s, buf.dtype).ravel() for s in seqs])
    mask = np.arange(buf.shape[1]) < lens[:, None]
    buf[:len(seqs)][mask] = flat


def pad_group(reads, refs, spec: BucketSpec,
              pad_multiple: int | None = None):
    """Pad a list of encoded pairs to a dispatch-ready (q, r, n, m) tuple.

    N is padded up to a multiple of `pad_multiple` (default: the bucket
    capacity) with dummy length-1 pairs.
    """
    n = np.asarray([len(x) for x in reads], np.int32)
    m = np.asarray([len(x) for x in refs], np.int32)
    N = len(reads)
    mult = pad_multiple if pad_multiple is not None else spec.capacity
    N_pad = int(np.ceil(max(N, 1) / mult) * mult)
    q_pad = np.full((N_pad, spec.q_len), 4, np.int8)
    r_pad = np.full((N_pad, spec.r_len), 4, np.int8)
    _scatter_ragged(q_pad, reads, n)
    _scatter_ragged(r_pad, refs, m)
    n = np.concatenate([n, np.ones(N_pad - N, np.int32)])
    m = np.concatenate([m, np.ones(N_pad - N, np.int32)])
    return q_pad, r_pad, n, m


@dataclasses.dataclass
class AlignmentBatch:
    """A padded, dispatch-ready batch of (query, reference) pairs."""
    q_pad: np.ndarray   # (N_pad, q_len) int8
    r_pad: np.ndarray   # (N_pad, r_len) int8
    n: np.ndarray       # (N_pad,) int32 true query lengths (1 for dummies)
    m: np.ndarray       # (N_pad,) int32 true reference lengths
    spec: BucketSpec
    num_real: int       # true request size N, before dummy-pair padding

    @classmethod
    def from_lists(cls, reads, refs, *, base_bandwidth=None, capacity=64,
                   band_cap=DEFAULT_BAND_CAP):
        n = np.asarray([len(x) for x in reads], np.int32)
        m = np.asarray([len(x) for x in refs], np.int32)
        spec = make_bucket(n, m, base_bandwidth=base_bandwidth,
                           capacity=capacity, band_cap=band_cap)
        q_pad, r_pad, n, m = pad_group(reads, refs, spec)
        return cls(q_pad=q_pad, r_pad=r_pad, n=n, m=m, spec=spec,
                   num_real=len(reads))


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device`. To a CUDA device the copy goes
    through pinned memory and is queued on the current stream without
    waiting for it (a copy from pageable memory would first wait for the
    stream to drain)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def on_device(device: torch.device):
    """Make `device` current for the block (a no-op off CUDA)."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def shard_rows(a: np.ndarray, shards: int, capacity: int) -> list:
    """The rows of `a` each of `shards` shards runs: shard s takes block s
    of capacity rows from every slice of capacity x shards rows."""
    if shards == 1:
        return [a]
    if a.shape[0] % (capacity * shards):
        raise ValueError(f"{a.shape[0]} rows are not whole slices of "
                         f"{capacity} x {shards} shards")
    blocks = a.reshape((-1, shards, capacity) + a.shape[1:])
    return [np.ascontiguousarray(blocks[:, s]).reshape((-1,) + a.shape[1:])
            for s in range(shards)]


def enqueue_dispatch(run, q_pad, r_pad, n, m, *, capacity: int, devices):
    """Enqueue one padded single-length-class group on its devices.

    `run` is a fully-bound backend callable `(q, r, n, m) -> result
    dict` — a partial over `backend.run`. The group runs in slices of
    capacity x len(devices) rows, each slice split into one block of
    `capacity` rows per device in order (one device: the slices are the
    blocks). Each device's rows are copied to it once; every copy and
    launch is queued on that device's current stream and nothing here
    synchronises, so the devices stay busy while the caller enqueues
    further groups or decodes earlier ones (`finalize_dispatch`). Returns
    the raw result dicts, one per (slice, device) in row order, as
    tensors on the device that computed them — none moves between
    devices.
    """
    devices = [torch.device(d) for d in devices]
    parts = zip(*(shard_rows(np.asarray(a), len(devices), capacity)
                  for a in (q_pad, r_pad, n, m)))
    uploaded = []
    for dev, arrays in zip(devices, parts):
        with on_device(dev):
            uploaded.append([upload(a, dev) for a in arrays])
    outs = []
    for lo in range(0, uploaded[0][0].shape[0], capacity):
        sl = slice(lo, lo + capacity)
        for dev, (q_d, r_d, n_d, m_d) in zip(devices, uploaded):
            with on_device(dev):
                outs.append(run(q_d[sl], r_d[sl], n_d[sl], m_d[sl]))
    return outs


def _none_rejected_cigars(merged: dict) -> None:
    """Replace the CIGAR of every xdrop-retired pair ('status' != 0) with
    None in place — the walk from a zeroed start cell already produced an
    empty op list; None is the caller-facing 'rejected' marker."""
    status = merged.get("status")
    if status is None:
        return
    for i in np.flatnonzero(np.asarray(status)):
        merged["cigars"][int(i)] = None


class HostFetch:
    """The only device->host copy site of the engine. Counts the bytes it
    materialises (`nbytes`).

    By default each copy is queued on the current stream of the tensor's
    device and so waits for everything queued there before it, later
    groups' launches included. With `ready` ({device: CUDA event recorded
    right after one group's or request's launches there}) and
    `copy_streams` ({device: second stream}), a tensor on such a device is
    copied on that device's second stream once its event has fired, so
    fetching this work does not wait for work enqueued after it. Every
    copy goes device-to-host; shards are joined by the caller on the
    host."""

    def __init__(self, ready=None, copy_streams=None):
        self.streams = {}
        self.nbytes = 0
        for dev, event in (ready or {}).items():
            self.streams[dev] = copy_streams[dev]
            self.streams[dev].wait_event(event)

    def __call__(self, x: torch.Tensor) -> np.ndarray:
        stream = self.streams.get(x.device)
        if stream is not None:
            with torch.cuda.stream(stream):
                host = x.to("cpu", non_blocking=True)
            stream.synchronize()
        else:
            host = x.cpu()
        arr = host.numpy()
        self.nbytes += arr.nbytes
        return arr


def finalize_dispatch(outs, n, m, *, band: int, num_real: int,
                      collect_tb: bool = False, mode: str = "global",
                      decode: str = "device", stats: dict | None = None,
                      ready=None, copy_streams=None):
    """Materialise an enqueued group: merge slices to numpy (this blocks
    only on *this* group's device work), strip dummy padding down to
    `num_real`, and — when collect_tb — produce the group's CIGARs.

    decode="device" (the production path): the backend already walked
    the traceback on-device, so the host fetch per slice is the RLE
    arrays trimmed to the longest CIGAR present (`cig_len` first, then
    the device-sliced op/run planes — O(path segments) bytes per pair,
    never the packed plane), and host work is a trivial RLE join.

    decode="host" (oracle / CPU fallback): fetch the packed
    (k, T, ceil(B/2)) flag plane and decode every CIGAR at once with the
    vectorised `traceback_banded_batch` (semiglobal paths start from the
    tracked best cell).

    When `stats` is given, `stats["fetched_bytes"]` is set to the bytes
    this call really materialised device->host — counted at the fetch
    (padded slice rows included, before dummy stripping), so a metrics
    layer accumulating it per flush sees the true fetch traffic rather
    than the stripped result size.

    `outs` is `enqueue_dispatch`'s list in row order (with several
    shards, their blocks interleaved slice by slice), so concatenating the
    fetched blocks joins the shards on the host in order. Every copy goes
    through one `HostFetch`; with `ready` and `copy_streams` it copies on
    each device's second stream behind this group's event there."""
    fetch = HostFetch(ready, copy_streams)

    if collect_tb and decode == "device":
        from repro_torch.core.traceback_device import rle_to_cigars

        # Trim the fetch across slices: cig_len is a tiny (k,) fetch and
        # bounds the device-side column slice of the op/run planes.
        lens = [fetch(o["cig_len"]) for o in outs]
        k_used = max(1, *(int(l.max(initial=0)) for l in lens))
        merged = {}
        for key in outs[0]:
            if key in ("cig_ops", "cig_runs"):
                merged[key] = np.concatenate(
                    [fetch(o[key][:, :k_used]) for o in outs]
                )[:num_real]
            elif key == "cig_len":
                merged[key] = np.concatenate(lens)[:num_real]
            else:
                merged[key] = np.concatenate(
                    [fetch(o[key]) for o in outs])[:num_real]
        merged["cigars"] = rle_to_cigars(merged["cig_ops"],
                                         merged["cig_runs"],
                                         merged["cig_len"])
        _none_rejected_cigars(merged)
        if stats is not None:
            stats["fetched_bytes"] = fetch.nbytes
        return merged
    merged = {}
    for key in outs[0]:
        merged[key] = np.concatenate(
            [fetch(o[key]) for o in outs])[:num_real]
    if collect_tb:
        if mode == "semiglobal":
            starts = np.stack([merged["best_i"], merged["best_j"]], axis=1)
        else:
            starts = np.stack([np.asarray(n[:num_real], np.int32),
                               np.asarray(m[:num_real], np.int32)], axis=1)
        # Retired pairs never completed their sweep, so their flag plane
        # past the retiring step is frozen-carry garbage: zero their
        # start cell (an empty walk) and report None, matching the
        # device decoder's handling.
        rejected = merged.get("status")
        if rejected is not None:
            starts = np.where((rejected != 0)[:, None], 0, starts)
        merged["cigars"] = banded.traceback_banded_batch(
            merged["tb"], merged["los"], n[:num_real], m[:num_real],
            band, starts=starts)
        _none_rejected_cigars(merged)
    if stats is not None:
        stats["fetched_bytes"] = fetch.nbytes
    return merged


def run_dispatch(bk, q_pad, r_pad, n, m, *, sc: ScoringConfig, band: int,
                 capacity: int, num_real: int, adaptive: bool = True,
                 collect_tb: bool = False, mode: str = "global",
                 t_max: int | None = None, decode: str = "device",
                 xdrop: int | None = None, device="cuda"):
    """Run one padded single-length-class group through a backend:
    `enqueue_dispatch` + `finalize_dispatch` back to back (the shared
    dispatch core of `align_batch`; the engine's multi-bucket path calls
    the two phases separately to overlap groups)."""
    run = functools.partial(bk.run, sc=sc, band=band, adaptive=adaptive,
                            collect_tb=collect_tb, mode=mode, t_max=t_max,
                            decode=decode, xdrop=xdrop)
    outs = enqueue_dispatch(run, q_pad, r_pad, n, m, capacity=capacity,
                            devices=(device,))
    return finalize_dispatch(outs, n, m, band=band, num_real=num_real,
                             collect_tb=collect_tb, mode=mode,
                             decode=decode)


def align_batch(batch: AlignmentBatch, sc: ScoringConfig = MINIMAP2, *,
                adaptive: bool = True, collect_tb: bool = False,
                mode: str = "global", backend: str = "auto",
                backend_opts: dict | None = None, decode: str = "device",
                device="cuda"):
    """Run the banded aligner over every dispatch group of a batch.

    mode="semiglobal" gives free gaps at the reference-window ends — the
    read-mapping configuration (candidate windows may be padded).

    backend selects the execution path ('reference', 'cuda', 'auto' =
    the CUDA kernels; raises without a card) and `device` where it runs
    (default the card; pass backend="reference", device="cpu" for the
    CPU); results are bit-identical across backends. Dummy padding pairs are
    stripped: every returned array covers exactly `batch.num_real` reads.
    When collect_tb, the result also carries 'cigars' — walked on-device
    by the lockstep decoder and fetched as RLE arrays (decode="device",
    the default), or fetched as packed planes and decoded by the
    vectorised host `traceback_banded_batch` (decode="host"); both yield
    bit-identical CIGARs and neither runs a per-pair Python decode loop.
    """
    bk = get_backend(backend, **(backend_opts or {}))
    return run_dispatch(bk, batch.q_pad, batch.r_pad, batch.n, batch.m,
                        sc=sc, band=batch.spec.band,
                        capacity=batch.spec.capacity,
                        num_real=batch.num_real, adaptive=adaptive,
                        collect_tb=collect_tb, mode=mode,
                        t_max=batch.spec.t_max, decode=decode,
                        device=check_device(device))
