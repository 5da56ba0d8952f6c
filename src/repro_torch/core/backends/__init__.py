"""Execution backends for the AlignmentEngine.

A backend is the compute-memory of the host/accelerator split (paper
Fig. 2a): the engine plans length-bucketed dispatch groups and a backend
executes one padded, single-length-class group. Every backend honours one
contract (see DESIGN.md §3):

    run(q_pad, r_pad, n, m, *, sc, band, adaptive, collect_tb, mode,
        t_max, decode, cell_dtype, xdrop)
      -> dict with (N,) int32 'score', 'final_lo', 'best_score',
         'best_i', 'best_j', 'status'; plus, when collect_tb:
           decode="host"   -> 'tb' ((N, T, ceil(B/2)) uint8) and 'los'
                              ((N, T+1) int32) — the raw packed planes,
                              for the host decoder / oracle paths;
           decode="device" -> 'cig_ops' ((N, T) uint8), 'cig_runs'
                              ((N, T) int32), 'cig_len' ((N,) int32) —
                              the fixed-width RLE CIGARs of
                              `core.traceback_device`, decoded on-device;
                              tb/los are consumed before they could ever
                              be fetched.
         T is the trimmed sweep length t_max (>= max true n + m over the
         batch) or the full padded Lq + Lr when t_max is None. Inputs and
         results are torch tensors on one device; work is queued on that
         device's current stream and `run` never synchronises.

    ``xdrop`` (int threshold, None = off) enables X-drop early
    termination: a pair retires the first step its live-band max H falls
    more than xdrop below the pair's running best. Retired pairs freeze
    their carry exactly like the t > n + m freeze (so surviving pairs
    are bit-identical to an xdrop-off run on every backend), report the
    retiring step in 'status' (0 = aligned, k > 0 = rejected at step k),
    keep 'score' at the NEG sentinel, and decode to an empty CIGAR.

The traceback plane is *packed*: two 4-bit flags per byte, even band
lane in the low nibble, odd lane in the high nibble; for odd B the last
byte holds a single valid nibble (`core.banded.pack_tb_lanes` is the
canonical layout, DESIGN.md §5). Rows of non-live steps (past a pair's
n + m, or from its retiring step on) are zero and 'los' holds the frozen
offset there, on every backend.

Two backends are registered:

  * 'reference' — the plain PyTorch versions (`core.banded`,
    `traceback_device.decode_packed_tb_plain`), on any device;
  * 'cuda' — the hand-written kernels (`kernels.banded_dp`, the walker of
    `core.traceback_device`), CUDA tensors only.

'auto' resolves to 'cuda' and raises when no CUDA device is present: an
entry point never carries on on the CPU unasked. Results are
bit-identical across backends — integer DP.

Backends additionally provide the persistent-dispatch entry point
(`AlignmentEngine(dispatch="persistent")`):

    run_persistent(groups, *, sc, adaptive, collect_tb, mode, decode,
                   cell_dtype, xdrop, device)
      groups: sequence of (q_pad, r_pad, n, m, band, t_max) host arrays —
        one entry per dispatch group, each with its own padded geometry,
        band and trimmed sweep. ALL groups run in ONE launch of the
        persistent wavefront (`kernels.banded_dp.persistent`, driven by a
        per-row work table) followed, with collect_tb, by ONE launch of
        the table walker (`traceback_device.decode_packed_tb_table`):
        no per-group launch and no synchronisation. The inputs are copied
        to `device` through pinned memory on the current stream.
        decode="host" is rejected — the raw-plane contract exists only on
        the pipelined path.
      Returns ONE merged dict over sum(N_pad_g) rows in group-major
      order: the scalar keys concatenated, plus (collect_tb) 'cig_ops' /
      'cig_runs' zero-padded on the right to the longest group sweep and
      'cig_len' (`merge_persistent_outputs`' layout). Bit-exact with
      running each group through `run`.

Backends register lazily by module path so importing the registry builds
and loads nothing.
"""

from __future__ import annotations

import importlib

import torch

_LAZY_BACKENDS = {
    "reference": "repro_torch.core.backends.reference",
    "cuda": "repro_torch.core.backends.cuda",
}
_INSTANCES: dict[str, object] = {}


def available_backends() -> tuple[str, ...]:
    """Backend names accepted by `get_backend` (plus 'auto')."""
    return tuple(_LAZY_BACKENDS)


def resolve_backend(name: str) -> str:
    """Map 'auto' to a concrete backend: the CUDA kernels. Raises when
    `torch.cuda.is_available()` is false — ask for 'reference' (and a CPU
    device) explicitly to run without a card."""
    if name != "auto":
        return name
    if not torch.cuda.is_available():
        raise RuntimeError(
            "backend='auto' resolves to the CUDA kernels, but "
            "torch.cuda.is_available() is False; pass backend='reference' "
            "and device='cpu' to run the plain versions on the CPU")
    return "cuda"


def merge_persistent_outputs(outs):
    """Concatenate per-group result dicts into the group-major merged
    layout of the `run_persistent` contract (on the tensors' device).

    Scalar keys concatenate directly. The RLE planes have per-group
    column counts (each group's sweep length bounds its path length), so
    they are zero-padded on the right to the widest group before the
    concat — zero is the 'unused segment' op code, and `cig_len` already
    bounds every consumer's read.
    """
    merged = {}
    for key in outs[0]:
        arrs = [o[key] for o in outs]
        if key in ("cig_ops", "cig_runs"):
            k_max = max(a.shape[1] for a in arrs)
            arrs = [torch.nn.functional.pad(a, (0, k_max - a.shape[1]))
                    for a in arrs]
        merged[key] = torch.cat(arrs)
    return merged


def run_persistent_program(groups, *, align, walker, device, sc,
                           adaptive=True, collect_tb=True, mode="global",
                           decode="device", cell_dtype="int32", xdrop=None):
    """The body both backends' `run_persistent` share: pack the groups
    into one work table, copy it and the flat inputs to `device`, run
    `align` (a `persistent_align_*` function) and, with collect_tb, the
    table `walker` behind it. Returns the merged result as device
    tensors."""
    from repro_torch.core.batch import upload
    from repro_torch.core.traceback_device import device_decode_table
    from repro_torch.kernels.banded_dp.persistent import pack_groups

    if collect_tb and decode != "device":
        raise ValueError(
            "persistent dispatch fuses the traceback decode on-device;"
            " decode='host' exists only on the pipelined path")
    device = torch.device(device)
    table, arrays = pack_groups(groups)
    table = table.to(device)
    q, r, n, m = (upload(a, device) for a in arrays)
    out = align(table, q, r, n, m, sc=sc, adaptive=adaptive,
                collect_tb=collect_tb, mode=mode, cell_dtype=cell_dtype,
                xdrop=xdrop)
    if collect_tb:
        out = device_decode_table(out, table, n, m, mode=mode,
                                  walker=walker)
    return out


def get_backend(name="auto", **opts):
    """Instantiate (and cache the no-option instance of) a backend.

    An already-constructed backend (anything with a `run` method) passes
    through unchanged; `opts` apply only when constructing by name.
    """
    if hasattr(name, "run"):
        return name
    name = resolve_backend(name)
    if name not in _LAZY_BACKENDS:
        raise ValueError(
            f"unknown backend {name!r}; available: {available_backends()}")
    if not opts and name in _INSTANCES:
        return _INSTANCES[name]
    mod = importlib.import_module(_LAZY_BACKENDS[name])
    backend = mod.BACKEND(**opts)
    if not opts:
        _INSTANCES[name] = backend
    return backend
