"""Closed-form roofline cost model of the alignment workload.

The reference's own bound on aligned pairs/s for a (length, band, pairs,
mesh, dispatch mode) record, computed from first principles and the same
for whatever implements the work, here on an H100 record by default
(`analysis.H100_INT32`: the DP is int32 work outside the tensor cores).

Only the alignment half of the reference module is ported:
`analytic_roofline` sends ``arch == "rapidx-align"`` records to
`alignment_roofline` and raises for the language models, whose half needs
the train-step microbatch policy (`launch/specs.py:microbatches_for`,
ROADMAP A11d).
"""

from __future__ import annotations

from repro_torch.roofline.analysis import H100_INT32, Hardware, roofline_terms

#: Divergence rate assumed for the RLE host-fetch estimate: one op-run
#: boundary per ~20 bases (read error + true-variant events), i.e. each
#: event ends an M run and opens/closes a gap or mismatch context.
ALIGN_DIVERGENCE = 0.05

#: Fixed cost charged per device dispatch: launch plus host mediation of
#: one group boundary (Python driver, argument staging, the fetch). An
#: assumed model charge, the reference's figure, not a measurement of this
#: package: the pipelined scheduler pays it once per dispatch group, the
#: persistent dispatch once per request.
DISPATCH_OVERHEAD_S = 100e-6

#: Band-state bytes per lane touched per wavefront step, by storage
#: precision: int32 keeps u/v/x/y/H at 4 B each; narrow packs the four
#: difference planes to int8 and H to a band-relative int16 (paper §IV
#: bit-width reduction) — 4 x 1 + 2 bytes.
CELL_STATE_BYTES = {"int32": 5 * 4, "narrow": 4 * 1 + 2}


def alignment_roofline(record: dict, hw: Hardware = H100_INT32) -> dict:
    """Roofline for the rapidx-align cells (the paper's own workload).

    Per wavefront step each lane does ~15 int32 operations (Eq. 4 update +
    masks + traceback encode); a pair of length L runs 2L steps over B
    lanes (equal-length pairs: the trimmed sweep t_max equals the true
    n + m = 2L). Traceback streams the *packed* plane — two 4-bit flags
    per byte, (2L x ceil(B/2)) uint8 per pair (DESIGN.md §5) — to HBM,
    where the on-device walker reads it back and reduces it to RLE
    CIGARs; sequences stream in once. The host-interface fetch is
    therefore charged with the **RLE bytes** (5 bytes per CIGAR segment
    + the per-pair length), not the packed plane — the plane never
    crosses the host interface (DESIGN.md §5). Collectives are zero by
    construction (tile independence).

    X-drop-aware trip counting: the record may carry ``reject_fraction``
    (share of pairs the xdrop rule retires, 0.0 = off) and
    ``reject_step_frac`` (the mean retiring step as a fraction of the
    full 2L sweep, default 0.5). The model then charges each pair its
    *expected surviving steps* — compute and tb traffic scale by
    ``1 - reject_fraction * (1 - reject_step_frac)`` — and drops the RLE
    fetch for retired pairs (they return only scalars). Defaults
    reproduce the xdrop-off numbers exactly.

    Dispatch-mode-aware launch charging: the record may carry
    ``dispatch`` ("pipelined"/"persistent"), ``n_groups`` and
    ``cell_dtype``. The pipelined scheduler pays `DISPATCH_OVERHEAD_S`
    once per dispatch group; the persistent dispatch pays it once per
    request (`core.engine` dispatch="persistent") — `step_time_total_s`
    adds that charge to the overlap bound and the pairs/s bound uses it.
    `cell_state_bytes_per_pair` reports the band-state bytes the sweep
    touches under the chosen cell dtype (an on-chip working set, NOT HBM
    traffic).
    """
    L = record["length"]
    B_band = record["band"]
    batch = record["global_batch"]
    chips = 1
    for s in record.get("mesh_shape", [1]):
        chips *= s
    dp = chips  # alignment shards batch over every axis it can
    pairs_dev = batch / min(dp, batch)
    # Expected surviving step fraction under xdrop: a retired pair stops
    # sweeping (and storing tb) at its retiring step instead of 2L.
    reject_frac = float(record.get("reject_fraction", 0.0))
    reject_step_frac = float(record.get("reject_step_frac", 0.5))
    survive_steps = 1.0 - reject_frac * (1.0 - reject_step_frac)
    ops = 2 * L * B_band * 15 * survive_steps  # int ops per pair
    flops_dev = pairs_dev * ops
    # packed tb plane per pair (expected stored rows under xdrop)
    tb_bytes = 2 * L * ((B_band + 1) // 2) * survive_steps
    seq_bytes = 2 * L * 4
    # HBM traffic: TBM store by the compute + read-back by the on-device
    # decoder (the walk's gathers re-touch at most the plane once).
    bytes_dev = pairs_dev * (2 * tb_bytes + seq_bytes)
    # Host-interface fetch per pair: the trimmed RLE arrays. Segment
    # count ~ 2 boundaries per divergence event + 1 (DESIGN.md §4b),
    # over the ~L ops of a near-diagonal alignment path (the path is L
    # ops long, not the 2L wavefront sweeps it takes to compute it).
    # Retired pairs have no path — they fetch only the scalar row.
    rle_segments = 2 * ALIGN_DIVERGENCE * L + 1
    host_fetch_bytes = pairs_dev * (
        5 * rle_segments * (1.0 - reject_frac) + 4)
    terms = roofline_terms(flops_dev, bytes_dev, 0.0, hw)
    dispatch = record.get("dispatch", "pipelined")
    n_groups = int(record.get("n_groups", 1))
    launches = 1 if dispatch == "persistent" else n_groups
    dispatch_overhead_s = launches * DISPATCH_OVERHEAD_S
    step_time_total_s = terms["step_time_overlap_s"] + dispatch_overhead_s
    cell_dtype = record.get("cell_dtype", "int32")
    return {
        "cell": f"rapidx-align/{record['shape']}/{record.get('mesh', '?')}",
        "chips": chips,
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": 0.0,
        "host_fetch_bytes_per_device": host_fetch_bytes,
        "tb_plane_bytes_per_pair": tb_bytes,
        "dispatch": dispatch,
        "reject_fraction": reject_frac,
        "surviving_step_fraction": survive_steps,
        "launches": launches,
        "dispatch_overhead_s": dispatch_overhead_s,
        "step_time_total_s": step_time_total_s,
        "cell_state_bytes_per_pair":
            2 * L * B_band * CELL_STATE_BYTES[cell_dtype],
        **terms,
        "pairs_per_s_per_chip_bound":
            1.0 / max(step_time_total_s / pairs_dev, 1e-30),
    }


def analytic_roofline(record: dict, hw: Hardware = H100_INT32) -> dict:
    """record: arch/shape/mesh + mesh_shape. Only the alignment workload
    (``arch == "rapidx-align"``) is modelled in this package."""
    if record.get("arch") == "rapidx-align":
        return alignment_roofline(record, hw)
    raise NotImplementedError(
        f"analytic_roofline for arch {record.get('arch')!r}: the language "
        "models' half needs launch/specs.py:microbatches_for, not ported "
        "yet (ROADMAP A11d)")
