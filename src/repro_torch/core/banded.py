"""Adaptive banded parallelized DP alignment (paper §IV-B) — plain PyTorch.

This is the paper's core algorithm as a Python loop over wavefront steps
on batched ``(N, B)`` int32 tensors, and the **plain version** of the CUDA
wavefront kernel (`kernels.banded_dp`): the same arithmetic, one tensor op
at a time, on whatever device the inputs live on. The CPU tests run it, the
kernel is held `torch.equal` against it on the card.

  * One loop step == one wavefront move (paper Fig. 4(c) / Fig. 6(c)): the
    band of B anti-diagonal cells advances one step right or down; total
    trip count is n + m ("the required number of iterations equals the sum
    of the two sequences' lengths", §VI-F).
  * The B band lanes update simultaneously — wavefront-level parallelism;
    the N pairs of the batch are the leading tensor dimension
    (sequence-level parallelism, paper Fig. 6(b)).
  * Within a step, all four shifted difference quantities (u'=dH', v'=dV',
    x'=dE', y'=dF') update in parallel from the shared intermediate A' and
    previous-step values only (paper Eq. (4)).
  * The wavefront direction is adaptive (§IV-B2): if the H value of the
    rightmost band cell (lane 0 = smallest i = largest j) exceeds the
    leftmost (lane B-1), the band moves right, else down. Hard feasibility
    clamps guarantee the global-alignment corner (n, m) stays reachable.
  * Traceback flags (4 bits: 2-bit direction + E-extend + F-extend, paper
    §V-C3 "4-bit flags") stream out per step, packed two per byte.

Band geometry: the grid is (n+1) x (m+1) with boundary row/col 0. On
anti-diagonal t the band covers rows i in [lo_t, lo_t + B); cell k is
(i, j) = (lo_t + k, t - lo_t - k). A down-move increments lo. Neighbour
alignment after a move is a +/-1 lane shift.

Output past a pair's last live step is **defined**: a step is live while
``t <= n + m`` and the pair has not been retired by the xdrop rule (the
retiring step itself is not live). ``tb`` rows of non-live steps are 0 and
``los`` holds the frozen band offset there, so two implementations can be
compared over whole tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.scoring import ScoringConfig
from repro_torch.kernels import build

NEG = -(1 << 28)
DEAD_THRESHOLD = -(1 << 27)

#: Steps between two tests of the early exit of the sweep: the loop stops
#: once every pair of the batch is retired or past its true trip count.
#: The test reads one flag back from the device (a host sync), so it runs
#: once per chunk, not per step.
XDROP_CHUNK = 64

# ---------------------------------------------------------------------------
# Narrow-cell storage (paper §IV: the band-relative score spread is bounded
# by the band geometry, so 8/16-bit cells suffice). `cell_dtype="narrow"`
# keeps the wavefront carry as int8 difference planes (u/v/x/y are the
# shifted Eq. (4) quantities, always in [0, M + 2(o+e)]) plus an int16
# band-RELATIVE H with one int32 per-pair base (the running max live H).
# Every step reconstructs exact int32 values, runs the identical int32
# update, and re-narrows — so results are bit-exact with cell_dtype="int32"
# by construction whenever `validate_narrow_cells` accepts the config.
# ---------------------------------------------------------------------------

#: Dead-cell sentinel for the int16 band-relative H plane. Live cells
#: store H - base in [-(INT16_SPREAD_LIMIT), 0]; anything at or below
#: DEAD16 means "not alive" (reconstructed as NEG).
DEAD16 = -(1 << 14)

#: Max live band-relative spread representable without touching DEAD16.
INT16_SPREAD_LIMIT = (1 << 14) - 1

#: Max shifted difference value representable in the int8 u/v/x/y planes.
INT8_DIFF_LIMIT = 127


def narrow_spread_bound(sc: ScoringConfig, band: int) -> int:
    """Conservative bound on max(H) - min(H) over live cells of one band
    diagonal. Adjacent live lanes (i, j) and (i+1, j-1) differ by
    dH(i+1, j-1) - dV(i, j), each in [-(o+e), A + o + e], so one lane
    step moves H by at most A + 2(o+e); we additionally fold in the
    mismatch penalty B for slack against boundary-override cells. Summed
    over the band's B-1 lane gaps (rounded to `band` for headroom)."""
    return band * (sc.match + sc.mismatch + sc.shift)


def validate_narrow_cells(sc: ScoringConfig, band: int) -> None:
    """Static overflow guard for `cell_dtype="narrow"` (paper §IV bound:
    cell width is set by band x max-penalty, not sequence length).

    Raises ValueError when (band, scoring) cannot be proven safe for the
    int8 difference planes + int16 band-relative H carry, so a bad config
    fails loudly instead of silently wrapping.
    """
    diff_max = sc.M + sc.shift
    if diff_max > INT8_DIFF_LIMIT:
        raise ValueError(
            f"narrow cells unsafe: shifted difference range "
            f"match + 2*(gap_open+gap_extend) = {diff_max} exceeds the "
            f"int8 limit {INT8_DIFF_LIMIT} for scoring {sc.name!r}; use "
            f"cell_dtype='int32' or a smaller-penalty scoring config")
    spread = narrow_spread_bound(sc, band)
    if spread > INT16_SPREAD_LIMIT:
        raise ValueError(
            f"narrow cells unsafe: band-relative score spread bound "
            f"band * (match + mismatch + 2*(gap_open+gap_extend)) = "
            f"{band} * {sc.match + sc.mismatch + sc.shift} = {spread} "
            f"exceeds the int16 live range {INT16_SPREAD_LIMIT}; shrink "
            f"the band below "
            f"{INT16_SPREAD_LIMIT // (sc.match + sc.mismatch + sc.shift)} "
            f"or use cell_dtype='int32'")

# ---------------------------------------------------------------------------
# Packed traceback-plane layout (paper §III / §V-C3: 4-bit flags). Two band
# lanes share one byte:
#
#     packed[..., b] = flags(lane 2b) | flags(lane 2b+1) << 4
#
# i.e. the EVEN lane rides the LOW nibble and the ODD lane the HIGH nibble.
# For odd band widths the last byte carries a single valid nibble (lane
# B-1 in its low nibble) and its high nibble is zero. See DESIGN.md §5.
# ---------------------------------------------------------------------------

#: Traceback flags packed per plane byte (two 4-bit flags).
TB_LANES_PER_BYTE = 2


def packed_tb_width(band: int) -> int:
    """Bytes per wavefront step of the packed traceback plane:
    ``ceil(band / 2)`` — the last byte is half-empty when ``band`` is odd."""
    return (band + 1) // 2


def pack_tb_lanes(code):
    """Pack 4-bit traceback flags two-per-byte along the last axis.

    ``code`` is an any-rank integer tensor (or array) with the lane axis
    last (values < 16); returns a uint8 tensor of shape
    ``(..., ceil(B / 2))`` in the low/high-nibble layout above.
    """
    code = torch.as_tensor(code)
    *lead, B = code.shape
    low = code[..., 0::2].to(torch.int32)    # ceil(B/2) even lanes
    high = code[..., 1::2].to(torch.int32)   # floor(B/2) odd lanes
    if B % 2:  # odd B: the last byte's high nibble is zero padding
        high = torch.cat(
            [high, torch.zeros((*lead, 1), dtype=torch.int32,
                               device=code.device)], dim=-1)
    return (low | (high << 4)).to(torch.uint8)


def select_tb_nibble(byte, lane):
    """4-bit flag of band lane ``lane`` from its packed plane byte
    (`pack_tb_lanes` layout: even lane = low nibble, odd lane = high).

    Written operator-wise so it serves both decoders: the host walkers
    pass numpy arrays, the plain device walker (`core.traceback_device`)
    passes int32 tensors.
    """
    return (byte >> ((lane & 1) * 4)) & 0xF


def unpack_tb_lanes(packed, band: int) -> np.ndarray:
    """Inverse of `pack_tb_lanes` (numpy, host-side).

    Debug/test helper only — the production decoders read nibbles
    straight from the packed plane and never materialise the unpacked
    layout.
    """
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed)
    out = np.empty((*packed.shape[:-1], packed.shape[-1] * 2), np.uint8)
    out[..., 0::2] = packed & 0xF
    out[..., 1::2] = packed >> 4
    return out[..., :band]


def _shift_away_lane0(a, fill):
    """result[:, k] = a[:, k-1]; lane 0 <- fill."""
    return torch.cat([torch.full_like(a[:, :1], fill), a[:, :-1]], dim=1)


def _shift_toward_lane0(a, fill):
    """result[:, k] = a[:, k+1]; last lane <- fill."""
    return torch.cat([a[:, 1:], torch.full_like(a[:, :1], fill)], dim=1)


def _widen(u, v, x, y, H, base):
    """Exact int32 view of a (possibly narrow) carry: u/v/x/y widened,
    H reconstructed as base + Hrel with DEAD16-sentinel cells -> NEG."""
    if H.dtype == torch.int16:
        H32 = torch.where(H <= DEAD16, NEG, base + H.to(torch.int32))
        H32 = H32.to(torch.int32)
    else:
        H32 = H
    return (u.to(torch.int32), v.to(torch.int32), x.to(torch.int32),
            y.to(torch.int32), H32)


def _narrow(H_new, u_new, v_new, x_new, y_new, cell_dtype: str):
    """Re-narrow the freshly computed int32 planes for the carry.

    Narrow mode: base = max live H this diagonal (there is always at
    least one live cell while t <= n + m); live cells store H - base in
    int16, clamped at DEAD16 + 1 as a belt-and-braces saturation floor —
    `validate_narrow_cells` proves the clamp never binds. u/v/x/y are
    stored int8 (range [0, M + 2(o+e)], boundary overrides included).
    Returns (H, u, v, x, y, base) with base an (N, 1) int32 tensor.
    """
    if cell_dtype != "narrow":
        return (H_new, u_new, v_new, x_new, y_new,
                torch.zeros_like(H_new[:, :1]))
    live = H_new > DEAD_THRESHOLD
    base = torch.where(live, H_new, NEG).amax(dim=1, keepdim=True)
    rel = torch.clamp(H_new - base, min=DEAD16 + 1)
    H16 = torch.where(live, rel, DEAD16).to(torch.int16)
    return (H16, u_new.to(torch.int8), v_new.to(torch.int8),
            x_new.to(torch.int8), y_new.to(torch.int8),
            base.to(torch.int32))


def banded_align_batch(q_batch, r_batch, n_batch, m_batch, *, sc, band,
                       adaptive=True, collect_tb=True, mode="global",
                       t_max: int | None = None,
                       cell_dtype: str = "int32",
                       xdrop: int | None = None, device=None):
    """Align a padded batch of (query, reference) pairs with the adaptive
    banded parallelized DP — the plain PyTorch version of the wavefront.

    Args:
      q_batch: (N, Lq) encoded queries (int8/int32, padded with 4).
      r_batch: (N, Lr) encoded references.
      n_batch, m_batch: (N,) true lengths (ragged batches).
      sc: scoring config.
      band: band width B.
      adaptive: adaptive wavefront direction on/off (Table V ablation).
      collect_tb: stream traceback flags (off = score-only, Fig. 14).
      t_max: trimmed sweep length — the wavefront runs t_max steps
        instead of the full padded Lq + Lr (§VI-F: the required trip count
        is the *true* n + m). Must satisfy t_max >= n + m for every pair;
        scores and CIGARs are invariant to any valid choice because the
        carry freezes past t = n + m. None = full padded sweep.
      cell_dtype: "int32" (default) or "narrow" — carry the wavefront
        state as int8 difference planes + int16 band-relative H (paper
        §IV bit-width reduction). Bit-exact with int32 whenever
        `validate_narrow_cells(sc, band)` accepts the config (callers
        invoke the guard).
      xdrop: X-drop early-exit threshold. A pair retires the first step
        its live-band max H falls more than xdrop below the pair's
        running best; retired pairs freeze their carry (the same freeze
        as t > n + m), report 'status' = the retiring step and keep
        'score' at the NEG sentinel. The loop leaves early, tested once
        per `XDROP_CHUNK` steps, when every pair is retired or finished.
        None (default) = no retirement; any surviving pair is
        bit-identical either way.
      device: where numpy/list inputs are placed; tensors stay where they
        are when None.

    Returns a dict of (N,) int32 'score', 'final_lo', 'best_score',
    'best_i', 'best_j', 'status' (0 = aligned, k > 0 = retired by xdrop
    at step k), and when collect_tb: 'tb' ((N, T, ceil(B/2)) uint8 —
    4-bit flags packed two lanes per byte, even lane in the low nibble;
    see `pack_tb_lanes`) and 'los' ((N, T+1) int32 band offsets,
    los[:, 0] = 0), where T = t_max or Lq + Lr. Rows of 'tb' at non-live
    steps are 0 and 'los' holds the frozen offset there.
    """
    build.count(banded_align_batch, "calls")
    q = torch.as_tensor(q_batch, device=device)
    dev = q.device
    q = q.to(torch.int32)
    r = torch.as_tensor(r_batch, device=dev).to(torch.int32)
    n = torch.as_tensor(n_batch, device=dev).to(torch.int32).reshape(-1, 1)
    m = torch.as_tensor(m_batch, device=dev).to(torch.int32).reshape(-1, 1)
    N, Lq = q.shape
    Lr = r.shape[1]
    T = int(t_max) if t_max is not None else Lq + Lr
    B = int(band)
    narrow = cell_dtype == "narrow"
    o, e = sc.gap_open, sc.gap_extend
    oe = o + e
    shift = 2 * (o + e)
    nm = n + m
    lanes = torch.arange(B, dtype=torch.int32, device=dev).reshape(1, B)

    def full(shape, value, dtype=torch.int32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    # Diagonal t=0: only cell (0,0) is alive, with H=0 and zero deltas.
    z = full((N, B), 0, torch.int8 if narrow else torch.int32)
    u_st, v_st, x_st, y_st = z, z.clone(), z.clone(), z.clone()
    if narrow:
        H_st = full((N, B), DEAD16, torch.int16)
    else:
        H_st = full((N, B), NEG)
    H_st[:, 0] = 0
    base_st = full((N, 1), 0)
    lo = full((N, 1), 0)
    score = full((N, 1), NEG)
    final_lo = full((N, 1), 0)
    best = full((N, 1), NEG if mode == "semiglobal" else 0)
    best_i = full((N, 1), 0)
    best_j = full((N, 1), 0)
    pair_best = full((N, 1), 0)
    retired_at = full((N, 1), 0)
    if collect_tb:
        tb = full((N, T, packed_tb_width(B)), 0, torch.uint8)
        los = full((N, T + 1), 0)

    t_last = 0
    for t in range(1, T + 1):
        s_u, s_v, s_x, s_y, s_H = _widen(u_st, v_st, x_st, y_st, H_st,
                                         base_st)

        # ---- 1. Wavefront direction (paper §IV-B2 + feasibility clamps)
        # Corner reachability: going right now, lo can still grow by at
        # most (n + m - t); the final diagonal needs lo_final >= n - B + 1.
        must_down = (lo + (nm - t)) < (n - B + 1)
        must_right = lo >= n
        if adaptive:
            # Rightmost band cell = lane 0 (largest j); leftmost = B-1.
            heur_right = s_H[:, :1] > s_H[:, B - 1:]
        else:
            # Fixed direction: steer the band centre toward the main
            # diagonal. int32 arithmetic (it wraps past the 16384 bucket
            # edge exactly as two's-complement int32 does).
            heur_right = (2 * lo + B) * nm >= 2 * t * n
        go_down = must_down | (~must_right & ~heur_right)
        lo_new = lo + go_down.to(torch.int32)

        # ---- 2. Align previous-diagonal neighbours to the new band ----
        # down: up[k] = prev[k],   left[k] = prev[k+1]
        # right: up[k] = prev[k-1], left[k] = prev[k]
        def pick_up(a, fill):
            return torch.where(go_down, a, _shift_away_lane0(a, fill))

        def pick_left(a, fill):
            return torch.where(go_down, _shift_toward_lane0(a, fill), a)

        up_H = pick_up(s_H, NEG)
        up_x = pick_up(s_x, 0)
        up_v = pick_up(s_v, 0)
        left_H = pick_left(s_H, NEG)
        left_y = pick_left(s_y, 0)
        left_u = pick_left(s_u, 0)
        up_valid = up_H > DEAD_THRESHOLD
        left_valid = left_H > DEAD_THRESHOLD

        # ---- 3. Cell coordinates, masks, substitution scores ----
        i_vec = lo_new + lanes          # (N, B)
        j_vec = t - i_vec
        valid = (i_vec >= 0) & (i_vec <= n) & (j_vec >= 0) & (j_vec <= m)
        interior = valid & (i_vec >= 1) & (j_vec >= 1)
        brow = valid & (i_vec == 0) & (j_vec >= 1)   # boundary row 0
        bcol = valid & (j_vec == 0) & (i_vec >= 1)   # boundary column 0

        qb = torch.gather(q, 1, torch.clamp(i_vec - 1, 0, Lq - 1).long())
        rb = torch.gather(r, 1, torch.clamp(j_vec - 1, 0, Lr - 1).long())
        is_match = (qb == rb) & (qb < 4) & (rb < 4)
        s_sub = torch.where(is_match, sc.match, -sc.mismatch).to(torch.int32)

        # ---- 4. Parallelized shifted update (Eq. (4)) ----
        x_arm = torch.where(up_valid, up_x, NEG)
        y_arm = torch.where(left_valid, left_y, NEG)
        v_up = torch.where(up_valid, up_v, oe)   # neutral: dV_up = 0
        u_left = torch.where(left_valid, left_u, oe)
        diag_valid = up_valid | left_valid
        s_arm = torch.where(diag_valid, s_sub + shift, NEG)

        a_new = torch.maximum(torch.maximum(s_arm, x_arm), y_arm)
        u_new = a_new - v_up
        v_new = a_new - u_left
        x_new = torch.maximum(a_new, x_arm + o) - u_left
        y_new = torch.maximum(a_new, y_arm + o) - v_up
        H_new = torch.where(up_valid, up_H + u_new - oe,
                            torch.where(left_valid, left_H + v_new - oe,
                                        NEG))

        # ---- 5. Traceback flags (paper Eq. (5), 4-bit) ----
        if collect_tb:
            direction = torch.where(a_new == s_arm, 0,
                                    torch.where(a_new == x_arm, 1, 2))
            ext_e = ((x_arm + o) > a_new).to(torch.int32)
            ext_f = ((y_arm + o) > a_new).to(torch.int32)
            code = direction + 4 * ext_e + 8 * ext_f
            code = pack_tb_lanes(torch.where(interior, code, 0))

        # ---- 6. Boundary overrides (constants derived in the paper's
        # difference recurrence) ----
        if mode == "semiglobal":
            # Free leading reference gap: H(0,j) = 0 for all j, so
            # dV(0,j) = 0 -> v' = o+e; dE(0,j) = -(o+e) -> x' = o+e.
            v_new = torch.where(brow, oe, v_new)
            x_new = torch.where(brow, oe, x_new)
            H_brow = torch.zeros_like(H_new)
        else:
            first = torch.where(j_vec == 1, 0, o)
            v_new = torch.where(brow, first, v_new)
            x_new = torch.where(brow, first, x_new)
            H_brow = -(o + j_vec * e)
        u_new = torch.where(brow, o, u_new)
        y_new = torch.where(brow, o, y_new)
        first = torch.where(i_vec == 1, 0, o)
        u_new = torch.where(bcol, first, u_new)
        y_new = torch.where(bcol, first, y_new)
        v_new = torch.where(bcol, o, v_new)
        x_new = torch.where(bcol, o, x_new)
        H_new = torch.where(brow, H_brow, H_new)
        H_new = torch.where(bcol, -(o + i_vec * e), H_new)

        # Dead cells.
        H_new = torch.where(valid, H_new, NEG).to(torch.int32)
        u_new = torch.where(valid, u_new, 0).to(torch.int32)
        v_new = torch.where(valid, v_new, 0).to(torch.int32)
        x_new = torch.where(valid, x_new, 0).to(torch.int32)
        y_new = torch.where(valid, y_new, 0).to(torch.int32)

        # ---- 7. X-drop retire rule + score capture ----
        done = nm == t
        in_sweep = nm >= t
        if xdrop is None:
            active = in_sweep
        else:
            # Retire when the whole live band fell > xdrop below the
            # pair's running best (dead cells are NEG, so the band max is
            # over live cells only). ~done keeps the final corner step
            # eligible for score capture: a pair never retires on its
            # last diagonal.
            band_max = H_new.amax(dim=1, keepdim=True)
            pb_new = torch.maximum(pair_best, band_max)
            newly = in_sweep & (retired_at == 0) & ~done & \
                (band_max < pb_new - int(xdrop))
            retired_at = torch.where(newly, t, retired_at).to(torch.int32)
            active = in_sweep & (retired_at == 0)
            pair_best = torch.where(active, pb_new, pair_best)

        k_corner = torch.clamp(n - lo_new, 0, B - 1).long()
        h_corner = torch.gather(H_new, 1, k_corner)
        # Gate on active too: a retired pair's recomputed planes must
        # never leak into score capture (no-op when xdrop is None).
        capture = done & active
        score = torch.where(capture, h_corner, score)
        final_lo = torch.where(capture, lo_new, final_lo)

        # Extension / local-max tracking (paper §III-A2: local traceback
        # starts from the max-score cell). Only interior cells compete —
        # in semiglobal mode only cells on the last read row.
        elig = interior & active
        if mode == "semiglobal":
            elig = elig & (i_vec == n)
        H_masked = torch.where(elig, H_new, NEG)
        cand = H_masked.amax(dim=1, keepdim=True)
        # First (smallest-k) maximising lane.
        k_best = torch.where(H_masked == cand, lanes, B).amin(
            dim=1, keepdim=True)
        k_best = torch.clamp(k_best, 0, B - 1).long()
        better = cand > best
        best = torch.where(better, cand, best)
        best_i = torch.where(better, torch.gather(i_vec, 1, k_best), best_i)
        best_j = torch.where(better, torch.gather(j_vec, 1, k_best), best_j)

        # Freeze the carry once past the final diagonal (ragged lengths
        # run extra steps for shorter pairs) — and once retired.
        H_nw, u_nw, v_nw, x_nw, y_nw, base_nw = _narrow(
            H_new, u_new, v_new, x_new, y_new, cell_dtype)
        u_st = torch.where(active, u_nw, u_st)
        v_st = torch.where(active, v_nw, v_st)
        x_st = torch.where(active, x_nw, x_st)
        y_st = torch.where(active, y_nw, y_st)
        H_st = torch.where(active, H_nw, H_st)
        base_st = torch.where(active, base_nw, base_st)
        lo = torch.where(active, lo_new, lo)

        if collect_tb:
            tb[:, t - 1] = torch.where(active, code, 0)
            los[:, t] = lo[:, 0]
        t_last = t

        # Early exit, one host sync per chunk: nothing is live any more.
        if t % XDROP_CHUNK == 0 and t < T:
            if not bool(((retired_at == 0) & (nm > t)).any()):
                break

    if collect_tb and t_last < T:
        los[:, t_last + 1:] = lo
    out = {"score": score[:, 0], "final_lo": final_lo[:, 0],
           "best_score": best[:, 0], "best_i": best_i[:, 0],
           "best_j": best_j[:, 0], "status": retired_at[:, 0]}
    if collect_tb:
        out["tb"] = tb
        out["los"] = los
    return out


#: Calls of the plain wavefront since the count was last set to 0 (a run
#: on the card checks that its main path never took the plain version).
banded_align_batch.calls = 0


def banded_align(q_pad, r_pad, n, m, *, sc, band, adaptive=True,
                 collect_tb=True, mode="global", t_max: int | None = None,
                 cell_dtype: str = "int32", xdrop: int | None = None,
                 device=None):
    """Align one (query, reference) pair: `banded_align_batch` at N = 1,
    the reference's single-pair entry point.

    q_pad: (n_pad,) encoded query (padded with 4); r_pad: (m_pad,)
    reference; n, m: true lengths. Other arguments as for
    `banded_align_batch`. Returns the same dict with 0-d int32 scalars
    and, when collect_tb, 'tb' (T, ceil(B/2)) uint8 and 'los' (T+1,)
    int32, where T = t_max or n_pad + m_pad.
    """
    q = torch.as_tensor(q_pad, device=device)
    dev = q.device
    out = banded_align_batch(
        q[None], torch.as_tensor(r_pad, device=dev)[None],
        torch.as_tensor(n, device=dev).reshape(1),
        torch.as_tensor(m, device=dev).reshape(1), sc=sc, band=band,
        adaptive=adaptive, collect_tb=collect_tb, mode=mode, t_max=t_max,
        cell_dtype=cell_dtype, xdrop=xdrop)
    return {key: v[0] for key, v in out.items()}


# ---------------------------------------------------------------------------
# Traceback decode (paper §V-C3) — host-side, mirroring the peripheral
# traceback logic. Exact affine walk using the 4-bit flags.
# ---------------------------------------------------------------------------

def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def traceback_banded(tb, los, n: int, m: int,
                     band: int) -> list[tuple[str, int]]:
    """Decode one packed (T, ceil(B/2)) flag plane into a CIGAR.

    Lane k of step t (the cell (i, j) with i + j = t and k = i - los[t])
    lives in byte ``tb[t-1, k // 2]``: low nibble for even k, high nibble
    for odd k (`pack_tb_lanes` layout). Flags: bits 0-1 direction
    (0 diag / 1 E / 2 F), bit 2 E-extend, bit 3 F-extend (the extend bit
    of cell (i,j) describes the E/F value *entering* cell (i+1,j) /
    (i,j+1), per the Eq. (4) regrouping).

    Per-pair oracle — the production path is `traceback_banded_batch`.
    """
    tb = _to_numpy(tb)
    los = _to_numpy(los)

    def code(i, j):
        t = i + j
        k = i - int(los[t])
        if t < 1 or k < 0 or k >= band:
            return None  # path escaped the band: heuristic loss
        return int(select_tb_nibble(int(tb[t - 1, k >> 1]), k))

    ops: list[str] = []
    i, j = n, m
    state = "M"
    while i > 0 or j > 0:
        if i == 0:
            ops.append("D")
            j -= 1
            continue
        if j == 0:
            ops.append("I")
            i -= 1
            continue
        c = code(i, j)
        if c is None:
            # Escaped the band — fall back to a diagonal step (should not
            # happen for paths the band actually scored).
            ops.append("M")
            i -= 1
            j -= 1
            continue
        if state == "M":
            d = c & 3
            if d == 0:
                ops.append("M")
                i -= 1
                j -= 1
            elif d == 1:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            ops.append("I")
            up = code(i - 1, j)
            ext = bool(up & 4) if (up is not None and i - 1 >= 1 and j >= 1) else False
            i -= 1
            if not ext:
                state = "M"
        else:  # "F"
            ops.append("D")
            left = code(i, j - 1)
            ext = bool(left & 8) if (left is not None and j - 1 >= 1 and i >= 1) else False
            j -= 1
            if not ext:
                state = "M"
    ops.reverse()
    cigar: list[tuple[str, int]] = []
    for op in ops:
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + 1)
        else:
            cigar.append((op, 1))
    return cigar


# Batched traceback op codes (0 = no emission this sweep iteration).
_OP_CHARS = "?MID"
_OP_M, _OP_I, _OP_D = 1, 2, 3


def traceback_banded_batch(tb, los, n, m, band: int, *, starts=None
                           ) -> list[list[tuple[str, int]]]:
    """Vectorised CIGAR decode of a whole dispatch group at once (numpy).

    Walks all N tracebacks in lockstep: every sweep iteration advances every
    still-active pair by one traceback step with O(N) numpy gathers instead
    of a per-pair Python loop. Semantics are identical to per-pair
    `traceback_banded` (same flag encoding, same band-escape fallback).

    Decodes straight from the *packed* plane: each flag lookup is one byte
    gather plus a shift/mask nibble select, so the unpacked (N, T, B)
    layout is never materialised on the host.

    Args:
      tb: (N, T, ceil(B/2)) uint8 packed flag planes (`pack_tb_lanes`
        layout: even lane in the low nibble, odd lane in the high nibble).
      los: (N, T+1) int32 band offsets.
      n, m: (N,) true lengths (the default traceback start cells).
      band: band width B shared by the group.
      starts: optional (N, 2) start cells (i, j) — pass the tracked best
        cells for semiglobal/extension mode; defaults to (n, m).

    Returns a list of N CIGARs ([(op, run_len), ...]).
    """
    tb = _to_numpy(tb)
    los = _to_numpy(los)
    n = _to_numpy(n).astype(np.int64).reshape(-1)
    m = _to_numpy(m).astype(np.int64).reshape(-1)
    N = tb.shape[0]
    if N == 0:
        return []
    T = tb.shape[1]
    if starts is None:
        i, j = n.copy(), m.copy()
    else:
        starts = _to_numpy(starts).astype(np.int64)
        i, j = starts[:, 0].copy(), starts[:, 1].copy()

    cap = max(int((i + j).max()), 1)
    ops_buf = np.zeros((N, cap), np.uint8)
    ops_len = np.zeros(N, np.int64)
    state = np.zeros(N, np.uint8)  # 0 = M, 1 = E (ins run), 2 = F (del run)
    idx = np.arange(N)

    def lookup(ii, jj):
        """Flags at (ii, jj) per pair + in-band validity (t >= 1 and the
        lane inside [0, band)). One byte gather from the packed plane,
        then a nibble select by lane parity."""
        t = ii + jj
        k = ii - los[idx, np.clip(t, 0, los.shape[1] - 1)]
        ok = (t >= 1) & (k >= 0) & (k < band)
        kc = np.clip(k, 0, band - 1)
        byte = tb[idx, np.clip(t - 1, 0, T - 1), kc >> 1]
        return select_tb_nibble(byte, kc), ok

    while True:
        active = (i > 0) | (j > 0)
        if not active.any():
            break
        c, in_band = lookup(i, j)

        emit = np.zeros(N, np.uint8)
        di = np.zeros(N, np.int64)
        dj = np.zeros(N, np.int64)
        new_state = state.copy()

        # Boundary row/column: forced gaps.
        b_del = active & (i == 0)
        emit[b_del] = _OP_D
        dj[b_del] = 1
        b_ins = active & (i > 0) & (j == 0)
        emit[b_ins] = _OP_I
        di[b_ins] = 1

        interior = active & (i > 0) & (j > 0)
        # Escaped the band: diagonal fallback (heuristic loss).
        esc = interior & ~in_band
        emit[esc] = _OP_M
        di[esc] = 1
        dj[esc] = 1

        core = interior & in_band
        d = c & 3
        in_m = core & (state == 0)
        m_diag = in_m & (d == 0)
        emit[m_diag] = _OP_M
        di[m_diag] = 1
        dj[m_diag] = 1
        # d != 0: enter a gap run — state change only, no emission/move.
        new_state[in_m & (d == 1)] = 1
        new_state[in_m & (d >= 2)] = 2

        in_e = core & (state == 1)
        emit[in_e] = _OP_I
        di[in_e] = 1
        cu, up_ok = lookup(i - 1, j)
        ext_e = up_ok & (i - 1 >= 1) & (j >= 1) & ((cu & 4) != 0)
        new_state[in_e & ~ext_e] = 0

        in_f = core & (state == 2)
        emit[in_f] = _OP_D
        dj[in_f] = 1
        cl, left_ok = lookup(i, j - 1)
        ext_f = left_ok & (j - 1 >= 1) & (i >= 1) & ((cl & 8) != 0)
        new_state[in_f & ~ext_f] = 0

        do = active & (emit != 0)
        ops_buf[idx[do], ops_len[do]] = emit[do]
        ops_len[do] += 1
        i -= np.where(active, di, 0)
        j -= np.where(active, dj, 0)
        state = np.where(active, new_state, state).astype(np.uint8)

    cigars: list[list[tuple[str, int]]] = []
    for p in range(N):
        ops = ops_buf[p, :ops_len[p]][::-1]
        if ops.size == 0:
            cigars.append([])
            continue
        bounds = np.flatnonzero(np.diff(ops)) + 1
        seg_starts = np.concatenate([[0], bounds])
        seg_ends = np.concatenate([bounds, [ops.size]])
        cigars.append([(_OP_CHARS[int(ops[s])], int(e - s))
                       for s, e in zip(seg_starts, seg_ends)])
    return cigars
