"""The work of one call of each hand-written kernel: its operations, by
the peak rate they run at, and the bytes it must move (each input read
once, each output written once), computed from the call's shapes.

One formula per kernel, shared by the two readers of it: the bounds of
`chip_smoke.py`'s kernel table (the least time the card could take: the
larger of the operations over their peak and the bytes over HBM's rate)
and the dry run's count of a step's work (`launch.dryrun`), to which
every kernel wrapper reports its call when a counter is active
(`build.WORK`). Where the work depends on the data (B1's live steps), the
caller passes what its inputs need.

Peaks are the published dense rates of one H100 SXM (NVIDIA's data sheet,
at the full 700 W power limit), the same as `roofline.analysis.H100` and
`H100_INT32`: 989 TFLOP/s bf16 on the tensor cores, 494.7 TFLOP/s TF32,
67 TFLOP/s f32 on the FMA units, 16.75 TOP/s int32 (a quarter of the f32
figure: half the lanes, one operation an instruction), 3.35 TB/s of HBM.
"""

from __future__ import annotations

import dataclasses

#: Operations a second by peak class.
PEAKS = {"bf16": 989e12, "tf32": 494.7e12, "f32": 67e12, "int32": 16.75e12}
#: HBM bytes a second.
HBM_BYTES_PER_S = 3.35e12

#: FLOP per live (query, key) pair and head size unit of B5's forward
#: (QK^T and PV, two products of 2 D) and of its backwards (five
#: products: S = QK^T, dP = dO V^T, dV += P^T dO, dK += dS^T Q, dQ += dS K).
FLASH_FWD_OPS_PER_PAIR_PER_D = 4
FLASH_BWD_OPS_PER_PAIR_PER_D = 10
#: int32 operations per band cell and wavefront step of B1 and B2, counted
#: from the plain version's step (selects, compares, adds, maxima, index
#: clamps, flag packing, reductions).
WAVEFRONT_OPS_PER_CELL = 80
#: f32 operations per (b, t, d) of B6's gates and step (two sigmoids, exp,
#: sqrt, max and the products; a transcendental counts one), and of B6-bwd
#: (the gates and h recomputed, the reverse step and the gate chain).
RGLRU_OPS_PER_ELEM = 16
RGLRU_BWD_OPS_PER_ELEM = 40
#: f32 operations per (b, head, step, unit) of B8's cell beside the 8 Dh
#: of its recurrent product.
SLSTM_CELL_OPS = 24
#: The same of the sLSTM cell's backward beside the recurrent products (a
#: multiply, an add, a max, a compare or a select counting one, as does a
#: transcendental or a division), term by term as `slstm_bwd.cu`'s note
#: writes the function, each shared value once. The step's forward from
#: its record, 21: f~ 1, log_sigmoid(f~) 2, m' 2, i' 2, f' 2, z 1, o 3,
#: c' 3, n' 2, 1 / n' 2, the max's branch 1. Its backward, 31: dh_t 1;
#: c' / n', o / n', do, dc', o c' / n'^2, dn' 8; delta_z 4; delta_i 3;
#: delta_f 5 and sigmoid(-f~) 3; delta_o 3; dc, dn 2; g onto the winning
#: branch and on to the step before 2.
SLSTM_BWD_CELL_OPS = 52


@dataclasses.dataclass(frozen=True)
class Work:
    """One call's work: operations by peak class (a key of `PEAKS`) and
    the bytes it must move."""
    ops: dict
    nbytes: int

    @property
    def total_ops(self) -> int:
        return sum(self.ops.values())

    def at(self, peak: str) -> "Work":
        """The same work with every operation at the peak `peak` (a
        yardstick: B7-bwd's bound before its products went to the tensor
        cores)."""
        return Work({peak: self.total_ops}, self.nbytes)

    def bound(self) -> tuple:
        """(ms, "operations" or "bytes"): the larger of each class's
        operations over its peak and the bytes over HBM's rate."""
        t_ops = max(n / PEAKS[c] for c, n in self.ops.items())
        t_bytes = self.nbytes / HBM_BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")


def flash_live_pairs(B, Hq, T, W) -> int:
    """Live (query, key) pairs of a causal pass with window W (None: T)."""
    W = T if W is None else min(W, T)
    return B * Hq * (W * (W + 1) // 2 + (T - W) * W)


def _flash_peak(itemsize: int) -> str:
    """bf16 runs on the bf16 tensor cores, f32 at the TF32 peak."""
    return "bf16" if itemsize == 2 else "tf32"


def flash(B, Hq, Hkv, T, D, W, itemsize) -> Work:
    """B5 (either route, with or without its lse): 4 D FLOP a live pair;
    q, k, v read once and o written once."""
    ops = FLASH_FWD_OPS_PER_PAIR_PER_D * D * flash_live_pairs(B, Hq, T, W)
    nbytes = 2 * B * Hq * T * D * itemsize + 2 * B * Hkv * T * D * itemsize
    return Work({_flash_peak(itemsize): ops}, nbytes)


def flash_bwd(B, Hq, Hkv, T, D, W, itemsize) -> Work:
    """B5-bwd (bf16) and the f32 attention backward: 10 D FLOP a live pair
    at the route's peak; q, k, v, o, dO and lse (f32) read once and dq,
    dk, dv written once."""
    q_bytes = B * Hq * T * D * itemsize
    k_bytes = B * Hkv * T * D * itemsize
    ops = FLASH_BWD_OPS_PER_PAIR_PER_D * D * flash_live_pairs(B, Hq, T, W)
    nbytes = 2 * (2 * q_bytes + 2 * k_bytes) + q_bytes + 4 * B * Hq * T
    return Work({_flash_peak(itemsize): ops}, nbytes)


def wavefront(live_steps, band, N, Lq, Lr, T, collect_tb) -> Work:
    """B1: `live_steps` (every pair's true n + m, summed) of `band` cells
    at `WAVEFRONT_OPS_PER_CELL` int32 operations; q, r, n, m read once, the
    stats (and the packed flags and band offsets) written once."""
    nbytes = N * (Lq + Lr) + 8 * N + 6 * 4 * N
    if collect_tb:
        nbytes += N * T * ((band + 1) // 2) + 4 * N * (T + 1)
    return Work({"int32": live_steps * band * WAVEFRONT_OPS_PER_CELL},
                nbytes)


def rglru(B, T, D, itemsize, lam_itemsize, with_h0) -> Work:
    """B6: wa, wx, x read and y written in their dtype, lam read, h_last
    (and h0) in f32."""
    nbytes = 4 * B * T * D * itemsize + D * lam_itemsize \
        + B * D * 4 * (2 if with_h0 else 1)
    return Work({"f32": B * T * D * RGLRU_OPS_PER_ELEM}, nbytes)


def rglru_bwd(B, T, D, itemsize, lam_itemsize, with_h0, tile_t,
              tile_c) -> Work:
    """B6-bwd: wa, wx, x, dy read and dwa, dwx, dx written in their dtype
    (7 an element), each tile's inclusive h of the forward's scratch (4
    B a channel), lam read and dlam written, h_last's gradient (and h0,
    dh0) in f32; tiles of `tile_t` steps x `tile_c` channels."""
    n = B * T * D
    ntiles = -(-T // tile_t) * B * -(-D // tile_c)
    nbytes = 7 * n * itemsize + 4 * ntiles * tile_c \
        + 2 * D * lam_itemsize + B * D * 4 * (3 if with_h0 else 1)
    return Work({"f32": n * RGLRU_BWD_OPS_PER_ELEM}, nbytes)


def mlstm(B, H, T, D, L) -> dict:
    """B7 whole and each of its three passes ({"whole",
    "mlstm_chunk_states", "mlstm_state_scan", "mlstm_chunk_outputs"}):
    the products at the TF32 peak, the other f32 operations on the FMA
    units (`.at("f32")`: every operation on the FMA units, the bound before
    the products went to the tensor cores). Per chunk and head: whole,
    products 4 L D^2 + 2 L (L + 1) D (pass 1's (a k)^T v, q C_in, and q k^T
    and P v over the causal triangle) and 4 L D other operations; pass 1,
    2 L D^2 and 2 L D + 4 L; pass 2, none and 3 (D^2 + D) + 6; pass 3,
    products 2 L^2 D (q k^T over the whole 64 x 64 tile) + L (L + 1) D +
    2 L D^2 and 2 L D + 8 L others. Bytes: whole, q, k, v, gates, h and the
    state once; each pass its own inputs read once and outputs written
    once, a chunk's state its D^2 + D + 2 values."""
    nc = T // L
    n = B * H * nc
    state_b = 4 * n * (D * D + D + 2)

    def w(products, other, nbytes):
        return Work({"tf32": products, "f32": other}, nbytes)
    return {
        "whole": w(n * (4 * L * D * D + 2 * L * (L + 1) * D), n * 4 * L * D,
                   4 * (4 * B * T * H * D + 2 * B * H * T
                        + 2 * B * H * (D * D + D + 1))),
        "mlstm_chunk_states": w(n * 2 * L * D * D, n * (2 * L * D + 4 * L),
                                4 * (2 * B * T * H * D + 2 * B * H * T)
                                + state_b),
        "mlstm_state_scan": Work({"f32": n * (3 * (D * D + D) + 6)},
                                 2 * state_b
                                 + 8 * B * H * (D * D + D + 1)),
        "mlstm_chunk_outputs": w(n * (2 * L * L * D + L * (L + 1) * D
                                      + 2 * L * D * D),
                                 n * (2 * L * D + 8 * L),
                                 4 * (4 * B * T * H * D + 2 * B * H * T)
                                 + state_b)}


def mlstm_bwd(B, H, T, D, L) -> dict:
    """B7-bwd whole and each pass ({"whole", "mlstm_bwd_outputs",
    "mlstm_bwd_scan", "mlstm_bwd_inputs"}): the products at the TF32
    peak, the other f32 operations on the FMA units, each pass's inputs
    read once and outputs written once (a chunk state counted as its D^2
    + D values). Per chunk the products are four L x D x D (8 L D^2:
    dC_own in pass 1 — the m-gradient through sigma is the state's dot
    with it, not a product q C_in — and pass 3's k dC_out, v dC_out^T, dh~
    C_in^T) and pass 3's intra-chunk S, dP, P^T dh~, dS^T q, dS k over the
    causal triangle (5 L (L + 1) D)."""
    nc = T // L
    n = B * H * nc
    st = 4 * n * (D * D + D)
    rows = 4 * B * T * H * D
    gates = 4 * B * H * T

    def w(products, other, nbytes):
        return Work({"tf32": products, "f32": other}, nbytes)
    return {
        "whole": w(n * (8 * L * D * D + 5 * L * (L + 1) * D),
                   n * (14 * L * D + 6 * (D * D + D)),
                   8 * rows + 5 * gates + st + 4 * B * H * (D * D + D + 1)),
        "mlstm_bwd_outputs": w(n * 2 * L * D * D,
                               n * (2 * (D * D + D) + 4 * L * D),
                               3 * rows + 3 * gates + 2 * st),
        "mlstm_bwd_scan": w(0, n * (4 * (D * D + D) + 6),
                            3 * st + 4 * 4 * B * H * nc
                            + 4 * B * H * (D * D + D)),
        "mlstm_bwd_inputs": w(n * (6 * L * D * D + 5 * L * (L + 1) * D),
                              n * 10 * L * D,
                              8 * rows + 5 * gates + 2 * st)}


def slstm(B, T, H, Dh, itemsize, r_itemsize) -> Work:
    """B8: 8 Dh + 24 f32 operations a step and unit (8 Dh^2 + 24 Dh a step
    and head); the four wx and the four R read once, h written in f32,
    the state read and written."""
    d = H * Dh
    nbytes = 4 * B * T * d * itemsize + 4 * H * Dh * Dh * r_itemsize \
        + B * T * d * 4 + 8 * B * d * 4
    return Work({"f32": B * T * H * Dh * (8 * Dh + SLSTM_CELL_OPS)}, nbytes)


def slstm_bwd(B, T, H, Dh, r_itemsize, saved_rows, with_dr) -> Work:
    """B8-bwd: the kernel alone (`with_dr` False: 8 Dh^2 + 52 Dh a step and
    head; the record of `saved_rows` rows, h and dh read, the four delta
    rows written, R read, the states' gradients) or the call with dR's
    product (16 Dh^2 + 52 Dh; h once more and dR written)."""
    d = H * Dh
    rows = saved_rows + 1 + 4 + (1 if with_dr else 0)
    nbytes = B * T * d * 4 * rows \
        + 4 * H * Dh * Dh * r_itemsize * (2 if with_dr else 1) \
        + 8 * B * d * 4
    per_unit = (16 if with_dr else 8) * Dh + SLSTM_BWD_CELL_OPS
    return Work({"f32": B * T * H * Dh * per_unit}, nbytes)
