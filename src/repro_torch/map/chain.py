"""Anchor chaining — colinear seed selection between seeding and alignment.

Seeding (`repro_torch.map.index`) returns anchors: (read position,
reference position) pairs where a k-length exact match exists. Chaining
finds the highest-scoring *colinear* subset — anchors that advance in both
read and reference — which localises the read to one candidate reference
window per chain; only those windows go to the banded aligner.

Scoring is minimap2-style (Li 2018, Eq. 1): extending a chain from
anchor j to anchor i (with dq = q_i - q_j > 0, dr = r_i - r_j > 0) gains
the new matched bases min(dq, dr, k) minus a concave gap cost on the
diagonal drift dd = |dr - dq|:

    cost(dd) = dd * k // 100  +  ilog2(dd + 1) // 2

— the integer-arithmetic rendering of minimap2's 0.01·k·dd + 0.5·log2 dd
(pure int32 ops, so chain scores are bit-identical across platforms and
devices, which the end-to-end mapper identity tests rely on). The DP

    f(i) = max( k,  max_{j: colinear, within gap limits} f(j) + gain(j,i) )

is a sequential recurrence over anchors sorted by reference position,
followed by a backtrack from the best endpoint. `chain_padded` runs it over
a batch of padded anchor sets: on CUDA tensors the hand-written kernel
(``csrc/chain.cu``, one warp per set, stepping only the set's valid slots,
one launch per call) or an error; on CPU tensors its plain version
`chain_padded_plain`, a batched loop of tensor ops over the A anchor
slots.

Ragged anchor lists pad to `anchors_cap` (evenly-spaced subsample when
over — deterministic), and the batch dimension rounds up to a multiple of
16, as in the reference.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.core.batch import check_device, upload
from repro_torch.kernels import build

#: Sentinel for "no chain" / invalid anchor slots in the DP.
NEG = -(2 ** 30)

#: Batch-dimension pad multiple.
_BATCH_PAD = 16

#: Most anchor slots per set one launch takes.
MAX_ANCHORS = 1024

_P, _I = ctypes.c_void_p, ctypes.c_int


@dataclasses.dataclass(frozen=True)
class ChainParams:
    """Chaining configuration.

    k: anchor length = per-anchor weight (the index's k).
    max_gap: longest read/reference advance a single chain join may
      bridge (minimap2 -g); joins past it are forbidden.
    max_diag_diff: largest diagonal drift |dr - dq| a join may have
      (minimap2's chaining bandwidth -r); bounds the indel budget.
    anchors_cap: per-read anchor capacity A — longer lists are evenly
      subsampled, shorter ones padded.
    """

    k: int = 13
    max_gap: int = 5000
    max_diag_diff: int = 500
    anchors_cap: int = 128


@dataclasses.dataclass
class Chain:
    """One chained candidate: its score and member anchors (ascending
    reference order, genome coordinates)."""

    score: int
    q_pos: np.ndarray
    r_pos: np.ndarray

    @property
    def diag_start(self) -> int:
        """Chain-projected read start on the reference: the first
        anchor's diagonal r - q — the mapper's reported locus."""
        return int(self.r_pos[0] - self.q_pos[0])


def _ilog2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for positive int32 x, exactly: frexp's exponent
    is floor(log2(x)) + 1; int -> float32 is exact below 2^24 and
    max_diag_diff is far below that."""
    return torch.frexp(x.to(torch.float32)).exponent.to(torch.int32) - 1


def gap_cost(dd, k: int) -> torch.Tensor:
    """Integer minimap2-style concave gap cost on diagonal drift dd
    (int32 tensor or array)."""
    dd = torch.as_tensor(dd).to(torch.int32)
    lin = torch.div(dd * k, 100, rounding_mode="floor")
    log = torch.where(dd > 0, torch.div(_ilog2(dd + 1), 2,
                                        rounding_mode="floor"), 0)
    return (lin + log).to(torch.int32)


def _leftmost_argmax(x: torch.Tensor):
    """(max, first index of the max) along dim 1 — `jnp.argmax`'s tie
    rule, written out."""
    best = x.max(dim=1).values
    slots = torch.arange(x.shape[1], device=x.device)
    idx = torch.where(x == best[:, None], slots, x.shape[1]).min(dim=1)
    return best, idx.values.to(torch.int32)


def chain_padded_plain(qp, rp, valid, *, k: int, max_gap: int,
                       max_dd: int):
    """Plain PyTorch version of the chaining kernel: all sets in lockstep,
    one step per anchor slot, on the tensors' device. Same arguments and
    results as `chain_padded`."""
    build.count(chain_padded_plain, "calls")
    qp = qp.to(torch.int32)
    rp = rp.to(torch.int32)
    R, A = qp.shape
    dev = qp.device
    rows = torch.arange(R, device=dev)
    f = torch.full((R, A), NEG, dtype=torch.int32, device=dev)
    pred = torch.full((R, A), -1, dtype=torch.int32, device=dev)
    for i in range(A):
        dq = qp[:, i:i + 1] - qp
        dr = rp[:, i:i + 1] - rp
        dd = (dr - dq).abs()
        ok = ((dq > 0) & (dr > 0) & (dq <= max_gap) & (dr <= max_gap)
              & (dd <= max_dd) & valid)
        gain = torch.minimum(dq, dr).clamp(max=k) - gap_cost(dd, k)
        # Slots j >= i still hold NEG, so "j before i" needs no mask.
        cand = torch.where(ok, f + gain, NEG)
        best, j = _leftmost_argmax(cand)
        extend = best > k   # strict: ties start a fresh chain (leftmost)
        vi = valid[:, i]
        f[:, i] = torch.where(vi, torch.where(extend, best, k), NEG)
        pred[:, i] = torch.where(vi & extend, j, -1)

    fmax, best_idx = _leftmost_argmax(f)
    best_idx = torch.where(fmax > NEG, best_idx, -1)
    mask = torch.zeros((R, A), dtype=torch.bool, device=dev)
    cur = best_idx.clone()
    for _ in range(A):
        live = cur >= 0
        safe = torch.clamp(cur, min=0).long()
        mask[rows, safe] |= live
        cur = torch.where(live, pred[rows, safe], -1)
    return f, pred, mask, best_idx


#: Calls of the plain version since the count was last set to 0.
chain_padded_plain.calls = 0


def _lib():
    lib = build.load("chain")
    fn = lib.chain_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I] * 5 + [_P]
        fn.restype = _I
    return lib


def chain_padded_cuda(qp, rp, valid, *, k: int, max_gap: int, max_dd: int):
    """Launch the chaining kernel on CUDA tensors: one launch for all R
    sets, on the current stream, not synchronised. Raises on anything the
    kernel does not take."""
    if not (isinstance(qp, torch.Tensor) and qp.is_cuda):
        raise ValueError("chain_padded_cuda takes CUDA tensors; the plain "
                         "version chain_padded_plain runs anywhere")
    dev = qp.device
    R, A = qp.shape
    if not 1 <= A <= MAX_ANCHORS:
        raise ValueError(f"{A} anchor slots outside the kernel's range "
                         f"1..{MAX_ANCHORS}")
    qp = qp.to(torch.int32).contiguous()
    rp = rp.to(device=dev, dtype=torch.int32).contiguous()
    valid = valid.to(device=dev, dtype=torch.bool).contiguous()
    if rp.shape != (R, A) or valid.shape != (R, A):
        raise ValueError("qp, rp and valid must have one shape")
    f = torch.empty((R, A), dtype=torch.int32, device=dev)
    pred = torch.empty((R, A), dtype=torch.int32, device=dev)
    mask = torch.empty((R, A), dtype=torch.bool, device=dev)
    best = torch.empty(R, dtype=torch.int32, device=dev)
    if R:
        with torch.cuda.device(dev):
            err = _lib().chain_launch(
                qp.data_ptr(), rp.data_ptr(), valid.data_ptr(),
                f.data_ptr(), pred.data_ptr(), mask.data_ptr(),
                best.data_ptr(), R, A, int(k), int(max_gap), int(max_dd),
                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"chain kernel launch failed: CUDA error "
                               f"{err}")
        build.count(chain_padded_cuda)
    return f, pred, mask, best


#: Kernel launches since the count was last set to 0.
chain_padded_cuda.launches = 0


def chain_padded(qp, rp, valid, *, k: int, max_gap: int, max_dd: int):
    """Chain padded anchor sets where they live.

    Args:
      qp, rp: (R, A) int32 read / reference positions, each set sorted by
        (reference, read) position; valid: (R, A) bool slot mask.

    Returns (f, pred, best_mask, best_idx): (R, A) int32 DP scores,
    (R, A) int32 predecessors (-1 = chain start), (R, A) bool membership
    of each set's best chain, (R,) int32 endpoints (-1 when the set has
    no valid slot). CPU tensors take `chain_padded_plain`, CUDA tensors
    the kernel.
    """
    kw = dict(k=k, max_gap=max_gap, max_dd=max_dd)
    if qp.device.type == "cpu":
        return chain_padded_plain(qp, rp, valid, **kw)
    return chain_padded_cuda(qp, rp, valid, **kw)


def _pad_anchors(anchor_sets, cap: int):
    """Stack ragged (q_pos, r_pos) anchor lists into padded (R', A)
    int32 arrays + valid mask (R' rounded up to the batch pad multiple;
    over-long lists evenly subsampled, deterministically)."""
    R = len(anchor_sets)
    Rp = max(-(-R // _BATCH_PAD) * _BATCH_PAD, _BATCH_PAD)
    qp = np.zeros((Rp, cap), np.int32)
    rp = np.zeros((Rp, cap), np.int32)
    valid = np.zeros((Rp, cap), bool)
    for i, (q, r) in enumerate(anchor_sets):
        a = len(q)
        if a > cap:
            take = np.linspace(0, a - 1, cap).round().astype(np.int64)
            q, r = np.asarray(q)[take], np.asarray(r)[take]
            a = cap
        qp[i, :a] = q
        rp[i, :a] = r
        valid[i, :a] = True
    return qp, rp, valid


def chain_batch(anchor_sets, params: ChainParams = ChainParams(), *,
                device="cuda"):
    """Chain a batch of reads' anchor lists in one launch.

    `anchor_sets` is a list of (q_pos, r_pos) pairs (one per read /
    strand probe; empty lists allowed). The padded sets are copied to
    `device` (default the card; raises without one — pass "cpu" for the
    plain version), chained, and fetched. Returns per-set numpy
    (f, pred, best_mask, best_idx) tuples — `f[i]` is the best chain
    score ending at anchor i, `best_mask` the membership of the best
    chain (all False when the set was empty).
    """
    if not anchor_sets:
        return []
    dev = check_device(device)
    qp, rp, valid = (upload(a, dev) for a in _pad_anchors(
        anchor_sets, params.anchors_cap))
    f, pred, mask, best = (x.cpu().numpy() for x in chain_padded(
        qp, rp, valid, k=params.k, max_gap=params.max_gap,
        max_dd=params.max_diag_diff))
    return [(f[i], pred[i], mask[i], int(best[i]))
            for i in range(len(anchor_sets))]


def _extract(qp, rp, f, pred, idx) -> Chain:
    """Host-side predecessor walk from endpoint `idx` (for secondary
    chains; the best chain's walk is already done on the device)."""
    members = []
    cur = int(idx)
    while cur >= 0:
        members.append(cur)
        cur = int(pred[cur])
    members.reverse()
    return Chain(score=int(f[idx]),
                 q_pos=np.asarray([qp[i] for i in members], np.int64),
                 r_pos=np.asarray([rp[i] for i in members], np.int64))


def top_chains(q_pos, r_pos, chained, *, max_chains: int = 2,
               min_sep: int = 100, cap: int = 128):
    """The top `max_chains` non-overlapping chains of one anchor set.

    `chained` is one element of `chain_batch`'s output for this set.
    The best chain comes from the device backtrack; secondaries are the
    best remaining DP endpoints whose reference span stays at least
    `min_sep` away from every already-taken chain (a chain through a
    suppressed region is discarded — it is the same candidate). Anchor
    arrays are the ORIGINAL (unpadded) lookup arrays; `cap` must match
    the ChainParams used, so endpoint indices line up.
    """
    f, pred, best_mask, best_idx = chained
    if best_idx < 0 or len(q_pos) == 0:
        return []
    qp, rp = np.asarray(q_pos, np.int64), np.asarray(r_pos, np.int64)
    if qp.size > cap:
        take = np.linspace(0, qp.size - 1, cap).round().astype(np.int64)
        qp, rp = qp[take], rp[take]
    a = qp.size
    out = [Chain(score=int(f[best_idx]), q_pos=qp[best_mask[:a]],
                 r_pos=rp[best_mask[:a]])]
    taken = [(int(out[0].r_pos[0]), int(out[0].r_pos[-1]))]
    scores = np.where(best_mask[:a], NEG, f[:a]).astype(np.int64)
    while len(out) < max_chains:
        for lo, hi in taken:
            near = (rp >= lo - min_sep) & (rp <= hi + min_sep)
            scores[near] = NEG
        idx = int(np.argmax(scores))
        if scores[idx] <= 0:
            break
        chain = _extract(qp, rp, f, pred, idx)
        span = (int(chain.r_pos[0]), int(chain.r_pos[-1]))
        scores[idx] = NEG
        # A secondary that walked back into a taken region is the same
        # candidate seen from a different endpoint — skip it.
        if any(span[0] <= hi + min_sep and span[1] >= lo - min_sep
               for lo, hi in taken):
            continue
        out.append(chain)
        taken.append(span)
    return out


__all__ = ["Chain", "ChainParams", "chain_batch", "chain_padded",
           "chain_padded_cuda", "chain_padded_plain", "top_chains",
           "gap_cost", "NEG"]
