"""Shared helpers of the tests/test_torch_*.py parity tests: inputs made
from a seed with numpy and handed to both packages, and the comparison
rules. Not a test module."""

import dataclasses

import numpy as np

from repro.core.scoring import MINIMAP2 as JAX_SC
from repro_torch.core.interop import scoring_from_fields

#: The port's scoring config, carried across from the reference's fields.
TORCH_SC = scoring_from_fields(**dataclasses.asdict(JAX_SC))

SCALAR_KEYS = ("score", "final_lo", "best_score", "best_i", "best_j",
               "status")

_BASES = np.arange(4, dtype=np.int8)


def mutate(rng, ref, sub=0.05, ins=0.03, dele=0.03):
    """A corrupted copy of `ref` (numpy only, independent of either
    package's simulator)."""
    out = []
    for b in ref:
        roll = rng.random()
        if roll < dele:
            continue
        if roll < dele + ins:
            out.append(int(rng.integers(0, 4)))
        if roll < dele + ins + sub:
            out.append(int((b + 1 + rng.integers(0, 3)) % 4))
        else:
            out.append(int(b))
    return np.asarray(out or [0], np.int8)


def make_pairs(seed, lengths, unrelated=()):
    """Lists of (reads, refs) at the given reference lengths; positions in
    `unrelated` get a random read (the xdrop rule retires those)."""
    rng = np.random.default_rng(seed)
    reads, refs = [], []
    for k, L in enumerate(lengths):
        ref = rng.integers(0, 4, L).astype(np.int8)
        read = (rng.integers(0, 4, L).astype(np.int8) if k in unrelated
                else mutate(rng, ref))
        reads.append(read)
        refs.append(ref)
    return reads, refs


def pad_pairs(reads, refs, Lq, Lr):
    n = np.asarray([len(x) for x in reads], np.int32)
    m = np.asarray([len(x) for x in refs], np.int32)
    q = np.full((len(reads), Lq), 4, np.int8)
    r = np.full((len(refs), Lr), 4, np.int8)
    for p, (a, b) in enumerate(zip(reads, refs)):
        q[p, :len(a)] = a
        r[p, :len(b)] = b
    return q, r, n, m


def assert_same_result(jax_out, torch_out, n, m, collect_tb):
    """Bit-exact comparison of a reference result dict with the port's.

    Scalars: every key, every pair. `tb`/`los`: only the live steps of
    each pair — t <= n + m for a pair that finished, t < status for one
    the xdrop rule retired. Past those the reference writes recomputed
    frozen-carry bytes that no decoder reads, while the port defines them
    (flags 0, offset frozen); the port's definition is asserted here.
    """
    for key in SCALAR_KEYS:
        np.testing.assert_array_equal(np.asarray(jax_out[key]),
                                      torch_out[key].numpy(), err_msg=key)
    if not collect_tb:
        assert "tb" not in torch_out and "los" not in torch_out
        return
    jtb, jlos = np.asarray(jax_out["tb"]), np.asarray(jax_out["los"])
    ttb, tlos = torch_out["tb"].numpy(), torch_out["los"].numpy()
    assert jtb.shape == ttb.shape and jtb.dtype == ttb.dtype
    assert jlos.shape == tlos.shape and jlos.dtype == tlos.dtype
    status = np.asarray(jax_out["status"])
    T = jtb.shape[1]
    for p in range(len(n)):
        live = int(n[p] + m[p]) if status[p] == 0 else int(status[p]) - 1
        live = min(live, T)
        np.testing.assert_array_equal(jtb[p, :live], ttb[p, :live])
        np.testing.assert_array_equal(jlos[p, :live + 1], tlos[p, :live + 1])
        assert not ttb[p, live:].any()
        assert (tlos[p, live:] == tlos[p, live]).all()
