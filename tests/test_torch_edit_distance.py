"""Edit-distance mode of `repro_torch` (`core/edit_distance.py`), the
single-pair `banded_align` and the difference-DP oracle (`core/diff_dp.py`)
on the CPU against the JAX package, same seeded inputs, tolerance 0
(integer DP): distances, bands, trimmed sweeps, CIGARs decoded on the
device and on the host, the single-pair planes over their live steps, and
every array of the Eq. (4) sweep."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.banded import traceback_banded_batch
from torch_parity import TORCH_SC, JAX_SC, mutate

# The modules by path: each package's `core` re-exports functions of the
# same names (`diff_dp`, `edit_distance`).
jax_banded, jax_diff_dp, jax_ed, jax_scoring = (
    importlib.import_module(f"repro.core.{m}")
    for m in ("banded", "diff_dp", "edit_distance", "scoring"))
banded, diff_dp, ed, scoring = (
    importlib.import_module(f"repro_torch.core.{m}")
    for m in ("banded", "diff_dp", "edit_distance", "scoring"))

SC_NAMES = ("MINIMAP2", "BWA_MEM", "EDIT_DISTANCE", "LINEAR_GAP")


def _padded_batch(seed, N=10, L=128):
    """Ragged (read, ref) pairs padded to L: near-copies, a few unrelated."""
    rng = np.random.default_rng(seed)
    q = np.full((N, L), 4, np.int8)
    r = np.full((N, L), 4, np.int8)
    n = np.zeros(N, np.int32)
    m = np.zeros(N, np.int32)
    for i in range(N):
        ref = rng.integers(0, 4, int(rng.integers(30, 80))).astype(np.int8)
        read = (rng.integers(0, 4, len(ref)).astype(np.int8) if i % 5 == 4
                else mutate(rng, ref))[:L]
        q[i, :len(read)], r[i, :len(ref)] = read, ref
        n[i], m[i] = len(read), len(ref)
    return q, r, n, m


@pytest.mark.parametrize("decode", ["device", "host"])
def test_edit_distance_batch_matches_jax(decode):
    q, r, n, m = _padded_batch(71)
    ours = ed.edit_distance_batch(q, r, n, m, with_traceback=True,
                                  decode=decode, backend="reference",
                                  device="cpu")
    theirs = jax_ed.edit_distance_batch(q, r, n, m, with_traceback=True,
                                        decode=decode)
    assert ours["band"] == theirs["band"]
    assert ours["t_max"] == theirs["t_max"] < 2 * q.shape[1]
    assert ours["distance"].dtype == np.asarray(theirs["distance"]).dtype
    np.testing.assert_array_equal(ours["distance"], theirs["distance"])
    if decode == "device":
        assert ours["cigars"] == theirs["cigars"]
        return
    band = ours["band"]
    cigars = traceback_banded_batch(ours["tb"], ours["los"], n, m, band)
    assert cigars == jax_banded.traceback_banded_batch(
        np.asarray(theirs["tb"]), np.asarray(theirs["los"]), n, m, band)
    # Device and host decode agree, and without traceback the distances
    # are the same.
    assert cigars == ed.edit_distance_batch(
        q, r, n, m, with_traceback=True, backend="reference",
        device="cpu")["cigars"]
    plain = ed.edit_distance_batch(q, r, n, m, backend="reference",
                                   device="cpu", band=band + 1)
    assert "cigars" not in plain and "tb" not in plain
    assert plain["band"] == band + 1


def test_edit_distance_batch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    q, r, n, m = _padded_batch(72, N=2)
    with pytest.raises(RuntimeError, match="is_available"):
        ed.edit_distance_batch(q, r, n, m)
    with pytest.raises(RuntimeError, match="is_available"):
        ed.edit_distance(q[0, :n[0]], r[0, :m[0]])
    # The single pair's CUDA route is the engine's CUDA backend, which
    # refuses the CPU rather than running its plain version there.
    with pytest.raises(ValueError, match="cannot run on device cpu"):
        ed.edit_distance(q[0, :n[0]], r[0, :m[0]], device="cpu",
                         backend="cuda")


def test_edit_distance_single_pair_and_levenshtein_match_jax():
    rng = np.random.default_rng(73)
    for k in range(6):
        a = rng.integers(0, 4, int(rng.integers(5, 50))).astype(np.int8)
        b = (mutate(rng, a) if k % 2 else
             rng.integers(0, 4, int(rng.integers(5, 50))).astype(np.int8))
        full = max(len(a), len(b)) + 2
        lev = ed.levenshtein_reference(a, b)
        assert lev == jax_ed.levenshtein_reference(a, b)
        for band in (full, None):
            ours = ed.edit_distance(a, b, band=band, with_traceback=True,
                                    device="cpu")
            assert ours == jax_ed.edit_distance(a, b, band=band,
                                                with_traceback=True)
        assert ours[0] >= lev
        assert ed.edit_distance(a, b, band=full, device="cpu") == (lev, None)


@pytest.mark.parametrize("band", ["full", None, 5])
def test_edit_distance_single_pair_batch_route_matches_jax(band):
    """The route a single pair takes on the card — a batch of one through
    the engine and the device decoder — here with the engine's plain
    backend on the CPU: the same distance and CIGAR as the JAX single-pair
    wavefront and as the port's own plain single-pair route."""
    rng = np.random.default_rng(76)
    for k in range(4):
        a = rng.integers(0, 4, int(rng.integers(1, 50))).astype(np.int8)
        b = (mutate(rng, a) if k % 2 else
             rng.integers(0, 4, int(rng.integers(1, 50))).astype(np.int8))
        bw = max(len(a), len(b)) + 2 if band == "full" else band
        ours = ed.edit_distance(a, b, band=bw, with_traceback=True,
                                device="cpu", backend="reference")
        assert ours == jax_ed.edit_distance(a, b, band=bw,
                                            with_traceback=True)
        assert ours == ed.edit_distance(a, b, band=bw, with_traceback=True,
                                        device="cpu")
        assert ed.edit_distance(a, b, band=bw, device="cpu",
                                backend="reference") == (ours[0], None)


@pytest.mark.parametrize("mode,xdrop", [("global", None),
                                        ("semiglobal", None),
                                        ("global", 8)])
def test_banded_align_single_pair_matches_jax(mode, xdrop):
    rng = np.random.default_rng(74)
    ref = rng.integers(0, 4, 70).astype(np.int8)
    pairs = [(mutate(rng, ref), ref),
             (rng.integers(0, 4, 60).astype(np.int8), ref[:64])]
    for read, rf in pairs:
        q = np.full(80, 4, np.int8)
        r = np.full(80, 4, np.int8)
        q[:len(read)], r[:len(rf)] = read, rf
        n, m = len(read), len(rf)
        kw = dict(band=21, mode=mode, xdrop=xdrop, t_max=160)
        ours = banded.banded_align(q, r, n, m, sc=TORCH_SC, device="cpu",
                                   **kw)
        theirs = jax_banded.banded_align(jnp.asarray(q), jnp.asarray(r), n,
                                         m, sc=JAX_SC, **kw)
        for key in ("score", "final_lo", "best_score", "best_i", "best_j",
                    "status"):
            assert ours[key].shape == () and ours[key].dtype == torch.int32
            assert int(ours[key]) == int(theirs[key]), key
        status = int(theirs["status"])
        live = n + m if status == 0 else status - 1
        assert ours["tb"].shape == theirs["tb"].shape
        np.testing.assert_array_equal(ours["tb"][:live].numpy(),
                                      np.asarray(theirs["tb"])[:live])
        np.testing.assert_array_equal(ours["los"][:live + 1].numpy(),
                                      np.asarray(theirs["los"])[:live + 1])
        assert not ours["tb"][live:].any()


@pytest.mark.parametrize("name", SC_NAMES)
def test_diff_dp_matches_jax(name):
    """The tests/test_equivalence.py shapes: 8 random pairs of 2..27 bases
    through the Eq. (4) sweep and 5 through the serial Eq. (2)."""
    sc, jsc = getattr(scoring, name), getattr(jax_scoring, name)
    rng = np.random.default_rng(75)
    for k in range(8):
        n, m = rng.integers(2, 28, 2)
        q = rng.integers(0, 4, n).astype(np.int8)
        r = rng.integers(0, 4, m).astype(np.int8)
        ours, theirs = diff_dp.diff_dp(q, r, sc), jax_diff_dp.diff_dp(q, r,
                                                                      jsc)
        assert ours.score == theirs.score
        for field in ("H", "aprime", "uprime", "vprime", "xprime",
                      "yprime"):
            np.testing.assert_array_equal(getattr(ours, field),
                                          getattr(theirs, field))
        assert diff_dp.range_report(ours, sc) == \
            jax_diff_dp.range_report(theirs, jsc)
        if k < 5:
            assert diff_dp.serial_eq2(q, r, sc) == \
                jax_diff_dp.serial_eq2(q, r, jsc) == ours.score
