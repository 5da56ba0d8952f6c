"""The slice as a whole on the CPU: `repro_torch`'s AlignmentEngine and
`align_batch` against the JAX reference engine. Tolerance 0."""

import numpy as np
import pytest

from repro.core.batch import AlignmentBatch as JaxBatch
from repro.core.batch import align_batch as jax_align_batch
from repro.core.engine import AlignmentEngine as JaxEngine
from repro_torch.core.batch import AlignmentBatch, align_batch
from repro_torch.core.engine import (SCALAR_KEYS, AlignmentEngine,
                                     PendingDispatch, PendingPersistent)
from torch_parity import JAX_SC, TORCH_SC, make_pairs

#: Three length classes (buckets 128, 256, 512), ragged inside each.
LENGTHS = (40, 150, 90, 300, 41, 160, 35, 120, 1, 140, 280)


def _request(seed=41):
    return make_pairs(seed, LENGTHS, unrelated=(2, 5))


def _engines(**kw):
    return (JaxEngine(backend="reference", sc=JAX_SC, capacity=4, **kw),
            AlignmentEngine(backend="reference", device="cpu", sc=TORCH_SC,
                            capacity=4, **kw))


def _assert_same(ref, out, collect_tb=True):
    assert set(ref) == set(out)
    for key in SCALAR_KEYS + ("band",):
        assert out[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(ref[key], out[key], err_msg=key)
    if collect_tb:
        assert ref["cigars"] == out["cigars"]


@pytest.mark.parametrize("mode,xdrop,decode", [
    ("global", None, "device"), ("global", 20, "device"),
    ("semiglobal", 20, "device"), ("semiglobal", None, "host"),
])
def test_engine_align_matches_reference_engine(mode, xdrop, decode):
    reads, refs = _request()
    je, te = _engines(xdrop=xdrop, decode=decode)
    ref = je.align(reads, refs, mode=mode, collect_tb=True)
    out = te.align(reads, refs, mode=mode, collect_tb=True)
    _assert_same(ref, out)
    assert len(te.plan([len(x) for x in reads],
                       [len(x) for x in refs])) == 3    # multi-bucket
    if xdrop is not None:
        rejected = np.flatnonzero(out["status"])
        assert set(rejected.tolist()) >= {2, 5}
        for p in range(len(reads)):   # None for rejected, never []
            assert (out["cigars"][p] is None) == (p in rejected)
    else:
        assert all(c is not None for c in out["cigars"])


def test_engine_score_only_narrow_untrimmed():
    reads, refs = _request(seed=42)
    je, te = _engines(cell_dtype="narrow", trim=False, adaptive=False)
    _assert_same(je.align(reads, refs), te.align(reads, refs),
                 collect_tb=False)


def test_enqueue_finalize_counts_fetched_bytes():
    reads, refs = _request(seed=43)
    je, te = _engines()
    groups = te.plan([len(x) for x in reads], [len(x) for x in refs])
    jgroups = je.plan([len(x) for x in reads], [len(x) for x in refs])
    assert [g.spec for g in groups] == \
        [type(g.spec)(**vars(j.spec)) for g, j in zip(groups, jgroups)]
    for g, jg in zip(groups, jgroups):
        np.testing.assert_array_equal(g.indices, jg.indices)
        members = ([reads[i] for i in g.indices],
                   [refs[i] for i in g.indices])
        pd = te.enqueue_group(*members, g.spec, collect_tb=True)
        jpd = je.enqueue_group(*members, jg.spec, collect_tb=True)
        assert isinstance(pd, PendingDispatch)
        assert pd.num_slots == jpd.num_slots
        assert pd.signature == jpd.signature
        st, jst = {}, {}
        merged = te.finalize_group(pd, stats=st)
        jmerged = je.finalize_group(jpd, stats=jst)
        assert st["fetched_bytes"] == jst["fetched_bytes"] > 0
        assert merged["cigars"] == jmerged["cigars"]
        # The trimmed RLE fetch: 5 * K_used + 4 bytes per padded slot,
        # plus the six int32 scalars.
        k_used = max(int(merged["cig_len"].max()), 1)
        assert st["fetched_bytes"] == pd.num_slots * (5 * k_used + 4 + 24)


def test_align_arrays_and_align_batch_match_reference():
    reads, refs = make_pairs(44, (60, 50, 64, 33, 58))
    jb = JaxBatch.from_lists(reads, refs, capacity=4)
    tb = AlignmentBatch.from_lists(reads, refs, capacity=4)
    assert vars(jb.spec) == vars(tb.spec) and jb.num_real == tb.num_real
    for a, b in ((jb.q_pad, tb.q_pad), (jb.r_pad, tb.r_pad), (jb.n, tb.n),
                 (jb.m, tb.m)):
        np.testing.assert_array_equal(a, b)
    ref = jax_align_batch(jb, JAX_SC, collect_tb=True, mode="semiglobal",
                          backend="reference")
    out = align_batch(tb, TORCH_SC, collect_tb=True, mode="semiglobal",
                      backend="reference", device="cpu")
    assert ref["cigars"] == out["cigars"]
    for key in SCALAR_KEYS:
        np.testing.assert_array_equal(ref[key], out[key])
    je, te = _engines()
    jr = je.align_arrays(jb.q_pad, jb.r_pad, jb.n, jb.m, band=9,
                         t_max=jb.spec.t_max)
    tr = te.align_arrays(tb.q_pad, tb.r_pad, tb.n, tb.m, band=9,
                         t_max=tb.spec.t_max)
    for key in SCALAR_KEYS:
        np.testing.assert_array_equal(np.asarray(jr[key]), tr[key].numpy())
    with pytest.raises(ValueError, match="t_max"):
        te.align_arrays(tb.q_pad, tb.r_pad, tb.n, tb.m, t_max=8)


def test_warmup_and_unported_modes():
    _, te = _engines()
    assert te.warmup([(40, 40), (150, 160)], collect_tb=True) == 2
    assert te.warmup([]) == 0
    assert te.num_shards == 1 and te.backend_name == "reference"
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        AlignmentEngine(backend="reference", device="cpu",
                        dispatch="persistent")
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        AlignmentEngine(backend="reference", device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        te.backend.run_persistent([])
    with pytest.raises(ValueError):
        AlignmentEngine(backend="reference", device="cpu", dispatch="x")
    with pytest.raises(ValueError):
        AlignmentEngine(backend="reference", device="cpu", xdrop=0)
    assert PendingPersistent.__dataclass_fields__.keys() >= {"outs"}
