"""Tile-level parallelism on the CPU: `repro_torch.core.distributed`, the
engine's `mesh=` path and `launch.mesh` against the JAX package at mesh
1x1, and against the unsharded port engine at CPU meshes of 2 and 4
shards (every shard the CPU, which tests the split, the padding and the
in-order join on the host). Tolerance 0.

The reference asserts that its lowered sharded program holds zero
collectives; the port has no lowered program, so its counterpart is that
each shard's result lives on its own shard's device and that no module of
the package uses `torch.distributed`."""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.distributed import alignment_input_specs as \
    jax_alignment_input_specs
from repro.core.distributed import make_aligner as jax_make_aligner
from repro.core.engine import AlignmentEngine as JaxEngine
from repro.data.genome import ReadSimulator, random_genome, \
    simulate_read_pairs
from repro.launch.mesh import make_debug_mesh as jax_make_debug_mesh
from repro_torch.core.distributed import (alignment_input_specs,
                                          alignment_serve_step, make_aligner)
from repro_torch.core.engine import SCALAR_KEYS, AlignmentEngine
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch.mesh import (DeviceMesh, make_debug_mesh,
                                     make_production_mesh)
from repro_torch.serve import AlignmentService
from torch_parity import JAX_SC, TORCH_SC, make_pairs

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHARDS = (1, 2, 4)


def _cpu_mesh(data):
    return make_debug_mesh(data=data, model=1, device="cpu")


def _mesh_engine(data, **kw):
    return AlignmentEngine(backend="reference", sc=TORCH_SC,
                           mesh=_cpu_mesh(data), **kw)


def _host(outs, key):
    """One key of a sharded result, fetched and joined in shard order."""
    return np.concatenate([o[key].cpu().numpy() for o in outs])


def _simulated(k=7, lengths=(60, 140, 260)):
    sim = ReadSimulator(random_genome(30_000, seed=2), "illumina", seed=3)
    reads, refs = [], []
    for i in range(k):
        ref, read = sim.sample(lengths[i % len(lengths)])
        refs.append(ref)
        reads.append(read)
    return reads, refs


@pytest.mark.parametrize("data", SHARDS)
def test_shard_map_aligner_matches_local(data):
    """The sharded aligner equals the reference's shard_map aligner at
    mesh 1x1 on every scalar key (8 pairs split over 1, 2 or 4 shards)."""
    q, r, n, m = simulate_read_pairs(8, 100, "illumina", seed=9)
    ref = jax_make_aligner(jax_make_debug_mesh(1, 1), JAX_SC, band=16)(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(n), jnp.asarray(m))
    aligner = make_aligner(_cpu_mesh(data), TORCH_SC, band=16,
                           backend="reference")
    outs = aligner(q, r, n, m)
    assert len(outs) == data
    for key in SCALAR_KEYS:
        np.testing.assert_array_equal(np.asarray(ref[key]), _host(outs, key),
                                      err_msg=key)


@pytest.mark.parametrize("data", SHARDS)
def test_engine_mesh_align_matches_unsharded(data):
    """AlignmentEngine(mesh=...) runs the ragged multi-bucket path through
    sharded dispatch slices and matches the reference's meshed engine at
    1x1 and the port's single-device engine bit-exactly (scores, bands,
    CIGARs). 11 pairs in three classes of 4 / 4 / 3 at capacity 3: every
    group pads across shards."""
    reads, refs = _simulated(11)
    jeng = JaxEngine(backend="reference", sc=JAX_SC, capacity=3,
                     mesh=jax_make_debug_mesh(1, 1))
    eng_mesh = _mesh_engine(data, capacity=3)
    eng = AlignmentEngine(backend="reference", device="cpu", sc=TORCH_SC,
                          capacity=3)
    assert eng_mesh.num_shards == data and eng_mesh.batch_axes == ("data",)
    assert eng_mesh.device == torch.device("cpu")
    o1 = eng_mesh.align(reads, refs, collect_tb=True)
    o2 = eng.align(reads, refs, collect_tb=True)
    oj = jeng.align(reads, refs, collect_tb=True)
    for key in SCALAR_KEYS + ("band",):
        np.testing.assert_array_equal(o1[key], o2[key], err_msg=key)
        np.testing.assert_array_equal(o1[key], oj[key], err_msg=key)
    assert o1["cigars"] == o2["cigars"] == oj["cigars"]


@pytest.mark.parametrize("data", (2, 4))
@pytest.mark.parametrize("mode,decode", [("global", "device"),
                                         ("semiglobal", "host")])
def test_engine_mesh_groups_pad_to_whole_sharded_slices(data, mode, decode):
    """Each group pads to capacity x num_shards rows, as the reference
    pads (`pad_multiple=spec.capacity * num_shards`); the padded blocks
    are split over the shards and the results equal unsharded."""
    reads, refs = make_pairs(61, (40, 150, 90, 41, 160, 35, 120, 1, 140))
    eng_mesh = _mesh_engine(data, capacity=2, decode=decode)
    eng = AlignmentEngine(backend="reference", device="cpu", sc=TORCH_SC,
                          capacity=2, decode=decode)
    for g in eng.plan([len(x) for x in reads], [len(x) for x in refs]):
        members = ([reads[i] for i in g.indices],
                   [refs[i] for i in g.indices])
        pd = eng_mesh.enqueue_group(*members, g.spec, mode=mode,
                                    collect_tb=True)
        slots = -(-len(g.indices) // (2 * data)) * 2 * data
        assert pd.num_slots == slots
        assert len(pd.outs) == slots // 2          # one block per shard
        got = eng_mesh.finalize_group(pd)
        want = eng.finalize_group(eng.enqueue_group(
            *members, g.spec, mode=mode, collect_tb=True))
        for key in SCALAR_KEYS:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got["cigars"] == want["cigars"]


@pytest.mark.parametrize("data", SHARDS)
@pytest.mark.parametrize("collect_tb,decode", [(False, "host"),
                                               (True, "device")])
def test_engine_mesh_results_stay_on_their_shards(data, collect_tb, decode):
    """The engine's sharded runner — including a trimmed sweep and the
    on-device walker — returns one result per shard, each on its own
    shard's device: nothing is gathered on a device. (The reference
    asserts zero collectives in the lowered program.)"""
    eng = _mesh_engine(data)
    specs = alignment_input_specs(8, 64, 64)
    q, r = (np.zeros(tuple(s.shape), np.int8) for s in specs[:2])
    n = m = np.full(8, 40, np.int32)
    fn = eng.sharded_runner(band=16, collect_tb=collect_tb, t_max=96,
                            decode=decode)
    outs = fn(q, r, n, m)
    assert len(outs) == data
    for out, dev in zip(outs, eng.shard_devices):
        assert out["score"].shape == (8 // data,)
        assert all(t.device == dev for t in out.values())
    if collect_tb:
        assert {"cig_ops", "cig_runs", "cig_len"} <= set(outs[0])
    unsharded = AlignmentEngine(backend="reference", device="cpu",
                                sc=TORCH_SC).align_arrays(
        q, r, n, m, band=16, collect_tb=collect_tb, t_max=96, decode=decode)
    for key in unsharded:
        np.testing.assert_array_equal(_host(outs, key),
                                      unsharded[key].numpy(), err_msg=key)
    with pytest.raises(ValueError, match="split"):
        fn(q[:7], r[:7], n[:7], m[:7]) if data > 1 else fn(q[:0], r[:0],
                                                           n[:0], m[:0])


def test_alignment_lowering_has_no_collectives():
    """Tile-level parallelism needs no inter-tile communication (paper
    §V-A): the serve step's results stay per shard, and no module of the
    port imports or names `torch.distributed`."""
    step = alignment_serve_step(_cpu_mesh(2), TORCH_SC, band=16,
                                backend="reference")
    eng_outs = step(*[np.ones(tuple(s.shape), np.int8 if i < 2 else np.int32)
                      for i, s in enumerate(alignment_input_specs(8, 32,
                                                                  32))])
    assert len(eng_outs) == 2
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            assert not any(nm.startswith(("torch.distributed", "torch.nn."
                                          "parallel")) for nm in names), path
            assert not (isinstance(node, ast.Attribute)
                        and node.attr == "distributed"), path


def test_alignment_input_specs_match_the_reference():
    ref = jax_alignment_input_specs(8, 64, 48)
    got = alignment_input_specs(8, 64, 48)
    for r, g in zip(ref, got):
        assert tuple(g.shape) == tuple(r.shape)
        assert str(g.dtype).removeprefix("torch.") == str(r.dtype)
        assert g.device.type == "meta"


def test_service_over_a_meshed_engine_matches_one_shot():
    """The streaming service drives a meshed engine's enqueue/finalize
    pipeline; its results equal the one-shot unsharded `align`."""
    reads, refs = make_pairs(71, (40, 150, 90, 41, 160, 35, 120, 140, 33))
    one_shot = AlignmentEngine(backend="reference", device="cpu",
                               sc=TORCH_SC, capacity=2).align(
        reads, refs, collect_tb=True)
    with AlignmentService(_mesh_engine(2, capacity=2), collect_tb=True,
                          max_wait_ms=1.0) as svc:
        assert svc.device == torch.device("cpu") and svc.streams == {}
        res = [f.result(timeout=120) for f in
               [svc.submit(rd, rf) for rd, rf in zip(reads, refs)]]
        assert svc.stats()["completed"] == len(reads)
    for p, out in enumerate(res):
        for key in SCALAR_KEYS:
            assert int(out[key]) == int(one_shot[key][p]), (p, key)
        assert out["cigar"] == one_shot["cigars"][p]


def test_mesh_shards_over_data_axes_in_row_major_order():
    """Shard order is row-major over the batch axes ("pod", "data");
    along "model" the shards would be replicas and only index 0 runs."""
    grid = np.empty(12, dtype=object)
    grid[:] = [f"d{i}" for i in range(12)]
    mesh = DeviceMesh(grid.reshape(2, 3, 2), ("pod", "data", "model"))
    assert mesh.shape == {"pod": 2, "data": 3, "model": 2}
    assert mesh.shard_devices(("pod", "data")) == (
        "d0", "d2", "d4", "d6", "d8", "d10")
    assert mesh.shard_devices(("data",)) == ("d0", "d2", "d4")
    with pytest.raises(ValueError, match="not among"):
        mesh.shard_devices(("rows",))
    with pytest.raises(ValueError):
        DeviceMesh(grid.reshape(2, 6), ("data",))
    cpu = make_debug_mesh(data=2, model=1, pod=2, device="cpu")
    assert cpu.axis_names == ("pod", "data", "model")
    eng = AlignmentEngine(backend="reference", sc=TORCH_SC, mesh=cpu)
    assert eng.batch_axes == ("pod", "data") and eng.num_shards == 4
    assert AlignmentEngine(backend="reference", sc=TORCH_SC, mesh=cpu,
                           batch_axes=("data",)).num_shards == 2


def test_mesh_modes_that_raise():
    """Persistent dispatch runs one device: with mesh= it raises, as in
    the reference. A mesh must be a DeviceMesh whose batch axes exist."""
    mesh = _cpu_mesh(2)
    with pytest.raises(ValueError, match="persistent"):
        AlignmentEngine(backend="reference", sc=TORCH_SC, mesh=mesh,
                        dispatch="persistent")
    with pytest.raises(TypeError, match="DeviceMesh"):
        AlignmentEngine(backend="reference", device="cpu", mesh=object())
    with pytest.raises(ValueError, match="not among"):
        AlignmentEngine(backend="reference", mesh=mesh, batch_axes=("x",))
    with pytest.raises(ValueError, match="cuda"):
        AlignmentEngine(backend="cuda", mesh=mesh)
    with pytest.raises(ValueError, match="requires"):
        AlignmentEngine(backend="reference", device="cpu").sharded_runner(
            band=16)
    with pytest.raises(ValueError, match=">= 1"):
        make_debug_mesh(data=0, device="cpu")


def test_no_card_means_a_meshed_engine_raises():
    """No fallback: a CUDA mesh without cards raises, and so does an
    engine over a hand-built CUDA mesh, and the launcher's default mesh."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="is_available"):
        make_debug_mesh()                          # default: the card
    with pytest.raises(RuntimeError, match="is_available"):
        make_debug_mesh(data=2, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        make_production_mesh()
    with pytest.raises(NotImplementedError, match="A11d"):
        make_production_mesh(multi_pod=True)
    grid = np.empty(1, dtype=object)
    grid[:] = [torch.device("cuda", 0)]
    with pytest.raises(RuntimeError, match="is_available"):
        AlignmentEngine(backend="reference",
                        mesh=DeviceMesh(grid.reshape(1, 1),
                                        ("data", "model")))
    with pytest.raises(RuntimeError, match="is_available"):
        serve_launcher.main(["--reads", "2"])


def test_launch_serve_builds_a_mesh_without_no_mesh(capsys):
    """Without --no-mesh (pipelined, one replica) `launch.serve` shards
    over a mesh — here a one-shard CPU mesh, asked for — and returns the
    same scores as --no-mesh."""
    args = ["--reads", "24", "--device", "cpu", "--backend", "reference",
            "--read-len", "60", "--max-wait-ms", "1"]
    meshed, stats = serve_launcher.main(args)
    out = capsys.readouterr().out
    assert "shards=1 mesh={'data': 1, 'model': 1}" in out
    assert stats["completed"] == 24
    plain, _ = serve_launcher.main(args + ["--no-mesh"])
    assert "mesh=off" in capsys.readouterr().out
    assert [int(s) for s in meshed] == [int(s) for s in plain]
    serve_launcher.main(args + ["--dispatch", "persistent"])
    assert "mesh=off" in capsys.readouterr().out
