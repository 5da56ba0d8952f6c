"""`repro_torch.roofline.hlo_collectives`: the collectives of a profiler
trace by kind, and the dry run's count of them from the sharding specs.

The reference reads collectives out of compiled HLO; the port reads the
`c10d::*` operator events of a `torch.profiler` trace. A one-process gloo
group on the CPU issues each kind, so counts and output bytes are known
by hand; the sharded engine on CPU meshes of 2 and 4 shards issues none,
the twin of the reference's three zero-collective lowering tests
(`tests/test_distributed.py`). Tolerance: none.
"""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.distributed import make_aligner
from repro_torch.core.engine import AlignmentEngine
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.roofline import (collective_bytes_by_kind,
                                  collective_bytes_from_specs)
from repro_torch.roofline.hlo_collectives import KINDS
from repro_torch.sharding import param_specs
from torch_parity import TORCH_SC


def _trace(fn, tmp_path) -> dict:
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())


@pytest.fixture
def gloo_group(tmp_path):
    """A one-process gloo group initialised through a file (no port: the
    test files run in parallel), destroyed afterwards."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_each_kind_counts_its_output_bytes(gloo_group, tmp_path):
    """all-reduce (a tensor list, f32 and int64), all-gather into a list
    and into a tensor, reduce-scatter into a tensor, all-to-all of a
    tensor and of lists: each op counted once with its output bytes
    (world size 1: an output the size of its input)."""
    x = torch.ones(4, 8)                               # 128 B
    ids = torch.ones(3, 5, dtype=torch.int64)          # 120 B

    def run():
        dist.all_reduce(x)
        dist.all_reduce(ids)
        dist.all_gather([torch.empty_like(ids)], ids)
        dist.all_gather_into_tensor(torch.empty_like(x), x)
        dist.reduce_scatter_tensor(torch.empty_like(x), x)
        dist.all_to_all_single(torch.empty_like(x), x)
        dist.all_to_all([torch.empty_like(ids)], [ids])

    got = collective_bytes_by_kind(_trace(run, tmp_path))
    assert got["all-reduce"] == {"count": 2, "bytes": 128 + 120}
    assert got["all-gather"] == {"count": 2, "bytes": 120 + 128}
    assert got["reduce-scatter"] == {"count": 1, "bytes": 128}
    assert got["all-to-all"] == {"count": 2, "bytes": 128 + 120}
    assert got["collective-permute"] == {"count": 0, "bytes": 0}
    assert got["total_bytes"] == 248 + 248 + 128 + 248
    assert got["nccl_kernels"] == {}


def test_the_json_text_reads_as_the_dict(gloo_group, tmp_path):
    x = torch.ones(16)
    trace = _trace(lambda: dist.all_reduce(x), tmp_path)
    assert collective_bytes_by_kind(json.dumps(trace)) \
        == collective_bytes_by_kind(trace)
    assert collective_bytes_by_kind(trace)["all-reduce"] == {"count": 1,
                                                            "bytes": 64}


def _zero(got):
    return got["total_bytes"] == 0 and all(got[k]["count"] == 0
                                           for k in KINDS)


def test_a_trace_without_collectives_gives_zeros(tmp_path):
    got = collective_bytes_by_kind(_trace(
        lambda: torch.ones(8, 8) @ torch.ones(8, 8), tmp_path))
    assert _zero(got)
    assert _zero(collective_bytes_by_kind({"traceEvents": []}))


def test_nccl_kernels_are_counted_by_kind_beside_the_totals():
    """NCCL device kernels count by the kind their name gives, outside the
    byte totals (the bytes are the c10d op's)."""
    ev = [{"ph": "X", "cat": "kernel", "ts": i, "name": name}
          for i, name in enumerate((
              "ncclDevKernel_AllReduce_Sum_f32_RING_LL",
              "ncclDevKernel_AllGather_RING_LL",
              "ncclDevKernel_SendRecv", "ncclKernel_ReduceScatter_Sum_bf16",
              "ampere_sgemm_128x64"))]
    got = collective_bytes_by_kind({"traceEvents": ev})
    assert got["nccl_kernels"] == {"all-reduce": 1, "all-gather": 1,
                                   "collective-permute": 1,
                                   "reduce-scatter": 1}
    assert _zero(got)


def _pairs(N, L, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (N, L)).astype(np.int8)
    r = q.copy()
    r[:, ::7] = (r[:, ::7] + 1) % 4
    n = np.full(N, L, np.int32)
    return q, r, n, n.copy()


@pytest.mark.parametrize("shards", (2, 4))
@pytest.mark.parametrize("variant", ("trimmed", "device_decode",
                                     "aligner"))
def test_sharded_engine_issues_no_collective(tmp_path, shards, variant):
    """The sharded engine on a CPU mesh: the sharded runner with a trimmed
    sweep, with the traceback walked on each shard, and `make_aligner`;
    a profiler trace of each holds no collective."""
    mesh = make_debug_mesh(data=shards, model=1, device="cpu")
    q, r, n, m = _pairs(2 * shards, 20, shards)
    if variant == "aligner":
        fn = make_aligner(mesh, TORCH_SC, band=16, collect_tb=False,
                          backend="reference")
    else:
        eng = AlignmentEngine(backend="reference", sc=TORCH_SC, mesh=mesh)
        fn = eng.sharded_runner(
            band=16, collect_tb=variant == "device_decode", t_max=48,
            decode="device" if variant == "device_decode" else "host")
    outs = []
    got = collective_bytes_by_kind(_trace(
        lambda: outs.append(fn(q, r, n, m)), tmp_path))
    assert len(outs[0]) == shards
    assert _zero(got)


def _tiny_params():
    """A vocabulary table, two stacked layers of a column-parallel and a
    row-parallel weight, and a stacked norm scale."""
    def t(*shape):
        return torch.empty(shape, device="meta")
    return {"embed": {"table": t(8, 4)},
            "periods": {"pos0": {"attn": {"wq": {"w": t(2, 4, 4)},
                                          "wo": {"w": t(2, 4, 4)}},
                                 "ln1": {"scale": t(2, 4)}}}}


@pytest.mark.parametrize("pod", (None, 2))
def test_spec_rule_on_a_hand_counted_train_cell(pod):
    """Train, two microbatches (four passes), on (data 2, model 2) and
    (pod 2, data 2, model 2). By hand: the table (8 x 4 on model x data),
    wq and wo (each 2 x 4 x 4 on data and model) are each gathered over
    "data" in every pass, 16 elements in bf16 after the "model" split
    (4 x 32 B each); their gradients reduce-scatter to 8 f32 (32 B) and,
    with a pod axis, all-reduce that shard over "pod"; the norm, sharded
    nowhere, all-reduces its 8 f32 gradients; the table's lookup and wo
    (row-parallel, two layers) all-reduce 5 tokens x 4 in bf16 (40 B) a
    pass and layer: 4 + 8."""
    params = _tiny_params()
    mesh = make_debug_mesh(2, 2, pod=pod, device="cpu")
    got = collective_bytes_from_specs(
        params, param_specs(params, mesh), mesh.shape, step_kind="train",
        microbatches=2, act_tokens=5, d_model=4)
    pods = 3 if pod else 0
    assert got["all-gather"] == {"count": 12, "bytes": 12 * 32}
    assert got["reduce-scatter"] == {"count": 3, "bytes": 3 * 32}
    assert got["all-reduce"] == {"count": 4 + 8 + 1 + pods,
                                 "bytes": 12 * 40 + 32 + pods * 32}
    assert got["all-to-all"] == got["collective-permute"] \
        == {"count": 0, "bytes": 0}
    assert got["total_bytes"] == 12 * 32 + 3 * 32 + 12 * 40 + 32 \
        + pods * 32


def test_spec_rule_on_a_hand_counted_prefill_cell():
    """Prefill (one pass, no gradients): three gathers, the table's lookup
    and wo's two layers of all-reduce."""
    params = _tiny_params()
    mesh = make_debug_mesh(2, 2, device="cpu")
    got = collective_bytes_from_specs(
        params, param_specs(params, mesh), mesh.shape, step_kind="prefill",
        act_tokens=5, d_model=4)
    assert got["all-gather"] == {"count": 3, "bytes": 3 * 32}
    assert got["all-reduce"] == {"count": 3, "bytes": 3 * 40}
    assert got["reduce-scatter"]["count"] == 0
    assert got["total_bytes"] == 3 * 32 + 3 * 40


def test_spec_rule_on_one_device_is_empty():
    params = _tiny_params()
    mesh = make_debug_mesh(1, 1, device="cpu")
    assert _zero(collective_bytes_from_specs(
        params, param_specs(params, mesh), mesh.shape, step_kind="train",
        microbatches=4, act_tokens=5, d_model=4))
