"""`repro_torch.launch.specs` and `repro_torch.sharding` against the JAX
package's `launch/specs.py` and `sharding/rules.py`, and the meta-device
path of the port's inits.

The port's abstract trees are "meta" tensors; the reference's are
`jax.eval_shape` structs. Paths, shapes and dtypes must be equal, and
the specs equal as tuples (tolerance: none, all exact). The JAX rules read
only `mesh.axis_names` and `mesh.devices.shape`, so they are handed a
stand-in with those two attributes; the port's rules read its CPU
`DeviceMesh`es.
"""

import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JaxP

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.launch import specs as jspecs
from repro.sharding import rules as jrules
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import init_params
from repro_torch.models.model import tree_leaves_with_path
from repro_torch.optim.adamw import tree_leaves
from repro_torch.sharding import (P, PartitionSpec, batch_specs, cache_specs,
                                  param_specs, train_state_specs)

ARCHS = jax_list_archs()
MESHES = ((1, 1), (16, 16), (2, 16, 16))
#: (batch, max_len) of the cache specs: decode_32k's and long_500k's.
CACHES = {name: (SHAPES[name].global_batch, SHAPES[name].seq_len)
          for name in ("decode_32k", "long_500k")}


def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _jax_flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JaxP))[0]
    return {tuple(_key(k) for k in path): leaf for path, leaf in leaves}


def _port_flat(tree) -> dict:
    return dict(tree_leaves_with_path(tree))


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _assert_same_abstract(jtree, ptree):
    jf, pf = _jax_flat(jtree), _port_flat(ptree)
    assert sorted(pf) == sorted(jf)
    for path, leaf in pf.items():
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == "meta", \
            path
        assert tuple(leaf.shape) == tuple(jf[path].shape), path
        assert _dtype(leaf) == _dtype(jf[path]), path


def _assert_same_specs(jtree, ptree):
    jf, pf = _jax_flat(jtree), _port_flat(ptree)
    assert sorted(pf) == sorted(jf)
    for path, spec in pf.items():
        assert isinstance(spec, PartitionSpec), path
        assert tuple(spec) == tuple(jf[path]), (path, spec, jf[path])


def _jax_mesh(shape):
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


def _port_mesh(shape):
    if len(shape) == 3:
        return make_debug_mesh(data=shape[1], model=shape[2], pod=shape[0],
                               device="cpu")
    return make_debug_mesh(data=shape[0], model=shape[1], device="cpu")


def test_registry_and_shapes_match():
    assert list_archs() == ARCHS
    assert list(SHAPES) == list(JAX_SHAPES)


def test_partition_spec_normalises_as_jax():
    for parts in ((), (None,), ("data", None), (("pod", "data"), None),
                  (("data",), "model"), ((), None), (["a", "b"],)):
        assert tuple(P(*parts)) == tuple(JaxP(*parts)), parts
    assert P("data") == PartitionSpec("data") and hash(P()) == hash(())
    with pytest.raises(AttributeError):
        P("data").append("model")


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in SHAPES:
        got = specs.input_specs(cfg, SHAPES[name])
        want = jspecs.input_specs(jcfg, JAX_SHAPES[name])
        assert list(got) == list(want), name
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == want[k].shape, (name, k)
            assert _dtype(got[k]) == _dtype(want[k]), (name, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_match_jax_eval_shape(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    _assert_same_abstract(jspecs.abstract_params(jcfg),
                          specs.abstract_params(cfg))
    _assert_same_abstract(jspecs.abstract_state(jcfg),
                          specs.abstract_state(cfg))
    for batch, max_len in CACHES.values():
        _assert_same_abstract(jspecs.abstract_cache(jcfg, batch, max_len),
                              specs.abstract_cache(cfg, batch, max_len))


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_for_matches_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in SHAPES:
        for dp in (1, 16, 32, 64):
            assert specs.microbatches_for(cfg, SHAPES[name], dp) \
                == jspecs.microbatches_for(jcfg, JAX_SHAPES[name], dp), \
                (name, dp)
    for budget in (1e9, 6e9, 4e10):
        assert specs.microbatches_for(cfg, SHAPES["train_4k"], 16,
                                      budget_bytes=budget) \
            == jspecs.microbatches_for(jcfg, JAX_SHAPES["train_4k"], 16,
                                       budget_bytes=budget)


@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharding_specs_match_jax(arch, mesh_shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    mesh, jmesh = _port_mesh(mesh_shape), _jax_mesh(mesh_shape)
    params, jparams = specs.abstract_params(cfg), jspecs.abstract_params(jcfg)
    _assert_same_specs(jrules.param_specs(jparams, jmesh),
                       param_specs(params, mesh))
    state, jstate = specs.abstract_state(cfg), jspecs.abstract_state(jcfg)
    _assert_same_specs(
        jrules.train_state_specs(jstate["params"], jstate["opt"], jmesh),
        train_state_specs(state["params"], state["opt"], mesh))
    for name in SHAPES:
        _assert_same_specs(
            jrules.batch_specs(jspecs.input_specs(jcfg, JAX_SHAPES[name]),
                               jmesh),
            batch_specs(specs.input_specs(cfg, SHAPES[name]), mesh))
    _assert_same_specs(
        jrules.batch_specs(jspecs.input_specs(jcfg, JAX_SHAPES["train_4k"]),
                           jmesh, batch_axes=("data",)),
        batch_specs(specs.input_specs(cfg, SHAPES["train_4k"]), mesh,
                    batch_axes=("data",)))
    for batch, max_len in CACHES.values():
        _assert_same_specs(
            jrules.cache_specs(jspecs.abstract_cache(jcfg, batch, max_len),
                               jmesh, batch=batch),
            cache_specs(specs.abstract_cache(cfg, batch, max_len), mesh,
                        batch=batch))


#: Sum and sum of squares (in f64, leaf order) and element count of
#: `init_params(cfg.reduced(), 7, device="cpu")`, taken from the port
#: before its inits took an explicit device: the meta-device repair moves
#: no CPU value. The sums are compared within 1e-12 relative, since
#: torch's CPU reduction order may change with its version or the CPU;
#: a moved init value moves them by far more.
CPU_INIT_SUMS = {
    "gemma3-27b": (1111.5216010679706, 16323.11378092012, 263168),
    "mixtral-8x22b": (429.7656928072556, 14726.860487487773, 164672),
    "musicgen-medium": (360.7536088415511, 1210.830393516775, 82240),
    "paligemma-3b": (377.71810778586456, 13724.636353480917, 90432),
    "qwen2-moe-a2.7b": (416.6576937400296, 15027.065490400922, 189760),
    "qwen2.5-14b": (420.7104287020006, 14022.234178106995, 115392),
    "qwen3-0.6b": (518.933960941544, 13889.390139314595, 98688),
    "recurrentgemma-9b": (560.2536997268548, 14542.936697511188, 142784),
    "stablelm-3b": (420.7104287020006, 14022.234178106995, 115008),
    "xlstm-125m": (270.17149332596, 13462.89130346139, 54536),
}


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_init_is_the_cpu_tree_and_cpu_values_unchanged(arch):
    cfg = get_config(arch)
    meta = init_params(cfg, 0, device="meta")
    _assert_same_abstract(jspecs.abstract_params(jax_get_config(arch)), meta)
    small = cfg.reduced()
    cpu = init_params(small, 7, device="cpu")
    small_meta = init_params(small, 7, device="meta")
    got, want = _port_flat(cpu), _port_flat(small_meta)
    assert list(got) == list(want)
    for path, t in got.items():
        assert t.device.type == "cpu"
        assert (t.shape, t.dtype) == (want[path].shape, want[path].dtype)
    leaves = [t.double() for t in tree_leaves(cpu)]
    total, squares, count = CPU_INIT_SUMS[arch]
    assert sum(t.numel() for t in leaves) == count
    assert sum(t.sum() for t in leaves).item() == pytest.approx(total,
                                                                rel=1e-12)
    assert sum((t * t).sum() for t in leaves).item() == pytest.approx(
        squares, rel=1e-12)
    gen = torch.Generator().manual_seed(7)
    same = init_params(small, gen, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cpu),
                                                 tree_leaves(same)))
    cpu_gen_meta = init_params(small, torch.Generator().manual_seed(7),
                               device="meta")
    assert all(t.device.type == "meta" for t in tree_leaves(cpu_gen_meta))
