"""`repro_torch.roofline` against the JAX package's roofline, key by key,
with the same `Hardware` fields handed to both. Same arithmetic in the
same order: tolerance 0 (exact float equality); the language models'
half of `analytic_roofline` within 1e-12 relative."""

import ast
import pathlib

import pytest

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import list_archs as jax_list_archs
from repro.roofline.analysis import Hardware as JaxHardware
from repro.roofline.analysis import analyze_record as jax_analyze_record
from repro.roofline.analysis import model_flops as jax_model_flops
from repro.roofline.analysis import roofline_terms as jax_roofline_terms
from repro.roofline.analytic import alignment_roofline as \
    jax_alignment_roofline
from repro.roofline import analytic as jax_analytic
from repro_torch.configs import SHAPES, list_archs
from repro_torch.kernels import work
from repro_torch.roofline import (ALIGN_DIVERGENCE, CELL_STATE_BYTES,
                                  DISPATCH_OVERHEAD_S, H100, H100_INT32, HW,
                                  Hardware, alignment_roofline,
                                  analytic_roofline, analyze_record,
                                  model_flops, roofline_terms)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RECORDS_HW = (H100, H100_INT32)


def _jax_hw(hw: Hardware) -> JaxHardware:
    return JaxHardware(hw.name, hw.peak_flops, hw.hbm_bw, hw.link_bw)


def _assert_same(ref: dict, got: dict):
    assert list(got) == list(ref)
    for key in ref:
        assert got[key] == ref[key], key


@pytest.mark.parametrize("length", (150, 2000, 8000))
@pytest.mark.parametrize("band", (20, 60, 100))
@pytest.mark.parametrize("dispatch,n_groups", [
    ("pipelined", 1), ("pipelined", 33), ("persistent", 1),
    ("persistent", 7)])
def test_alignment_roofline_matches_jax(length, band, dispatch, n_groups):
    for reject in (0.0, 0.3):
        for cell_dtype in ("int32", "narrow"):
            for mesh_shape, mesh in (([1], "1"), ([2, 2], "2x2")):
                rec = {"length": length, "band": band, "global_batch": 4096,
                       "shape": f"L{length}", "mesh": mesh,
                       "mesh_shape": mesh_shape, "dispatch": dispatch,
                       "n_groups": n_groups, "cell_dtype": cell_dtype,
                       "reject_fraction": reject}
                for hw in RECORDS_HW:
                    _assert_same(jax_alignment_roofline(rec, _jax_hw(hw)),
                                 alignment_roofline(rec, hw))
                    arec = dict(rec, arch="rapidx-align")
                    _assert_same(
                        jax_analytic.analytic_roofline(arec, _jax_hw(hw)),
                        analytic_roofline(arec, hw))


def test_alignment_roofline_defaults_and_constants():
    """The module constants equal the reference's; the default record is
    the H100's int32 one; the xdrop-off defaults are the plain record."""
    assert ALIGN_DIVERGENCE == jax_analytic.ALIGN_DIVERGENCE
    assert DISPATCH_OVERHEAD_S == jax_analytic.DISPATCH_OVERHEAD_S
    assert CELL_STATE_BYTES == jax_analytic.CELL_STATE_BYTES
    rec = {"length": 150, "band": 20, "global_batch": 64, "shape": "s"}
    got = alignment_roofline(rec)
    _assert_same(jax_alignment_roofline(rec, _jax_hw(H100_INT32)), got)
    assert got == alignment_roofline(dict(rec, reject_fraction=0.0,
                                          dispatch="pipelined", n_groups=1))
    assert got["collective_bytes_per_device"] == 0.0
    assert got["dominant"] == "compute" and got["launches"] == 1


LM_MESHES = (("1x1", [1, 1]), ("16x16", [16, 16]), ("2x16x16", [2, 16, 16]))


def _assert_close(ref: dict, got: dict, rtol=1e-12):
    assert list(got) == list(ref)
    for key in ref:
        if isinstance(ref[key], str):
            assert got[key] == ref[key], key
        else:
            assert abs(got[key] - ref[key]) <= rtol * abs(ref[key]), key


@pytest.mark.parametrize("mesh,mesh_shape", LM_MESHES,
                         ids=[m for m, _ in LM_MESHES])
@pytest.mark.parametrize("shape", list(JAX_SHAPES))
@pytest.mark.parametrize("arch", jax_list_archs())
def test_analytic_roofline_lm_matches_jax(arch, shape, mesh, mesh_shape):
    """The LM half against the reference's, both handed the port's H100
    fields: every field within 1e-12 relative (strings equal); the default
    record of an LM cell is the dense bf16 `H100`."""
    rec = {"arch": arch, "shape": shape, "mesh": mesh,
           "mesh_shape": mesh_shape}
    want = jax_analytic.analytic_roofline(rec, _jax_hw(H100))
    _assert_close(want, analytic_roofline(rec, H100))
    _assert_close(want, analytic_roofline(rec))
    if JAX_SHAPES[shape].kind == "decode":
        masked = dict(rec, masked_cache_write=True)
        _assert_close(jax_analytic.analytic_roofline(masked, _jax_hw(H100)),
                      analytic_roofline(masked))


@pytest.mark.parametrize("hw", RECORDS_HW, ids=lambda h: h.name)
def test_roofline_terms_match_jax(hw):
    for flops, byts, coll in ((1e12, 1e9, 0.0), (3e9, 7e11, 5e8),
                              (0.0, 0.0, 0.0), (2.5e14, 2.5e10, 4e10)):
        _assert_same(jax_roofline_terms(flops, byts, coll, _jax_hw(hw)),
                     roofline_terms(flops, byts, coll, hw))


@pytest.mark.parametrize("arch", jax_list_archs())
def test_model_flops_and_analyze_record_match_jax(arch):
    assert list_archs() == jax_list_archs()
    assert list(SHAPES) == list(JAX_SHAPES)
    for k, shape in enumerate(SHAPES):
        assert model_flops(arch, shape) == jax_model_flops(arch, shape)
        rec = {"arch": arch, "shape": shape, "mesh": "16x16",
               "mesh_shape": [16, 16], "status": "ok",
               "flops_per_device": 1.5e14 * (k + 1),
               "bytes_accessed_per_device": 3.0e11 / (k + 1),
               "collectives": {"total_bytes": 2.0e9 * k}}
        for hw in RECORDS_HW:
            _assert_same(jax_analyze_record(rec, hw=_jax_hw(hw)),
                         analyze_record(rec, hw=hw))
        _assert_same(jax_analyze_record(rec, chips=2),
                     analyze_record(rec, chips=2, hw=Hardware(
                         "tpu-v5e", 197e12, 819e9, 50e9)))
    for rec in ({"arch": arch, "shape": "train_4k", "mesh": "m",
                 "skipped": "does not fit"},
                {"arch": arch, "shape": "train_4k", "mesh": "m",
                 "status": "error"},
                {"arch": "rapidx-align", "shape": "s", "mesh": "m",
                 "status": "ok", "flops_per_device": 1e12,
                 "bytes_accessed_per_device": 1e9,
                 "collectives": {"total_bytes": 0}}):
        _assert_same(jax_analyze_record(rec, hw=_jax_hw(HW)),
                     analyze_record(rec))


def _assigned(tree, name):
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            return ast.unparse(node.value)
    raise AssertionError(f"chip_smoke.py assigns no {name}")


def test_h100_records_are_the_data_sheet_and_chip_smokes_constants():
    """The H100 records are NVIDIA's data-sheet peaks (dense bf16 989
    TFLOP/s, HBM 3.35 TB/s, NVLink 450 GB/s a direction; int32 = a
    quarter of the 67 TFLOP/s f32 figure), the default `HW` is the H100,
    and `chip_smoke.py` and the kernel table's formulas (`kernels.work`)
    take their bounds' rates from them or equal them."""
    assert (H100.peak_flops, H100.hbm_bw, H100.link_bw) == (989e12, 3.35e12,
                                                            450e9)
    assert H100_INT32 == Hardware("h100-sxm-int32", 16.75e12, 3.35e12, 450e9)
    assert HW == H100 == Hardware()
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    assert _assigned(tree, "HBM_BYTES_PER_S") == "H100_INT32.hbm_bw"
    assert _assigned(tree, "INT32_OPS_PER_S") == "H100_INT32.peak_flops"
    assert _assigned(tree, "BF16_FLOP_PER_S") == "H100.peak_flops"
    # The kernel table's formulas (`kernels.work`, read by chip_smoke.py's
    # bounds and the dry run) take the same rates.
    assert work.PEAKS["bf16"] == H100.peak_flops
    assert work.PEAKS["int32"] == H100_INT32.peak_flops
    assert work.PEAKS["f32"] / 4 == H100_INT32.peak_flops
    assert work.HBM_BYTES_PER_S == H100.hbm_bw == H100_INT32.hbm_bw
