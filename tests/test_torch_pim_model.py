"""`repro_torch.core.pim_model` (the paper's RAPID-vs-RAPIDx cycle/energy
model, Fig. 11 / 14) against the JAX package's module: a copy of pure
host arithmetic, so every number is equal (tolerance 0)."""

import dataclasses

import pytest

from repro.core import pim_model as jax_pim
from repro_torch.core import pim_model

LENGTHS = (100, 150, 250, 1000, 10_000)
BANDS = (10, 20, 60, 100, 128)
CHIPS = ({}, {"tiles": 32, "tbms_per_tile": 8, "freq_hz": 400e6,
              "power_w": 12.0})


def test_fig11_summary_and_rapid_cell_update_match_jax():
    assert pim_model.fig11_summary() == jax_pim.fig11_summary()
    assert pim_model.rapid_cell_update() == jax_pim.rapid_cell_update()
    assert pim_model.RAPID_OPS == pim_model.OpCount(adds=5, maxes=4)
    for name in ("RAPID_BITS", "RAPIDX_BITS", "RAPIDX_EDIT_BITS",
                 "CYCLES_ADD_PER_BIT", "CYCLES_XOR", "CYCLES_COPY_PER_BIT",
                 "CYCLES_MAX_PIM_PER_BIT", "CYCLES_MAX_PERIPH_PER_BIT",
                 "ENERGY_ADD_PER_BIT", "ENERGY_XOR", "ENERGY_COPY_PER_BIT",
                 "ENERGY_MAX_PIM_PER_BIT", "ENERGY_MAX_PERIPH_PER_BIT"):
        assert getattr(pim_model, name) == getattr(jax_pim, name), name


@pytest.mark.parametrize("bits", range(1, 9))
def test_rapidx_cell_update_matches_jax(bits):
    assert pim_model.rapidx_cell_update(bits) \
        == jax_pim.rapidx_cell_update(bits)
    ops = pim_model.OpCount(adds=3, maxes=2, copies=1)
    jops = jax_pim.OpCount(adds=3, maxes=2, copies=1)
    for periph in (False, True):
        assert ops.latency(bits, periph_max=periph, parallel_groups=2) \
            == jops.latency(bits, periph_max=periph, parallel_groups=2)
        assert ops.energy(bits, periph_max=periph) \
            == jops.energy(bits, periph_max=periph)


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("band", BANDS)
def test_rapidx_chip_matches_jax(length, band):
    for kw in CHIPS:
        chip, jchip = pim_model.RapidxChip(**kw), jax_pim.RapidxChip(**kw)
        assert dataclasses.asdict(chip) == dataclasses.asdict(jchip)
        assert chip.max_segments(band, length) \
            == jchip.max_segments(band, length)
        for tb in (True, False):
            for bits in (pim_model.RAPIDX_BITS, pim_model.RAPIDX_EDIT_BITS):
                assert chip.reads_per_second(length, band, bits=bits,
                                             traceback=tb) \
                    == jchip.reads_per_second(length, band, bits=bits,
                                              traceback=tb)
            assert chip.efficiency(length, band, traceback=tb) \
                == jchip.efficiency(length, band, traceback=tb)
