"""The paper's own workload config: RAPIDx alignment service.

Not an LM — this config parameterises the alignment serve step (the
paper's co-processor role): scoring preset, read-length classes and the
adaptive band function, plus the hardware-analog geometry used by the
PIM cost model benchmarks.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.scoring import MINIMAP2, ScoringConfig, adaptive_bandwidth


@dataclasses.dataclass(frozen=True)
class RapidxConfig:
    name: str = "rapidx"
    scoring: ScoringConfig = MINIMAP2
    short_read_w: int = 10      # base bandwidth for reads <= 1 kbp (§VI-B)
    long_read_w: int = 30       # base bandwidth for long reads
    max_band: int = 100
    # Accelerator geometry (paper §VI-A) — used by core.pim_model.
    tiles: int = 64
    subarray: int = 1024
    tbms_per_tile: int = 15

    def band_for(self, length: int) -> int:
        w = self.short_read_w if length <= 1024 else self.long_read_w
        return adaptive_bandwidth(length, w, cap=self.max_band)


CONFIG = RapidxConfig()
