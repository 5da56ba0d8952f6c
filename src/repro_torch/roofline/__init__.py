"""Roofline models on H100 records: the three-term roofline
(`analysis`) and the closed-form bounds of the alignment workload and the
language models (`analytic`). The reference's XLA-HLO collective
inventory (`roofline/hlo_collectives.py`) has no counterpart yet
(ROADMAP A11d)."""

from repro_torch.roofline.analysis import (H100, H100_INT32, HW, Hardware,
                                           analyze_record, model_flops,
                                           roofline_terms)
from repro_torch.roofline.analytic import (ALIGN_DIVERGENCE,
                                           CELL_STATE_BYTES,
                                           DISPATCH_OVERHEAD_S,
                                           alignment_roofline,
                                           analytic_roofline)
