"""Roofline models on H100 records: the three-term roofline
(`analysis`), the closed-form bounds of the alignment workload and the
language models (`analytic`), and the collective inventory by kind
(`hlo_collectives`: read from a profiler trace, or counted from the
sharding specs for the dry run)."""

from repro_torch.roofline.analysis import (H100, H100_INT32, HW, Hardware,
                                           analyze_record, model_flops,
                                           roofline_terms)
from repro_torch.roofline.analytic import (ALIGN_DIVERGENCE,
                                           CELL_STATE_BYTES,
                                           DISPATCH_OVERHEAD_S,
                                           alignment_roofline,
                                           analytic_roofline)
from repro_torch.roofline.hlo_collectives import (
    collective_bytes_by_kind, collective_bytes_from_specs)
