"""RAPIDx core algorithms (paper §III-IV), PyTorch port: serving path."""

from repro_torch.core.scoring import (BWA_MEM, CONSTANT_GAP, EDIT_DISTANCE,
                                      LINEAR_GAP, MINIMAP2, PRESETS,
                                      ScoringConfig, adaptive_bandwidth,
                                      decode, encode)
from repro_torch.core.full_dp import (FullDPResult, cigar_score,
                                      full_dp_align, full_dp_matrices,
                                      full_dp_score, traceback_full)
from repro_torch.core.banded import (banded_align_batch, pack_tb_lanes,
                                     packed_tb_width, select_tb_nibble,
                                     traceback_banded,
                                     traceback_banded_batch, unpack_tb_lanes,
                                     validate_narrow_cells)
from repro_torch.core.traceback_device import (decode_packed_tb,
                                               device_decode_result,
                                               fetch_rle, rle_to_cigars)
from repro_torch.core.batch import (DEFAULT_BAND_CAP, AlignmentBatch,
                                    BucketSpec, align_batch, length_class,
                                    make_bucket, pad_group, plan_buckets)
from repro_torch.core.backends import (available_backends, get_backend,
                                       resolve_backend)
from repro_torch.core.engine import AlignmentEngine
