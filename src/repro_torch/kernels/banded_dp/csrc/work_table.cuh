// Columns of the int64 work table of a persistent request, one row per
// pair (kernels/banded_dp/persistent.py: TABLE_COLS). Read by the
// persistent wavefront (persistent.cu) and the table walker
// (core/csrc/traceback.cu).

#pragma once

namespace work_table {

enum Col { ROW, Q_OFF, R_OFF, LQ, LR, BAND, STEPS, TB_OFF, LOS_OFF, NCOL };

}  // namespace work_table
