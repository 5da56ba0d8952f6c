from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.schedules import cosine_schedule, linear_warmup
from repro_torch.optim.grad_compress import (compress_int8, decompress_int8,
                                             error_feedback_update)
