from repro_torch.train.train_step import (make_prefill_step, make_serve_step)
