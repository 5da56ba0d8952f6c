from repro_torch.train.train_step import (loss_fn, make_serve_step,
                                          make_train_step, make_prefill_step,
                                          TrainState, init_train_state)
