from repro_torch.checkpoint.checkpoint import (CheckpointManager, latest_step,
                                               restore, save)
