from repro_torch.sharding.rules import (P, PartitionSpec, batch_specs,
                                        cache_specs, param_specs,
                                        train_state_specs)
