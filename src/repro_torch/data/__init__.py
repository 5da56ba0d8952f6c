from repro_torch.data.genome import (ERROR_PROFILES, ReadSimulator,
                                     SimulatedRead, random_genome,
                                     reverse_complement, simulate_read_pairs)
