from repro_torch.configs.base import (ArchConfig, ShapeSpec, SHAPES, REGISTRY,
                                      get_config, list_archs, register)
import repro_torch.configs.archs  # noqa: F401  (populates REGISTRY)
from repro_torch.configs.rapidx import CONFIG, RapidxConfig
