from repro_torch.models.model import (LanguageModel, init_cache, init_params,
                                      model_apply, model_decode)
