from repro_torch.configs.rapidx import CONFIG, RapidxConfig
