from repro_torch.configs.base import ArchConfig, get_config, list_archs, register
