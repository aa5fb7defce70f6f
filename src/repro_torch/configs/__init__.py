"""Model configurations of the port: the reference's ten architectures."""
from repro_torch.configs.base import (ModelConfig, get_config, list_configs,
                                      smoke_of)

__all__ = ["ModelConfig", "get_config", "list_configs", "smoke_of"]
