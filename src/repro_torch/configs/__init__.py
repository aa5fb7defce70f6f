"""Model configurations of the port: the reference's ten architectures, and
its shape suites."""
from repro_torch.configs.base import (ModelConfig, get_config, list_configs,
                                      smoke_of)
from repro_torch.configs.shapes import SUITES, ShapeSuite, applicable, cells

__all__ = ["ModelConfig", "get_config", "list_configs", "smoke_of", "SUITES",
           "ShapeSuite", "applicable", "cells"]
