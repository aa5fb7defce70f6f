"""repro_torch.train: optimizer, data, checkpointing, fault tolerance and
the spectral monitor, after the reference's ``repro.train``."""
from repro_torch.train.optimizer import (AdamWConfig, adamw_init, adamw_update,
                                         cosine_lr)
from repro_torch.train.trainer import Trainer
from repro_torch.train.data import DataConfig, batch_at, Prefetcher
from repro_torch.train import checkpoint
from repro_torch.train.ft import (StragglerMonitor, FailureInjector,
                                  run_with_restarts)
from repro_torch.train.spectral import SpectralMonitor, SpectralMonitorConfig

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
           "Trainer", "DataConfig", "batch_at", "Prefetcher", "checkpoint",
           "StragglerMonitor", "FailureInjector", "run_with_restarts",
           "SpectralMonitor", "SpectralMonitorConfig"]
