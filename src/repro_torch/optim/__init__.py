"""Optimizers on PyTorch (a port of the reference's ``repro.optim``):
AdamW and Adafactor over the port's nested-dict parameter trees, the
learning-rate schedules and the int8 gradient-compression roundtrip."""
from repro_torch.optim import grad_compress, schedule
from repro_torch.optim.adamw import (AdafactorConfig, AdamWConfig,
                                     adafactor_init, adafactor_update,
                                     adamw_init, adamw_update)

__all__ = ["AdamWConfig", "AdafactorConfig", "adamw_init", "adamw_update",
           "adafactor_init", "adafactor_update", "schedule", "grad_compress"]
