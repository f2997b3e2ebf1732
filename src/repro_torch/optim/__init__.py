"""Optimizers and gradient compression, as ``repro/optim``: plain
functions on the params dict of tensors (``adamw.py``,
``compression.py``)."""
from repro_torch.optim.adamw import (OptState, adafactor_init,
                                     adafactor_update, adamw_init,
                                     adamw_update, apply_opt,
                                     clip_by_global_norm, cosine_lr,
                                     init_opt)
from repro_torch.optim.compression import EFState, compress, ef_init

__all__ = ["OptState", "adamw_init", "adamw_update", "adafactor_init",
           "adafactor_update", "init_opt", "apply_opt",
           "clip_by_global_norm", "cosine_lr", "EFState", "ef_init",
           "compress"]
