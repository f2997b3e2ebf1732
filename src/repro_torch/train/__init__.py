"""Training, as ``repro/train``: the step builders (``steps.py``) and the
fault-tolerant loop with the tendency monitor (``loop.py``)."""
from repro_torch.train.steps import (TrainState, build_serve_step,
                                     build_train_step, init_state, loss_fn)
from repro_torch.train.loop import train

__all__ = ["TrainState", "build_serve_step", "build_train_step",
           "init_state", "loss_fn", "train"]
