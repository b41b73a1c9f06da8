"""Training of the port: AdamW and the micro-batched train step and loop."""
from repro_torch.training.loop import TrainLoop, make_train_step
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "make_train_step", "TrainLoop",
]
