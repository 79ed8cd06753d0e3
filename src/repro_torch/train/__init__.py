"""Training and serving runtime: step factories and the SpotTrainer control loop."""

from repro_torch.train.spot_trainer import SpotTrainer, SpotTrainerConfig
from repro_torch.train.steps import TrainState, make_decode_step, make_prefill, make_train_step

__all__ = [
    "SpotTrainer",
    "SpotTrainerConfig",
    "TrainState",
    "make_decode_step",
    "make_prefill",
    "make_train_step",
]
