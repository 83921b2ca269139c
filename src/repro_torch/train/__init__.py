"""The training loop: checkpointing, fault recovery, stragglers."""
from .loop import InjectedFault, TrainConfig, Trainer
