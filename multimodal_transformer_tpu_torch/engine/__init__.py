"""Training engine of the PyTorch port."""

from .optim import ReduceLROnPlateau, make_adam
from .train_engine import Engine

__all__ = ["Engine", "ReduceLROnPlateau", "make_adam"]
