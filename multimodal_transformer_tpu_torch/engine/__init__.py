"""Training engine, checkpoints and artifact writers of the PyTorch port."""

from .checkpoint import load_model, load_train_state, save_checkpoint
from .csv_io import append_perf_save, seq_id_strings, write_pred_save
from .guards import NanGuard, NonFiniteError
from .logging_utils import get_logger
from .optim import ReduceLROnPlateau, make_adam
from .train_engine import Engine

__all__ = ["Engine", "NanGuard", "NonFiniteError", "ReduceLROnPlateau",
           "append_perf_save", "get_logger", "load_model", "load_train_state",
           "make_adam", "save_checkpoint", "seq_id_strings", "write_pred_save"]
