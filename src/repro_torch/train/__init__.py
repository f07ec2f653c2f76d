"""The port's training path: AdamW, the train step, synthetic data,
checkpoints and the straggler monitor (``repro.train``'s counterparts)."""
from . import checkpoint, data, elastic, optimizer, train_step

__all__ = ["checkpoint", "data", "elastic", "optimizer", "train_step"]
