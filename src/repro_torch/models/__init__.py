from .config import ModelConfig
from .model import Model

__all__ = ["Model", "ModelConfig"]
