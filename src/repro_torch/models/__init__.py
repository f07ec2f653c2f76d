"""The model zoo's building blocks.  ``Model`` is imported on first use:
the layers import ``parallel.collective_planner``, which imports
``models.param``, so that either package may be imported first."""
from .config import ModelConfig

__all__ = ["Model", "ModelConfig"]


def __getattr__(name):
    if name == "Model":
        from .model import Model
        return Model
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
