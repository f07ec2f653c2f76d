from .registry import (ARCH_IDS, SHAPES, Shape, all_cells, cells_for,
                       get_config, get_smoke_config)

__all__ = ["ARCH_IDS", "SHAPES", "Shape", "all_cells", "cells_for",
           "get_config", "get_smoke_config"]
