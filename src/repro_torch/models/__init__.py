from .api import ModelAPI, build_model
from .layers import Ctx

__all__ = ["ModelAPI", "build_model", "Ctx"]
