from .api import ModelAPI, build_model, decode_block
from .layers import Ctx

__all__ = ["ModelAPI", "build_model", "decode_block", "Ctx"]
