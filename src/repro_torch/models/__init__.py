from . import api, convert, encdec, layers, moe, transformer, vlm
from .api import Model, get_model

__all__ = ["Model", "get_model", "api", "convert", "encdec", "layers", "moe",
           "transformer", "vlm"]
