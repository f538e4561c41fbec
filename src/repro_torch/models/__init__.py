from . import api, convert, layers, transformer
from .api import Model, get_model

__all__ = ["Model", "get_model", "api", "convert", "layers", "transformer"]
