"""Entry points of the port (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``) and its meshes (``mesh``)."""
from . import mesh

__all__ = ["mesh"]
