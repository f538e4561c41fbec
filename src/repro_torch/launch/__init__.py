"""Entry points of the port (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``, ``python -m
repro_torch.launch.dryrun``) and its meshes (``mesh``)."""
from . import dryrun, mesh

__all__ = ["dryrun", "mesh"]
